"""Fixed-slot allocator for the shared decode cache.

The engine's cache has ``n_slots`` batch rows; each admitted request owns
exactly one row until it finishes. The allocator is deliberately dumb —
lowest free index first — because slot *identity* must not matter: the
decode step is row-independent (bit-exactness gate), so any free row is as
good as any other.
"""
from __future__ import annotations


class SlotAllocator:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._free: list[int] = sorted(range(n_slots), reverse=True)
        self._in_use: set[int] = set()

    def allocate(self) -> int | None:
        """Lowest free slot index, or None when full. Never double-allocates."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.discard(slot)
        # keep lowest-first order without a heap: n_slots is tiny
        self._free.append(slot)
        self._free.sort(reverse=True)

    @property
    def in_use(self) -> frozenset[int]:
        return frozenset(self._in_use)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def __len__(self) -> int:
        return len(self._in_use)
