"""Request / completion records and the FIFO admission queue.

Pure host-side bookkeeping, the same as the JAX package's. Timestamps are
filled in by the engine (monotonic clock) so completions carry queue
latency, time-to-first-token and end-to-end latency for serve_bench.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a token-id sequence; generation is greedy and stops at
    ``eos_id`` (if given) or after ``max_new_tokens``. ``uid`` is assigned
    by the queue at submit time.
    """

    prompt: tuple[int, ...]
    max_new_tokens: int
    eos_id: int | None = None
    uid: int = -1
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0

    def __post_init__(self) -> None:
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")


@dataclasses.dataclass
class Completion:
    """A finished request: generated tokens + latency breakdown."""

    uid: int
    prompt: tuple[int, ...]
    tokens: tuple[int, ...]
    finish_reason: str  # "eos" | "length"
    t_submit: float
    t_admit: float
    t_first_token: float
    t_done: float
    logits: list | None = None  # per-token final logits (record_logits=True)

    @property
    def queue_s(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> float:
        """Submit -> first token (queue wait + prefill)."""
        return self.t_first_token - self.t_submit

    @property
    def total_s(self) -> float:
        return self.t_done - self.t_submit


class RequestQueue:
    """FIFO admission queue. Admission order == submit order (fairness is
    property-tested: the engine never reorders waiting requests)."""

    def __init__(self) -> None:
        self._q: deque[Request] = deque()
        self._uids = itertools.count()

    def submit(self, req: Request) -> int:
        req.uid = next(self._uids)
        self._q.append(req)
        return req.uid

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
