"""AMR error injection: any ``reduction.Schedule`` as a matmul.

The port of the JAX package's ``numerics/injection.py``.  A schedule, such
as a DSE candidate rebuilt with ``reduction.build_schedule(..., assigner=)``
that has no 256x256 table, is registered under a string handle
(``register_schedule``) and named by ``AMRNumerics("amr_inject",
schedule_ref=handle)``; every matmul under that policy then computes the
exact AMR products of its quantized operands by replaying the reduction
circuit (``engine.CompiledInjector``).  ``schedule_ref=None`` is the
paper's schedule for ``(n_digits=2, border)``.  Anonymous handles come from
a monotonic counter that skips taken names and never recycles one.

The JAX package's ``injected_matmul_int`` / ``injected_matmul_grouped``
are ``kernels/inject_replay/ops.py``'s ``inject_replay_matmul`` and its
grouped form here: one front behind the int32-saturation guard, which runs
the hand kernel for CUDA tensors and its plain version
(``kernels/inject_replay/ref.py``, chunked as ``plan_chunks`` does in the
JAX package) for CPU tensors.

Left out on purpose: the JAX package's identity-keyed ``WEIGHT_PACKS``
cache and its ``packed_weights`` front.  The port quantizes weights on
every call, so the packed operand is a new tensor each time and the cache
could never hit; torch tensors are also mutable in place, which an
identity key cannot see.  Packing is ``CompiledInjector.pack_weights``.
"""
from __future__ import annotations

from repro_torch.core import engine, reduction

__all__ = ["register_schedule", "resolve_schedule", "get_injector", "check_accumulation_bound",
           "schedule_label"]

# Registered custom schedules (DSE candidates etc.), keyed by handle.  Default
# design points (schedule_ref=None) go through engine.get_injector's cache.
_SCHEDULES: dict[str, reduction.Schedule] = {}
_INJECTORS: dict[str, engine.CompiledInjector] = {}
_ANON_COUNTER = 0


def register_schedule(schedule: reduction.Schedule, name: str | None = None) -> str:
    """Register a custom schedule; returns the handle for ``schedule_ref``.

    Only 2-digit schedules (whose MRSD range strictly contains int8) are
    accepted.  Re-registering a name replaces the schedule and drops its
    compiled injector; anonymous handles (``name=None``) are ``custom:<n>``
    from a monotonic counter that skips taken names.
    """
    global _ANON_COUNTER
    if schedule.n_digits != 2:
        raise ValueError(
            f"amr_inject matmuls run on int8 operands: need a 2-digit "
            f"schedule, got n_digits={schedule.n_digits}")
    if name is None:
        while True:
            name = f"custom:{_ANON_COUNTER}"
            _ANON_COUNTER += 1
            if name not in _SCHEDULES:
                break
    _SCHEDULES[name] = schedule
    _INJECTORS.pop(name, None)
    return name


def resolve_schedule(numerics) -> reduction.Schedule:
    """The schedule an ``amr_inject`` policy refers to."""
    if numerics.schedule_ref is None:
        return reduction.get_schedule(2, numerics.border)
    try:
        return _SCHEDULES[numerics.schedule_ref]
    except KeyError:
        raise KeyError(
            f"numerics.schedule_ref={numerics.schedule_ref!r} is not "
            f"registered in this process — call "
            f"numerics.injection.register_schedule(schedule) first") from None


def get_injector(numerics) -> engine.CompiledInjector:
    """Compiled injector for a policy (cached per handle / default border)."""
    if numerics.schedule_ref is None:
        return engine.get_injector(2, numerics.border)
    inj = _INJECTORS.get(numerics.schedule_ref)
    if inj is None:
        inj = engine.compile_injector(resolve_schedule(numerics))
        _INJECTORS[numerics.schedule_ref] = inj
    return inj


def schedule_label(inj: engine.CompiledInjector, schedule: str | None = None) -> str:
    """The registered handle when the caller has one, else the design-point
    label of the injector's schedule (as in the JAX package's guard errors)."""
    if schedule is not None:
        return schedule
    s = inj.schedule
    return f"default(n_digits={s.n_digits}, border={s.border})"


def check_accumulation_bound(inj: engine.CompiledInjector, k: int, *,
                             schedule: str | None = None) -> None:
    """Raise when K products could saturate the int32 accumulator
    (``K * inj.max_abs_product >= 2**31``)."""
    worst = k * inj.max_abs_product
    if worst >= 2**31:
        raise ValueError(
            f"amr_inject int32 accumulator can saturate: schedule "
            f"{schedule_label(inj, schedule)}: K={k} with "
            f"max|product|={inj.max_abs_product} gives K*max|product| = "
            f"{worst} >= 2**31 = {2**31}; keep K <= "
            f"{(2**31 - 1) // inj.max_abs_product} for this schedule "
            f"(or split the contraction before the matmul)")
