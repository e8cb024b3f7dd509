"""The conformance matrix: families x modes x paths, with invariants.

The port of the JAX package's ``conformance/matrix.py``.  Every arm
builds a ``get_reduced_config`` variant (validated by
``configs.validate_config``), swaps in the numerics policy under test, and
drives the port's real entry points (``train.steps``' ``make_train_state``,
``make_train_step`` and ``loss_fn``; ``models.forward``, ``encode``,
``prefill_with_cache`` and ``decode_step``; ``runtime.fault.
FaultTolerantLoop``), never reimplementations.  Invariants per arm:

  * train      — finite loss and gradients over a few real optimizer
                 steps, non-degenerate logits (the model computes).
  * audit      — amr_inject bit-identical to the table-gather oracle at
                 every call site (``numerics_scope(audit=AuditTrace())``,
                 the registry's ``ModeSpec.oracle`` hook).
  * parity     — prefill -> decode logits match the full forward within a
                 per-mode tolerance (``PARITY_TOL``); amr_noise is exempt
                 (decode folds the cache position into its keys, the full
                 forward has none).
  * decorrel   — amr_noise draws differ across steps and reproduce within
                 a (seed, step) coordinate.
  * restart    — a ``FaultTolerantLoop`` under amr_inject, preempted
                 mid-run, resumes from its checkpoints and reproduces the
                 uninterrupted float32 loss stream bit for bit.

Every function takes ``device=`` ("cuda" by default, as every entry point
of the port): on the card the arms run the hand kernels, on the CPU their
plain versions.  The rows carry the JAX rows' keys.  The inputs are the
JAX package's: ``make_inputs`` draws the same tokens (the port's copy of
``SyntheticLM``) and the same audio or VLM extras (the same numpy rng);
the weights come from the port's own generator (``init_params``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.configs import families, get_reduced_config, validate_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import decode_step, encode, forward, init_params, prefill_with_cache
from repro_torch.models.tree import tree_items, tree_map
from repro_torch.numerics import AMRNumerics, mode_names, numerics_scope
from repro_torch.numerics.context import AuditTrace
from repro_torch.train.steps import loss_fn, make_train_state, make_train_step

__all__ = ["REPRESENTATIVE", "PARITY_TOL", "BORDER", "ACTIVATION_SITES",
           "arch_mode_arms", "policy_for", "tiny_config", "make_inputs",
           "run_train_arm", "run_inject_audit", "run_decode_parity",
           "run_noise_decorrelation", "run_restart_arm"]

# The paper's default approximate border for all conformance arms.
BORDER = 8

# One representative arch per family.
REPRESENTATIVE = {
    "dense": "gemma3-1b",     # swa+full pattern — covers both attn kinds
    "ssm": "mamba2-370m",
    "hybrid": "zamba2-1.2b",  # ssm + shared_attn groups
    "moe": "dbrx-132b",
    "audio": "whisper-small",
    "vlm": "internvl2-76b",
}

# Decode-vs-forward parity tolerance per mode (float32 logit max-abs-diff),
# the JAX package's: int8-quantized modes get headroom for bin flips (a
# float order difference upstream can move an activation across an int8
# boundary, stepping the output by a full product quantum).  None: parity
# not applicable (amr_noise: decode folds the cache position into its
# keys, the forward has none).
PARITY_TOL: dict[str, float | None] = {
    "exact": 0.15,
    "amr_lut": 0.75,
    "amr_inject": 0.75,
    "amr_lowrank": 0.75,
    "amr_noise": None,
    "amr_kernel": 0.75,
}

# Activation x activation seam sites each family's forward must route
# under a non-exact policy (the QK^T / PV score chain, the MoE's grouped
# expert matmuls, the SSD scan's readout): ``run_inject_audit``'s sites
# are checked against this map, so a call site that falls back to a plain
# product fails conformance.
ACTIVATION_SITES: dict[str, set[str]] = {
    "dense": {"attn.qk", "attn.pv"},
    "ssm": {"ssm.scan"},
    "hybrid": {"attn.qk", "attn.pv", "ssm.scan"},
    "moe": {"attn.qk", "attn.pv", "moe.expert.w_gate", "moe.expert.w_up",
            "moe.expert.w_down"},
    "audio": {"attn.qk", "attn.pv"},   # cross-attn shares the seam sites
    "vlm": {"attn.qk", "attn.pv"},
}


def policy_for(mode: str, *, border: int = BORDER, schedule_ref: str | None = None,
               noise_seed: int = 0) -> AMRNumerics:
    """The conformance policy for a registry mode, from its declared
    defaults (``registry.default_policy`` drops the overrides a mode does
    not take)."""
    from repro_torch.numerics import default_policy

    return default_policy(mode, border=border, schedule_ref=schedule_ref,
                          noise_seed=noise_seed)


def tiny_config(arch: str, mode: str, **policy_kw: Any) -> ModelConfig:
    """Validated reduced config with the mode-under-test numerics."""
    cfg = validate_config(get_reduced_config(arch))
    return dataclasses.replace(cfg, numerics=policy_for(mode, **policy_kw))


def arch_mode_arms(archs=None, modes=None) -> list[tuple[str, str]]:
    """The (arch, mode) sweep grid, registry-ordered on both axes."""
    if archs is None:
        archs = [a for fam in families().values() for a in fam]
    if modes is None:
        modes = list(mode_names())
    return [(a, m) for a in archs for m in modes]


def make_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Token batch + the stub-frontend extras a family needs, on ``device``:
    the JAX package's arrays (the extras drawn in float64, rounded to
    float32 and then to ``cfg.dtype``, as the JAX package converts them)."""
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=seed)
    out = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(0).items()}
    rng = np.random.default_rng(seed + 1)
    n = cfg.encoder_frames if cfg.encoder_layers else cfg.vision_prefix
    if n:
        extra = rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)
        out["extra"] = torch.from_numpy(extra).to(device=device, dtype=getattr(torch, cfg.dtype))
    return out


def _finite(t: torch.Tensor | None) -> bool:
    return t is None or not t.is_floating_point() or bool(torch.isfinite(t).all())


def run_train_arm(arch: str, mode: str, *, steps: int = 2, batch: int = 2, seq: int = 8,
                  seed: int = 0, device: str | torch.device = "cuda", **policy_kw: Any) -> dict:
    """A few real optimizer steps; finiteness + non-degeneracy invariants."""
    cfg = tiny_config(arch, mode, **policy_kw)
    state = make_train_state(cfg, seed, device=device)
    train_step = make_train_step(cfg, total_steps=max(steps, 2))
    batch0 = make_inputs(cfg, batch, seq, seed, device=device)

    # gradient finiteness probed before the optimizer could smear a NaN
    # into every parameter; the same pass gives the logits
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        loss, (_, logits) = loss_fn(cfg, ps, batch0["tokens"], batch0["targets"],
                                    batch0.get("extra"), step=state.step, with_logits=True)
        grads = torch.autograd.grad(loss, [p for _, p in tree_items(ps)], allow_unused=True)
    grad_finite = all(_finite(g) for g in grads)
    lg = logits.detach().float().cpu().numpy()
    del ps, grads, logits

    losses = []
    for i in range(steps):
        state, metrics = train_step(state, make_inputs(cfg, batch, seq, seed + i, device=device))
        losses.append(float(metrics["loss"]))
    loss_finite = all(np.isfinite(losses))

    # non-degenerate: finite, and the model discriminates over the vocab
    # (a collapsed stack emits near-constant rows)
    nondegenerate = bool(np.isfinite(lg).all()
                         and (lg.max(axis=-1) - lg.min(axis=-1)).min() > 1e-4)
    return {
        "kind": "train", "arch": arch, "mode": mode, "steps": steps,
        "loss_finite": loss_finite, "grad_finite": grad_finite,
        "nondegenerate": nondegenerate,
        "first_loss": losses[0], "final_loss": losses[-1],
    }


def run_inject_audit(arch: str, *, schedule_ref: str | None = None, batch: int = 2,
                     seq: int = 8, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """amr_inject forward under the audit scope: every call site's output
    compared with the table-gather oracle (grid-step units)."""
    cfg = tiny_config(arch, "amr_inject", schedule_ref=schedule_ref)
    params = init_params(cfg, seed, device=device)
    inputs = make_inputs(cfg, batch, seq, seed, device=device)
    trace = AuditTrace()
    step = torch.zeros((), dtype=torch.int32, device=device)
    with torch.inference_mode(), numerics_scope(step=step, audit=trace):
        forward(cfg, params, inputs["tokens"], inputs.get("extra"))
    assert trace.calls > 0, f"{arch}: audit saw no approx_matmul call sites"
    return {
        "kind": "inject_audit", "arch": arch,
        "schedule": schedule_ref or "default",
        "bit_exact": trace.bit_exact(), "max_abs_diff": trace.max_abs_diff,
        "sites": len(trace.sites), "calls": trace.calls,
        "site_diffs": {s: e["max_abs_diff"] for s, e in sorted(trace.sites.items())},
    }


def run_decode_parity(arch: str, mode: str, *, seq: int = 12, batch: int = 2, seed: int = 0,
                      device: str | torch.device = "cuda", **policy_kw: Any) -> dict:
    """Prefill S-1 tokens, decode token S-1; final logits vs full forward."""
    tol = PARITY_TOL.get(mode, 0.75)
    if tol is None:
        return {"kind": "decode_parity", "arch": arch, "mode": mode,
                "applicable": False, "within_tol": True, "parity_diff": 0.0}
    cfg = tiny_config(arch, mode, **policy_kw)
    params = init_params(cfg, seed, device=device)
    inputs = make_inputs(cfg, batch, seq, seed, device=device)
    toks, extra = inputs["tokens"], inputs.get("extra")
    with torch.inference_mode():
        enc_out = encode(cfg, params, extra) if cfg.encoder_layers else None
        ref, _ = forward(cfg, params, toks, extra)
        # vision tokens prepend to the decoder sequence: the cache holds them
        _, cache = prefill_with_cache(cfg, params, toks[:, : seq - 1],
                                      capacity=seq + cfg.vision_prefix, extra_embeddings=extra)
        lg, _ = decode_step(cfg, params, toks[:, seq - 1: seq], cache, enc_out)
    diff = float((lg[:, 0].float() - ref[:, -1].float()).abs().max())
    return {"kind": "decode_parity", "arch": arch, "mode": mode,
            "applicable": True, "within_tol": diff <= tol,
            "parity_diff": diff, "tol": tol}


def run_noise_decorrelation(arch: str, *, batch: int = 2, seq: int = 8, seed: int = 0,
                            device: str | torch.device = "cuda") -> dict:
    """amr_noise must differ across step coordinates and reproduce within
    one: the scope's fold does its job at model scale."""
    cfg = tiny_config(arch, "amr_noise")
    params = init_params(cfg, seed, device=device)
    inputs = make_inputs(cfg, batch, seq, seed, device=device)

    def fwd(step: int) -> np.ndarray:
        with torch.inference_mode(), numerics_scope(
                step=torch.full((), step, dtype=torch.int32, device=device)):
            logits, _ = forward(cfg, params, inputs["tokens"], inputs.get("extra"))
        return logits.float().cpu().numpy()

    l0, l0b, l1 = fwd(0), fwd(0), fwd(1)
    return {
        "kind": "noise_decorrelation", "arch": arch,
        "reproducible": bool((l0 == l0b).all()),
        "steps_decorrelated": bool(np.abs(l0 - l1).max() > 0),
    }


# --------------------------------------------------------------------------
# restart bit-consistency (the fault story, end to end)
# --------------------------------------------------------------------------

def _build_loop(cfg: ModelConfig, ckpt_dir, data: SyntheticLM, losses: list, *,
                preempt_at: int | None = None, use_signal: bool = False, on_restore=None,
                ckpt_every: int = 2, device: str | torch.device = "cuda"):
    """A FaultTolerantLoop whose step_fn records per-step float32 losses
    and (optionally) raises the preemption flag at global step
    ``preempt_at``: by a real SIGTERM to this process or by setting the
    loop's event directly (the handler does exactly that)."""
    from repro_torch.runtime.fault import FaultTolerantLoop

    train_step = make_train_step(cfg, total_steps=64)

    def step_fn(state, batch):
        step = int(state.step)
        state, metrics = train_step(state, batch)
        losses.append((step, float(metrics["loss"])))
        if preempt_at is not None and step == preempt_at - 1:
            if use_signal:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                loop._preempted.set()
        return state, metrics

    loop = FaultTolerantLoop(
        ckpt_dir=ckpt_dir,
        make_state=lambda: make_train_state(cfg, 0, device=device),
        step_fn=step_fn,
        batch_at=lambda i: {k: torch.from_numpy(v).to(device)
                            for k, v in data.batch_at(i).items()},
        ckpt_every=ckpt_every,
        on_restore=on_restore,
    )
    return loop


def run_restart_arm(arch: str = "gemma-2b", *, total_steps: int = 6, preempt_at: int = 3,
                    batch: int = 2, seq: int = 8, use_signal: bool = False,
                    schedule_ref: str | None = None, on_restore=None, between_lives=None,
                    mode: str = "amr_inject", device: str | torch.device = "cuda") -> dict:
    """Preempted-and-resumed run (amr_inject unless ``mode`` says
    otherwise) vs uninterrupted: loss streams must be bitwise equal.

    The interrupted life additionally finds a stale ``.tmp-step_*`` dir (a
    save killed mid-write) that restore must ignore and clean.
    ``between_lives`` runs after the kill, before the resumed loop exists
    (to wipe process-level state, such as the schedule registry, the way a
    process death would); ``on_restore`` runs in the resumed life right
    after the checkpoint restore, before stepping (the hook that
    re-registers a DSE schedule handle).  With ``use_signal`` the process's
    SIGTERM handler is the loop's for the interrupted life and restored
    after it.
    """
    cfg = tiny_config(arch, mode, schedule_ref=schedule_ref)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=7)

    with tempfile.TemporaryDirectory() as base:
        ref_losses: list = []
        loop = _build_loop(cfg, os.path.join(base, "ref"), data, ref_losses, device=device)
        res = loop.run(total_steps, log=lambda *_: None)
        assert not res.preempted and res.steps_done == total_steps

        killed_losses: list = []
        loop = _build_loop(cfg, os.path.join(base, "kill"), data, killed_losses,
                           preempt_at=preempt_at, use_signal=use_signal, device=device)
        previous = signal.getsignal(signal.SIGTERM)
        if use_signal:
            loop.install_preemption_handler()
        try:
            res = loop.run(total_steps, log=lambda *_: None)
        finally:
            if use_signal:
                signal.signal(signal.SIGTERM, previous)
        assert res.preempted, "loop was not preempted"
        done_at_kill = res.steps_done

        # simulate a save killed mid-write in the dead process
        tmp = os.path.join(base, "kill", f".tmp-step_{99:08d}")
        os.makedirs(tmp)
        with open(os.path.join(tmp, "leaf_00000.npy"), "wb") as f:
            f.write(b"partial")
        if between_lives is not None:
            between_lives()

        # "new process": a fresh loop on the same checkpoint dir resumes
        loop2 = _build_loop(cfg, os.path.join(base, "kill"), data, killed_losses,
                            on_restore=on_restore, device=device)
        res2 = loop2.run(total_steps, log=lambda *_: None)
        assert not res2.preempted and res2.steps_done == total_steps
        tmp_cleaned = not os.path.exists(tmp)

    ref = dict(ref_losses)
    got = dict(killed_losses)  # resumed steps overwrite nothing: disjoint
    missing = sorted(set(ref) - set(got))
    diffs = [abs(ref[s] - got[s]) for s in ref if s in got]
    bit_exact = not missing and all(d == 0.0 for d in diffs)
    return {
        "kind": "restart", "arch": arch,
        "schedule": schedule_ref or "default",
        "bit_exact": bit_exact, "max_abs_diff": max(diffs, default=float("inf")),
        "steps": total_steps, "resumed_from": done_at_kill,
        "tmp_cleaned": tmp_cleaned,
        "ref_losses": [ref[s] for s in sorted(ref)],
        "resumed_losses": [got[s] for s in sorted(got)],
    }
