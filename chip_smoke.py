#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the run exits non-zero):

1. build — compile every CUDA kernel of the main path from ``src/`` with
   nvcc for sm_90a (one nvcc per source, in parallel); print the build
   seconds and the card's name and power limit;
2. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes: the integer gather kernels bit for bit at
   border 8 (int16 table in shared memory) and border 14 (int32 table,
   products beyond int16), the low-rank kernel within
   1e-5 * max_mn sum_k (|a b| + sum_r |u v|) of its plain version and
   within K * sigma_{r+1} (plus that slack) of the bit-exact table sums;
   time kernel, plain version and, for the low-rank kernel, one
   ``torch.matmul`` on the prebuilt augmented operands (the yardstick);
3. reference — reduced gemma-2b in float32 on the card (kernels) and on
   the CPU (plain versions), same weights: tokens equal, logits within
   1e-3 * max|logit|;
4. serve — full-width gemma-2b (18 layers, d_model 2048, vocab 256000,
   random weights from seed 0) through ``ServeEngine`` under
   ``AMRNumerics("amr_kernel", border=8)`` at rank 0 and at rank 8:
   4 requests, 2 slots, prompt 16, 8 new tokens.  Launch counts are set
   to 0 just before each run and read just after: rank 0 must launch
   both gather kernels and not the low-rank one, rank 8 the reverse;
5. batched vs solo — request 0 at rank 0 served alone (1 slot) gives the
   same tokens as in the batched run; the logits' max difference is
   printed (the exact LM head is a cuBLAS product whose order may depend
   on the batch);
6. profile — one more run of 2 requests at rank 0 and at rank 8 under
   ``torch.profiler``: device time by kernel and the device's idle share.

The last lines are the card's name and power limit, one JSON object with
the kernels' numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores (no int32 rate is published)
L2_BYTES = 50 * 2**20
BORDER, RANK = 8, 8
SLOTS, PROMPT_LEN, GEN, REQUESTS = 2, 16, 8, 4
CAPACITY = PROMPT_LEN + GEN


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls (CUDA events), cycling
    through ``arg_sets`` so that operands larger than L2 come from HBM."""
    import torch

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def copies(nbytes: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


# ------------------------------------------------------------------ phases
def phase_build() -> None:
    from repro_torch.kernels.amr_matmul.kernel import LIBRARIES
    from repro_torch.kernels.build import build_all

    t0 = time.perf_counter()
    records = build_all(list(LIBRARIES))
    log(f"[build] {len(records)} CUDA sources in {time.perf_counter() - t0:.1f}s wall "
        + ", ".join(f"{k} {v.seconds:.1f}s" for k, v in records.items()))
    for name, rec in records.items():
        for line in rec.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[card] {card_line()}")


def _int8(shape, gen, device):
    import torch

    return torch.randint(-128, 128, shape, generator=gen, device=device, dtype=torch.int8)


def path_shapes(cfg) -> tuple[list, list, dict]:
    """The kernels' shapes on the serve path: M of the dense sites (decode over
    the slots, prefill over one prompt), their (K, N), and the grouped
    (G, M, K, N) of attn.qk / attn.pv, where the query heads of a kv head
    fold into the rows."""
    g = cfg.n_heads // cfg.n_kv_heads
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    dense_kn = [(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model), (cfg.d_model, kv * hd)]
    grouped = {"decode qk": (SLOTS * kv, g, hd, CAPACITY),
               "decode pv": (SLOTS * kv, g, CAPACITY, hd),
               "prefill qk": (kv, g * PROMPT_LEN, hd, PROMPT_LEN),
               "prefill pv": (kv, g * PROMPT_LEN, PROMPT_LEN, hd)}
    return [SLOTS, PROMPT_LEN], dense_kn, grouped


def phase_kernels(device, cfg) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import lut
    from repro_torch.kernels.amr_matmul import kernel, ops, ref

    gen = torch.Generator(device=device).manual_seed(0)
    rows: dict[str, list[dict]] = {"lut": [], "grouped": [], "lowrank": []}
    dense_m, dense_kn, grouped = path_shapes(cfg)

    # full-LUT gather kernel: dense sites at rank 0
    for border in (8, 14):
        table = ops.kernel_table(border, device)
        table32 = lut.table_tensor(border, device)
        for m in dense_m:
            for k, n in dense_kn:
                a = _int8((m, k), gen, device)
                bs = [_int8((k, n), gen, device) for _ in range(min(copies(k * n), 64))]
                got = kernel.amr_matmul_int8_lut(a, bs[0], table)
                want = ref.lut_matmul_ref(a, bs[0], table32)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"LUT kernel differs from plain at border {border}, "
                                         f"{(m, k, n)}: {(got - want).abs().max().item()}")
                nbytes = m * k + k * n + table.numel() * table.element_size() + 4 * m * n
                b_ms, b_by = bound(nbytes, 2 * m * n * k)
                args = [(a, b, table) for b in bs]
                rows["lut"].append(dict(
                    border=border, shape=(m, k, n), table=str(table.dtype).split(".")[-1],
                    max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    ms=time_ms(kernel.amr_matmul_int8_lut, args, 20),
                    plain_ms=time_ms(ref.lut_matmul_ref, [(a, bs[0], table32)], 2)))

    # grouped gather kernel: attn.qk / attn.pv at rank 0
    for border in (8, 14):
        table = ops.kernel_table(border, device)
        table32 = lut.table_tensor(border, device)
        for site, (g, m, k, n) in grouped.items():
            a, b = _int8((g, m, k), gen, device), _int8((g, k, n), gen, device)
            got = kernel.amr_matmul_int8_lut_grouped(a, b, table)
            want = ref.lut_matmul_ref(a, b, table32)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"grouped kernel differs from plain at border {border}, "
                                     f"{site} {(g, m, k, n)}")
            nbytes = g * (m * k + k * n + 4 * m * n) + table.numel() * table.element_size()
            b_ms, b_by = bound(nbytes, 2 * g * m * n * k)
            rows["grouped"].append(dict(
                border=border, site=site, shape=(g, m, k, n), max_abs_err=0.0, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                ms=time_ms(kernel.amr_matmul_int8_lut_grouped, [(a, b, table)], 50),
                plain_ms=time_ms(ref.lut_matmul_ref, [(a, b, table32)], 10)))

    # low-rank kernel: dense sites at rank 8
    u, v = lut.factor_tensors(BORDER, RANK, device)
    sigma = lut.lowrank_factor(BORDER, RANK).sigma_next
    table32 = lut.table_tensor(BORDER, device)
    for m in dense_m:
        for k, n in dense_kn:
            a = _int8((m, k), gen, device)
            bs = [_int8((k, n), gen, device) for _ in range(min(copies(k * n), 64))]
            got = kernel.amr_matmul_int8(a, bs[0], u, v)
            want = ref.lowrank_matmul_ref(a, bs[0], u, v)
            fa, fb = a.float(), bs[0].float()
            scale = float((fa.abs() @ fb.abs() + ref.lowrank_matmul_ref(a, bs[0], u.abs(), v.abs())
                           - fa @ fb).max())
            err = float((got - want).abs().max())
            if not err <= 1e-5 * scale:
                raise AssertionError(f"low-rank kernel off its plain version at {(m, k, n)}: "
                                     f"{err} > 1e-5 * {scale}")
            exact = ref.lut_matmul_ref(a, bs[0], table32).double()
            gap = float((got.double() - exact).abs().max())
            if not gap <= k * sigma + 1e-5 * scale:
                raise AssertionError(f"low-rank kernel beyond K*sigma_(r+1) at {(m, k, n)}: "
                                     f"{gap} > {k * sigma}")
            # library yardstick: one float32 matmul on the prebuilt augmented operands
            ua, vb = u[a.long() + 128], v[bs[0].long() + 128]
            a_aug = torch.cat([fa[..., None], ua], -1).reshape(m, k * (1 + RANK))
            b_aug = torch.cat([fb[:, None, :], vb.transpose(1, 2)], 1).reshape(k * (1 + RANK), n)
            nbytes = m * k + k * n + 2 * u.numel() * 4 + 4 * m * n
            b_ms, b_by = bound(nbytes, 2 * m * n * k * (1 + RANK))
            args = [(a, b, u, v) for b in bs]
            rows["lowrank"].append(dict(
                border=BORDER, rank=RANK, shape=(m, k, n), max_abs_err=err, gap_vs_exact=gap,
                k_sigma=k * sigma, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(kernel.amr_matmul_int8, args, 10),
                plain_ms=time_ms(ref.lowrank_matmul_ref, [(a, bs[0], u, v)], 2),
                library_ms=time_ms(torch.matmul, [(a_aug, b_aug)], 10)))
            del ua, vb, a_aug, b_aug
    for name, rs in rows.items():
        for r in rs:
            log(f"[kernel] {name} " + json.dumps(r))
    return rows


def phase_reference(device) -> None:
    """Reduced gemma-2b, float32: the card's kernels against the CPU's plain versions."""
    from repro_torch.configs.gemma_2b import reduced
    from repro_torch.models import init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.numerics import AMRNumerics
    from repro_torch.serve import Request, ServeEngine

    for rank in (0, RANK):
        cfg = dataclasses.replace(reduced(), dtype="float32",
                                  numerics=AMRNumerics("amr_kernel", border=BORDER, rank=rank))
        params = init_params(cfg, 0, device="cpu")
        out = {}
        for dev in ("cpu", device):
            eng = ServeEngine(cfg, tree_map(lambda t: t.to(dev), params), n_slots=2,
                              capacity=24, record_logits=True, device=dev)
            for prompt in [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]:
                eng.submit(Request(prompt=prompt, max_new_tokens=5))
            out[str(dev)] = eng.run()
        cpu, card = out["cpu"], out[str(device)]
        if [c.tokens for c in cpu] != [c.tokens for c in card]:
            raise AssertionError(f"reduced model at rank {rank}: card tokens differ from CPU")
        diff = max(float(np.abs(x - y).max()) for c, d in zip(cpu, card)
                   for x, y in zip(c.logits, d.logits))
        top = max(float(np.abs(x).max()) for c in cpu for x in c.logits)
        if not diff <= 1e-3 * top:
            raise AssertionError(f"reduced model at rank {rank}: logits differ by {diff}")
        log(f"[reference] reduced gemma-2b f32 rank {rank}: tokens equal, "
            f"max |logit diff| card vs CPU {diff:.3g} (max |logit| {top:.3g})")


def phase_serve(device, card: str, config) -> dict:
    """Full-width gemma-2b through ServeEngine at rank 0 and rank 8."""
    import torch

    from repro_torch.kernels.amr_matmul import kernel
    from repro_torch.models import init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.numerics import AMRNumerics
    from repro_torch.serve import Request, ServeEngine

    t0 = time.perf_counter()
    params = init_params(config, 0, device=device)
    torch.cuda.synchronize()
    sizes: list[int] = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    log(f"[serve] gemma-2b: {n_params / 1e9:.3f} G parameters on {device} in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, config.vocab, PROMPT_LEN))
               for _ in range(REQUESTS)]
    launches, runs = {}, {}
    for rank in (0, RANK):
        cfg = dataclasses.replace(config, numerics=AMRNumerics("amr_kernel", border=BORDER,
                                                               rank=rank))
        eng = ServeEngine(cfg, params, n_slots=SLOTS, capacity=CAPACITY, record_logits=True,
                          device=device)
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=GEN))
        for k in kernel.KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernel.KERNELS}
        launches[rank] = counts
        runs[rank] = done
        if len(done) != REQUESTS or any(len(c.tokens) != GEN for c in done):
            raise AssertionError(f"rank {rank}: expected {REQUESTS} completions of {GEN} tokens")
        if any(not 0 <= t < config.vocab for c in done for t in c.tokens):
            raise AssertionError(f"rank {rank}: token out of range")
        if not all(np.isfinite(x).all() and x.shape == (config.vocab,)
                   for c in done for x in c.logits):
            raise AssertionError(f"rank {rank}: non-finite or misshapen logits")
        uses = ({"amr_matmul_int8_lut", "amr_matmul_int8_lut_grouped"} if rank == 0
                else {"amr_matmul_int8"})
        for name, n in counts.items():
            if (name in uses) != (n > 0):
                raise AssertionError(f"rank {rank}: kernel {name} launched {n} times")
        tokens = sum(len(c.tokens) for c in done)
        log(f"[serve] rank {rank} on {card}: {len(done)} requests, {tokens} tokens in "
            f"{wall:.3f}s ({tokens / wall:.2f} tok/s end to end); prefill "
            f"{eng.prefill_tokens} prompt tokens in {eng.prefill_seconds:.3f}s "
            f"({eng.prefill_tokens / eng.prefill_seconds:.1f} tok/s); decode "
            f"{eng.decode_tokens} tokens in {eng.steps_done} steps, {eng.decode_seconds:.3f}s "
            f"({eng.decode_tokens / eng.decode_seconds:.2f} tok/s, "
            f"{1e3 * eng.decode_seconds / eng.steps_done:.1f} ms/step); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")

    # batched vs solo: request 0 at rank 0 alone in a one-slot engine
    cfg = dataclasses.replace(config, numerics=AMRNumerics("amr_kernel", border=BORDER, rank=0))
    eng = ServeEngine(cfg, params, n_slots=1, capacity=CAPACITY, record_logits=True,
                      device=device)
    eng.submit(Request(prompt=prompts[0], max_new_tokens=GEN))
    [solo] = eng.run()
    batched = runs[0][0]
    diff = max(float(np.abs(x - y).max()) for x, y in zip(batched.logits, solo.logits))
    if solo.tokens != batched.tokens:
        raise AssertionError(f"batched {batched.tokens} != solo {solo.tokens}")
    log(f"[batched-vs-solo] rank 0 request 0: tokens identical {list(solo.tokens)}; "
        f"max |logit diff| {diff:.3g}")
    for rank in (0, RANK):
        profile_serve(device, card, dataclasses.replace(
            config, numerics=AMRNumerics("amr_kernel", border=BORDER, rank=rank)), params,
            prompts)
    return launches


def profile_serve(device, card: str, cfg, params, prompts) -> None:
    """Device time by kernel over one engine run of SLOTS requests (their
    prefills and decode steps) under torch.profiler, and the device's idle
    share of the run's wall time (which the profiler's own host cost
    lengthens)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, n_slots=SLOTS, capacity=CAPACITY, device=device)
    for p in prompts[:SLOTS]:
        eng.submit(Request(prompt=p, max_new_tokens=GEN))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    ours = sum(r[0] for r in rows if "amr_" in r[2])
    log(f"[profile] {cfg.numerics} on {card}: {SLOTS} prefills + {eng.steps_done} decode "
        f"steps, {wall_us / 1e3:.2f} ms wall, device busy {busy_us / 1e3:.2f} ms "
        f"(idle share {1 - busy_us / wall_us:.3f}), AMR kernels {ours / 1e3:.2f} ms")
    for dev_us, count, key in rows[:12]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  {count:6d} calls  {key[:100]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: repro_torch not found under {ROOT / 'src'}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.configs.gemma_2b import CONFIG

    phase_build()
    card = card_line()
    rows = phase_kernels(device, CONFIG)
    phase_reference(device)
    launches = phase_serve(device, card, CONFIG)

    from repro_torch.kernels.amr_matmul import kernel

    src = "src/repro_torch/kernels/amr_matmul/csrc/"
    picks = {  # the decode shape each kernel spends most time on at border 8
        "amr_matmul_int8_lut": (rows["lut"][0], src + "lut_matmul.cu",
                                "src/repro/kernels/amr_matmul/kernel.py:137", 0),
        "amr_matmul_int8_lut_grouped": (rows["grouped"][0], src + "lut_matmul.cu",
                                        "src/repro/kernels/amr_matmul/kernel.py:175", 0),
        "amr_matmul_int8": (rows["lowrank"][0], src + "lowrank_matmul.cu",
                            "src/repro/kernels/amr_matmul/kernel.py:47", RANK),
    }
    out = []
    for k in kernel.KERNELS:
        row, source, replaces, rank = picks[k.name]
        out.append({"name": k.name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[rank][k.name], "max_abs_err": row["max_abs_err"],
                    "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "shape": row["shape"]})
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
