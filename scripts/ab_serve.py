"""Same-call A/B of the port's serving decode time: this tree against a parent.

    python3 scripts/ab_serve.py PARENT_TREE      # on one CUDA card

PARENT_TREE is an unpacked copy of another commit (``git archive``).  The
script runs ten processes one after another, parent and change taking
turns to go first: five pairs.  Each process imports the ``repro_torch``
of its tree (``--serve SRC``) and serves, through ``ServeEngine``,
full-width gemma-2b at rank 0 and rank 8 and under amr_inject, gemma3-1b
at rank 0 with 600-token prompts, and mamba2-370m at rank 0 (random
weights from seed 0, border 8).  A warm-up request per run keeps the
kernel build and first launches out of the timed window, and each run is
timed 3 times in its process.  Each process prints, as one JSON line, the
median decode ms per step of every run and the host cost of one AMR site:
the wall µs per ``layers.dense`` call at a tiny decode shape, (2, 1, 256)
@ (256, 256), 500 calls queued with no sync between them (the card's work
per call is shorter than the host's), the median of 5 such windows.  The
script prints every round's numbers, then per run the parent / change
ratio of the means (above 1: the change is faster).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BORDER = 8
# label: (arch, mode, rank, requests, slots, prompt length, tokens generated)
RUNS = {
    "gemma-2b rank 0": ("gemma-2b", "amr_kernel", 0, 4, 2, 16, 16),
    "gemma-2b rank 8": ("gemma-2b", "amr_kernel", 8, 4, 2, 16, 16),
    "gemma-2b amr_inject": ("gemma-2b", "amr_inject", 0, 2, 2, 16, 8),
    "gemma3-1b rank 0": ("gemma3-1b", "amr_kernel", 0, 2, 2, 600, 8),
    "mamba2-370m rank 0": ("mamba2-370m", "amr_kernel", 0, 4, 2, 16, 16),
}
ORDER = ("parent", "change", "change", "parent") * 2 + ("parent", "change")
TIMED, SITE_CALLS = 3, 500


def serve_all() -> dict:
    """Every run of RUNS with the ``repro_torch`` first on sys.path: the
    median of TIMED engine runs' decode ms per step, their decode steps."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_params
    from repro_torch.numerics import AMRNumerics
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    out, params, loaded = {}, None, None
    for label, (arch, mode, rank, requests, slots, prompt_len, gen) in RUNS.items():
        cfg = get_config(arch)
        if loaded != arch:
            params = None
            torch.cuda.empty_cache()
            params, loaded = init_params(cfg, 0, device="cuda"), arch
        cfg = dataclasses.replace(cfg, numerics=AMRNumerics(mode, border=BORDER, rank=rank))
        rng = np.random.default_rng(0)
        prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, prompt_len))
                   for _ in range(requests)]

        def engine():
            return ServeEngine(cfg, params, n_slots=slots, capacity=prompt_len + gen,
                               device="cuda")

        warm = engine()
        warm.submit(Request(prompt=prompts[0], max_new_tokens=2))
        warm.run()
        times = []
        for _ in range(TIMED):
            eng = engine()
            for p in prompts:
                eng.submit(Request(prompt=p, max_new_tokens=gen))
            eng.run()
            torch.cuda.synchronize()
            times.append(1e3 * eng.decode_seconds / eng.steps_done)
        out[label] = {"ms_per_step": float(np.median(times)), "steps": eng.steps_done}
    return out


def host_us_per_site() -> dict:
    """Wall µs per ``dense`` call under rank 0, rank 8 and amr_inject with
    the ``repro_torch`` first on sys.path: the median of 5 windows."""
    import numpy as np
    import torch

    from repro_torch.models.layers import dense
    from repro_torch.numerics import AMRNumerics

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 1, 256), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((256, 256), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for label, nm in (("rank 0", AMRNumerics("amr_kernel", border=BORDER, rank=0)),
                      ("rank 8", AMRNumerics("amr_kernel", border=BORDER, rank=8)),
                      ("amr_inject", AMRNumerics("amr_inject", border=BORDER))):
        windows = []
        with torch.inference_mode():
            for _ in range(50):
                dense(x, w, nm, site="mlp.w_gate")
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SITE_CALLS):
                    dense(x, w, nm, site="mlp.w_gate")
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) / SITE_CALLS * 1e6)
        out[f"site {label}"] = {"us_per_call": float(np.median(windows))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, nargs="?", help="the parent tree (git archive)")
    ap.add_argument("--serve", type=Path, default=None, metavar="SRC",
                    help=argparse.SUPPRESS)  # one timing process: SRC's repro_torch
    args = ap.parse_args(argv)
    if args.serve is not None:
        sys.path.insert(0, str(args.serve.resolve()))
        print(json.dumps({**serve_all(), **host_us_per_site()}), flush=True)
        return 0
    if args.parent is None or not (args.parent / "src" / "repro_torch").is_dir():
        ap.error("give a parent tree that holds src/repro_torch")
    rounds = []
    for label in ORDER:
        src = (args.parent if label == "parent" else ROOT) / "src"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--serve",
                               str(src)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        rounds.append((label, result))
        print(f"[ab-serve] {label} from {src} in {time.perf_counter() - t0:.1f}s: "
              f"{json.dumps(result)}", flush=True)
    summary = {}
    for run, times in rounds[0][1].items():
        what = "ms_per_step" if "ms_per_step" in times else "us_per_call"
        parent = [r[run][what] for lab, r in rounds if lab == "parent"]
        change = [r[run][what] for lab, r in rounds if lab == "change"]
        summary[run] = {"what": what, "parent": parent, "change": change,
                        "parent_over_change": sum(parent) / sum(change)}
        print(f"[ab-serve] {run} {what}: parent {parent}, change {change}, "
              f"parent/change {summary[run]['parent_over_change']}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
