"""Serving launcher: continuous-batching engine over the slot-decode path.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --full \
      --requests 8 --slots 4 --prompt-len 16 --gen 8 \
      --numerics amr_kernel --border 8 --rank 0
  PYTHONPATH=src python -m repro_torch.launch.serve --full --numerics amr_inject
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --full \
      --numerics amr_kernel --rank 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --full \
      --numerics amr_kernel --rank 0 --heartbeat build/serve_heartbeat.json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --full \
      --numerics amr_kernel --rank 0 --slots 2 --requests 4 --prompt-len 16 --gen 8

Thin CLI over ``repro_torch.serve.ServeEngine`` with random weights from
``--seed``.  ``--numerics`` overrides the config's matmul policy
(``amr_inject`` replays the paper's schedule at ``--border``), and
``--policy-file`` loads a per-layer policy file (``launch/cli.py``).  A warmup
cycle (default on) first serves one short request so that the kernel
build and first launches fall outside the timed window; the report then
separates prefill and steady-state decode rates from end-to-end time.
``--heartbeat PATH`` has the timed engine publish its progress to PATH
(``runtime.fault.Heartbeat``); its decode steps slower than 2.5x the
running median are printed as stragglers.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from repro_torch.configs.registry import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.launch.cli import add_numerics_args, numerics_from_args, policy_label
from repro_torch.models import init_params
from repro_torch.runtime import Heartbeat
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", dest="warmup", action="store_false")
    add_numerics_args(ap)
    ap.add_argument("--heartbeat", default=None,
                    help="path for the serve heartbeat JSON (runtime.fault)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    nm = numerics_from_args(args)
    if nm is not None:
        cfg = dataclasses.replace(cfg, numerics=nm)
    print(f"[serve] {cfg.name} on {args.device}, numerics {policy_label(cfg.numerics)}")

    rng = np.random.default_rng(args.seed)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len))
               for _ in range(args.requests)]
    params = init_params(cfg, args.seed, device=args.device)

    def new_engine(**kw) -> ServeEngine:
        return ServeEngine(cfg, params, n_slots=args.slots,
                           capacity=args.prompt_len + args.gen, device=args.device, **kw)

    if args.warmup:
        warm = new_engine()
        warm.submit(Request(prompt=prompts[0], max_new_tokens=2))
        warm.run()
    engine = new_engine(heartbeat=Heartbeat(Path(args.heartbeat)) if args.heartbeat else None,
                        log=print)
    for p in prompts:
        engine.submit(Request(prompt=p, max_new_tokens=args.gen))
    t0 = time.monotonic()
    done = engine.run()
    wall = time.monotonic() - t0

    total_tokens = sum(len(c.tokens) for c in done)
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in {wall:.3f}s "
          f"({total_tokens / wall:.1f} tok/s end-to-end)")
    print(f"[serve] prefill: {engine.prefill_tokens} prompt tokens / "
          f"{engine.prefill_seconds:.3f}s")
    if engine.decode_seconds > 0:
        print(f"[serve] steady-state decode: {engine.decode_tokens} tokens / "
              f"{engine.decode_seconds:.3f}s = "
              f"{engine.decode_tokens / engine.decode_seconds:.1f} tok/s")
    print(f"[serve] stats {engine.stats()}; sample: {list(done[0].tokens)[:16]}")


if __name__ == "__main__":
    main()
