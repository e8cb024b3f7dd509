"""Training launcher: config -> synthetic data -> train state -> train step
-> fault-tolerant loop with async checkpoints, preemption handling,
straggler flags and a heartbeat (the JAX package's launcher without the
mesh).

  PYTHONPATH=src python -m repro_torch.launch.train --arch amr-paper-100m --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
      --steps 3 --batch 2 --seq 16

Runs on the card unless ``--device cpu``.  ``--ckpt-dir`` keeps the
checkpoints (and the heartbeat file) there, and a later run with the same
directory resumes from its newest checkpoint; without it they go to a
temporary directory removed at the end.  Prints the steps, restarts,
tokens/s over the run and the median step time after the first step (the
first builds the kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.cli import add_numerics_args, numerics_from_args, policy_label
from repro_torch.runtime import FaultTolerantLoop, Heartbeat
from repro_torch.train.steps import make_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="amr-paper-100m", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_numerics_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    nm = numerics_from_args(args)
    if nm is not None:
        cfg = dataclasses.replace(cfg, numerics=nm)
    print(f"[train] {cfg.name} on {device}, numerics policy: {policy_label(cfg.numerics)}")

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        ckpt_dir = Path(args.ckpt_dir or tmp)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=args.seed)
        step_raw = make_train_step(cfg, peak_lr=args.lr, warmup=20, total_steps=args.steps,
                                   microbatch=args.microbatch or None)
        step_seconds: list[float] = []

        def step_fn(state, batch):
            t0 = time.perf_counter()
            state, metrics = step_raw(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            return state, metrics

        def batch_at(i: int) -> dict:
            return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}

        hb = Heartbeat(ckpt_dir / "heartbeat.json")
        hb.start()
        loop = FaultTolerantLoop(
            ckpt_dir=ckpt_dir, make_state=lambda: make_train_state(cfg, args.seed, device=device),
            step_fn=step_fn, batch_at=batch_at, ckpt_every=args.ckpt_every, heartbeat=hb)
        loop.install_preemption_handler()
        t0 = time.time()
        try:
            result = loop.run(args.steps, log_every=1)
        finally:
            hb.stop()
        wall = time.time() - t0
    tokens = args.batch * args.seq
    print(f"[train] done: {result.steps_done} steps, {result.restarts} restarts, "
          f"preempted={result.preempted}, ~{len(step_seconds) * tokens / max(wall, 1e-9):.0f} "
          f"tok/s over the run")
    if len(step_seconds) > 1:
        med = statistics.median(step_seconds[1:])
        print(f"[train] after the first step: median {med * 1e3:.1f} ms per step, "
              f"{tokens / med:.0f} tok/s")


if __name__ == "__main__":
    main()
