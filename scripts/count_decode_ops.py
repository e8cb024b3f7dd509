"""Count the host work of one serving decode step: PyTorch ops and Python calls.

    PYTHONPATH=src python3 scripts/count_decode_ops.py [--src SRC] [--arch gemma3-1b]

Serves two 8-token prompts of the reduced ``--arch`` at ``amr_kernel``
rank 0 (border 8) on the CPU through ``ServeEngine``, runs one warm decode
step, then counts in one more decode step the aten ops dispatched (a
``TorchDispatchMode``) and the Python function calls (``sys.setprofile``).
``--src`` picks the tree whose ``repro_torch`` is imported, so two commits
compare by running the script once for each.  Counts, not times: the same
on every host.  On the CPU the plain versions run below the kernel
wrappers; the code above them is the card's path.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path


def count(arch: str) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.numerics import AMRNumerics
    from repro_torch.serve import Request, ServeEngine

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_reduced_config(arch),
                              numerics=AMRNumerics("amr_kernel", border=8, rank=0))
    eng = ServeEngine(cfg, init_params(cfg, 0, device="cpu"), n_slots=2, capacity=24,
                      device="cpu")
    for first in (1, 3):
        eng.submit(Request(prompt=tuple(range(first, first + 8)), max_new_tokens=6))
    calls = 0

    def profile(frame, event, arg):  # noqa: ARG001
        nonlocal calls
        calls += event == "call"

    with torch.inference_mode():
        eng._admit()
        eng._decode_once()
        with Ops() as mode:
            sys.setprofile(profile)
            try:
                eng._decode_once()
            finally:
                sys.setprofile(None)
    return {"arch": arch, "aten_ops": sum(mode.ops.values()), "python_calls": calls,
            "ops": dict(mode.ops.most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=Path(__file__).resolve().parent.parent / "src")
    ap.add_argument("--arch", default="gemma3-1b")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    print(json.dumps(count(args.arch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
