"""Shared numerics CLI surface of the port's launchers.

The port of the JAX package's ``launch/cli.py``: ``--numerics --border
--rank`` build one ``AMRNumerics``, and ``--policy-file`` loads a (possibly
per-layer) policy file written by either package (``numerics.save_policy``),
which wins over the uniform flags.  The mode choices come from the
registry; ``--noise-seed`` roots the ``amr_noise`` streams.  Left out:
``--inject-impl`` and ``--pallas-interpret`` (the tensor's device picks the
route) and the multi-mode ``--modes`` (the multi-arm comparison scripts are
not ported).
"""
from __future__ import annotations

import argparse

from repro_torch.numerics import (AMRNumerics, UniformPolicy, get_mode, load_policy, mode_names,
                                  policy_summary)


def add_numerics_args(ap: argparse.ArgumentParser) -> None:
    """Attach the numerics policy flags to ``ap``; no ``--numerics`` keeps
    the config's policy."""
    g = ap.add_argument_group("numerics policy")
    g.add_argument("--numerics", default=None, choices=list(mode_names()),
                   help="override the config's matmul numerics policy")
    g.add_argument("--border", type=int, default=8,
                   help="approximate border column for the AMR modes")
    g.add_argument("--rank", type=int, default=8,
                   help="low-rank error rank; 0 with amr_kernel = full-LUT kernel")
    g.add_argument("--noise-seed", type=int, default=0,
                   help="PRNG seed for the Gaussian-surrogate mode")
    g.add_argument("--policy-file", default=None, metavar="JSON",
                   help="load a (possibly per-layer) numerics policy file "
                        "(numerics.save_policy); overrides --numerics")


def numerics_from_args(args):
    """Parsed args -> numerics policy, or None to keep the config's.
    ``--policy-file`` wins over ``--numerics``; its ``schedule_ref`` handles
    must be registered in this process."""
    if getattr(args, "policy_file", None):
        return load_policy(args.policy_file)
    if args.numerics is None:
        return None
    return AMRNumerics(args.numerics, border=args.border, rank=args.rank,
                       noise_seed=args.noise_seed)


def policy_label(nm) -> str:
    """A label like ``amr_lowrank(b=8,r=16)``: the parameters shown are the
    mode's required ones; a heterogeneous policy is summarized
    (``numerics.policy_summary``)."""
    if isinstance(nm, UniformPolicy):
        nm = nm.numerics
    if not isinstance(nm, AMRNumerics) and hasattr(nm, "resolve"):
        return policy_summary(nm)
    req = get_mode(nm.mode).required_params
    parts = [f"b={nm.border}"] * ("border" in req) + [f"r={nm.rank}"] * ("rank" in req)
    return f"{nm.mode}({','.join(parts)})" if parts else nm.mode
