"""Cross-architecture numerics conformance: one harness, many consumers.

The port of the JAX package's ``conformance``: ``matrix`` runs tiny
reduced variants of every registered config family through the train
step and the prefill -> decode path under every registered numerics mode,
on the card by default (``device="cuda"``) or on the CPU, asserting the
per-family invariants.  ``tests/test_torch_conformance.py`` holds it
against the JAX package's; ``chip_smoke.py`` (``phase_conformance``) runs
it on the card.
"""
from .matrix import (ACTIVATION_SITES, PARITY_TOL, REPRESENTATIVE, arch_mode_arms, make_inputs,
                     policy_for, run_decode_parity, run_inject_audit, run_noise_decorrelation,
                     run_restart_arm, run_train_arm, tiny_config)

__all__ = ["REPRESENTATIVE", "PARITY_TOL", "ACTIVATION_SITES",
           "arch_mode_arms", "policy_for",
           "tiny_config", "make_inputs", "run_train_arm", "run_inject_audit",
           "run_decode_parity", "run_noise_decorrelation", "run_restart_arm"]
