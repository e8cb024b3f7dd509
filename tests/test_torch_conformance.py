"""The port's conformance matrix and audit channel against the JAX
package's, on the CPU.

* The matrix's constants (``BORDER``, ``REPRESENTATIVE``, ``PARITY_TOL``,
  ``ACTIVATION_SITES``), its ``__all__``, the registry's ``families()``
  and ``arch_mode_arms()`` equal the JAX package's; so do the modes that
  carry an audit ``oracle``.
* ``make_inputs`` draws the same arrays in both packages (tokens, targets,
  and the audio and VLM extras in bfloat16).
* ``lut_from_schedule`` (the port's numpy replay) equals the JAX package's
  bit for bit on the default schedule at border 8 and on a DSE candidate,
  found by the port's own ``search_assignments`` and ``materialize``;
  its recorded decisions are the JAX package's search's and
  ``chip_smoke.DSE_CANDIDATE``'s.
* ``AuditTrace`` records as the JAX one does.  One call site under
  amr_inject at (4, 32) @ (32, 16): 0 grid steps from the oracle, and
  ``compare="exact"`` records positive error mass.  Negative control: the
  replay of another schedule (border 6) scored against the border-8 oracle
  records at least 1.0 (without it a zero audit would prove nothing).
* The arms on the CPU (the kernels' plain versions; the card runs them in
  ``chip_smoke.py``'s ``phase_conformance``): ``run_train_arm`` and
  ``run_decode_parity`` under exact and ``amr_kernel`` rank 0 for each
  representative (finite, non-degenerate, within ``PARITY_TOL``),
  ``run_noise_decorrelation`` on the dense representative, the inject
  audit of each representative (bit-exact, the family's activation sites
  among the audited) and of the dense one on the DSE candidate, and the
  restart arm under both preemption protocols at rank 0 (amr_inject's
  restart runs on the card: no CPU amr_inject training here).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.conformance as jconf
import repro_torch.conformance as tconf
from repro.conformance import matrix as jmatrix
from repro.configs import families as jfamilies
from repro.core import reduction as jreduction
from repro.core.dse import lut_from_schedule as jlut_from_schedule
from repro.core.dse import materialize, search_assignments
from repro.numerics import AuditTrace as JAudit
from repro.numerics import get_mode as jget_mode
from repro.numerics import mode_names as jmode_names
from repro_torch.conformance import matrix as tmatrix
from repro_torch.configs import families as tfamilies
from repro_torch.core import reduction as treduction
from repro_torch.core.dse import ColumnChoice, lut_from_schedule, materialize_choices
from repro_torch.core.dse import materialize as tmaterialize
from repro_torch.core.dse import search_assignments as tsearch_assignments
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.numerics import AuditTrace, approx_matmul, get_mode, injection, mode_names
from repro_torch.numerics import numerics_scope

from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REPS = sorted(tconf.REPRESENTATIVE.items())
CPU = "cpu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def candidate():
    """A DSE candidate found by the port's own search and materialized by
    the port, the JAX package's schedule from the JAX package's search (as
    tests/test_torch_inject.py builds it, the reference), and the port's
    recorded decisions."""
    search = dict(k=1, beam_width=8, branch_cap=4, max_nodes=2000)
    [cand] = tsearch_assignments(2, 8, **search)
    [jcand] = search_assignments(2, 8, **search)
    assert ([dataclasses.astuple(c) for c in cand.choices]
            == [dataclasses.astuple(c) for c in jcand.choices])
    assert cand.expected_error == jcand.expected_error
    return materialize(jcand), tmaterialize(cand), list(cand.choices)


# ------------------------------------------------------------ the matrix
def test_constants_and_sweep_match_jax():
    assert tconf.__all__ == jconf.__all__ and tmatrix.__all__ == jmatrix.__all__
    assert tmatrix.BORDER == jmatrix.BORDER
    assert tconf.REPRESENTATIVE == jconf.REPRESENTATIVE
    assert tconf.PARITY_TOL == jconf.PARITY_TOL
    assert tconf.ACTIVATION_SITES == jconf.ACTIVATION_SITES
    assert set(tconf.PARITY_TOL) == set(mode_names())
    assert tfamilies() == jfamilies()
    assert sum(map(len, tfamilies().values())) == 11 and len(tfamilies()) == 6
    assert tconf.arch_mode_arms() == jconf.arch_mode_arms()
    assert mode_names() == jmode_names()
    assert ({m: get_mode(m).oracle is not None for m in mode_names()}
            == {m: jget_mode(m).oracle is not None for m in jmode_names()})


@pytest.mark.parametrize("arch", [a for _, a in REPS] + ["minitron-8b", "qwen3-32b"])
def test_make_inputs_match_jax(arch):
    j = jconf.make_inputs(jconf.tiny_config(arch, "exact"), 2, 8, 3)
    t = tconf.make_inputs(tconf.tiny_config(arch, "exact"), 2, 8, 3, device=CPU)
    assert set(t) == set(j)
    for k, v in j.items():
        assert str(t[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert np.array_equal(t[k].float().numpy(), np.asarray(jnp.asarray(v, jnp.float32))), k


def test_tiny_config_policies_match_jax():
    for arch, mode in tconf.arch_mode_arms():
        t, j = tconf.tiny_config(arch, mode).numerics, jconf.tiny_config(arch, mode).numerics
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, mode, f.name)


# ------------------------------------------------------------ the oracle tables
def test_lut_from_schedule_matches_jax(candidate):
    jsched, tsched, _ = candidate
    got = lut_from_schedule(treduction.get_schedule(2, 8))
    assert got.dtype == np.int32
    assert np.array_equal(got, jlut_from_schedule(jreduction.get_schedule(2, 8)))
    dse = lut_from_schedule(tsched)
    assert np.array_equal(dse, jlut_from_schedule(jsched))
    assert not np.array_equal(dse, got)  # a candidate, not the default design
    with pytest.raises(ValueError, match="2-digit"):
        lut_from_schedule(treduction.get_schedule(3, 12))


def test_chip_smoke_candidate_is_the_jax_candidate(candidate):
    recorded = _chip_smoke().DSE_CANDIDATE
    assert [dataclasses.astuple(c) for c in candidate[2]] == [tuple(c) for c in recorded]
    rebuilt = materialize_choices(2, 8, [ColumnChoice(*c) for c in recorded])
    assert np.array_equal(lut_from_schedule(rebuilt), lut_from_schedule(candidate[1]))
    with pytest.raises(AssertionError, match="desync"):
        materialize_choices(2, 8, list(candidate[2])[1:])


# ------------------------------------------------------------ the audit channel
def test_audit_trace_records_as_jax():
    records = [("attn.qk", 0.0, None, None), ("attn.qk", 2.0, 1, 5.0), ("mlp.w_up", 0.5, 1, None)]
    t, j = AuditTrace(), JAudit()
    for site, d, layer, mass in records:
        t.record(site, d, layer=layer, mass=mass)
        j.record(site, d, layer=layer, mass=mass)
    assert t.sites == j.sites and t.coords == j.coords
    assert (t.max_abs_diff, t.calls, t.bit_exact()) == (j.max_abs_diff, j.calls, j.bit_exact())
    assert AuditTrace().bit_exact() and AuditTrace().calls == 0
    with pytest.raises(ValueError, match="compare"):
        AuditTrace("lut")


def _operands():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)))


def test_single_site_audit():
    a, b = _operands()
    oracle = AuditTrace()
    with numerics_scope(audit=oracle):
        approx_matmul(a, b, TN("amr_inject", border=8), site="mlp.w_up")
        approx_matmul(a, b, TN("exact"), site="mlp.w_up")  # exact: nothing to audit
    assert oracle.sites == {"mlp.w_up": {"calls": 1, "max_abs_diff": 0.0, "sum_abs_diff": 0.0}}
    exact = AuditTrace("exact")
    with numerics_scope(audit=exact, layer=3):
        out = approx_matmul(a, b, TN("amr_inject", border=8), site="mlp.w_up")
    ent = exact.sites["mlp.w_up"]
    assert ent["calls"] == 1 and ent["sum_abs_diff"] > 0 and ent["max_abs_diff"] > 0
    assert exact.coords[("mlp.w_up", 3)] == ent
    assert float((out - a @ b).abs().max()) == pytest.approx(ent["max_abs_diff"])


def test_negative_control_other_schedule_records_a_step():
    tapprox = importlib.import_module("repro_torch.numerics.approx_matmul")
    a, b = _operands()
    other = injection.register_schedule(treduction.get_schedule(2, 6), name="test:conf-b6")
    out = tapprox.matmul_amr_inject(a, b, TN("amr_inject", border=8, schedule_ref=other))
    ref = tapprox._inject_oracle(a, b, TN("amr_inject", border=8))
    assert float(tapprox._grid_diff(out, ref, a, b)) >= 1.0
    # and scored against its own table, the same replay is exact
    own = tapprox._inject_oracle(a, b, TN("amr_inject", border=8, schedule_ref=other))
    assert float(tapprox._grid_diff(out, own, a, b)) == 0.0


# ------------------------------------------------------------ the arms on the CPU
@pytest.mark.parametrize("mode", ["exact", "amr_kernel"])
@pytest.mark.parametrize("family,arch", REPS)
def test_train_arm(family, arch, mode):
    row = tconf.run_train_arm(arch, mode, steps=2, device=CPU)
    assert set(row) == {"kind", "arch", "mode", "steps", "loss_finite", "grad_finite",
                        "nondegenerate", "first_loss", "final_loss"}
    assert row["loss_finite"] and row["grad_finite"] and row["nondegenerate"], row


@pytest.mark.parametrize("mode", ["exact", "amr_kernel"])
@pytest.mark.parametrize("family,arch", REPS)
def test_decode_parity_arm(family, arch, mode):
    row = tconf.run_decode_parity(arch, mode, device=CPU)
    assert row["applicable"] and row["tol"] == tconf.PARITY_TOL[mode]
    assert row["within_tol"], row


def test_decode_parity_not_applicable_under_noise():
    row = tconf.run_decode_parity("gemma3-1b", "amr_noise", device=CPU)
    assert row == {"kind": "decode_parity", "arch": "gemma3-1b", "mode": "amr_noise",
                   "applicable": False, "within_tol": True, "parity_diff": 0.0}


def test_noise_decorrelation_arm():
    row = tconf.run_noise_decorrelation(tconf.REPRESENTATIVE["dense"], device=CPU)
    assert row["reproducible"] and row["steps_decorrelated"], row


@pytest.mark.parametrize("family,arch", REPS)
def test_inject_audit_arm(family, arch):
    row = tconf.run_inject_audit(arch, device=CPU)
    assert row["sites"] > 0 and row["calls"] > 0, row
    assert row["bit_exact"], row["site_diffs"]
    assert tconf.ACTIVATION_SITES[family] <= set(row["site_diffs"]), row["site_diffs"]


def test_inject_audit_arm_on_a_dse_candidate(candidate):
    handle = injection.register_schedule(candidate[1], name="test:conf-dse")
    row = tconf.run_inject_audit(tconf.REPRESENTATIVE["dense"], schedule_ref=handle, device=CPU)
    assert row["schedule"] == handle and row["bit_exact"], row["site_diffs"]
    assert tconf.ACTIVATION_SITES["dense"] <= set(row["site_diffs"])


@pytest.mark.parametrize("use_signal", [False, True], ids=["event", "sigterm"])
def test_restart_arm(use_signal):
    import signal

    before = signal.getsignal(signal.SIGTERM)
    row = tconf.run_restart_arm("gemma-2b", use_signal=use_signal, mode="amr_kernel",
                                device=CPU)
    assert signal.getsignal(signal.SIGTERM) is before
    assert row["bit_exact"] and row["tmp_cleaned"], row
    assert row["resumed_from"] == 3 and len(row["ref_losses"]) == row["steps"] == 6
    assert row["ref_losses"] == row["resumed_losses"]


@pytest.mark.parametrize("arch,ring", [("minitron-8b", False), ("gemma3-1b", True)])
def test_parity_cause_decodes_on_the_forwards_own_cache(arch, ring):
    """``chip_smoke.parity_cause``, the rule that holds a decode-parity row
    past ``PARITY_TOL`` on the card: the decode of the last token on the
    forward's own cache (a prefill of all S tokens, rewound one position)
    gives the forward's last logits bit for bit where no window ring
    quantizes V over the window alone, and the first layer whose cache
    differs between the prefills of S - 1 and S tokens is named (layer 1:
    layer 0's K and V come from the embeddings row by row).  An SSM state
    cannot be rewound, so an SSM row is never held."""
    cause = _chip_smoke().parity_cause(arch, "amr_kernel", CPU)
    assert cause["window_ring"] == ring
    assert ring or cause["decode_on_own_cache_diff"] == 0.0
    assert cause["held"] and cause["first_differing_cache"]["layer"] == 1, cause
    assert _chip_smoke().parity_cause("mamba2-370m", "amr_kernel", CPU)["held"] is False
