"""The port's replay engine, metrics, multiplier facade, LUT builds, energy
model and baselines against the JAX package's, on the CPU.

Every result is integer or a float64 the two packages compute in the same
order, so every comparison is bit for bit:

* ``core/engine``'s torch replay (``device="cpu"``) against the JAX
  package's numpy ``reduction.evaluate_split`` (the oracle its own engine
  tests use) over n_digits {2, 4, 8} x border {None, 4, 8}, ragged batches,
  the exact 8-digit design against Python integers, and against the JAX
  package's jitted engine at 2 digits; ``evaluate_split_many`` and
  ``CandidateBatch`` equal the one-schedule calls; ``inject_products``
  equals the JAX package's table;
* ``monte_carlo`` result dicts (both port engines) equal the JAX package's
  numpy-engine dicts at (2, 8), (4, 16) and (8, 45);
* ``build_int8_luts`` with either engine equals the JAX package's numpy
  tables, with provenance;
* ``DesignFeatures``, ``fit``, ``predict``, ``literal_energy_proxy``,
  ``drum``, ``trunc_mul`` and ``mared`` equal the JAX package's.
"""
import numpy as np
import pytest
import torch

from repro.core import AMRMultiplier as JMul
from repro.core import baselines as jbaselines
from repro.core import energy as jenergy
from repro.core import engine as jengine
from repro.core import lut as jlut
from repro.core import metrics as jmetrics
from repro.core import mrsd as jmrsd
from repro.core import ppgen as jppgen
from repro.core import reduction as jreduction
from repro_torch.core import AMRMultiplier, baselines, energy, engine, lut, metrics
from repro_torch.core import reduction

from _torch_threads import one_intra_op_thread  # noqa: F401

CPU = "cpu"
DESIGNS = [(n_digits, border) for n_digits in (2, 4, 8) for border in (None, 4, 8)]
# fit targets: the paper's Table II at 2 and 4 digits (exact + 5 borders each),
# as benchmarks/paper_data.py records them
TABLE2 = {
    2: {"borders": [None, 6, 7, 8, 9, 10],
        "delay_ns": [0.73, 0.72, 0.71, 0.71, 0.71, 0.69],
        "energy_pj": [0.63, 0.61, 0.54, 0.42, 0.36, 0.25],
        "area_um2": [1263, 1297, 1145, 972, 844, 764]},
    4: {"borders": [None, 12, 15, 18, 21, 24],
        "delay_ns": [1.04, 1.03, 1.00, 0.94, 0.91, 0.73],
        "energy_pj": [4.85, 3.51, 2.85, 2.18, 1.36, 0.75],
        "area_um2": [5408, 4120, 3617, 3243, 2358, 2167]},
}


def _operand_bits(n_digits, batch, seed):
    rng = np.random.default_rng(seed)
    xd = jmrsd.random_digits(rng, n_digits, batch)
    yd = jmrsd.random_digits(rng, n_digits, batch)
    return jppgen.flatten_operand_bits(xd), jppgen.flatten_operand_bits(yd)


def _assert_split_equal(got, want):
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("n_digits,border", DESIGNS)
def test_split_bit_exact_vs_jax_numpy(n_digits, border):
    # 999 exercises the ragged final 32-sample word
    batch = 256 if n_digits == 8 else 999
    xb, yb = _operand_bits(n_digits, batch, seed=n_digits * 31 + (border or 0))
    want = jreduction.evaluate_split(jreduction.get_schedule(n_digits, border), xb, yb)
    eng = engine.get_engine(n_digits, border, CPU)
    assert eng.device == torch.device(CPU)
    assert eng.schedule is reduction.get_schedule(n_digits, border)
    _assert_split_equal(eng.evaluate_split(xb, yb), want)
    np.testing.assert_array_equal(eng.evaluate(xb, yb), jreduction.split_to_float(*want))


@pytest.mark.parametrize("batch", [1, 31, 32, 33, 100])
def test_ragged_batches(batch):
    xb, yb = _operand_bits(2, batch, seed=batch)
    got = engine.get_engine(2, 8, CPU).evaluate_split(xb, yb)
    assert got[0].shape == (batch,)
    _assert_split_equal(got, jreduction.evaluate_split(jreduction.get_schedule(2, 8), xb, yb))


@pytest.mark.parametrize("border", [None, 8])
def test_split_matches_jax_jitted_engine(border):
    xb, yb = _operand_bits(2, 333, seed=9)
    _assert_split_equal(engine.get_engine(2, border, CPU).evaluate_split(xb, yb),
                        jengine.get_engine(2, border).evaluate_split(xb, yb))


def test_exact_design_matches_integer_products():
    """Values reach ~2**69: every limb of the split."""
    rng = np.random.default_rng(5)
    xd = jmrsd.random_digits(rng, 8, 64)
    yd = jmrsd.random_digits(rng, 8, 64)
    lo, hi = engine.evaluate_digits_split(8, None, xd, yd, device=CPU)
    for i in range(64):
        assert int(lo[i]) + (int(hi[i]) << 32) == jmrsd.decode_int(xd[i]) * jmrsd.decode_int(yd[i])


def test_many_and_candidate_batch_equal_one_schedule_calls():
    xb, yb = _operand_bits(4, 200, seed=3)
    borders = (None, 4, 8)
    many = engine.evaluate_split_many(4, borders, xb, yb, device=CPU)
    assert tuple(many) == borders
    singles = [engine.get_engine(4, b, CPU).evaluate_split(xb, yb) for b in borders]
    for b, one in zip(borders, singles):
        _assert_split_equal(many[b], one)
    scheds = [reduction.get_schedule(4, b) for b in borders]
    batch = engine.compile_candidates([scheds[0], engine.get_engine(4, 4, CPU), scheds[2]], CPU)
    for got, one in zip(batch.evaluate_split(xb, yb), singles):
        _assert_split_equal(got, one)
    for got, one in zip(engine.evaluate_candidates_split(scheds, xb, yb, device=CPU), singles):
        _assert_split_equal(got, one)


def test_candidates_rejected_across_widths_and_devices():
    with pytest.raises(ValueError, match="n_digits"):
        engine.compile_candidates([reduction.get_schedule(2, 8), reduction.get_schedule(4, 8)], CPU)
    with pytest.raises(ValueError, match="sit on"):
        engine.compile_candidates([engine.get_engine(2, 8, CPU)], torch.device("meta"))


def test_inject_products_equal_the_jax_table():
    rng = np.random.default_rng(11)
    ia, ib = rng.integers(0, 256, (3, 50)), rng.integers(0, 256, (3, 50))
    want = jlut.build_int8_lut(8, engine="numpy")[ia, ib]
    for sched in (reduction.get_schedule(2, 8), engine.get_injector(2, 8)):
        got = engine.inject_products(sched, torch.from_numpy(ia), torch.from_numpy(ib))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_engine_cache_is_per_design_point_and_device():
    assert engine.get_engine(2, 8, CPU) is engine.get_engine(2, 8, torch.device(CPU))
    assert engine.get_engine(2, 8, CPU) is not engine.get_engine(2, 6, CPU)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    xb, yb = _operand_bits(2, 4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.get_engine(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AMRMultiplier(2, 8, engine="torch").multiply_digits_split(*(
            jmrsd.random_digits(np.random.default_rng(0), 2, 4) for _ in range(2)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lut.build_int8_luts((8,), engine="torch")
    # the defaults are the card: no entry point falls back to the host
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AMRMultiplier(2, 8).monte_carlo(64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lut.build_int8_luts((8,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lut.lut_record(6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.evaluate_split_many(2, (8,), xb, yb)


# ------------------------------------------------------------ metrics and the facade
@pytest.mark.parametrize("n_digits,border", [(2, 8), (4, 16), (8, 45)])
def test_monte_carlo_dicts_equal_jax(n_digits, border):
    want = JMul(n_digits, border).monte_carlo(2000, seed=3, chunk=512)
    for eng in ("torch", "numpy"):
        got = AMRMultiplier(n_digits, border, engine=eng, device=CPU).monte_carlo(
            2000, seed=3, chunk=512)
        assert got == want, eng


def test_accumulator_and_relative_errors_equal_jax():
    rng = np.random.default_rng(1)
    approx, exact = rng.integers(-500, 500, 300), rng.integers(-500, 500, 300)
    t, j = metrics.ErrorAccumulator(max_abs=250000.0), jmetrics.ErrorAccumulator(max_abs=250000.0)
    t.update(approx, exact)
    j.update(approx, exact)
    lo, hi = rng.integers(0, 1 << 32, 50), rng.integers(-3, 3, 50)
    t.update_split(lo, hi, lo[::-1], hi[::-1])
    j.update_split(lo, hi, lo[::-1], hi[::-1])
    assert t.result() == j.result()
    np.testing.assert_array_equal(metrics.relative_errors(approx, exact),
                                  jmetrics.relative_errors(approx, exact))


def test_multiplier_facade_equals_jax():
    t, j = AMRMultiplier(2, 8, device=CPU), JMul(2, 8)
    vals = np.arange(-128, 128)
    np.testing.assert_array_equal(t.multiply_values(vals, vals[::-1], engine="torch"),
                                  j.multiply_values(vals, vals[::-1]))
    assert (vars(t.cfg), t.cfg.tag(), t.n_stages, t.cell_counts, t.cell_usage_percent(),
            t.expected_error) == (vars(j.cfg), j.cfg.tag(), j.n_stages, j.cell_counts,
                                  j.cell_usage_percent(), j.expected_error)


def test_engine_name_value_error():
    with pytest.raises(ValueError, match="engine must be one of"):
        AMRMultiplier(2, 8, engine="jax")
    with pytest.raises(ValueError, match="engine must be one of"):
        AMRMultiplier(2, 8).multiply_values([3], [4], engine="bogus")
    with pytest.raises(ValueError, match="engine must be one of"):
        lut.build_int8_luts((8,), engine="jax")


# ------------------------------------------------------------ LUT builds
def test_int8_luts_equal_jax_with_provenance():
    borders = (None, 4, 8, 14)
    built = lut.build_int8_luts(borders, engine="torch", device=CPU)
    for b in borders:
        want = jlut.build_int8_lut(b, engine="numpy")
        assert built[b].dtype == np.int32 and not built[b].flags.writeable
        np.testing.assert_array_equal(built[b], want)
        np.testing.assert_array_equal(lut.build_int8_lut(b, engine="numpy"), want)
        rec = lut.lut_record(b, "torch", CPU)
        assert (rec.n_digits, rec.border, rec.engine, rec.device) == (2, b, "torch",
                                                                      torch.device(CPU))
        assert rec.table is built[b]
        assert (lut.lut_record(b, "numpy").engine, lut.lut_record(b, "numpy").device) == ("numpy", None)
    # the served tables keep their numpy source
    np.testing.assert_array_equal(lut.table_tensor(8, torch.device(CPU)).numpy(),
                                  lut.lut_record(8, "numpy").table)


# ------------------------------------------------------------ energy and baselines
def _features(pkg_reduction, pkg_energy):
    feats, area, energy_pj, delay = [], [], [], []
    for digits, ref in TABLE2.items():
        for i, border in enumerate(ref["borders"]):
            feats.append(pkg_energy.DesignFeatures.from_schedule(
                pkg_reduction.get_schedule(digits, border)))
            area.append(ref["area_um2"][i])
            energy_pj.append(ref["energy_pj"][i])
            delay.append(ref["delay_ns"][i])
    return feats, np.asarray(area), np.asarray(energy_pj), np.asarray(delay)


def test_energy_model_equals_jax():
    tf, *targets = _features(reduction, energy)
    jf, *_ = _features(jreduction, jenergy)
    assert [vars(f) for f in tf] == [vars(f) for f in jf]
    assert energy.CELL_LITERALS == jenergy.CELL_LITERALS
    tm, jm = energy.fit(tf, *targets), jenergy.fit(jf, *targets)
    np.testing.assert_array_equal(tm.area_coef, jm.area_coef)
    np.testing.assert_array_equal(tm.energy_coef, jm.energy_coef)
    assert ((tm.delay_d0, tm.delay_per_stage, tm.delay_approx_scale)
            == (jm.delay_d0, jm.delay_per_stage, jm.delay_approx_scale))
    assert (energy.predict(tm, AMRMultiplier(2, 8, device=CPU))
            == jenergy.predict(jm, JMul(2, 8)))
    for n, b in [(2, None), (2, 8), (4, 15)]:
        assert (energy.literal_energy_proxy(reduction.get_schedule(n, b))
                == jenergy.literal_energy_proxy(jreduction.get_schedule(n, b)))


def test_baselines_equal_jax():
    rng = np.random.default_rng(7)
    x, y = rng.integers(-32768, 32768, 4000), rng.integers(-32768, 32768, 4000)
    exact = baselines.exact_mul(x, y)
    np.testing.assert_array_equal(exact, jbaselines.exact_mul(x, y))
    for k in (4, 6, 8):
        np.testing.assert_array_equal(baselines.drum(x, y, k), jbaselines.drum(x, y, k))
        assert (baselines.mared(baselines.drum(x, y, k), exact)
                == jbaselines.mared(jbaselines.drum(x, y, k), exact))
    for t in (4, 8, 12):
        np.testing.assert_array_equal(baselines.trunc_mul(x, y, 16, t),
                                      jbaselines.trunc_mul(x, y, 16, t))
