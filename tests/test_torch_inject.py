"""The port's amr_inject path against the JAX package, on the CPU.

Same numpy inputs to both packages.  Integer results (lowering tables,
max|product|, injected products and sums) are compared bit for bit, as is
the CUDA kernel's program, replayed here by a numpy model of the kernel's
arithmetic (``_kernel_model``): the kernel itself runs only on a GPU
(tests/test_torch_kernels_cuda.py).  Float results of ``approx_matmul``
rescale the same int32 sums by the same scales, in another order:
|port - jax| <= 4 float32 ulps of max|out|.  Model token streams are equal.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.gemma_2b import reduced as jreduced
from repro.core import engine as jengine
from repro.core import lut as jlut
from repro.core import reduction as jreduction
from repro.core.dse import lut_from_schedule, materialize, search_assignments
from repro.core.dse.export import _ReplayAssigner
from repro.kernels.inject_replay import inject_replay_matmul as jreplay
from repro.models import init_params as jinit
from repro.numerics import AMRNumerics as JN
from repro.numerics import injection as jinjection
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs.gemma_2b import reduced as treduced
from repro_torch.core import engine as tengine
from repro_torch.core import reduction as treduction
from repro_torch.kernels.inject_replay import kernel as tkernel
from repro_torch.kernels.inject_replay import ops as tops
from repro_torch.kernels.inject_replay import ref as tref
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.numerics import injection as tinjection
from repro_torch.serve import Request, ServeEngine

from _torch_threads import one_intra_op_thread  # noqa: F401

japprox = importlib.import_module("repro.numerics.approx_matmul")
tapprox = importlib.import_module("repro_torch.numerics.approx_matmul")
ULP = 2.0 ** -23
BORDERS = [8, 14, None]


def _idx(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def candidate():
    """A whole-multiplier DSE candidate: JAX schedule and the port's rebuild."""
    [cand] = search_assignments(2, 8, k=1, beam_width=8, branch_cap=4, max_nodes=2000)
    port = treduction.build_schedule(2, 8, assigner=_ReplayAssigner(cand))
    return materialize(cand), port


# ------------------------------------------------------------ the lowering
def _assert_lowering_equal(jl, tl):
    for f in ("gate_masks", "x_idx", "y_idx", "final_ids", "weights", "offsets",
              "bit_weights"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), err_msg=f)
    assert (tl.n_limbs, tl.offset_total) == (jl.n_limbs, jl.offset_total)
    assert len(tl.stages) == len(jl.stages)
    for ts, js in zip(tl.stages, jl.stages):
        for f in ("in3", "sum_masks", "carry_masks", "perm"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)


@pytest.mark.parametrize("border", BORDERS)
def test_lowering_and_max_product_match_jax(border):
    jl = jengine.lower_schedule(jreduction.get_schedule(2, border))
    tl = tengine.lower_schedule(treduction.get_schedule(2, border))
    _assert_lowering_equal(jl, tl)
    assert (tengine.get_injector(2, border).max_abs_product
            == jengine.get_injector(2, border).max_abs_product)


@pytest.mark.parametrize("border", [8, 14])
def test_injector_pieces_bitwise(border):
    ti, ji = tengine.get_injector(2, border), jengine.get_injector(2, border)
    ia, ib = _idx((6, 10), 1), _idx((10, 37), 2)
    np.testing.assert_array_equal(ti.pack_weights(_t(ib)).numpy(),
                                  np.asarray(ji.pack_weights(jnp.asarray(ib))).view(np.int32))
    xm = ti.operand_masks(_t(ia))
    np.testing.assert_array_equal(xm.numpy(),
                                  np.asarray(ji.operand_masks(jnp.asarray(ia))).view(np.int32))
    pa, pb = np.broadcast_to(ia[:, :, None], (6, 10, 37)), np.broadcast_to(ib, (6, 10, 37))
    np.testing.assert_array_equal(ti.products(_t(pa), _t(pb)).numpy(),
                                  jlut.build_int8_lut(border)[pa, pb])


# ------------------------------------------------------ the integer matmul
@pytest.mark.parametrize("border,m,k,n", [(8, 8, 16, 12), (8, 32, 48, 64), (8, 4, 13, 45),
                                          (8, 64, 8, 96), (14, 32, 48, 64), (14, 4, 13, 45)])
def test_injected_matmul_bitwise_vs_jax_kernel(border, m, k, n):
    """The plain version (in small chunks) and the ops (CPU route) against
    the JAX Pallas kernel in interpret mode, at tests/test_inject_replay.py's
    shapes."""
    ia, ib = _idx((m, k), m + k + n), _idx((k, n), 7)
    want = np.asarray(jreplay(jengine.get_injector(2, border), jnp.asarray(ia), jnp.asarray(ib),
                              interpret=True))
    inj = tengine.get_injector(2, border)
    got = tref.replay_matmul_ref(inj, _t(ia), _t(ib), max_pairs=1 << 10)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.inject_replay_matmul(inj, _t(ia), _t(ib)).numpy(), want)


def test_grouped_matches_jax():
    ia, ib = _idx((3, 5, 24), 3), _idx((3, 24, 40), 4)
    want = np.asarray(jinjection.injected_matmul_grouped(
        jengine.get_injector(2, 8), jnp.asarray(ia), jnp.asarray(ib)))
    inj = tengine.get_injector(2, 8)
    np.testing.assert_array_equal(
        tref.replay_matmul_ref(inj, _t(ia), _t(ib), max_pairs=1 << 10).numpy(), want)
    np.testing.assert_array_equal(
        tops.inject_replay_matmul_grouped(inj, _t(ia), _t(ib)).numpy(), want)


def test_dse_candidate_products_match_its_jax_table(candidate):
    jsched, tsched = candidate
    _assert_lowering_equal(jengine.lower_schedule(jsched), tengine.lower_schedule(tsched))
    inj = tengine.compile_injector(tsched)
    pairs = torch.arange(256 * 256)
    table = inj.products(pairs // 256, pairs % 256).reshape(256, 256).numpy()
    np.testing.assert_array_equal(table, lut_from_schedule(jsched))
    assert inj.max_abs_product == int(np.abs(table).max())


# ------------------------------------- the kernel's program, replayed in numpy
def _lop3(tt, a, b, c):
    """f(a, b, c) bitwise, bit a*4 + b*2 + c of ``tt`` (the LOP3 convention)."""
    out = np.zeros(np.broadcast_shapes(a.shape, b.shape, c.shape), np.uint32)
    for k in range(8):
        if (tt >> k) & 1:
            out |= ((a if k & 4 else ~a) & (b if k & 2 else ~b) & (c if k & 1 else ~c))
    return out


def _transpose32(v):
    """csrc/replay_device.cuh's transpose32, on a list of 32 uint32 arrays."""
    masks = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
    for level, m in enumerate(masks):
        j = 16 >> level
        for r in range(32):
            if r & j == 0:
                t = ((v[r] >> np.uint32(j)) ^ v[r + j]) & np.uint32(m)
                v[r + j] = v[r + j] ^ t
                v[r] = v[r] ^ (t << np.uint32(j))
    return v


def _csa_add(s, c, x):
    """replay_device.cuh's csa_add: (s, c) += x in carry-save form."""
    carries = [_lop3(0xE8, s[q], c[q], x[q]) for q in range(32)]
    s = [_lop3(0x96, s[q], c[q], x[q]) for q in range(32)]
    return s, [np.zeros_like(carries[0])] + carries[:31]


def _kernel_model(prog, ia, ib):
    """The kernel's arithmetic over all (row, word) threads at once: the
    program's runs over wire slots (a run's cells with the pair its header
    names in ``CELL_PAIRS``, gates as the select of y by two masks per x),
    the carry-save accumulator and its ripple, the transpose and the offset.
    ia (M, K), ib (K, N) indices -> int64 (M, N)."""
    M, K = ia.shape
    N = ib.shape[1]
    W = -(-N // 32)
    cols = np.full((K, W * 32), 128)
    cols[:, :N] = ib
    lane_bits = prog.value_bits[cols].reshape(K, W, 32)       # stored bits per column
    y = np.zeros((K, prog.n_opbits, W), np.uint32)
    lanes = np.arange(32, dtype=np.uint32)
    for j in range(prog.n_opbits):
        bit_j = (lane_bits >> np.uint32(j)) & np.uint32(1)
        y[:, j] = (bit_j << lanes).sum(-1, dtype=np.uint32)

    def mask(tt, bit):
        return np.uint32(0xFFFFFFFF) if (tt >> bit) & 1 else np.uint32(0)

    s = [np.zeros((M, W), np.uint32) for _ in range(32)]
    c = [np.zeros((M, W), np.uint32) for _ in range(32)]
    zero = np.zeros((M, W), np.uint32)
    for k in range(K):
        xb = prog.value_bits[ia[:, k]][:, None]                 # (M, 1)
        slots = [zero for _ in range(prog.n_slots)]
        i = 0
        while i < prog.ops.shape[0]:
            count, case = prog.ops[i]
            assert count >> 24 == 2                              # a run header
            for op0, op1 in prog.ops[i + 1:i + 1 + (count & 0xFFFFFF)]:
                f0, f1, f2 = op0 & 0xFF, (op0 >> 8) & 0xFF, (op0 >> 16) & 0xFF
                tt0, tt1 = (op1 >> 16) & 0xFF, op1 >> 24
                if op0 >> 24 == 0:
                    xm = (np.uint32(0) - ((xb >> np.uint32(f0)) & np.uint32(1))).astype(np.uint32)
                    yw = y[k, f1][None, :]
                    slots[op1 & 0xFF] = _lop3(0xCA, xm, _lop3(0xCA, yw, mask(tt0, 7), mask(tt0, 4)),
                                              _lop3(0xCA, yw, mask(tt0, 3), mask(tt0, 0)))
                else:
                    if case != tkernel.GENERIC:
                        tt0, tt1 = tkernel.CELL_PAIRS[case]
                    a, b, cc = slots[f0], slots[f1], slots[f2]
                    slots[op1 & 0xFF], slots[(op1 >> 8) & 0xFF] = (_lop3(tt0, a, b, cc),
                                                                   _lop3(tt1, a, b, cc))
            i += 1 + (count & 0xFFFFFF)
        for row in (0, 1):
            x = [slots[prog.fin[q, row]] if q < tkernel.POSITIONS else zero for q in range(32)]
            s, c = _csa_add(s, c, x)
    acc, carry = [], zero
    for q in range(32):  # the carry-save pair resolved by one ripple
        acc.append(_lop3(0x96, s[q], c[q], carry))
        carry = _lop3(0xE8, s[q], c[q], carry)
    lanes = np.stack(_transpose32(acc), -1)                      # (M, W, 32)
    sums = (lanes - np.uint32(K) * np.uint32(prog.offset & 0xFFFFFFFF)).view(np.int32)
    return sums.reshape(M, W * 32)[:, :N].astype(np.int64)


@pytest.mark.parametrize("border", BORDERS + ["dse"])
def test_kernel_program_reproduces_the_table(border, candidate):
    sched = candidate[1] if border == "dse" else treduction.get_schedule(2, border)
    inj = tengine.compile_injector(sched)
    prog = tkernel.replay_program(inj.lowered, inj.value_bits)
    assert prog.n_slots <= 80 and prog.n_ops == 100 + 101 and prog.generic_ops == 0
    assert prog.ops.shape == (prog.n_ops + prog.n_runs, 2) and prog.n_runs <= 30
    ia, ib = _idx((3, 5), 11), _idx((5, 70), 12)
    table = (lut_from_schedule(candidate[0]) if border == "dse"
             else jlut.build_int8_lut(border)).astype(np.int64)
    want = table[ia[:, :, None], ib[None, :, :]].sum(axis=1)
    np.testing.assert_array_equal(_kernel_model(prog, ia, ib), want)


@pytest.mark.parametrize("m,n_words", [(1, 1), (2, 1), (2, 8), (2, 512), (16, 64), (8, 1),
                                       (40, 3), (200, 700)])
def test_block_shape_fills_the_block(m, n_words):
    wpb, rpb, kpb = tkernel.block_shape(m, n_words)
    assert wpb * rpb * kpb == tkernel.THREADS and kpb >= 1
    assert wpb <= max(64, n_words) and (wpb >= min(n_words, 64))


def test_wrapper_checks_its_operands():
    inj = tengine.get_injector(2, 8)
    ia, ib = torch.zeros((1, 2, 4), dtype=torch.int32), torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tkernel.inject_replay_int32(inj, ia.long(), ib)
    with pytest.raises(ValueError, match="mismatch"):
        tkernel.inject_replay_int32(inj, ia, ib[:3])
    assert tkernel.inject_replay_int32(inj, ia, ib).shape == (1, 2, 3)


# ----------------------------------------------------------- the registry
def test_registry_handles_and_rules(candidate):
    tsched = candidate[1]
    h1 = tinjection.register_schedule(tsched)
    h2 = tinjection.register_schedule(tsched)
    assert h1 != h2 and h1.startswith("custom:") and h2.startswith("custom:")
    nm = TN("amr_inject", border=8, schedule_ref=h1)
    inj = tinjection.get_injector(nm)
    assert tinjection.get_injector(nm) is inj
    assert tinjection.register_schedule(treduction.get_schedule(2, 14), name=h1) == h1
    assert tinjection.get_injector(nm) is not inj                 # replaced: recompiled
    assert tinjection.resolve_schedule(nm) is treduction.get_schedule(2, 14)
    with pytest.raises(ValueError, match="2-digit"):
        tinjection.register_schedule(treduction.get_schedule(3, 12))
    with pytest.raises(KeyError, match="register_schedule"):
        tinjection.resolve_schedule(TN("amr_inject", border=8, schedule_ref="test:missing"))
    with pytest.raises(ValueError, match="schedule_ref"):
        TN("amr_inject", border=8, schedule_ref=3)


def test_saturation_error_text_matches_jax():
    k = 2**31 // 16451 + 1
    msgs = []
    for check, inj in ((jinjection.check_accumulation_bound, jengine.get_injector(2, 8)),
                       (tinjection.check_accumulation_bound, tengine.get_injector(2, 8))):
        with pytest.raises(ValueError) as err:
            check(inj, k, schedule="test:h")
        msgs.append(str(err.value))
        check(inj, k - 1)
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- approx_matmul
def _float(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("a_shape,b_shape", [((2, 3, 24), (24, 33)),
                                             ((2, 2, 6, 16), (2, 2, 16, 9))])
def test_approx_matmul_inject_matches_jax(a_shape, b_shape):
    a, b = _float(a_shape, 5), _float(b_shape, 6)
    want = np.asarray(japprox.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                            JN("amr_inject", border=8, inject_impl="xla")))
    got = tapprox.approx_matmul(_t(a), _t(b), TN("amr_inject", border=8)).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 4 * ULP * float(np.abs(want).max())


def test_approx_matmul_inject_dse_candidate_equals_its_table(candidate):
    jsched, tsched = candidate
    handle = tinjection.register_schedule(tsched, name="test:dse")
    a, b = _float((4, 16), 2), _float((16, 8), 3)
    got = tapprox.approx_matmul(_t(a), _t(b), TN("amr_inject", border=8, schedule_ref=handle))
    from repro_torch.numerics.quant import quantize_int8_ste
    qa, sa = quantize_int8_ste(_t(a), axis=-1)
    qb, sb = quantize_int8_ste(_t(b), axis=0)
    ia, ib = qa.long().numpy() + 128, qb.long().numpy() + 128
    acc = lut_from_schedule(jsched).astype(np.int64)[ia[:, :, None], ib[None]].sum(1)
    want = _t(acc.astype(np.float32)) * sa * sb
    assert torch.equal(got, want)


# ----------------------------------------------------------- served model
def test_reduced_model_token_streams_match_jax_engine():
    jcfg = dataclasses.replace(jreduced(), dtype="float32",
                               numerics=JN("amr_inject", border=8, inject_impl="xla"))
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN("amr_inject", border=8))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    # one prompt length: the JAX engine compiles one prefill
    prompts, gens = [(5, 9, 2, 7), (3, 11, 4, 1), (13, 2, 8, 6)], [3, 4, 2]
    out = []
    for eng in (JEngine(jcfg, jp, n_slots=2, capacity=16),
                ServeEngine(tcfg, tp, n_slots=2, capacity=16, device="cpu")):
        for p, g in zip(prompts, gens):
            eng.submit((JRequest if isinstance(eng, JEngine) else Request)(
                prompt=p, max_new_tokens=g))
        out.append([c.tokens for c in eng.run()])
    assert out[1] == out[0]


def test_launcher_serves_amr_inject_on_cpu(capsys):
    tlaunch.main(["--device", "cpu", "--requests", "2", "--slots", "2", "--prompt-len", "4",
                  "--gen", "2", "--numerics", "amr_inject"])
    out = capsys.readouterr().out
    assert "amr_inject" in out and "tok/s end-to-end" in out
