"""The port's fused AMR attention op against the JAX package's, on the CPU.

The same numpy inputs go to the JAX op (its Pallas kernels in interpret
mode, as tests/test_attn_fused.py runs them) and to the port's op (its
plain versions: CPU tensors never reach a kernel).

Bars:
* the quantized operands and the int32 QK^T accumulators are equal bit for
  bit (the JAX side's from its quantizers and its product table);
* the outputs are within ``ref.flip_tolerance`` of the JAX op's and of its
  unfused reference: XLA's exp and its softmax sum differ from ATen's by
  float32 ulps, so a re-quantized probability may land one int8 step away.
  A row whose n probability indices differ moves by at most n * step * ps *
  sv, step being the largest change of a table product when its first
  operand moves one step (1586 at border 8), plus 2**-20 * |out| for the
  scales' ulps and the rescale.  The indices are counted against the JAX
  kernel's chain run on the same accumulators; at most 1% may differ, each
  by one step;
* the port's plain version against the port's unfused seam composition
  (``fused_attention_reference``, ``torch.softmax``): the same tolerance,
  its indices from the seam's ``attn.pv`` quantizer.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.gemma_2b import reduced as jreduced
from repro.core import lut as jlut
from repro.core import reduction as jreduction
from repro.kernels.attn_fused import fused_attention as jfused
from repro.kernels.attn_fused import fused_attention_reference as jreference
from repro.kernels.attn_fused.kernel import NEG_INF as JNEG_INF
from repro.kernels.attn_fused.kernel import _quantize_probs
from repro.models import init_params as jinit
from repro.models.attention import _project_qkv as jproject
from repro.models.layers import embed as jembed
from repro.models.layers import rms_norm as jrms_norm
from repro.numerics import injection as jinjection
from repro.numerics.quant import quantize_int8 as jquantize
from repro.numerics.quant import quantize_int8_ste as jquantize_ste
from repro_torch.configs.gemma_2b import reduced as treduced
from repro_torch.core import engine as tengine
from repro_torch.core import lut as tlut
from repro_torch.core import reduction as treduction
from repro_torch.kernels.amr_matmul.ref import lut_matmul_ref
from repro_torch.kernels.attn_fused import fused_attention, fused_attention_reference, kernel, ops
from repro_torch.kernels.attn_fused import ref
from repro_torch.kernels.inject_replay.ref import replay_matmul_ref
from repro_torch.models.attention import _project_qkv as tproject
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import embed as tembed
from repro_torch.models.layers import rms_norm as trms_norm
from repro_torch.numerics import AMRNumerics
from repro_torch.numerics import injection as tinjection
from repro_torch.numerics.approx_matmul import approx_matmul
from repro_torch.numerics.quant import quantize_int8

MAX_FLIP_SHARE = 0.01


def _case(g=3, m=8, d=16, t=32, p=16, seed=0):
    """Normal q, kt, v and a ragged decode-style mask: row (g, i) sees the
    first lengths[g, i] of the T slots."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((g, m, d)).astype(np.float32)
    kt = rng.standard_normal((g, d, t)).astype(np.float32)
    v = rng.standard_normal((g, t, p)).astype(np.float32)
    lengths = rng.integers(1, t + 1, (g, m))
    return q, kt, v, np.arange(t)[None, None, :] < lengths[:, :, None]


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_fused(ops_np, **kw):
    return np.array(jax.jit(lambda q, kt, v, mask: jfused(q, kt, v, mask, **kw))(*ops_np))


def _jax_reference(ops_np, **kw):
    return np.array(jax.jit(lambda q, kt, v, mask: jreference(q, kt, v, mask, **kw))(*ops_np))


def _jax_kernel_indices(acc, sq, sk, mask, scale):
    """The JAX kernel's chain from the int32 scores to its int8 probabilities."""
    def chain(acc, sq, sk, mask):
        s = acc.astype(jnp.float32) * sq * sk / scale
        qp, ps = _quantize_probs(jax.nn.softmax(jnp.where(mask != 0, s, JNEG_INF), axis=-1))
        return qp, ps

    qp, ps = jax.jit(chain)(acc, sq, sk, mask)
    return torch.from_numpy(np.array(qp).astype(np.int8)), torch.from_numpy(np.array(ps))


def _table_gather(a8, b8, table):
    """int32 sums of table products, per group, from the JAX package's table."""
    return np.stack([np.asarray(table, np.int64)[a.astype(np.int64)[:, :, None] + 128,
                                                 b.astype(np.int64)[None, :, :] + 128].sum(1)
                     for a, b in zip(a8, b8)]).astype(np.int32)


def _check_within(out, want, qp, qp_other, ps, ps_other, sv, step):
    """|out - want| within ``ref.flip_tolerance``; few indices flipped, each one step."""
    diff = (qp.int() - qp_other.int()).abs()
    assert int(diff.max()) <= 1, int(diff.max())
    share = float((diff != 0).float().mean())
    assert share <= MAX_FLIP_SHARE, share
    tol = ref.flip_tolerance(qp, qp_other, ps, ps_other, sv, step, want)
    assert out.shape == want.shape and bool(torch.isfinite(out).all())
    assert bool(((out - want).abs() <= tol).all()), float(((out - want).abs() - tol).max())


def _against_jax(ops_np, method, border, table, schedule_ref=None, scale=None,
                 jax_schedule_ref=None):
    """Quantized operands and QK^T bit for bit; the output within tolerance
    of the JAX op (and, for lut, of the JAX reference)."""
    tt = _t(ops_np)
    D = ops_np[0].shape[-1]
    sc = float(D) ** 0.5 if scale is None else scale
    q8, k8, v8, sq, sk, sv = ops.quantize_operands(*tt[:3], method)
    jquant = jquantize if method == "lut" else jquantize_ste
    for mine, x, axis in ((q8, sq), ops_np[0], -1), ((k8, sk), ops_np[1], -2), \
            ((v8, sv), ops_np[2], -2):
        jq, js = jquant(jnp.asarray(x), axis=axis)
        assert np.array_equal(mine[0].numpy(), np.asarray(jq).astype(np.int8))
        assert np.array_equal(mine[1].numpy(), np.asarray(js))
    if method == "lut":
        acc = lut_matmul_ref(q8, k8, table)
    else:
        inj = tinjection.get_injector(AMRNumerics("amr_inject", border=border,
                                                  schedule_ref=schedule_ref))
        acc = replay_matmul_ref(inj, q8.int() + 128, k8.int() + 128)
    assert np.array_equal(acc.numpy(), _table_gather(q8.numpy(), k8.numpy(),
                                                     jlut.build_int8_lut(border)))

    out = fused_attention(*tt, border=border, method=method, schedule_ref=schedule_ref,
                          scale=scale)
    qp, ps = ref.softmax_requant(acc, sq, sk, tt[3].int(), sc)
    jqp, jps = _jax_kernel_indices(acc.numpy(), sq.numpy(), sk.numpy(),
                                   np.asarray(ops_np[3], np.int32), sc)
    step = ref.index_step(table)
    jkw = dict(border=border, method=method, schedule_ref=jax_schedule_ref, scale=scale)
    _check_within(out, torch.from_numpy(_jax_fused(ops_np, **jkw)), qp, jqp, ps, jps, sv, step)
    if method == "lut":
        _check_within(out, torch.from_numpy(_jax_reference(ops_np, **jkw)), qp, jqp, ps, jps,
                      sv, step)
    return out


@pytest.mark.parametrize("border", [2, 8])
def test_lut_matches_jax(border):
    out = _against_jax(_case(), "lut", border, tlut.table_tensor(border, torch.device("cpu")))
    assert out.shape == (3, 8, 16)


def test_inject_word_padded_t_and_p_matches_jax():
    """T and P that are not whole 32-column words."""
    out = _against_jax(_case(g=2, m=4, d=8, t=40, p=24, seed=2), "inject", 8,
                       tlut.table_tensor(8, torch.device("cpu")))
    assert out.shape == (2, 4, 24)


def test_inject_custom_schedule_matches_jax():
    """A DSE-style candidate: the border-6 schedule registered under a
    handle in each package, replayed, held to the border-6 table."""
    jh = jinjection.register_schedule(jreduction.get_schedule(2, 6), name="attnfused:b6")
    th = tinjection.register_schedule(treduction.get_schedule(2, 6), name="attnfused:b6")
    _against_jax(_case(g=2, m=4, d=8, t=32, p=16, seed=3), "inject", 6,
                 torch.from_numpy(jlut.build_int8_lut(6)), schedule_ref=th, jax_schedule_ref=jh)


def test_explicit_scale_matches_jax():
    _against_jax(_case(g=2, m=4, d=16, t=16, p=8, seed=4), "lut", 8,
                 tlut.table_tensor(8, torch.device("cpu")), scale=7.5)


@pytest.mark.parametrize("method", ["lut", "inject"])
def test_row_tile_changes_nothing(method):
    tt = _t(_case(m=8))
    outs = [fused_attention(*tt, method=method, bm=bm) for bm in (1, 2, 4, 8, None)]
    for o in outs[1:]:
        assert torch.equal(outs[0], o)


def test_shape_and_method_validation():
    q, kt, v, mask = _t(_case())
    with pytest.raises(ValueError, match="method"):
        fused_attention(q, kt, v, mask, method="nope")
    with pytest.raises(ValueError, match="schedule_ref"):
        fused_attention(q, kt, v, mask, method="lut", schedule_ref="x")
    with pytest.raises(ValueError, match="shapes disagree"):
        fused_attention(q, kt[:, :-1], v, mask)
    with pytest.raises(ValueError, match="mask"):
        fused_attention(q, kt, v, mask[:, :, :-1])
    with pytest.raises(ValueError, match="bm=3"):
        fused_attention(q, kt, v, mask, bm=3)
    with pytest.raises(ValueError, match="schedule_ref"):
        fused_attention_reference(q, kt, v, mask, method="lut", schedule_ref="x")


@pytest.mark.parametrize("method,what", [("lut", "fused_attention PV int32 accumulator"),
                                         ("inject", "amr_inject int32 accumulator")])
def test_saturation_guard_covers_t(method, what):
    """K = T of the PV product is guarded as K = D of QK^T is."""
    t = (2**31 - 1) // tlut.table_max_abs(14) + 1
    q, kt, v = torch.ones(1, 1, 4), torch.ones(1, 4, t), torch.ones(1, t, 2)
    with pytest.raises(ValueError, match=what):
        fused_attention(q, kt, v, torch.ones(1, 1, t), border=14, method=method)


@pytest.mark.parametrize("method", ["lut", "inject"])
def test_plain_version_within_tolerance_of_the_seam(method):
    """The plain version (the op on CPU tensors) against the port's unfused
    seam composition, at a causal prefill shape and a ragged decode shape."""
    for g, m, d, t, p, seed in ((1, 32, 32, 32, 24, 5), (2, 8, 64, 96, 64, 6)):
        q, kt, v, mask = _t(_case(g, m, d, t, p, seed))
        if m == t:
            mask = torch.tril(torch.ones(m, t, dtype=torch.bool)).expand(g, m, t)
        out = fused_attention(q, kt, v, mask, method=method)
        want = fused_attention_reference(q, kt, v, mask, method=method)
        q8, k8, v8, sq, sk, sv = ops.quantize_operands(q, kt, v, method)
        table = tlut.table_tensor(8, torch.device("cpu"))
        qp, ps = ref.softmax_requant(lut_matmul_ref(q8, k8, table), sq, sk, mask.int(),
                                     float(d) ** 0.5)
        rqp, rps = quantize_int8(ops.reference_probabilities(q, kt, mask, method=method), axis=-1)
        _check_within(out, want, qp, rqp, ps, rps, sv, ref.index_step(table))


def test_lut_reference_is_the_amr_lut_composition():
    """The lut reference runs amr_kernel at rank 0, which gives amr_lut's bits."""
    q, kt, v, mask = _t(_case(seed=7))
    nm = AMRNumerics("amr_lut", border=8)
    s = torch.where(mask, approx_matmul(q, kt, nm, site="attn.qk") / 4.0, ref.NEG_INF)
    want = approx_matmul(torch.softmax(s, dim=-1), v, nm, site="attn.pv")
    assert torch.equal(fused_attention_reference(q, kt, v, mask), want)


def test_methods_agree_on_float32():
    """On float32 inputs both quantizers give the same indices, and the
    paper's schedule replays its table: the two methods give the same bits."""
    tt = _t(_case(seed=8))
    assert torch.equal(fused_attention(*tt, method="lut"), fused_attention(*tt, method="inject"))


@pytest.mark.parametrize("t", [1, 5, 31, 32, 33, 64, 100, 257])
def test_lane_order_sum_is_the_warp_order(t):
    """lane_order_sum equals a float32 simulation of the kernels' warp: lane j
    adds columns j, j + 32, ... in order, then the xor-16/8/4/2/1 butterfly
    (each lane adds its partner's value to its own)."""
    x = np.random.default_rng(t).random((3, t)).astype(np.float32) * 10.0
    lanes = np.zeros((3, 32), np.float32)
    for c in range(t):
        lanes[:, c % 32] = lanes[:, c % 32] + x[:, c]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    got = ref.lane_order_sum(torch.from_numpy(x))
    assert got.shape == (3, 1)
    assert np.array_equal(got[:, 0].numpy(), lanes[:, 0])
    assert (lanes == lanes[:, :1]).all()  # every lane ends with the same bits


def test_largest_probability_is_one_over_the_sum():
    """The kernels take max|p| as fl(1 / sum): the largest score gives
    exp(0) = 1 and a correctly rounded division is monotone.  Checked on
    random rows with ties, fully masked rows and wide score ranges."""
    rng = np.random.default_rng(9)
    acc = torch.from_numpy(rng.integers(-5000, 5000, (4, 64, 300)).astype(np.int32))
    acc[0, :, :10] = acc[0, :, :1]                    # ties at the max
    mask = torch.from_numpy(rng.random((4, 64, 300)) < 0.7)
    mask[1, :5] = False                               # fully masked rows
    sq = torch.from_numpy(rng.random((4, 64, 1)).astype(np.float32) * 0.1)
    sk = torch.from_numpy(rng.random((4, 1, 300)).astype(np.float32) * 0.1)
    s = acc.float() * sq * sk / torch.tensor(2.0)
    s = torch.where(mask, s, ref.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    total = ref.lane_order_sum(e)
    assert torch.equal((e / total).amax(-1, keepdim=True), torch.ones_like(total) / total)
    assert torch.equal(total[1, :5], torch.full((5, 1), 300.0))


def test_kernel_wrappers_check_their_operands():
    q8, k8, v8, sq, sk, sv = ops.quantize_operands(*_t(_case())[:3], "lut")
    mask = torch.ones(3, 8, 32, dtype=torch.int32)
    table = tlut.table_tensor(8, torch.device("cpu"))
    with pytest.raises(TypeError, match="mask must be int32"):
        kernel.attn_fused_lut(q8, k8, v8, sq, sk, sv, mask.bool(), table, scale=4.0)
    with pytest.raises(ValueError, match="sk must be"):
        kernel.attn_fused_lut(q8, k8, v8, sq, sk[:, :, :-1], sv, mask, table, scale=4.0)
    with pytest.raises(TypeError, match="q must be"):
        kernel.attn_fused_lut(q8.float(), k8, v8, sq, sk, sv, mask, table, scale=4.0)
    with pytest.raises(ValueError, match="bm=3"):
        kernel.attn_fused_inject(tengine.get_injector(2, 8), q8, k8, v8, sq, sk, sv, mask,
                                 scale=4.0, bm=3)
    assert kernel.default_row_tile(1, 8192, "lut", 1024, 132) == 16
    assert kernel.default_row_tile(1, 2048, "lut", 256, 132) == 16
    assert kernel.default_row_tile(1, 2048, "inject", 256, 132) == 8
    assert kernel.default_row_tile(2, 8, "inject", 8192, 132) == 8
    assert kernel.default_row_tile(2, 8, "lut", 8192, 132) == 8
    assert kernel.default_row_tile(2, 8, "inject", 24, 132) == 1
    with pytest.raises(ValueError, match="depends on T"):
        kernel.default_row_tile(2, 8, "inject", 0, 132)
    assert kernel.default_row_tile(2, 8, "lut", 24, 132) == 1


def _fold(q, k, v):
    """(B, S, Hq, D) queries and (B, T, Hkv, D) keys and values folded as the
    seam folds them: (B Hkv, g S, D), (B Hkv, D, T), (B Hkv, T, D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qa = q.reshape(B, S, Hkv, g, D).transpose(0, 2, 3, 1, 4).reshape(B * Hkv, g * S, D)
    return (np.ascontiguousarray(qa), np.ascontiguousarray(k.transpose(0, 2, 3, 1).reshape(
        B * Hkv, D, T)), np.ascontiguousarray(v.transpose(0, 2, 1, 3).reshape(B * Hkv, T, D)))


def test_gemma_slice_matches_jax():
    """The slice as a whole: reduced gemma-2b's layer-0 attention inputs,
    projected in each package from the same numpy params (the JAX package's
    init), folded as the seam folds them and through each package's fused
    op under a causal mask.  The projections agree to float32 ulps and
    quantize to the same int8 operands here, so the bar is the one above."""
    jcfg = dataclasses.replace(jreduced(), dtype="float32")
    tcfg = dataclasses.replace(treduced(), dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens = np.random.default_rng(10).integers(0, jcfg.vocab, (2, 8))
    B, S = tokens.shape
    args = (jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim)

    jl = jax.tree.map(lambda t: t[0], jp["layers"][0])
    jh = jrms_norm(jembed(jp["embed"], jnp.asarray(tokens)), jl["ln1"], jcfg.norm_eps)
    jqkv = jproject(jl["attn"], jh, *args, jnp.broadcast_to(jnp.arange(S), (B, S)),
                    jcfg.rope_theta, jcfg.qk_norm, None, jcfg.norm_eps)
    tl = {k: v[0] for k, v in tp["layers"][0]["attn"].items()}
    th = trms_norm(tembed(tp["embed"], torch.from_numpy(tokens)), tp["layers"][0]["ln1"][0],
                   tcfg.norm_eps)
    tqkv = tproject(tl, th, *args, torch.arange(S).expand(B, S), tcfg.rope_theta,
                    tcfg.qk_norm, None, tcfg.norm_eps)
    jops = _fold(*(np.asarray(x) for x in jqkv))
    tops = _fold(*(x.numpy() for x in tqkv))
    for a, b in zip(jops, tops):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    g = jcfg.n_heads // jcfg.n_kv_heads
    causal = np.tile(np.tril(np.ones((S, S), bool)), (g, 1))[None].repeat(B, 0)
    tt = _t(tops) + [torch.from_numpy(causal)]
    q8, k8, v8, sq, sk, sv = ops.quantize_operands(*tt[:3], "lut")
    for mine, x, axis in ((q8, jops[0], -1), (k8, jops[1], -2), (v8, jops[2], -2)):
        assert np.array_equal(mine.numpy(), np.asarray(jquantize(jnp.asarray(x), axis=axis)[0]))
    table = tlut.table_tensor(8, torch.device("cpu"))
    acc = lut_matmul_ref(q8, k8, table)
    qp, ps = ref.softmax_requant(acc, sq, sk, tt[3].int(), float(jcfg.head_dim) ** 0.5)
    jqp, jps = _jax_kernel_indices(acc.numpy(), sq.numpy(), sk.numpy(),
                                   causal.astype(np.int32), float(jcfg.head_dim) ** 0.5)
    out = fused_attention(*tt)
    assert out.shape == (B, g * S, jcfg.head_dim)
    _check_within(out, torch.from_numpy(_jax_fused((*jops, causal))), qp, jqp, ps, jps, sv,
                  ref.index_step(table))
