"""The port's Mamba2 SSM path against the JAX package on reduced mamba2-370m.

Inputs are made with numpy from a seed and handed to both packages; the
model tests load the JAX package's ``init_params`` through
``params_from_numpy``.

Tolerances:
* the plain SSD scan against JAX ``ssd_chunked`` and against the Pallas
  kernel in interpret mode: rtol = atol = 2e-4 in float32, the bound the
  JAX package's own interpret test states (float32 sums and the cumulative
  log decay run in another order); 0.05 with bf16 inputs, as there;
* the model: the tolerances and reasons of ``tests/test_torch_model.py``:
  float32 1e-4; bf16 exact 0.1; bf16 AMR correlation >= 0.98 and mean
  |port - jax| <= 0.2 * mean |jax| (reduced gemma-2b: 0.15; reduced mamba2
  runs 28 quantized sites in sequence to gemma's 18, and its index flips
  add up to 0.165 on these inputs);
* float32 under ``amr_kernel`` rank 8: the dense sums are float32 in
  another order, and a one-ulp difference upstream of an int8 quantizer
  moves an index by one step (seen at one of 40 prompt positions, whose
  logits then differ by 0.06), so these logits take the bf16 AMR criterion;
* the float32 SSM state under bf16 AMR numerics sums the prompt's bf16
  conv outputs, each with its index flips, and most of its entries are
  near zero, so a mean ratio says little there: correlation >= 0.95 (0.980
  to 0.987 measured on these inputs); the logits that read it take the
  criterion above.

The engine tests are in ``tests/test_torch_ssm_serve.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.mamba2_370m import reduced as jreduced
from repro.kernels.ssd_scan.ops import ssd_mixer as jssd_mixer
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.models import ssm as jssm
from repro.numerics import AMRNumerics as JN
from repro_torch.configs.mamba2_370m import reduced as treduced
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan.ops import decay_weighted_c
from repro_torch.kernels.ssd_scan.ref import ssd_carried, ssd_error_bound, ssd_ref
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tree import tree_map
from repro_torch.numerics import AMRNumerics as TN

from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_lut", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8),
         ("amr_inject", 8, 8)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
CAP = 24
_COMPILE = {"xla_allow_excess_precision": False}


def _scan_inputs(B, S, H, P, N, G, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(dtype),
            rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            rng.uniform(0.0, 1.5, (H,)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(dtype),
            rng.normal(size=(B, S, G, N)).astype(dtype))


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- the scan
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (2, 40, 4, 8, 16, 2, 16),      # G < H, S off the grid (padded tail)
    (1, 5, 4, 16, 8, 4, 16),       # shorter than one chunk, G = H
    (2, 96, 8, 16, 32, 2, 32),     # on the grid, 3 chunks
])
def test_plain_ssd_matches_jax_chunked(B, S, H, P, N, G, chunk):
    arrs = _scan_inputs(B, S, H, P, N, G, seed=B * S + H)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk, return_state=True)
    ty, th = ssd_ref(*map(torch.from_numpy, arrs), chunk)
    _close(ty, jy)
    _close(th, jh)
    # h_prev: the state before chunk i is the final state of the first i
    # chunks (checked at the last chunk, which carries all earlier ones)
    y_intra, h_prev, h_final = ssd_ref(*map(torch.from_numpy, arrs), chunk, split=True)
    assert torch.equal(h_final, th)
    nc = -(-S // chunk)
    assert h_prev.shape == (B, nc, H, N, P)
    assert not h_prev[:, 0].any()
    if nc > 1:
        prefix = [a[:, :(nc - 1) * chunk] if a.ndim > 1 else a for a in arrs]
        _, jh = jssm.ssd_chunked(*map(jnp.asarray, prefix), chunk, return_state=True)
        _close(h_prev[:, -1], jh)
    # split mode: y_intra plus the exact readout is the full y
    dc = decay_weighted_c(torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]),
                          torch.from_numpy(arrs[4]), chunk, H)
    inter = torch.matmul(dc, h_prev).permute(0, 1, 3, 2, 4).reshape(B, -1, H, P)[:, :S]
    _close(y_intra + inter, ty, 1e-5)


@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (1, 128, 2, 64, 64, 1, 64),
    (2, 256, 4, 32, 16, 2, 128),
    (2, 128, 8, 16, 32, 8, 32),
])
def test_plain_ssd_matches_jax_pallas_interpret(B, S, H, P, N, G, chunk):
    """The JAX kernel (its ``ssd_mixer`` expands the groups) in interpret mode
    against the port's wrapper, which takes the groups as they are."""
    arrs = _scan_inputs(B, S, H, P, N, G, seed=S + H)
    want = jssd_mixer(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    got, _ = skernel.ssd_scan(*map(torch.from_numpy, arrs), chunk)
    _close(got, want)


def test_plain_ssd_bf16_inputs():
    import ml_dtypes

    arrs = _scan_inputs(1, 80, 2, 32, 32, 1, seed=9)
    x, dt, a, b, c = arrs
    xb, bb, cb = (v.astype(ml_dtypes.bfloat16) for v in (x, b, c))
    want = jssm.ssd_chunked(jnp.asarray(xb), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bb),
                            jnp.asarray(cb), 32)
    tb = [torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for v in (x, b, c)]
    got, _ = ssd_ref(tb[0], torch.from_numpy(dt), torch.from_numpy(a), tb[1], tb[2], 32)
    assert got.dtype == torch.float32
    _close(got, want, 0.05)


def test_state_carries_across_chunks():
    """An impulse at t = 0 reaches rows in later chunks, in the full and the
    split form, and the padded tail (dt = 0) leaves the state unchanged."""
    B, S, H, P, N, chunk = 1, 200, 1, 8, 8, 64
    x = torch.zeros((B, S, H, P))
    x[0, 0, 0] = 1.0
    dt = torch.full((B, S, H), 0.05)
    a_log = torch.tensor([0.1])
    b = torch.ones((B, S, 1, N))
    c = torch.ones((B, S, 1, N))
    y, h = ssd_ref(x, dt, a_log, b, c, chunk)
    assert y[0, chunk + 5].abs().sum() > 0
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(t.numpy()) for t in (x, dt, a_log, b, c)), chunk,
                              return_state=True)
    _close(y, jy)
    _close(h, jh)
    # state after 200 rows equals the state of the same 200 rows padded to 256
    _, h_grid = ssd_ref(*(torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, 56))
                          for t in (x, dt)), a_log,
                        *(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 56)) for t in (b, c)),
                        chunk)
    assert torch.equal(h_grid, h)


def _bound_inputs(B, S, H, P, N, G, chunk, carry, seed):
    """a_log at its init; dt as the model makes it (softplus of a
    projection), or scaled per head so that a chunk decays the state by
    exp(-0.5) on average (the inputs of the card's carry check)."""
    rng = np.random.default_rng(seed)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    if carry:
        dt = rng.uniform(0.0, 1.0, (B, S, H)) / (np.exp(a_log) * chunk)
    else:
        dt = np.logaddexp(rng.normal(size=(B, S, H)), 0.0)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32), dt.astype(np.float32), a_log,
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32))


_BOUND_SHAPE = (2, 300, 8, 32, 64, 2, 128)  # G < H, 3 chunks, the last ragged


@pytest.mark.parametrize("carry", [False, True], ids=["model-dt", "carry"])
def test_error_bound_admits_jax_and_rejects_tf32_rounding(carry):
    """``ssd_error_bound`` admits another float32 implementation (JAX's
    ``ssd_chunked``, its sums in another order); on inputs whose carried
    state shows, it rejects x dt rounded as TF32 would round it."""
    *shape, chunk = _BOUND_SHAPE
    arrs = _bound_inputs(*shape, chunk, carry, seed=4)
    targs = tuple(map(torch.from_numpy, arrs))
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk, return_state=True)
    want = ssd_ref(*targs, chunk)
    bounds = ssd_error_bound(*targs, chunk)
    for j, w, bd in zip((jy, jh), want, bounds):
        assert bool(((torch.from_numpy(np.array(j)) - w).abs() <= bd).all())
    if carry:
        xdt = targs[0] * targs[1][..., None]
        tf32 = ((xdt.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
        x_tf32 = (tf32.double() / targs[1][..., None].double()).float()
        got = ssd_ref(x_tf32, *targs[1:], chunk)
        assert max(float(((g - w).abs() / bd).max()) for g, w, bd in zip(got, want, bounds)) > 1


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_carried_part_is_what_a_carry_free_scan_misses(split):
    """``ssd_carried``: each output less its carried part is what the scan
    gives with the state reset to 0 at the chunk's start, and on the carry
    inputs the carried part exceeds the error bound a hundredfold."""
    *shape, chunk = _BOUND_SHAPE
    S = shape[1]
    targs = tuple(map(torch.from_numpy, _bound_inputs(*shape, chunk, True, seed=5)))
    outs = ssd_ref(*targs, chunk, split=split)
    carried = ssd_carried(*targs, chunk, split=split)
    bounds = ssd_error_bound(*targs, chunk, split=split)

    def alone(c0):  # the scan over chunk c0 alone, from a zero state
        rows = slice(c0 * chunk, min(S, (c0 + 1) * chunk))
        return ssd_ref(targs[0][:, rows], targs[1][:, rows], targs[2], targs[3][:, rows],
                       targs[4][:, rows], chunk)

    nc = -(-S // chunk)
    last_y, last_h = alone(nc - 1)
    _close(outs[-1] - carried[-1], last_h, 1e-5)
    if split:
        assert not carried[0].any()
        for ci in range(1, nc):
            _close(outs[1][:, ci] - carried[1][:, ci], alone(ci - 1)[1], 1e-5)
    else:
        _close((outs[0] - carried[0])[:, (nc - 1) * chunk:], last_y, 1e-5)
    seen = [float((cr.abs() / bd).max()) for cr, bd in zip(carried, bounds)]
    assert min(seen[1:] if split else seen) >= 100.0, seen


def test_wrapper_routes_cpu_to_plain_and_checks_shapes():
    arrs = [torch.from_numpy(a) for a in _scan_inputs(1, 20, 4, 16, 8, 2, seed=1)]
    before = skernel.SSD.launches
    for split in (False, True):
        got = skernel.ssd_scan(*arrs, 16, split=split)
        want = ssd_ref(*arrs, 16, split=split)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert skernel.SSD.launches == before  # the CPU route launches nothing
    with pytest.raises(ValueError, match="disagree"):
        skernel.ssd_scan(arrs[0], arrs[1][:, :-1], *arrs[2:], 16)


# ----------------------------------------------------------------- the mixer
def _mixer_setup(dtype):
    cfg = treduced()
    jp = jssm.init_ssm(jax.random.PRNGKey(3), cfg.d_model, jreduced().ssm, jnp.dtype(dtype))
    specs = tssm.ssm_param_specs(cfg.d_model, cfg.ssm, getattr(torch, dtype), lambda *s: s)
    tp = {k: torch.from_numpy(np.asarray(jp[k]).astype(np.float32)).to(specs[k][1]) for k in jp}
    assert set(tp) == set(specs) and all(tp[k].shape == specs[k][0] for k in tp)
    return cfg, jp, tp


@pytest.mark.parametrize("mode", [MODES[0], MODES[2]], ids=_IDS)
def test_ssm_mixer_forward_prefill_decode_match_jax(mode):
    cfg, jp, tp = _mixer_setup("float32")
    jcfg = jreduced().ssm
    jnm, tnm = JN(*mode), TN(*mode)
    xin = np.random.default_rng(4).normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xin), torch.from_numpy(xin)
    jforward_ = jax.jit(lambda p, x: jssm.ssm_forward(p, x, cfg.d_model, jcfg, jnm))
    jprefill_ = jax.jit(lambda p, x: jssm.ssm_prefill(p, x, cfg.d_model, jcfg, jnm))
    jdecode_ = jax.jit(lambda p, x, s: jssm.ssm_decode(p, x, s, cfg.d_model, jcfg, jnm))
    _close(tssm.ssm_forward(tp, tx, cfg.d_model, cfg.ssm, tnm), jforward_(jp, jx), 1e-4)
    ty, ts = tssm.ssm_prefill(tp, tx, cfg.d_model, cfg.ssm, tnm)
    jy, js = jprefill_(jp, jx)
    _close(ty, jy, 1e-4)
    for name in ("conv_x", "conv_b", "conv_c", "h"):
        _close(getattr(ts, name), getattr(js, name), 1e-4)
    step = np.random.default_rng(5).normal(size=(3, 2, 1, cfg.d_model)).astype(np.float32)
    for s in step:
        ty, ts = tssm.ssm_decode(tp, torch.from_numpy(s), ts, cfg.d_model, cfg.ssm, tnm)
        jy, js = jdecode_(jp, jnp.asarray(s), js)
        _close(ty, jy, 1e-4)
        _close(ts.h, js.h, 1e-4)


def test_softplus_and_conv_follow_jax():
    x = np.linspace(-30, 30, 101).astype(np.float32)
    _close(tssm._softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), 1e-6)
    rng = np.random.default_rng(6)
    xs, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 9, 12), (4, 12), (12,)))
    _close(tssm._causal_conv(*map(torch.from_numpy, (xs, w, b))),
           jssm._causal_conv(*map(jnp.asarray, (xs, w, b))), 1e-6)


# ----------------------------------------------------------------- the model
def _configs(mode, dtype, seed=0):
    jcfg = dataclasses.replace(jreduced(), dtype=dtype, numerics=JN(*mode))
    tcfg = dataclasses.replace(treduced(), dtype=dtype, numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_COMPILE)(*args)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _check(got, ref, dtype, mode, state=False):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(got - ref)
    float_sums = mode[0] == "amr_kernel" and mode[2] > 0
    exact = mode[0] == "exact"
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1] if diff.max() > 0 else 1.0
    statistical = corr >= 0.98 and diff.mean() <= 0.2 * np.abs(ref).mean()
    if dtype == "float32" and not float_sums:
        assert diff.max() <= 1e-4, diff.max()
    elif exact:
        assert diff.max() <= 0.1, diff.max()
    elif state:
        assert corr >= 0.95, corr
    else:
        assert statistical, (corr, diff.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_forward_prefill_decode_match_jax(mode, dtype):
    jcfg, jp, tcfg, tp = _configs(mode, dtype)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 20))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    # one JAX compile for the forward and the prefill
    jf, (jl, jc) = _jit(lambda p, t: (jforward(jcfg, p, t)[0], jprefill(jcfg, p, t, CAP)),
                        jp, jt)
    with torch.inference_mode():
        _check(tforward(tcfg, tp, tt)[0], jf, dtype, mode)
        tl, tc = tprefill(tcfg, tp, tt, CAP)
    _check(tl, jl, dtype, mode)
    for j_st, t_st in zip(jc, tc):
        for name in ("conv_x", "conv_b", "conv_c", "h"):
            _check(getattr(t_st, name), getattr(j_st, name), dtype, mode, state=name == "h")

    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c)).lower(jp, jt[:, -1:], jc).compile(
        _COMPILE)
    tok = toks[:, -1:]
    for _ in range(3):
        jl, jc = step(jp, jnp.asarray(tok, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tdecode(tcfg, tp, torch.from_numpy(tok), tc)
        _check(tl, jl, dtype, mode)
        tok = _np(jl)[:, -1].argmax(-1)[:, None]  # both continue from the JAX choice
    _check(tc[0].h, jc[0].h, dtype, mode, state=True)


def test_params_layout_and_float32_leaves():
    cfg = treduced()
    jp = jax.tree.map(np.asarray, jinit(jreduced(), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, cfg, "cpu")
    layer = tp["layers"][0]
    assert set(layer) == {"ln1", "ln2", "ssm"}
    for name in ("a_log", "dt_bias", "d_skip", "norm"):
        assert layer["ssm"][name].dtype == torch.float32
        np.testing.assert_array_equal(layer["ssm"][name].numpy(), jp["layers"][0]["ssm"][name])
    assert layer["ssm"]["wx"].dtype == torch.bfloat16
    own = tinit(cfg, 0, device="cpu")["layers"][0]["ssm"]
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == tree_map(
        lambda t: (tuple(t.shape), t.dtype), layer["ssm"])
    _close(own["a_log"], jp["layers"][0]["ssm"]["a_log"], 1e-6)
    assert torch.equal(own["d_skip"], torch.ones_like(own["d_skip"]))
