"""The port's gemma3-1b against the JAX package on the reduced config.

Reduced gemma3-1b: 4 layers, ("swa", "full") x 2, d_model 64, 2 heads and
1 KV head of 16, window 8.  Both packages compute on the same weights (the
JAX package's ``init_params`` exported to numpy), in float32:

* ``forward`` logits, then ``prefill_with_cache`` of a 12-token prompt
  (capacity 20: the sliding-window layers' 8-slot ring rolls in prefill)
  and 6 ``decode_step``s (the ring wraps), on logits and caches;
* the ring's first fill: prompts of 7, 8 and 9 tokens;
* ``ServeEngine`` token streams against the JAX engine's, and batched ==
  solo inside the port;
* ``_chunked_attention`` against the JAX function at S = 4096 (two query
  blocks), and the route that decides between the chunked and the
  one-block form.

Tolerances:
* exact and ``amr_kernel`` rank 0: |port - jax| <= 1e-4 (they agree to
  about 3e-6: float32 order and transcendental ulps, no int8 index flips);
* ``amr_kernel`` rank 8: the packages sum the float32 augmented-K product
  of ``attn.qk`` / ``attn.pv`` in other orders (about 5e-7 apart), and at a
  rounding tie that moves an int8 index: with these weights one attn.pv
  probability of layer 3 sits at 115.49995 steps in JAX and just above
  115.5 in the port.  A moved index moves every later layer, so rank-8
  logits and caches are held by the statistical rule of
  ``tests/test_torch_model.py`` (correlation >= 0.98, mean |diff| <= 0.15
  * mean |jax|), and chunked attention at S = 4096 by |diff| <= 1e-4 *
  max |jax| (sums of 4096 * 9 lanes, outputs up to about 400);
* batched vs solo: tokens and float32 logits bit for bit.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.gemma3_1b import reduced as jreduced
from repro.models import attention as jattn
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.numerics import AMRNumerics as JN
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs.gemma3_1b import reduced as treduced
from repro_torch.models import attention as tattn
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.serve import Request, ServeEngine

from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
WINDOW = 8
PROMPT, CAP, STEPS = 12, 20, 6


@lru_cache(maxsize=None)
def _setup(mode):
    jcfg = dataclasses.replace(jreduced(), dtype="float32", numerics=JN(*mode))
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _check(got, ref, tight: bool):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(got - ref)
    if tight:
        assert diff.max() <= 1e-4, diff.max()
    else:
        corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
        assert corr >= 0.98 and diff.mean() <= 0.15 * np.abs(ref).mean(), (corr, diff.mean())


def _check_cache(tc, jc, tight: bool):
    for t_kv, j_kv in zip(tc, jc):
        _check(t_kv.k, j_kv.k, tight)
        _check(t_kv.v, j_kv.v, tight)
        np.testing.assert_array_equal(t_kv.length.numpy(), np.asarray(j_kv.length))


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_forward_prefill_decode_match_jax(mode):
    jcfg, jp, tcfg, tp = _setup(mode)
    tight = mode[2] == 0 or mode[0] == "exact"
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, PROMPT))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)

    with torch.inference_mode():
        _check(tforward(tcfg, tp, tt)[0], jax.jit(lambda p, t: jforward(jcfg, p, t)[0])(jp, jt),
               tight)
        tl, tc = tprefill(tcfg, tp, tt, CAP)
    jl, jc = jax.jit(lambda p, t: jprefill(jcfg, p, t, CAP))(jp, jt)
    _check(tl, jl, tight)
    assert [tuple(c.k.shape[2:3]) for c in tc] == [(WINDOW,), (CAP,)]  # (n_repeat, B, C, ...)
    _check_cache(tc, jc, tight)

    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    tok = toks[:, -1:]
    for _ in range(STEPS):
        jl, jc = step(jp, jnp.asarray(tok, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tdecode(tcfg, tp, torch.from_numpy(tok), tc)
        _check(tl, jl, tight)
        _check_cache(tc, jc, tight)
        tok = _np(jl)[:, -1].argmax(-1)[:, None]  # both continue from the JAX choice


@pytest.mark.parametrize("S", [WINDOW - 1, WINDOW, WINDOW + 1])
def test_ring_first_fill(S):
    """Prompts one short of the window (the ring pads), of the window (it
    fills at slot 0 with no roll) and one past it (it rolls by 1): the
    caches and 3 decode steps against JAX, and the decode logits against
    the port's own forward over the whole sequence (exact numerics)."""
    jcfg, jp, tcfg, tp = _setup(MODES[0])
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S + 3))
    cap = S + 4
    with torch.inference_mode():
        full = tforward(tcfg, tp, torch.from_numpy(toks))[0].numpy()
        tl, tc = tprefill(tcfg, tp, torch.from_numpy(toks[:, :S]), cap)
    jl, jc = jax.jit(lambda p, t: jprefill(jcfg, p, t, cap))(jp, jnp.asarray(toks[:, :S]))
    assert tc[0].k.shape[2] == min(cap, WINDOW) and tc[1].k.shape[2] == cap
    _check(tl, jl, True)
    _check_cache(tc, jc, True)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, S - 1], atol=1e-4)
    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    for i in range(S, S + 3):
        jl, jc = step(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        with torch.inference_mode():
            tl, tc = tdecode(tcfg, tp, torch.from_numpy(toks[:, i:i + 1]), tc)
        _check(tl, jl, True)
        _check_cache(tc, jc, True)
        np.testing.assert_allclose(tl[:, -1].numpy(), full[:, i], atol=1e-4)


def test_inactive_slot_keeps_both_rings():
    """A masked decode step advances the active slot's window ring and
    global cache and leaves the inactive slot's, of both capacities, bit
    for bit."""
    _, _, tcfg, tp = _setup(MODES[1])
    with torch.inference_mode():
        _, c0 = tprefill(tcfg, tp, torch.arange(2 * PROMPT).reshape(2, PROMPT), CAP)
        for leaf in c0:
            leaf.length = leaf.length[:, None].expand(-1, 2).clone()
        _, c1 = tdecode(tcfg, tp, torch.tensor([[3], [4]]), c0,
                        active=torch.tensor([True, False]))
    for old, new in zip(c0, c1):
        assert torch.equal(new.k[:, 1], old.k[:, 1]) and torch.equal(new.v[:, 1], old.v[:, 1])
        assert not torch.equal(new.k[:, 0], old.k[:, 0])
        assert new.length[:, 0].tolist() == [PROMPT + 1] * 2
        assert new.length[:, 1].tolist() == [PROMPT] * 2


# ---------------------------------------------------------------- the engine
ENGINE_CAP = 24
# two prompt lengths (the JAX engine compiles a prefill per length): past
# the window (the ring rolls in prefill) and short of it (it wraps in decode)
PROMPTS = [(5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 11), (3, 11, 4, 1, 8, 6), (13, 2, 7, 9, 5, 1),
           (9, 7, 9, 1, 2, 12, 8, 3, 5, 10, 4)]
GENS = [3, 4, 2, 3]  # request 1 writes positions 6-8: its rings wrap in decode


def _serve(engine_cls, request_cls, cfg, params, n_slots, **kw):
    eng = engine_cls(cfg, params, n_slots=n_slots, capacity=ENGINE_CAP, **kw)
    for p, g in zip(PROMPTS, GENS):
        eng.submit(request_cls(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("mode", MODES[:2], ids=_IDS)
def test_token_streams_match_jax_engine(mode):
    jcfg, jp, tcfg, tp = _setup(mode)
    ref = _serve(JEngine, JRequest, jcfg, jp, 2)
    got = _serve(ServeEngine, Request, tcfg, tp, 2, device="cpu")
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in ref]


# amr_inject's batched == solo is held on the card (chip_smoke phase 8): its
# plain replay is the slowest CPU path of the port
@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_batched_decode_bit_identical_to_solo(mode):
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN(*mode))
    tp = _setup(MODES[0])[3]
    batched = _serve(ServeEngine, Request, tcfg, tp, 3, record_logits=True, device="cpu")
    solo = _serve(ServeEngine, Request, tcfg, tp, 1, record_logits=True, device="cpu")
    assert [len(c.tokens) for c in batched] == GENS
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)


# ------------------------------------------------------- chunked attention
def _qkv(S, Hq=2, Hkv=1, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("mode", [MODES[0], MODES[2]], ids=_IDS)
def test_chunked_attention_matches_jax(mode, window):
    """S = 4096: two blocks of 2048 queries against the whole of K and V."""
    q, k, v = _qkv(4096)
    ref = np.asarray(jax.jit(lambda *a: jattn._chunked_attention(*a, window, JN(*mode)))(q, k, v))
    with torch.inference_mode():
        got = tattn._chunked_attention(*map(torch.from_numpy, (q, k, v)), window,
                                       torch.float32, TN(*mode)).numpy()
    assert got.shape == ref.shape == (1, 4096, 2, 16)
    tol = 1e-4 if mode[0] == "exact" else 1e-4 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()


@pytest.mark.parametrize("window", [0, WINDOW])
def test_chunked_blocks_bit_identical_at_rank0(monkeypatch, window):
    """At rank 0 the integer products are exact and quantization runs per
    query row and per K / V column over the whole sequence, so query blocks
    (here 4 of 8 queries) give the one-block result bit for bit; both hold
    to the JAX package's blocks within 1e-4."""
    monkeypatch.setattr(tattn, "_Q_CHUNK", 8)
    monkeypatch.setattr(jattn, "_Q_CHUNK", 8)
    nm = ("amr_kernel", 8, 0)
    q, k, v = _qkv(32, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with torch.inference_mode():
        blocks = tattn._chunked_attention(tq, tk, tv, window, torch.float32, TN(*nm))
        whole = tattn._attend_rows(tq, tk, tv, torch.arange(32), window, torch.float32, TN(*nm))
    assert torch.equal(blocks, whole)
    ref = np.asarray(jax.jit(lambda *a: jattn._chunked_attention(*a, window, JN(*nm)))(q, k, v))
    assert np.abs(blocks.numpy() - ref).max() <= 1e-4


@pytest.mark.parametrize("S,chunked", [(16384, True), (18432, True), (16385, False),
                                       (17408, False), (16383, False), (4096, False)])
def test_attention_route(monkeypatch, S, chunked):
    """The JAX package's condition: S >= 16384 and a multiple of 2048; every
    other length runs in one block (none raises).  Read from the call that
    is made, with both forms stubbed out."""
    calls = []
    monkeypatch.setattr(tattn, "_chunked_attention", lambda *a: calls.append("chunked"))
    monkeypatch.setattr(tattn, "_attend_rows", lambda *a: calls.append("one block"))
    x = torch.zeros(1, S, 1, 1)
    tattn._causal_attention(x, x, x, WINDOW, torch.float32, None)
    assert calls == ["chunked" if chunked else "one block"]
    assert tattn.takes_chunked_path(S) == chunked
