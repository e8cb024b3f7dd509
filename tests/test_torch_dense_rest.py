"""The rest of the dense family, minitron-8b and qwen3-32b, against the JAX
package on their reduced configs, on the CPU.

Reduced minitron-8b (GQA 4 heads over 2 KV heads of 16, untied head) and
reduced qwen3-32b (the same, with ``qk_norm`` and ``rope_theta`` 1e6):
2 layers, d_model 64, vocab 256.  Both packages compute in float32 on the
same weights (the JAX package's ``init_params`` at seed 0 exported to
numpy, ``params_from_numpy``):

* the configs' fields, full and reduced, equal the JAX package's;
* ``forward`` logits, ``prefill_with_cache`` (logits and cache) of an
  8-token prompt at capacity 12 and 3 ``decode_step``s, under exact,
  ``amr_kernel`` rank 0 (JAX's rank 0 as its ``amr_lut`` oracle forward,
  ``tests/_jax_rank0.py``: no Pallas compile) and rank 8 (JAX's low-rank
  op with its kernel's plain reference, ``ref_lowrank_int8``, the same
  float32 math, in place of the Pallas interpret compile);
* ``ServeEngine`` token streams equal to the JAX engine's (rank 0, the
  served path's mode);
* batched == solo inside the port, tokens and float32 logits bit for bit.

Tolerance: |port - jax| <= 1e-4 everywhere, rank 8 included.  No int8
index sits at a rounding tie with these weights and inputs, so no tie is
named and no correlation rule is needed: rank 8's float32 sums are
ordered differently in the two packages (about 1e-6 apart), which would
move an index only at a tie.
"""
import contextlib
import dataclasses
import importlib
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import lut as jlut
from repro.kernels.amr_matmul import ops as jops
from repro.kernels.amr_matmul.ref import ref_lowrank_int8
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.numerics import AMRNumerics as JN
from repro.numerics.quant import quantize_int8 as jquantize
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config, get_reduced_config, validate_config
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.serve import Request, ServeEngine

from _jax_rank0 import oracle_rank0
from _torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = {"minitron-8b": "minitron_8b", "qwen3-32b": "qwen3_32b"}
MODES = [("exact", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
PROMPT, CAP, STEPS = 8, 12, 3


def _jmod(arch):
    return importlib.import_module(f"repro.configs.{ARCHS[arch]}")


def _field(cfg, name):
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch):
    jmod = _jmod(arch)
    full, red = get_config(arch), get_reduced_config(arch)
    for f in dataclasses.fields(full):
        if f.name != "numerics":
            assert _field(full, f.name) == _field(jmod.CONFIG, f.name), f.name
            assert _field(red, f.name) == _field(jmod.reduced(), f.name), f.name
    assert validate_config(full) is full and validate_config(red) is red


@lru_cache(maxsize=None)
def _setup(arch, mode):
    jcfg = dataclasses.replace(_jmod(arch).reduced(), dtype="float32", numerics=JN(*mode))
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32", numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _lowrank_by_ref(a, b, *, border, rank, method, **_tiling):
    """JAX's ``ops._amr_matmul_jit`` for the low-rank method with the
    kernel's plain reference: quantize, ``ref_lowrank_int8``, rescale."""
    qa, sa = jquantize(a, axis=-1)
    qb, sb = jquantize(b, axis=0)
    u, v = jlut.factor_arrays(border, rank)
    return ref_lowrank_int8(qa, qb, u, v) * sa * sb


@contextlib.contextmanager
def _jax_numerics(mode):
    """JAX's rank 0 through its oracle and rank 8 through its low-rank
    kernel's plain reference (no Pallas compile); exact as it is."""
    if mode[0] != "amr_kernel":
        yield
    elif mode[2] == 0:
        with oracle_rank0():
            yield
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jops, "_amr_matmul_jit", _lowrank_by_ref)
            yield


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert np.abs(got - ref).max() <= 1e-4, (what, np.abs(got - ref).max())


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, mode):
    jcfg, jp, tcfg, tp = _setup(arch, mode)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, PROMPT))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    with _jax_numerics(mode):
        # one compile for the forward and the prefill, one for the decode step
        jf, (jl, jc) = jax.jit(lambda p, t: (jforward(jcfg, p, t)[0],
                                             jprefill(jcfg, p, t, CAP)))(jp, jt)
        step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
        with torch.inference_mode():
            _close(tforward(tcfg, tp, tt)[0], jf, "forward")
            tl, tc = tprefill(tcfg, tp, tt, CAP)
        _close(tl, jl, "prefill")
        for t_kv, j_kv in zip(tc, jc):
            _close(t_kv.k, j_kv.k, "cache k")
            _close(t_kv.v, j_kv.v, "cache v")
            np.testing.assert_array_equal(t_kv.length.numpy(), np.asarray(j_kv.length))
        tok = toks[:, -1:]
        for i in range(STEPS):
            jl, jc = step(jp, jnp.asarray(tok, jnp.int32), jc)
            with torch.inference_mode():
                tl, tc = tdecode(tcfg, tp, torch.from_numpy(tok), tc)
            _close(tl, jl, f"decode step {i}")
            tok = _np(jl)[:, -1].argmax(-1)[:, None]  # both continue from the JAX choice


def test_qk_norm_is_read():
    """qwen3-32b's q_norm and k_norm reach the logits (a zero scale is
    the identity of the (1 + scale) form, so set them apart from it)."""
    _, _, tcfg, tp = _setup("qwen3-32b", MODES[0])
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (1, 6)))
    with torch.inference_mode():
        base = tforward(tcfg, tp, toks)[0]
        moved = {**tp, "layers": tuple({**lp, "attn": {**lp["attn"],
                                                      "q_norm": lp["attn"]["q_norm"] + 0.5}}
                                       for lp in tp["layers"])}
        assert not torch.equal(tforward(tcfg, moved, toks)[0], base)


# ---------------------------------------------------------------- the engine
ENGINE_CAP = 16
PROMPTS = [(5, 9, 2, 7, 1, 3), (3, 11, 4, 1, 8, 6), (13, 2, 7, 9, 5, 1)]  # one prompt length
GENS = [3, 4, 2]


def _serve(engine_cls, request_cls, cfg, params, n_slots, **kw):
    eng = engine_cls(cfg, params, n_slots=n_slots, capacity=ENGINE_CAP, **kw)
    for p, g in zip(PROMPTS, GENS):
        eng.submit(request_cls(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_token_streams_match_jax_engine(arch):
    mode = MODES[1]
    jcfg, jp, tcfg, tp = _setup(arch, mode)
    with _jax_numerics(mode):
        ref = _serve(JEngine, JRequest, jcfg, jp, 2)
    got = _serve(ServeEngine, Request, tcfg, tp, 2, device="cpu")
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in ref]


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_decode_bit_identical_to_solo(arch, mode):
    _, _, tcfg, tp = _setup(arch, mode)
    batched = _serve(ServeEngine, Request, tcfg, tp, 3, record_logits=True, device="cpu")
    solo = _serve(ServeEngine, Request, tcfg, tp, 1, record_logits=True, device="cpu")
    assert [len(c.tokens) for c in batched] == GENS
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)
