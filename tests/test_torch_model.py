"""The port's dense decoder against the JAX package on reduced gemma-2b.

Both packages compute on the same weights: the JAX package's
``init_params`` exported to numpy and loaded with ``params_from_numpy``.
``forward``, ``prefill_with_cache`` (logits and cache) and three
``decode_step``s are compared per numerics mode, in float32 and bfloat16.

Tolerances:
* float32: |port - jax| <= 1e-4 on logits and cache (they agree to about
  3e-6: float32 order and transcendental ulps, and no int8 index flips);
* bfloat16, exact: |port - jax| <= 0.1 (bf16 ulps through 2 layers);
* bfloat16, amr_kernel: a one-ulp bf16 difference upstream of an int8
  quantizer moves indices by one step, so logits are held statistically:
  correlation >= 0.98 and mean |port - jax| <= 0.15 * mean |jax|.  The JAX
  side is compiled with ``xla_allow_excess_precision=False`` so that every
  bf16 op rounds as its source says: by default XLA on the CPU keeps the
  quantizer's bf16 scale in float32, which the port does not copy.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.gemma_2b import reduced as jreduced
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.numerics import AMRNumerics as JN
from repro.train.steps import make_prefill_step as jprefill_step
from repro_torch.configs.gemma_2b import reduced as treduced
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.train.steps import make_prefill_step as tprefill_step

from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8)]
CAP = 12
_COMPILE = {"xla_allow_excess_precision": False}


def _configs(mode, dtype):
    jcfg = dataclasses.replace(jreduced(), dtype=dtype, numerics=JN(*mode))
    tcfg = dataclasses.replace(treduced(), dtype=dtype, numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_COMPILE)(*args)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _check(got, ref, dtype, exact):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(got - ref)
    if dtype == "float32":
        assert diff.max() <= 1e-4, diff.max()
    elif exact:
        assert diff.max() <= 0.1, diff.max()
    else:
        corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
        assert corr >= 0.98 and diff.mean() <= 0.15 * np.abs(ref).mean(), (corr, diff.mean())


def _field(cfg, name):
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("arch", ["gemma_2b", "gemma3_1b", "mamba2_370m", "amr_paper", "dbrx_132b",
                                  "moonshot_16b_a3b"])
def test_config_fields_match_jax(arch):
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    for f in dataclasses.fields(tmod.CONFIG):
        if f.name != "numerics":
            assert _field(tmod.CONFIG, f.name) == _field(jmod.CONFIG, f.name), f.name
            assert _field(tmod.reduced(), f.name) == _field(jmod.reduced(), f.name), f.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{m[0]}-r{m[2]}")
def test_forward_prefill_decode_match_jax(mode, dtype):
    jcfg, jp, tcfg, tp = _configs(mode, dtype)
    exact = tcfg.numerics.is_exact()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 8))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)

    with torch.inference_mode():
        _check(tforward(tcfg, tp, tt)[0], _jit(lambda p, t: jforward(jcfg, p, t)[0], jp, jt),
               dtype, exact)
        tl, tc = tprefill(tcfg, tp, tt, CAP)
    jl, jc = _jit(lambda p, t: jprefill(jcfg, p, t, CAP), jp, jt)
    _check(tl, jl, dtype, exact)
    for j_kv, t_kv in zip(jc, tc):
        _check(t_kv.k, j_kv.k, dtype, exact)
        _check(t_kv.v, j_kv.v, dtype, exact)
        np.testing.assert_array_equal(t_kv.length.numpy(), np.asarray(j_kv.length))

    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c)).lower(jp, jt[:, -1:], jc).compile(
        _COMPILE)
    tok = toks[:, -1:]
    for _ in range(3):
        jl, jc = step(jp, jnp.asarray(tok, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tdecode(tcfg, tp, torch.from_numpy(tok), tc)
        _check(tl, jl, dtype, exact)
        tok = _np(jl)[:, -1].argmax(-1)[:, None]  # both continue from the JAX choice
    np.testing.assert_array_equal(tc[0].length.numpy(), np.asarray(jc[0].length))


def test_params_from_numpy_rejects_mismatched_tree():
    jcfg, jp, tcfg, _ = _configs(MODES[0], "float32")
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, tcfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tree, tcfg, "cpu")


def test_init_params_layout_and_seed():
    cfg = treduced()
    p1, p2 = tinit(cfg, 3, device="cpu"), tinit(cfg, 3, device="cpu")
    assert p1["layers"][0]["mlp"]["w_gate"].shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert p1["layers"][0]["attn"]["wk"].dtype == torch.bfloat16
    assert p1["final_norm"].dtype == torch.float32
    assert torch.equal(p1["embed"], p2["embed"])
    assert not torch.equal(p1["embed"], tinit(cfg, 4, device="cpu")["embed"])


@pytest.mark.parametrize("mode", MODES[1:], ids=lambda m: f"{m[0]}-r{m[2]}")
def test_prefill_step_matches_jax(mode):
    """make_prefill_step: last-position logits (B, V) of the full forward."""
    jcfg, jp, tcfg, tp = _configs(mode, "float32")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 6))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    ref = _jit(lambda p, b: jprefill_step(jcfg)(p, b), jp, batch)
    got = tprefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, jcfg.vocab)
    _check(got, ref, "float32", False)
