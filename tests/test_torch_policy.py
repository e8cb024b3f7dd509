"""The port's numerics policy layer against the JAX package's.

* registry: the same modes in the same order, ``amr_noise`` included,
  the same defaults, the same validation;
* ``PerLayerPolicy``: the same resolution at every (site, layer) of a grid,
  precedence (layer, site) > layer > site > default and dotted prefixes;
* policy JSON files cross packages both ways (``noise_seed`` read and
  written; the port reads and drops the JAX-only ``inject_impl``);
* ``approx_matmul`` under a policy resolves per (site, layer) as JAX's:
  each runs, bit for bit, the design point JAX's policy resolves there;
* reduced amr-paper-100m in float32 under a ``PerLayerPolicy`` (exact +
  ``amr_kernel`` rank 0): forward logits within 1e-4 of JAX's, and the
  port's prefill (serving under the policy) within 1e-4 of its forward;
* ``quantize_int8_ste``'s gradient, through the scale too, matches
  ``jax.grad``'s: within 1e-6 of the largest |gradient| (float32), 1e-2
  relative (bfloat16 inputs, bf16 ulps of the scale).
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.numerics as jnum
from repro.configs.amr_paper import reduced as jreduced
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.numerics import quant as jq
from repro_torch import numerics as tnum
from repro_torch.configs.amr_paper import reduced as treduced
from repro_torch.models import forward as tforward
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.numerics import quant as tq



def _fields(nm):
    return (nm.mode, nm.border, nm.rank, nm.noise_seed, nm.schedule_ref)


def _policies(pkg):
    """The same PerLayerPolicy built in either package."""
    N = pkg.AMRNumerics
    return pkg.PerLayerPolicy(
        default=N("exact"),
        layers={1: N("amr_kernel", border=8, rank=0)},
        sites={"attn": N("amr_lut", border=6), "mlp.w_up": N("amr_kernel", border=8, rank=8)},
        layer_sites={(0, "mlp"): N("amr_lowrank", border=8, rank=4),
                     (1, "attn.qk"): N("amr_inject", border=8)})


# ------------------------------------------------------------------ registry
def test_registry_modes_order_defaults_and_validation():
    assert tnum.mode_names() == jnum.mode_names()
    for mode in tnum.mode_names():
        assert tnum.is_exact_mode(mode) == jnum.is_exact_mode(mode)
        assert tnum.get_mode(mode).required_params == jnum.get_mode(mode).required_params
        assert _fields(tnum.default_policy(mode, border=6, rank=3, noise_seed=5,
                                           schedule_ref=None)) == \
            _fields(jnum.default_policy(mode, border=6, rank=3, noise_seed=5,
                                        schedule_ref=None)), mode
        assert _fields(tnum.default_policy(mode)) == _fields(jnum.default_policy(mode)), mode
    assert _fields(tnum.AMRNumerics("amr_noise", noise_seed=3)) == \
        _fields(jnum.AMRNumerics("amr_noise", noise_seed=3))
    for mode, kw in (("bogus", {}), ("amr_lowrank", {"rank": 0}), ("amr_kernel", {"rank": -1}),
                     ("amr_lut", {"border": -1}), ("amr_inject", {"schedule_ref": 3})):
        with pytest.raises(ValueError):
            jnum.AMRNumerics(mode, **kw)
        with pytest.raises(ValueError):
            tnum.AMRNumerics(mode, **kw)


def test_per_layer_policy_resolves_as_jax():
    tp, jp = _policies(tnum), _policies(jnum)
    sites = [None, "attn", "attn.qk", "attn.pv", "attn.wq", "mlp", "mlp.w_up", "mlp.w_up.x",
             "mlp.w_down", "ssm.scan"]
    for layer in (None, 0, 1, 2):
        for site in sites:
            assert _fields(tp.resolve(site, layer)) == _fields(jp.resolve(site, layer)), \
                (site, layer)
    # the precedence, spelled out
    assert tp.resolve("attn.qk", 1).mode == "amr_inject"      # (layer, site)
    assert tp.resolve("attn.pv", 1).mode == "amr_kernel"      # layer over site
    assert tp.resolve("attn.pv", 0).mode == "amr_lut"         # site by dotted prefix
    assert tp.resolve("mlp.w_up", 0).mode == "amr_lowrank"    # (layer, prefix)
    assert tp.resolve("mlp.w_up", 2).rank == 8                # site over default
    assert tp.resolve("mlp.w_down", 2).is_exact()             # default
    assert set(map(_fields, tp.policies())) == set(map(_fields, jp.policies()))
    assert tnum.policy_summary(tp) == jnum.policy_summary(jp)


@pytest.mark.parametrize("kind", ["uniform", "per_layer"])
def test_policy_files_cross_packages(kind, tmp_path):
    if kind == "uniform":
        tp = tnum.UniformPolicy(tnum.AMRNumerics("amr_lowrank", border=8, rank=16))
        jp = jnum.UniformPolicy(jnum.AMRNumerics("amr_lowrank", border=8, rank=16))
    else:
        tp, jp = _policies(tnum), _policies(jnum)
    tnum.save_policy(tp, tmp_path / "t.json", meta={"from": "port"})
    jnum.save_policy(jp, tmp_path / "j.json")
    from_port = jnum.load_policy(tmp_path / "t.json")
    from_jax = tnum.load_policy(tmp_path / "j.json")
    assert jnum.policy_to_json(from_port) == jnum.policy_to_json(jp)
    assert tnum.policy_to_json(from_jax) == tnum.policy_to_json(tp)
    assert from_jax == tp
    assert json.loads((tmp_path / "t.json").read_text())["meta"] == {"from": "port"}


def test_numerics_json_fields():
    nm = tnum.numerics_from_json({"mode": "amr_inject", "border": 6, "rank": 8,
                                  "noise_seed": 3, "inject_impl": "pallas",
                                  "schedule_ref": None})
    assert _fields(nm) == ("amr_inject", 6, 8, 3, None)
    # noise_seed round-trips, and a JAX-written amr_noise entry loads with its seed
    noise = jnum.policy_to_json(jnum.UniformPolicy(jnum.AMRNumerics("amr_noise", noise_seed=3)))
    loaded = tnum.policy_from_json(json.loads(json.dumps(noise)))
    assert _fields(loaded.numerics) == ("amr_noise", 8, 8, 3, None)
    assert tnum.numerics_from_json(tnum.numerics_to_json(loaded.numerics)) == loaded.numerics
    assert jnum.policy_from_json(tnum.policy_to_json(loaded)).numerics.noise_seed == 3
    jpolicy = importlib.import_module("repro.numerics.policy")
    assert set(tnum.numerics_to_json(nm)) <= set(jpolicy.numerics_to_json(jnum.AMRNumerics()))
    with pytest.raises(ValueError, match="unknown AMRNumerics fields"):
        tnum.numerics_from_json({"mode": "exact", "bogus": 1})


def test_approx_matmul_resolves_per_site_and_layer_as_jax():
    """Under the policy, each (site, layer) runs the design point JAX's
    policy resolves there: bit for bit the port's matmul under that point
    (each mode's parity with JAX is held in the mode's own tests)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    tp, jp = _policies(tnum), _policies(jnum)
    seen = set()
    for layer in (None, 0, 1, 2):
        for site in ("attn.wq", "attn.qk", "mlp.w_up", "mlp.w_down"):
            with tnum.numerics_scope(static_layer=layer):
                got = tnum.approx_matmul(a, b, tp, site=site)
            want = tnum.AMRNumerics(*_fields(jp.resolve(site, layer)))
            seen.add(want)
            assert torch.equal(got, tnum.approx_matmul(a, b, want, site=site)), (site, layer)
    assert len(seen) == 6
    # outside any scope a layer-keyed entry does not apply
    assert tnum.current_scope().static_layer is None
    with tnum.numerics_scope(step=3, layer=1):
        with tnum.numerics_scope(static_layer=2):
            sc = tnum.current_scope()
    assert (sc.step, sc.layer, sc.static_layer) == (3, 1, 2)


def test_reduced_model_under_per_layer_policy_matches_jax():
    def policy(pkg):
        N = pkg.AMRNumerics
        return pkg.PerLayerPolicy(default=N("exact"), layers={1: N("amr_kernel", border=8, rank=0)},
                                  sites={"mlp.w_gate": N("amr_kernel", border=8, rank=0)})

    jcfg = dataclasses.replace(jreduced(), dtype="float32", numerics=policy(jnum))
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=policy(tnum))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 8))
    jf = jax.jit(lambda p, t: jforward(jcfg, p, t)[0])(jp, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        tf, aux = tforward(tcfg, tp, torch.from_numpy(toks))
        tl, _ = tprefill(tcfg, tp, torch.from_numpy(toks), 12)
    assert float(aux) == 0.0 and tf.shape == jf.shape
    assert float(np.abs(tf.numpy() - np.asarray(jf)).max()) <= 1e-4
    assert float((tl[:, 0] - tf[:, -1]).abs().max()) <= 1e-4


STE_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _ste_inputs():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 12, 16)) * 4).astype(np.float32)
    w = rng.standard_normal((3, 12, 16)).astype(np.float32)
    ws = {-1: rng.standard_normal((3, 12, 1)).astype(np.float32),
          -2: rng.standard_normal((3, 1, 16)).astype(np.float32)}
    return x, w, ws


@pytest.fixture(scope="module")
def ste_jax():
    """JAX's gradients of the STE quantizer for both axes, one jit a dtype."""
    x, w, ws = _ste_inputs()

    def loss(v, axis):
        q, s = jq.quantize_int8_ste(v, axis=axis)
        return jnp.sum(q * w) + jnp.sum(s * ws[axis])

    grads = jax.jit(lambda v: (jax.grad(loss)(v, -1), jax.grad(loss)(v, -2)))
    out = {}
    for name, (jd, _) in STE_DTYPES.items():
        xj = jnp.asarray(x).astype(jd)
        g1, g2 = grads(xj)
        out[name] = (xj, {-1: np.asarray(g1.astype(jnp.float32)),
                          -2: np.asarray(g2.astype(jnp.float32))})
    return out


@pytest.mark.parametrize("dtype", list(STE_DTYPES))
@pytest.mark.parametrize("axis", [-1, -2])
def test_quantize_int8_ste_gradient_matches_jax(ste_jax, dtype, axis):
    _, w, ws = _ste_inputs()
    xj, jgrads = ste_jax[dtype]
    ref = jgrads[axis]
    td = STE_DTYPES[dtype][1]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td).requires_grad_(True)
    q, s = tq.quantize_int8_ste(xt, axis=axis)
    (torch.sum(q * torch.from_numpy(w)) + torch.sum(s * torch.from_numpy(ws[axis]))).backward()
    got = xt.grad.float().numpy()
    diff = np.abs(got - ref).max()
    if td == torch.float32:
        assert diff <= 1e-6 * np.abs(ref).max(), diff
    else:
        assert diff <= 1e-2 * np.abs(ref).max(), diff
    # forward bits unchanged by the straight-through form
    qj, _ = jq.quantize_int8_ste(xj, axis=axis)
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(qj))
