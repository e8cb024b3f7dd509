"""The port's ``amr_noise`` mode and its PRNG scope against the JAX package's.

JAX's threefry stream is not reproduced (the port seeds a
``torch.Generator`` per call site), so the draw is held by its moments and
its decorrelation, and everything around the draw bit for bit:

* ``_site_id`` equals JAX's crc32 on every site label of both packages;
* the scope nests as JAX's (inner values override, absent ones inherit,
  ``unit`` included), and ``request_scope`` gives a request its own
  position or its unit;
* ``matmul_amr_noise`` with JAX's own normals fed through ``draw``: a 2-D
  B, a grouped B and a per-request key batch within 1e-6 relative of JAX's
  output, gradients within 1e-5 of each operand's largest |gradient|;
* the standardized error (out / scales - exact - K mu) / (sqrt(K) sigma)
  has mean 0 and standard deviation 1 within 5 standard errors at borders
  6, 8 and 14 (``lut.error_stats``);
* the key differs per site, step, layer and unit, and an absent
  coordinate differs from 0; a (B,) step gives each request the key a
  solo call at its position derives;
* ``run_noise_decorrelation``'s two rules (a step reproduces, two steps
  differ) on reduced amr-paper-100m, mamba2-370m and dbrx-132b; remat
  "block" gives the gradients of "none" bit for bit (the recompute draws
  the same noise);
* served batched equal to solo bit for bit (reduced gemma-2b and
  moonshot-v1-16b-a3b through ``ServeEngine``), and a decode step reads
  the positions to the host once.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.numerics import context as jctx
from repro.numerics.approx_matmul import matmul_amr_noise as jnoise
from repro_torch.configs import get_reduced_config
from repro_torch.core import lut as tlut
from repro_torch.models import forward, init_params
from repro_torch.models.tree import tree_items
from repro_torch.numerics import AMRNumerics, approx_matmul, current_scope, numerics_scope
from repro_torch.numerics import context as tctx
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.steps import make_grads_step

from _torch_threads import one_intra_op_thread  # noqa: F401

tam = importlib.import_module("repro_torch.numerics.approx_matmul")

SITES = ["attn.wq", "attn.wk", "attn.wv", "attn.wo", "attn.qk", "attn.pv", "mlp.w_gate",
         "mlp.w_up", "mlp.w_down", "ssm.in_proj", "ssm.out_proj", "ssm.scan",
         "moe.expert.w_gate", "moe.expert.w_up", "moe.expert.w_down", "vision.proj", "", "x"]


def test_site_id_matches_jax():
    for site in SITES:
        assert tctx._site_id(site) == jctx._site_id(site), site


def test_scope_nesting_with_unit():
    assert current_scope() == tctx.NumericsScope()
    with numerics_scope(step=3, layer=1, static_layer=1), \
            jctx.numerics_scope(step=3, layer=1, static_layer=1):
        with numerics_scope(unit=2), jctx.numerics_scope(unit=2):
            t, j = current_scope(), jctx.current_scope()
            assert (t.step, t.layer, t.unit, t.static_layer) == \
                (j.step, j.layer, j.unit, j.static_layer) == (3, 1, 2, 1)
            with numerics_scope(layer=5), jctx.numerics_scope(layer=5):
                assert current_scope().layer == jctx.current_scope().layer == 5
                assert current_scope().unit == jctx.current_scope().unit == 2
        assert current_scope().unit is None and jctx.current_scope().unit is None
    # a tensor coordinate is read to the host once, at its first use
    pos = torch.tensor([4, 9])
    with numerics_scope(step=pos):
        held = current_scope().step
        assert isinstance(held, tctx.HostOnce)
        k0 = tctx.noise_key(0, "mlp.w_up")
        pos[0] = 7
        assert tctx.noise_key(0, "mlp.w_up") == k0 and held.value() == (4, 9)
        # request r of 2 sees its own position; of another count, its unit
        with tctx.request_scope(1, 2):
            with numerics_scope(step=9):
                solo = tctx.noise_key(0, "mlp.w_up")
            assert tctx.noise_key(0, "mlp.w_up") == solo == k0[1]
        with tctx.request_scope(1, 3):
            assert current_scope().unit == 1
    with tctx.request_scope(0, 2):
        assert current_scope().unit == 0 and current_scope().step is None


def test_keys_differ_per_coordinate_and_absent_differs_from_zero():
    base = tctx.noise_key(0, "mlp.w_up")
    keys = {base, tctx.noise_key(1, "mlp.w_up"), tctx.noise_key(0, "mlp.w_gate"),
            tctx.noise_key(0, None)}
    for coord in ("step", "layer", "unit"):
        for v in (0, 1):
            with numerics_scope(**{coord: v}):
                keys.add(tctx.noise_key(0, "mlp.w_up"))
    assert len(keys) == 4 + 6
    with numerics_scope(step=0, layer=0, unit=0):
        zeros = tctx.noise_key(0, "mlp.w_up")
    assert zeros not in keys
    # a key batch: each request's key is what a solo call at its position derives
    with numerics_scope(step=(5, 6), layer=2):
        batch = tctx.noise_key(0, "attn.qk")
    for s, k in zip((5, 6), batch):
        with numerics_scope(step=s, layer=2):
            assert tctx.noise_key(0, "attn.qk") == k
    assert all(0 <= k < 2**64 for k in batch)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_draw(normals: dict):
    """A ``draw`` that returns JAX's normals for the port key it is given."""
    def draw(key, shape, device):
        out = torch.from_numpy(np.array(normals[key], np.float32))
        assert tuple(out.shape) == tuple(shape)
        return out
    return draw


CASES = {"2d": ((2, 3, 48), (48, 20), None), "grouped": ((4, 5, 40), (4, 40, 12), None),
         "key batch": ((3, 2, 64), (64, 16), 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_matmul_amr_noise_with_jax_normals(case):
    ashape, bshape, nb = CASES[case]
    rng = np.random.default_rng(0)
    a = rng.standard_normal(ashape).astype(np.float32)
    b = rng.standard_normal(bshape).astype(np.float32)
    w = rng.standard_normal((*np.broadcast_shapes(ashape[:-2], bshape[:-2]), ashape[-2],
                             bshape[-1])).astype(np.float32)
    out_shape = w.shape
    if nb is None:
        jkey = jax.random.PRNGKey(7)
        tkey = 0
    else:
        jkey = jax.random.split(jax.random.PRNGKey(7), nb)
        tkey = tuple(range(nb))

    def jrun(a, b):
        """JAX's output and gradients, and the normals its draw takes."""
        if nb is None:
            normals = [jax.random.normal(jkey, out_shape)]
        else:
            per = math.prod(out_shape[:-1]) // nb
            normals = [jax.random.normal(jkey[i], (per, out_shape[-1])) for i in range(nb)]

        def jloss(a, b):
            out = jnoise(a, b, 8, jkey)
            return jnp.sum(out * w), out

        return jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(a, b), normals

    ((_, jout), (ga, gb)), normals = jax.jit(jrun)(jnp.asarray(a), jnp.asarray(b))
    normals = dict(enumerate(normals))
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    out = tam.matmul_amr_noise(ta, tb, 8, tkey, draw=_jax_draw(normals))
    (out * _t(w)).sum().backward()
    jout = np.asarray(jout)
    assert np.abs(out.detach().numpy() - jout).max() <= 1e-6 * np.abs(jout).max()
    for got, want in ((ta.grad, ga), (tb.grad, gb)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the key= override of approx_matmul reaches the same draw
    nm = AMRNumerics("amr_noise", border=8)
    with torch.no_grad():
        drawn = tam.matmul_amr_noise(ta, tb, 8, tkey)
        assert torch.equal(approx_matmul(ta, tb, nm, key=tkey, site="mlp.w_up"), drawn)


def test_key_batch_must_divide_the_rows():
    a, b = torch.ones(3, 2, 8), torch.ones(8, 4)
    with pytest.raises(ValueError, match="rows must divide evenly"):
        tam.matmul_amr_noise(a, b, 8, (1, 2, 3, 4))
    with pytest.raises(ValueError, match="rows must divide evenly"):
        jax.eval_shape(lambda k: jnoise(jnp.ones((3, 2, 8)), jnp.ones((8, 4)), 8, k),
                       jax.random.split(jax.random.PRNGKey(0), 4))


@pytest.mark.parametrize("border", [6, 8, 14])
def test_standardized_error_moments(border):
    stats = tlut.error_stats(border)
    mu, sigma = stats["mean"], stats["std"]
    rng = np.random.default_rng(border)
    K = 64
    a = torch.from_numpy(rng.standard_normal((256, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, 512)).astype(np.float32))
    with numerics_scope(step=border, layer=3):
        out = approx_matmul(a, b, AMRNumerics("amr_noise", border=border), site="mlp.w_up")
    qa, sa = tam.quantize_int8_ste(a, axis=-1)
    qb, sb = tam.quantize_int8_ste(b, axis=-2)
    exact = (qa.double() @ qb.double())
    z = ((out.double() / (sa.double() * sb.double()) - exact - K * mu)
         / (math.sqrt(K) * sigma)).ravel()
    n = z.numel()
    assert abs(float(z.mean())) <= 5 / math.sqrt(n), float(z.mean())
    assert abs(float(z.std()) - 1) <= 5 * math.sqrt(1 / (2 * n)), float(z.std())


def _noise_cfg(arch, **kw):
    return dataclasses.replace(get_reduced_config(arch), dtype="float32",
                               numerics=AMRNumerics("amr_noise", border=8), **kw)


@pytest.mark.parametrize("arch", ["amr-paper-100m", "mamba2-370m", "dbrx-132b"])
def test_noise_decorrelation(arch):
    """The two rules of the JAX package's ``run_noise_decorrelation``: the
    forward at one step reproduces bit for bit, and two steps differ."""
    cfg = _noise_cfg(arch)
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))

    def fwd(step):
        with torch.inference_mode(), numerics_scope(step=torch.tensor(step)):
            return forward(cfg, params, tokens)[0]

    l0, l0b, l1 = fwd(0), fwd(0), fwd(1)
    assert torch.equal(l0, l0b)
    assert float((l0 - l1).abs().max()) > 0
    assert bool(torch.isfinite(l0).all())


def test_remat_block_draws_the_noise_of_none():
    grads = {}
    for remat in ("block", "none"):
        cfg = _noise_cfg("amr-paper-100m", remat=remat)
        params = init_params(cfg, 0, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)))
        grads[remat] = make_grads_step(cfg)(params, {"tokens": toks[:, :-1],
                                                     "targets": toks[:, 1:]})
    for (key, a), (_, b) in zip(tree_items(grads["block"]), tree_items(grads["none"])):
        assert torch.equal(a, b), key


PROMPTS = [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]
GENS = [3, 5, 4, 3]


def _serve(cfg, params, n_slots):
    eng = ServeEngine(cfg, params, n_slots=n_slots, capacity=24, record_logits=True,
                      device="cpu")
    for p, g in zip(PROMPTS, GENS):
        eng.submit(Request(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("arch", ["gemma-2b", "moonshot-v1-16b-a3b"])
def test_batched_decode_bit_identical_to_solo(arch, monkeypatch):
    cfg = _noise_cfg(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               dispatch_shard="replicate"))
    params = init_params(cfg, 0, device="cpu")
    reads = []
    value = tctx.HostOnce.value

    def counted(self):
        if self._value is None:
            reads.append(tuple(self._tensor.shape))
        return value(self)

    monkeypatch.setattr(tctx.HostOnce, "value", counted)
    batched = _serve(cfg, params, 3)
    steps = len(reads)
    solo = _serve(cfg, params, 1)
    # one read of the positions a decode step: GENS - 1 steps a request alone
    assert len(reads) - steps == sum(GENS) - len(GENS)
    assert all(shape == (3,) for shape in reads[:steps])
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens and len(b.tokens) > 1
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)
