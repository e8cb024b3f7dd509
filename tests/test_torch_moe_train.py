"""MoE training in the port against the JAX package's ``jax.value_and_grad``,
on the CPU.

Weights are the JAX package's ``init_moe`` / ``init_params`` through
``params_from_numpy``; inputs are made with numpy from a seed; float32
throughout; every gradient within 1e-4 of its leaf's largest |value|.

* The MoE layer (``moe_forward``) at reduced dbrx-132b's widths (4 experts
  top-2, d_ff_expert 64; reduced moonshot's layer runs the same code at
  other widths, held in the model cases), in the replicate form (the
  expert products through the numerics) at exact and rank 0 and in the
  local form (exact experts) at rank 0: the gradients of <out, cotangent> + 0.01 aux of the router
  (through softmax, top-k and the renormalization), of ``w_gate``,
  ``w_up`` and ``w_down`` (at rank 0 the straight-through backward) and
  of the input, and those of the aux loss alone (through the router's
  mean probabilities ``me``; the counts ``ce`` carry none); dropless (B 2,
  S 8: the port dispatches one request at a time, JAX the batch) and
  where the capacity drops (capacity factor 0.5, B S K > 4096).
* Reduced dbrx-132b and moonshot-v1-16b-a3b in the local form at exact
  and the replicate form at rank 0: ``loss_fn``'s loss and aux and every
  leaf's gradient, at B 2, S 8; and reduced moonshot past the dropless
  limit (B 2, S 1100: the batch dispatched at once with JAX's capacity)
  at exact.
* ``_GatherRows``, the dispatch's deterministic row gather: its gradient
  equals autograd's through plain indexing, and two backward passes give
  the same bits.

JAX's ``amr_kernel`` at rank 0 runs as its ``amr_lut`` oracle forward and
its straight-through backward (``tests/_jax_rank0.py``), so that no Pallas
interpret compile runs.  No amr_inject run here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.dbrx_132b import reduced as jdbrx
from repro.configs.moonshot_16b_a3b import reduced as jmoon
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.numerics import AMRNumerics as JN
from repro.train.steps import loss_fn as jloss_fn
from repro_torch.configs.dbrx_132b import reduced as tdbrx
from repro_torch.configs.moonshot_16b_a3b import reduced as tmoon
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tree import tree_items
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.train.steps import loss_fn, make_grads_step

from _jax_rank0 import rank0_by_oracle  # noqa: F401
from _torch_threads import one_intra_op_thread  # noqa: F401

EXACT, RANK0 = ("exact", 8, 8), ("amr_kernel", 8, 0)
_IDS = lambda m: m if isinstance(m, str) else f"{m[0]}-r{m[2]}"  # noqa: E731
ARCHS = {"dbrx-132b": (jdbrx, tdbrx), "moonshot-v1-16b-a3b": (jmoon, tmoon)}
_COMPILE = {"xla_allow_excess_precision": False}
RTOL = 1e-4


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_COMPILE)(*args)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, what) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert np.abs(ref).max() > 0, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= RTOL, (what, err)


# ---------------------------------------------------------------- the layer
LAYER_CASES = [("replicate", EXACT), ("replicate", RANK0), ("local", RANK0)]
LEAVES = ("router", "w_gate", "w_up", "w_down")
WEIGHTS = {"total": (0.01, 1.0), "aux": (1.0, 0.0)}  # (aux weight, output weight)


def _layer(form):
    jcfg = dataclasses.replace(jdbrx().moe, dispatch_shard=form)
    tcfg = dataclasses.replace(tdbrx().moe, dispatch_shard=form)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 64, jcfg, jnp.float32)
    return jcfg, jp, tcfg, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("drop", [False, True], ids=["dropless", "drops"])
@pytest.mark.parametrize("form,mode", LAYER_CASES, ids=_IDS)
def test_moe_layer_grads_match_jax(form, mode, drop):
    jcfg, jp, tcfg, tp = _layer(form)
    B, S = (2, 1100) if drop else (2, 8)
    cf = 0.5 if drop else 1.25
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    cot = rng.standard_normal((B, S, 64)).astype(np.float32)

    def jloss(p, x, aux_weight, out_weight):
        out, aux = jmoe.moe_forward(p, x, jcfg, capacity_factor=cf, numerics=JN(*mode))
        return out_weight * jnp.sum(out * cot) + aux_weight * aux

    def both(p, x):  # one compile for the two losses
        return {name: jax.value_and_grad(lambda p, x: jloss(p, x, *w), argnums=(0, 1))(p, x)
                for name, w in WEIGHTS.items()}

    ref = _jit(both, jp, x)
    for name, (aux_weight, out_weight) in WEIGHTS.items():
        ps = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        out, aux = tmoe.moe_forward(ps, xt, tcfg, capacity_factor=cf, numerics=TN(*mode))
        loss = out_weight * torch.sum(out * torch.from_numpy(cot)) + aux_weight * aux
        grads = torch.autograd.grad(loss, [ps[k] for k in LEAVES] + [xt], allow_unused=True)
        jval, (jgp, jgx) = ref[name]
        assert abs(float(loss) - float(jval)) <= RTOL * abs(float(jval)), name
        for key, g in zip(LEAVES + ("x",), grads):
            want = jgx if key == "x" else jgp[key]
            if name == "aux" and key != "router" and key != "x":
                # the aux loss reads the router and the input alone
                assert not g.any() and not np.asarray(want).any(), key
            else:
                _close(g, want, f"{name} {key}")
    if drop:  # the capacity dropped some assignment
        top_w, top_e, _ = tmoe.route(tp["router"], torch.from_numpy(x), tcfg.top_k)
        counts = torch.bincount(top_e.reshape(-1), minlength=tcfg.n_experts)
        assert int(counts.max()) > tmoe.capacity(B * S * tcfg.top_k, tcfg.n_experts, cf)


def test_gather_rows_backward_is_autograds_and_deterministic():
    """``_GatherRows`` against plain indexing (whose backward accumulates
    through ``index_put``): the same rows, the same gradient, and two
    backward passes the same bits; a dropped route reads the zero row."""
    rng = np.random.default_rng(4)
    T, K, E, C, D = 12, 3, 5, 6, 8
    src = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    # token t's K routes to distinct buffer rows in ascending order, some dropped
    rows = np.full((T, K), E * C)
    free = rng.permutation(E * C)
    for t in range(T):
        for k in range(K):
            if rng.random() < 0.8:
                rows[t, k] = free[t * K + k] if t * K + k < E * C else E * C
    rows = torch.from_numpy(np.sort(rows, axis=1))
    token = torch.full((E * C + 1,), T)
    token[rows.reshape(-1)] = torch.arange(T)[:, None].expand(T, K).reshape(-1)
    token = token[:E * C]
    g = torch.from_numpy(rng.standard_normal((E * C, D)).astype(np.float32))

    def grad_of(fn):
        s = src.clone().requires_grad_(True)
        (out,) = torch.autograd.grad((fn(s) * g).sum(), [s])
        return out

    ours = grad_of(lambda s: tmoe._GatherRows.apply(s, token, rows))
    plain = grad_of(lambda s: torch.nn.functional.pad(s, (0, 0, 0, 1))[token])
    with torch.no_grad():
        assert torch.equal(tmoe._GatherRows.apply(src, token, rows),
                           torch.nn.functional.pad(src, (0, 0, 0, 1))[token])
    assert torch.allclose(ours, plain, rtol=0, atol=1e-6)
    assert torch.equal(ours, grad_of(lambda s: tmoe._GatherRows.apply(s, token, rows)))


# ---------------------------------------------------------------- the models
# exact experts in both forms compute the same products: the local form at
# exact, the replicate form at rank 0 (the grouped expert sites)
MODEL_CASES = [(arch, form, mode) for arch in ARCHS
               for form, mode in (("local", EXACT), ("replicate", RANK0))]


def _configs(arch, mode, form):
    jr, tr = ARCHS[arch]
    jcfg = dataclasses.replace(jr(), dtype="float32", numerics=JN(*mode), remat="none",
                               moe=dataclasses.replace(jr().moe, dispatch_shard=form))
    tcfg = dataclasses.replace(tr(), dtype="float32", numerics=TN(*mode), remat="none",
                               moe=dataclasses.replace(tr().moe, dispatch_shard=form))
    return jcfg, tcfg


def _check_model(arch, form, mode, B, S):
    jcfg, tcfg = _configs(arch, mode, form)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    (jloss, jaux), jgrads = _jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, toks[:, :-1], toks[:, 1:]), has_aux=True), jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    with torch.no_grad():
        loss, aux = loss_fn(tcfg, params, batch["tokens"], batch["targets"])
    assert abs(float(loss) - float(jloss)) <= RTOL * abs(float(jloss))
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)
    grads = make_grads_step(tcfg)(params, batch)
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    for key, g in tree_items(grads):
        assert g.any(), key
        _close(g, jflat[key], key)


@pytest.mark.parametrize("arch,form,mode", MODEL_CASES, ids=_IDS)
def test_reduced_model_grads_match_jax(arch, form, mode):
    _check_model(arch, form, mode, 2, 8)


def test_reduced_model_grads_past_the_dropless_limit():
    """B S K = 4400 > 4096: the batch dispatched at once with JAX's
    capacity.  Exact: over 2200 tokens tens of rank-0 int8 indices sit
    within the two packages' float32 rounding of a tie (ROADMAP §3), and
    the layer cases hold rank 0 past the limit on the layer's own input."""
    _check_model("moonshot-v1-16b-a3b", "replicate", EXACT, 2, 1100)
