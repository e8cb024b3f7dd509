"""The port's MoE family against the JAX package's, on the CPU.

Weights are the JAX package's ``init_params`` / ``init_moe`` through
``params_from_numpy``; inputs are made with numpy from a seed; float32
throughout.  The JAX package's ``amr_lut`` (the bit-exact oracle) is the
reference for the port's ``amr_kernel`` rank 0, so that no Pallas
interpret compile runs.

* ``moe_forward`` (reduced dbrx-132b's widths: 4 experts top-2) in the
  global form (``dispatch_shard="replicate"``, the expert products through
  the numerics) and the local form (exact expert products, the numerics
  ignored), at exact and rank 0: output within 1e-4 of its largest
  |value|, aux within 1e-6; also where T * K > 4096 and the capacity drops
  assignments (capacity factor 0.5); the local form's output under rank 0
  equals its exact output bit for bit; ties among router probabilities go
  to the lower expert, as ``jax.lax.top_k`` breaks them; a per-layer
  policy's ``"moe.expert"`` entry resolves all three expert sites.
* Reduced dbrx-132b and moonshot-v1-16b-a3b, both forms: the forward's
  logits and aux, the prefill's logits and cache and 2 decode steps
  within 1e-4 of the max.  One tie: with JAX's seed-0 reduced
  moonshot weights, layer 0's ``attn.wo`` input (request 0, position 8,
  column 39) sits at 83.49998 int8 steps in the port and across the .5 in
  JAX (the attention output's float32 sums run in another order, one ulp
  apart; every ``attn.qk`` and ``attn.pv`` product agrees), so under rank 0
  request 0's logits take the correlation rule of
  ``tests/test_torch_gemma3.py`` (correlation >= 0.98, mean |diff| <= 0.15
  mean |JAX|) in the forward, request 1's logits and cache stay at 1e-4
  everywhere, request 0's prefill and decode logits are checked finite
  only (the moved index reaches all of request 0's positions from layer 1
  on: V quantizes per column over the positions), and the aux loss is held
  to 1e-2 relative (request 0's later routes move with it).  A second,
  JAX-internal tie in the same case: JAX's compiled second decode step
  gives request 1 logits 0.297 away from JAX's own op-by-op step
  (``jax.disable_jit``), which the port's match to 1e-6; that one row is
  checked finite, and request 1's cache after it at 1e-4 (the tie sits in
  the last layer's output, past every cache write).
  Cases: each arch in both forms, rank 0 in the replicate form, rank 0
  (dbrx-132b) and exact (moonshot) in the local form.
* Served batched equal to solo bit for bit, both forms, exact and rank 0.
* The ``moe`` leaves through ``params_from_numpy`` (the router float32),
  ``validate_config`` raising on the configs JAX's raises on (broken
  audio and VLM configs too), and the launchers on the MoE archs.

No amr_inject run here (held on the card by ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import validation as jvalidation
from repro.configs.base import LayerPattern as JPattern
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import SSMConfig as JSSM
from repro.configs.dbrx_132b import reduced as jdbrx
from repro.configs.internvl2_76b import reduced as jvlm
from repro.configs.moonshot_16b_a3b import reduced as jmoon
from repro.configs.whisper_small import reduced as jwhisper
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.models import prefill_with_cache as jprefill
from repro.numerics import AMRNumerics as JN
from repro_torch.configs import get_config, validate_config
from repro_torch.configs.base import LayerPattern as TPattern
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.configs.dbrx_132b import reduced as tdbrx
from repro_torch.configs.internvl2_76b import reduced as tvlm
from repro_torch.configs.moonshot_16b_a3b import reduced as tmoon
from repro_torch.configs.whisper_small import reduced as twhisper
from repro_torch.configs.registry import ARCH_NAMES, get_reduced_config
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import moe as tmoe
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tree import tree_items, tree_map
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.numerics import PerLayerPolicy as TPerLayer
from repro_torch.serve import Request, ServeEngine

from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_kernel", 8, 0)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
FORMS = ["replicate", "local"]
ARCHS = {"dbrx-132b": (jdbrx, tdbrx), "moonshot-v1-16b-a3b": (jmoon, tmoon)}
CAP = 24
_COMPILE = {"xla_allow_excess_precision": False}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_COMPILE)(*args)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, rtol=1e-4) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), np.abs(got - ref).max()


# (arch, mode) whose request 0 meets an int8 rounding tie (see the docstring)
TIES = {("moonshot-v1-16b-a3b", "amr_kernel")}


def _check(got, ref, tie: bool, corr: bool = False) -> None:
    """(B, ...) outputs: 1e-4 of the max; at the tie request 1 at 1e-4, and
    with ``corr`` the whole by the correlation rule."""
    if not tie:
        _close(got, ref)
        return
    got, ref = _np(got), _np(ref)
    _close(got[1], ref[1])
    assert np.isfinite(got).all()
    if corr:
        diff = np.abs(got - ref)
        r = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
        assert r >= 0.98 and diff.mean() <= 0.15 * np.abs(ref).mean(), (r, diff.mean())


def _jmode(mode):
    """JAX's reference for the port's mode: amr_lut for amr_kernel rank 0."""
    return ("amr_lut", mode[1], mode[2]) if mode == ("amr_kernel", 8, 0) else mode


# ---------------------------------------------------------------- the layer
def _layer(form, seed=0):
    jcfg = dataclasses.replace(jdbrx().moe, dispatch_shard=form)
    tcfg = dataclasses.replace(tdbrx().moe, dispatch_shard=form)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), 64, jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


# the local form at rank 0 only: its expert products ignore the numerics, and
# the case also checks that it equals the exact local form bit for bit
LAYER_CASES = [("replicate", MODES[0]), ("replicate", MODES[1]), ("local", MODES[1])]


@pytest.mark.parametrize("drop", [False, True], ids=["dropless", "drops"])
@pytest.mark.parametrize("form,mode", LAYER_CASES,
                         ids=lambda v: v if isinstance(v, str) else _IDS(v))
def test_moe_forward_matches_jax(form, mode, drop):
    jcfg, jp, tcfg, tp = _layer(form)
    B, S = (2, 1100) if drop else (2, 8)
    cf = 0.5 if drop else 1.25
    x = np.random.default_rng(1).standard_normal((B, S, 64)).astype(np.float32)
    jout, jaux = _jit(lambda p, x: jmoe.moe_forward(p, x, jcfg, capacity_factor=cf,
                                                    numerics=JN(*_jmode(mode))), jp, x)
    with torch.inference_mode():
        tout, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg, capacity_factor=cf,
                                      numerics=TN(*mode))
        _close(tout, jout)
        assert abs(float(taux) - float(jaux)) <= 1e-6
        if form == "local":  # the expert products ignore the numerics
            exact, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg, capacity_factor=cf)
            assert torch.equal(tout, exact)
        if drop:  # some assignment dropped: its token lost that expert's share
            top_w, top_e, _ = tmoe.route(tp["router"], torch.from_numpy(x), tcfg.top_k)
            counts = torch.bincount(top_e.reshape(-1), minlength=tcfg.n_experts)
            assert int(counts.max()) > tmoe.capacity(B * S * tcfg.top_k, tcfg.n_experts, cf)


def test_moe_expert_policy_entry_resolves_all_three_sites():
    """A per-layer policy's ``"moe.expert"`` entry reaches w_gate, w_up and
    w_down: the layer under it equals the layer under that design point."""
    _, _, tcfg, tp = _layer("replicate")
    rank0 = TN("amr_kernel", border=8, rank=0)
    policy = TPerLayer(default=TN("exact"), sites={"moe.expert": rank0})
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 64)).astype(np.float32))
    with torch.inference_mode():
        got, _ = tmoe.moe_forward(tp, x, tcfg, numerics=policy)
        want, _ = tmoe.moe_forward(tp, x, tcfg, numerics=rank0)
        exact, _ = tmoe.moe_forward(tp, x, tcfg)
    assert torch.equal(got, want) and not torch.equal(got, exact)


def test_top_k_ties_go_to_the_lower_expert():
    jcfg, jp, tcfg, tp = _layer("replicate")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(2).standard_normal((1, 5, 64)).astype(np.float32)
    _, top_e, _ = tmoe.route(tp["router"], torch.from_numpy(x), tcfg.top_k)
    probs = jax.nn.softmax(jnp.zeros((5, tcfg.n_experts)), axis=-1)
    assert top_e.tolist() == np.asarray(jax.lax.top_k(probs, tcfg.top_k)[1]).tolist()
    jout, _ = _jit(lambda p, x: jmoe.moe_forward(p, x, jcfg), jp, jnp.asarray(x))
    with torch.inference_mode():
        _close(tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)[0], jout)


# ---------------------------------------------------------------- the models
def _configs(arch, mode, form):
    jr, tr = ARCHS[arch]
    jcfg = dataclasses.replace(jr(), dtype="float32", numerics=JN(*_jmode(mode)),
                               moe=dataclasses.replace(jr().moe, dispatch_shard=form))
    tcfg = dataclasses.replace(tr(), dtype="float32", numerics=TN(*mode),
                               moe=dataclasses.replace(tr().moe, dispatch_shard=form))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


# each arch in both forms; rank 0 in the replicate form (the grouped gather at
# the expert sites), and in the local form rank 0 for dbrx-132b (the attention
# sites quantize, the experts not) and exact for moonshot
MODEL_CASES = [("dbrx-132b", "replicate", MODES[1]), ("dbrx-132b", "local", MODES[1]),
               ("moonshot-v1-16b-a3b", "replicate", MODES[1]),
               ("moonshot-v1-16b-a3b", "local", MODES[0])]


def _jax_run(jcfg, p, t, steps: int):
    """JAX's forward, prefill and ``steps`` greedy decode steps (each fed the
    argmax of the one before, the first the prompt's last token), compiled
    as one function."""
    f, aux = jforward(jcfg, p, t)
    lp, c = jprefill(jcfg, p, t, CAP)
    k0, tok, steps_out = c[0].k, t[:, -1:], []
    for _ in range(steps):
        l, c = jdecode(jcfg, p, tok, c)
        steps_out.append((tok, l))
        tok = jnp.argmax(l[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return f, aux, lp, k0, steps_out, c[0].k


@pytest.mark.parametrize("arch,form,mode", MODEL_CASES,
                         ids=lambda v: v if isinstance(v, str) else _IDS(v))
def test_reduced_model_matches_jax(arch, form, mode):
    jcfg, jp, tcfg, tp = _configs(arch, mode, form)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 12))
    jf, jaux, jl, jk, jsteps, jk_end = _jit(lambda p, t: _jax_run(jcfg, p, t, 2), jp,
                                            jnp.asarray(toks, jnp.int32))
    tie = (arch, mode[0]) in TIES
    with torch.inference_mode():
        tf, taux = tforward(tcfg, tp, torch.from_numpy(toks))
        tl, tc = tprefill(tcfg, tp, torch.from_numpy(toks), CAP)
    _check(tf, jf, tie, corr=True)
    # at the tie request 0's later routes move with its hidden state
    assert abs(float(taux) - float(jaux)) <= (1e-2 * float(jaux) if tie else 1e-6)
    assert float(taux) > 0
    _check(tl, jl, tie)
    _check(tc[0].k.transpose(0, 1), jnp.swapaxes(jk, 0, 1), tie)
    for i, (tok, jl) in enumerate(jsteps):  # both fed JAX's choices
        with torch.inference_mode():
            tl, tc = tdecode(tcfg, tp, torch.from_numpy(np.asarray(tok, np.int64)), tc)
        if tie and i == 1:  # the compiled step's own tie: see the docstring
            assert np.isfinite(_np(tl)).all()
        else:
            _check(tl, jl, tie)
    _check(tc[0].k.transpose(0, 1), jnp.swapaxes(jk_end, 0, 1), tie)
    assert int(tc[0].length[0]) == 14


PROMPTS = [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]
GENS = [3, 5, 4, 3]


def _serve(cfg, params, n_slots):
    eng = ServeEngine(cfg, params, n_slots=n_slots, capacity=CAP, record_logits=True,
                      device="cpu")
    for p, g in zip(PROMPTS, GENS):
        eng.submit(Request(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batched_decode_bit_identical_to_solo(arch, form, mode):
    base = get_reduced_config(arch)
    cfg = dataclasses.replace(base, numerics=TN(*mode),
                              moe=dataclasses.replace(base.moe, dispatch_shard=form))
    params = tinit(cfg, 0, device="cpu")
    batched, solo = _serve(cfg, params, 3), _serve(cfg, params, 1)
    assert len(batched) == len(solo) == len(PROMPTS)
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens and len(b.tokens) > 1
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)


# ------------------------------------------------------- layout and configs
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_layout_through_params_from_numpy(arch):
    jr, tr = ARCHS[arch]
    jp = jax.tree.map(np.asarray, jinit(jr(), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, tr(), "cpu")
    cfg = tr()
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    layer = tp["layers"][0]
    assert set(layer) == {"ln1", "ln2", "attn", "moe"} and "lm_head" in tp
    assert layer["moe"]["router"].dtype == torch.float32
    assert layer["moe"]["router"].shape == (cfg.n_layers, D, E)
    assert layer["moe"]["w_gate"].shape == layer["moe"]["w_up"].shape == (cfg.n_layers, E, D, F)
    assert layer["moe"]["w_down"].shape == (cfg.n_layers, E, F, D)
    assert layer["moe"]["w_down"].dtype == torch.bfloat16
    for key, leaf in tree_items(tp):
        assert np.array_equal(_np(leaf), np.asarray(dict(tree_items(jp))[key], np.float32)), key
    own = tinit(cfg, 0, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == tree_map(
        lambda t: (tuple(t.shape), t.dtype), tp)


def _bad_configs(pkg):
    """The same broken configs in either package's types."""
    base, moe, ssm, pattern = pkg
    r = dataclasses.replace
    return [
        r(base, n_layers=0),
        r(base, n_kv_heads=3),
        r(base, moe=None),
        r(base, moe=moe(n_experts=4, top_k=5, d_ff_expert=8)),
        r(base, moe=moe(n_experts=0, top_k=1, d_ff_expert=8)),
        r(base, pattern=pattern(kinds=("full",), n_repeat=3)),
        r(base, pattern=pattern(kinds=("swa", "full"), n_repeat=1)),
        r(base, family="ssm", moe=None),
        r(base, family="ssm", moe=None, pattern=pattern(kinds=("ssm", "full"), n_repeat=1),
          ssm=ssm(d_state=16, head_dim=48)),
    ]


def _bad_frontends(audio, vlm):
    """Broken audio and VLM configs, from either package's reduced ones."""
    r = dataclasses.replace
    return [
        r(audio, encoder_layers=0),
        r(audio, encoder_frames=0),
        r(audio, n_kv_heads=3),
        r(vlm, vision_prefix=0),
    ]


def test_validate_config_raises_where_jax_does():
    for name in ARCH_NAMES:
        for cfg in (get_config(name), get_reduced_config(name)):
            assert validate_config(cfg) is cfg
    jbad = _bad_configs((jdbrx(), JMoE, JSSM, JPattern)) + _bad_frontends(jwhisper(), jvlm())
    tbad = _bad_configs((tdbrx(), TMoE, TSSM, TPattern)) + _bad_frontends(twhisper(), tvlm())
    for j, t in zip(jbad, tbad):
        with pytest.raises(ValueError) as je:
            jvalidation.validate_config(j)
        with pytest.raises(ValueError) as te:
            validate_config(t)
        assert str(te.value) == str(je.value)


def test_launchers_serve_and_train_moe_on_cpu(capsys, tmp_path):
    serve_launch.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu", "--requests", "2",
                       "--slots", "2", "--prompt-len", "6", "--gen", "3", "--numerics",
                       "amr_kernel", "--rank", "0"])
    out = capsys.readouterr().out
    assert "[serve] moonshot-v1-16b-a3b on cpu" in out and "2 requests, 6 tokens" in out
    train_launch.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
                       "--numerics", "amr_noise", "--noise-seed", "3"])
    out = capsys.readouterr().out
    assert "dbrx-132b on cpu" in out and "amr_noise" in out
