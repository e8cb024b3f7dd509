"""The port's VLM family (internvl2-76b) against the JAX package's, on the
CPU, and the audio and VLM families through the launchers.

Reduced internvl2-76b (2 layers, d_model 64, 4 heads, 2 KV heads, an
8-patch prefix), float32, the JAX package's ``init_params`` weights
through ``params_from_numpy``; tokens and patch embeddings made with numpy
from a seed (the patches drawn as the conformance matrix's ``make_inputs``
draws them, ``default_rng(seed + 1)``).  Under exact and ``amr_kernel``
rank 0 (JAX's rank 0 as its ``amr_lut`` oracle forward and
straight-through backward, ``tests/_jax_rank0.py``), each within 1e-4 of
the reference's largest |value|:

* ``forward`` with the patches: the prefix through the exact
  ``vision.proj`` dense, prepended, and sliced off the logits (B, S, V);
  with ``last_only`` the last position's (B, 1, V);
* ``prefill_with_cache`` of S - 1 tokens with the patches at capacity S +
  prefix (the conformance arm's ``seq + cfg.vision_prefix``): the cache
  holds prefix + S - 1 positions, and one ``decode_step`` after it;
* one training step: ``loss_fn``'s loss and every leaf's gradient against
  ``jax.value_and_grad``, with the patches; and, at exact, without them
  (decoder only): ``vision_proj``'s gradient zero in both packages.

One tie, at rank 0: with JAX's seed-0 reduced weights and these inputs,
layer 0's ``attn.qk`` query of request 1 at position 12 (the prefix's 8,
then token 4), head 0, column 5 sits 7.6e-6 int8 steps (one float32 ulp)
from a rounding .5 in the port (the RoPE'd query one ulp apart from
JAX's); the index moves request 1's logits from position 12 on by up to
0.16 of the max.  There request 0 (whose quantizations are its own) and
request 1's positions before the tie stay at 1e-4, the rest takes the
correlation rule of ``tests/test_torch_gemma3.py`` (correlation >= 0.98,
mean |diff| <= 0.15 mean |JAX|), the loss 1e-2 relative and each
gradient leaf (a sum over both requests) the correlation rule.  Exact
has no tie and stays at 1e-4 everywhere.

Also: the VLM layout through ``params_from_numpy``, and the serve and
train launchers on reduced whisper-small and internvl2-76b on the CPU
(decoder only, as the JAX package's launchers run them).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.internvl2_76b import reduced as jreduced
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.numerics import AMRNumerics as JN
from repro.train.steps import loss_fn as jloss_fn
from repro_torch.configs.internvl2_76b import reduced as treduced
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models import unread_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tree import tree_items, tree_map
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.train.steps import loss_fn, make_grads_step

from _jax_rank0 import oracle_rank0
from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_kernel", 8, 0)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
_COMPILE = {"xla_allow_excess_precision": False}
B, S, SEED = 2, 8, 0


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_COMPILE)(*args)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, what, rtol=1e-4) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, (what, err)


TIE = ("amr_kernel", 8, 0)  # request 1, from token position TIE_AT on (see the docstring)
TIE_AT = 4


def _corr(got, ref, what) -> None:
    got, ref = _np(got).ravel(), _np(ref).ravel()
    r = np.corrcoef(got, ref)[0, 1]
    diff = np.abs(got - ref).mean()
    assert r >= 0.98 and diff <= 0.15 * np.abs(ref).mean(), (what, r, diff)


def _check(got, ref, what, tie: bool, before: int = 0) -> None:
    """(B, positions, ...) outputs at 1e-4; at the tie request 0 and request
    1's first ``before`` positions at 1e-4 and the whole by the
    correlation rule."""
    if not tie:
        _close(got, ref, what)
        return
    got, ref = _np(got), _np(ref)
    _close(got[0], ref[0], f"{what} request 0")
    if before:
        _close(got[1, :before], ref[1, :before], f"{what} request 1 before the tie")
    assert np.isfinite(got).all(), what
    _corr(got, ref, what)


def _configs(mode):
    jcfg = dataclasses.replace(jreduced(), dtype="float32", numerics=JN(*mode), remat="none")
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN(*mode), remat="none")
    return jcfg, tcfg


def _jax_run(cfg, p, toks, patches):
    """JAX's forward (all positions and the last), the prefill of S - 1
    tokens with the prefix, one decode step, and one step's loss and
    gradients with the patches and, at exact, without them."""
    logits, _ = jforward(cfg, p, toks[:, :S], patches)
    last, _ = jforward(cfg, p, toks[:, :S], patches, last_only=True)
    lp, cache = jprefill(cfg, p, toks[:, :S - 1], S + cfg.vision_prefix,
                         extra_embeddings=patches)
    ld, _ = jdecode(cfg, p, toks[:, S - 1:S], cache)
    grads = {name: jax.value_and_grad(
        lambda p: jloss_fn(cfg, p, toks[:, :-1], toks[:, 1:], extra), has_aux=True)(p)
        for name, extra in (("patches", patches), ("decoder only", None))
        if extra is not None or cfg.numerics.is_exact()}
    return logits, last, lp, cache[0].k, ld, grads


@pytest.fixture(scope="module")
def jax_ref():
    cfg = jreduced()
    jp = jinit(_configs(MODES[0])[0], jax.random.PRNGKey(0))
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    patches = np.random.default_rng(SEED + 1).normal(
        size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    out = {}
    for mode in MODES:
        jcfg = _configs(mode)[0]
        with oracle_rank0():
            out[mode] = _jit(lambda p, t, v: _jax_run(jcfg, p, t, v), jp, toks, patches)
    return jax.tree.map(np.asarray, jp), toks, patches, out


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_forward_prefill_and_decode_match_jax(jax_ref, mode):
    jp, toks, patches, ref = jax_ref
    jlogits, jlast, jlp, jk, jld, _ = ref[mode]
    _, tcfg = _configs(mode)
    p = params_from_numpy(jp, tcfg, "cpu")
    t, v = torch.from_numpy(toks), torch.from_numpy(patches)
    P = tcfg.vision_prefix
    tie = mode == TIE
    with torch.inference_mode():
        logits, _ = tforward(tcfg, p, t[:, :S], v)
        assert logits.shape == (B, S, tcfg.vocab)  # the prefix sliced off
        _check(logits, jlogits, "forward", tie, TIE_AT)
        _check(tforward(tcfg, p, t[:, :S], v, last_only=True)[0], jlast, "last_only", tie)
        lp, cache = tprefill(tcfg, p, t[:, :S - 1], S + P, extra_embeddings=v)
        _check(lp, jlp, "prefill", tie)
        assert cache[0].k.shape[2] == S + P and int(cache[0].length[0]) == S - 1 + P
        # (B, layers, positions, ...): the tie reaches layer 1's keys from its position on
        _check(cache[0].k.transpose(0, 1), jnp.swapaxes(jk, 0, 1), "prefill cache", tie)
        ld, cache = tdecode(tcfg, p, t[:, S - 1:S], cache)
        _check(ld, jld, "decode", tie)
    assert int(cache[0].length[0]) == S + P


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_train_step_loss_and_grads_match_jax(jax_ref, mode):
    jp, toks, patches, ref = jax_ref
    grads_ref = ref[mode][-1]
    _, tcfg = _configs(mode)
    p = params_from_numpy(jp, tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    assert unread_params(tcfg, with_extra=False) == {"vision_proj"}
    tie = mode == TIE
    for name, extra in (("patches", torch.from_numpy(patches)), ("decoder only", None)):
        if name not in grads_ref:
            continue
        b = dict(batch, extra=extra) if extra is not None else batch
        (jloss, _), jgrads = grads_ref[name]
        with torch.no_grad():
            loss, _ = loss_fn(tcfg, p, b["tokens"], b["targets"], extra)
        rtol = 1e-2 if tie and extra is not None else 1e-4
        assert abs(float(loss) - float(jloss)) <= rtol * abs(float(jloss)), name
        grads = make_grads_step(tcfg)(p, b)
        jflat = dict(tree_items(jgrads))
        for key, g in tree_items(grads):
            if extra is None and key == "vision_proj":  # zero in both packages
                assert not g.any() and not np.asarray(jflat[key]).any()
            elif tie and extra is not None:
                _corr(g, jflat[key], f"{name} {key}")
            else:
                assert g.any(), (name, key)
                _close(g, jflat[key], f"{name} {key}")


def test_vlm_layout_through_params_from_numpy():
    cfg = treduced()
    jp = jax.tree.map(np.asarray, jinit(jreduced(), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, cfg, "cpu")
    assert set(tp) == {"embed", "final_norm", "layers", "lm_head", "vision_proj"}
    assert set(tp["layers"][0]) == {"ln1", "ln2", "attn", "mlp"}
    assert tp["vision_proj"].shape == (cfg.d_model, cfg.d_model)
    assert tp["vision_proj"].dtype == torch.bfloat16
    for key, leaf in tree_items(tp):
        assert np.array_equal(_np(leaf), np.asarray(dict(tree_items(jp))[key], np.float32)), key
    own = tinit(cfg, 0, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == tree_map(
        lambda t: (tuple(t.shape), t.dtype), tp)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_launchers_run_audio_and_vlm_decoder_only_on_cpu(arch, capsys, tmp_path):
    serve_launch.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--slots", "2",
                       "--prompt-len", "5", "--gen", "3", "--numerics", "amr_kernel",
                       "--rank", "0"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in out and "2 requests, 6 tokens" in out
    train_launch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"[train] {arch} on cpu" in out and "2 steps" in out
