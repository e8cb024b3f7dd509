"""The port's audio family (whisper-small) against the JAX package's, on the
CPU.

Reduced whisper-small (2 encoder and 2 decoder layers, d_model 64, 4 heads,
16 frames), float32, the JAX package's ``init_params`` weights through
``params_from_numpy``; tokens and frames made with numpy from a seed (the
frames drawn as the conformance matrix's ``make_inputs`` draws them,
``default_rng(seed + 1)``).  Under exact and ``amr_kernel`` rank 0 (JAX's
rank 0 as its ``amr_lut`` oracle forward and straight-through backward,
``tests/_jax_rank0.py``), each within 1e-4 of the reference's largest
|value|:

* ``encode`` (the bidirectional encoder at the sites of its layers, in
  ``numerics_scope(layer=-1 - g)``);
* ``forward`` with the frames: every decoder layer's cross-attention (K
  and V of the encoder output at ``xattn.wk`` / ``xattn.wv``, computed in
  the layer's scope);
* the conformance decode arm: ``prefill_with_cache`` of S - 1 tokens with
  the frames, then ``decode_step`` of the last token with ``encode``'s
  output and a greedy step more (fed JAX's choice), the logits against
  JAX's; at exact the first step's logits also within 1e-4 of the full
  forward's last position (at rank 0 the decode arm's gap is the JAX
  package's own: 1.04 on these inputs, held to JAX at 1e-4 like the rest);
* one training step: ``loss_fn``'s loss and every leaf's gradient against
  ``jax.value_and_grad``, with the frames; and, at exact, without them
  (decoder only, as the JAX package's launchers run it): the encoder,
  cross-attention and ``ln_x`` leaves zero in both packages.

Also: the whisper layout through ``params_from_numpy``; and the
``amr_noise`` keys of the encoder's layers differ from decoder layer 0's.
No amr_inject run here (held on the card by ``chip_smoke.py``).
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.whisper_small import reduced as jreduced
from repro.models import decode_step as jdecode
from repro.models import encode as jencode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.numerics import AMRNumerics as JN
from repro.train.steps import loss_fn as jloss_fn
from repro_torch.configs.whisper_small import CONFIG as TFULL
from repro_torch.configs.whisper_small import reduced as treduced
from repro_torch.models import decode_step as tdecode
from repro_torch.models import encode as tencode
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models import unread_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import _map_specs, param_specs
from repro_torch.models.tree import tree_items, tree_map
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.numerics.context import _TAG_LAYER, _TAG_SITE, _site_id, fold_in, root_key
from repro_torch.train.steps import loss_fn, make_grads_step

from _jax_rank0 import oracle_rank0
from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_kernel", 8, 0)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
_COMPILE = {"xla_allow_excess_precision": False}
B, S, STEPS, SEED = 2, 8, 1, 0


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


def _inputs(cfg):
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    frames = np.random.default_rng(SEED + 1).normal(
        size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return toks, frames


def _configs(mode):
    jcfg = dataclasses.replace(jreduced(), dtype="float32", numerics=JN(*mode), remat="none")
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN(*mode), remat="none")
    return jcfg, tcfg


def _jax_run(cfg, p, toks, frames):
    """JAX's encode, forward, the decode arm (prefill S - 1 tokens, then
    the last token and STEPS greedy steps) and one step's loss and
    gradients, with the frames and, at exact, without them, in one
    function."""
    enc = jencode(cfg, p, frames)
    logits, _ = jforward(cfg, p, toks[:, :S], frames)
    _, cache = jprefill(cfg, p, toks[:, :S - 1], S + STEPS, extra_embeddings=frames)
    tok, steps = toks[:, S - 1:S], []
    for _ in range(1 + STEPS):
        lg, cache = jdecode(cfg, p, tok, cache, enc)
        steps.append((tok, lg))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
    grads = {name: jax.value_and_grad(
        lambda p: jloss_fn(cfg, p, toks[:, :-1], toks[:, 1:], extra), has_aux=True)(p)
        for name, extra in (("frames", frames), ("decoder only", None))
        if extra is not None or cfg.numerics.is_exact()}
    return enc, logits, steps, grads


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's results per mode on one seeded input, and the weights."""
    out = {}
    jp = jinit(_configs(MODES[0])[0], jax.random.PRNGKey(0))
    toks, frames = _inputs(jreduced())
    for mode in MODES:
        jcfg = _configs(mode)[0]
        with oracle_rank0():
            out[mode] = _jit(lambda p, t, f: _jax_run(jcfg, p, t, f), jp, toks, frames)
    return jax.tree.map(np.asarray, jp), toks, frames, out


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_encode_forward_and_decode_match_jax(jax_ref, mode):
    jp, toks, frames, ref = jax_ref
    jenc, jlogits, jsteps, _ = ref[mode]
    _, tcfg = _configs(mode)
    p = params_from_numpy(jp, tcfg, "cpu")
    t, f = torch.from_numpy(toks), torch.from_numpy(frames)
    with torch.inference_mode():
        enc = tencode(tcfg, p, f)
        _close(enc, jenc, "encode")
        logits, aux = tforward(tcfg, p, t[:, :S], f)
        _close(logits, jlogits, "forward")
        assert float(aux) == 0.0
        _, cache = tprefill(tcfg, p, t[:, :S - 1], S + STEPS, extra_embeddings=f)
        for i, (tok, jl) in enumerate(jsteps):
            lg, cache = tdecode(tcfg, p, torch.from_numpy(np.asarray(tok, np.int64)), cache,
                                enc)
            _close(lg, jl, f"decode step {i}")
            if i == 0 and tcfg.numerics.is_exact():  # the last token against the forward
                _close(lg[:, 0], logits[:, -1], "decode against forward")
    assert int(cache[0].length[0]) == S + STEPS


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_train_step_loss_and_grads_match_jax(jax_ref, mode):
    jp, toks, frames, ref = jax_ref
    grads_ref = ref[mode][3]
    _, tcfg = _configs(mode)
    p = params_from_numpy(jp, tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    unread = unread_params(tcfg, with_extra=False)
    assert unread and not unread_params(tcfg)
    for name, extra in (("frames", torch.from_numpy(frames)), ("decoder only", None)):
        if name not in grads_ref:
            continue
        b = dict(batch, extra=extra) if extra is not None else batch
        (jloss, _), jgrads = grads_ref[name]
        with torch.no_grad():
            loss, _ = loss_fn(tcfg, p, b["tokens"], b["targets"], extra)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss)), name
        grads = make_grads_step(tcfg)(p, b)
        jflat = dict(tree_items(jgrads))
        for key, g in tree_items(grads):
            if extra is None and key in unread:  # zero in both packages
                assert not g.any() and not np.asarray(jflat[key]).any(), key
            else:
                assert g.any(), (name, key)
                _close(g, jflat[key], f"{name} {key}")


def test_whisper_layout_through_params_from_numpy():
    cfg = treduced()
    jp = jax.tree.map(np.asarray, jinit(jreduced(), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, cfg, "cpu")
    layer = tp["layers"][0]
    assert set(layer) == {"ln1", "ln2", "attn", "xattn", "ln_x", "mlp"}
    assert set(tp) == {"embed", "final_norm", "layers", "encoder", "enc_norm"}
    assert set(tp["encoder"]) == {"ln1", "ln2", "attn", "mlp"}
    assert tp["encoder"]["attn"]["wq"].shape == (cfg.encoder_layers, cfg.d_model,
                                                 cfg.n_heads * cfg.head_dim)
    assert layer["xattn"]["wk"].shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert layer["ln_x"].dtype == tp["enc_norm"].dtype == torch.float32
    for key, leaf in tree_items(tp):
        assert np.array_equal(_np(leaf), np.asarray(dict(tree_items(jp))[key], np.float32)), key
    own = tinit(cfg, 0, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == tree_map(
        lambda t: (tuple(t.shape), t.dtype), tp)
    sizes = []
    _map_specs(lambda shape, *_: sizes.append(math.prod(shape)), param_specs(TFULL))
    assert 0.29e9 < sum(sizes) < 0.30e9, sum(sizes)  # whisper-small: about 0.29 G parameters


def test_encoder_layers_draw_other_noise_keys_than_decoder_layer_0(monkeypatch):
    """Under amr_noise every draw's key is recorded: the encoder's layer g
    draws at ``layer=-1 - g`` (its ``attn.wq`` key is the one that
    coordinate gives), and no encoder key is one of decoder layer 0's."""
    am = importlib.import_module("repro_torch.numerics.approx_matmul")
    drawn = []
    real = am.matmul_amr_noise

    def record(a, b, border, key, **kw):
        drawn.append(key)
        return real(a, b, border, key, **kw)

    monkeypatch.setattr(am, "matmul_amr_noise", record)
    cfg = dataclasses.replace(treduced(), dtype="float32",
                              numerics=TN("amr_noise", border=8, noise_seed=3))
    p = tinit(cfg, 0, device="cpu")
    toks, frames = _inputs(cfg)
    with torch.inference_mode():
        tencode(cfg, p, torch.from_numpy(frames))
        enc_keys = set(drawn)
        drawn.clear()
        tforward(cfg, p, torch.from_numpy(toks[:, :S]))  # decoder only: its layers' keys
        dec_keys = set(drawn)

    def key(site, layer):
        return fold_in(fold_in(root_key(3), _TAG_SITE, _site_id(site)), _TAG_LAYER, layer)

    for g in range(cfg.encoder_layers):
        assert key("attn.wq", -1 - g) in enc_keys
    assert key("attn.wq", 0) in dec_keys and key("attn.wq", 0) not in enc_keys
    assert enc_keys and not enc_keys & dec_keys
