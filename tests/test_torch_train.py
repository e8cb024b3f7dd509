"""Training in the port against the JAX package's, on the CPU.

* One matmul's gradients per mode (exact, ``amr_lut``, ``amr_kernel`` rank
  0 and 8, ``amr_lowrank``) against ``jax.grad``'s, for a 2-D B and for a
  batched B broadcast over A's leading dim: within 1e-5 of the largest
  |gradient| (float32 matmuls summed in other orders; ``amr_lut``'s
  gradient, through its scales alone, likewise).  ``amr_inject``'s
  against JAX's ``_lowrank_bwd`` alone (no JAX inject compile), at the
  same tolerance.
* ``loss_fn`` and the gradients on the JAX tests' ``TINY`` config
  (``tests/test_train_integration.py``) in float32, the same weights,
  against JAX's ``value_and_grad`` under exact, ``amr_kernel`` rank 0 and
  ``amr_lowrank``: loss within 1e-5 relative, each leaf's gradient within
  1e-4 of its largest |value|.  The JAX side is computed once per module.
* 3 AdamW steps on the same gradients: every leaf of params, moments and
  master within 1e-6 relative of JAX's; ``cosine_warmup`` within 1e-7.
* The loss falls over 30 steps under exact and ``amr_lowrank`` (as JAX's
  ``test_loss_decreases`` and ``test_amr_numerics_trains``); microbatch
  accumulation equals the full batch (loss within 1e-6 relative, params
  within 1e-6); ``remat="block"`` gives the gradients of ``"none"`` bit
  for bit; ``SyntheticLM`` and ``MemmapDataset`` batches equal JAX's bit
  for bit; an SSM config trains and an unported layer kind is refused; the
  trainer runs on the CPU.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JConfig
from repro.data import MemmapDataset as JMemmap
from repro.data import SyntheticLM as JSynthetic
from repro.models import init_params as jinit
from repro.numerics import AMRNumerics as JN
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_warmup as jcosine
from repro.train.steps import loss_fn as jloss_fn
from repro_torch.configs import mamba2_370m
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.data import MemmapDataset as TMemmap
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tree import tree_items
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
from repro_torch.train.steps import (loss_fn, make_grads_step, make_train_state,
                                     make_train_step)

from _torch_threads import one_intra_op_thread  # noqa: F401

japprox = importlib.import_module("repro.numerics.approx_matmul")
tapprox = importlib.import_module("repro_torch.numerics.approx_matmul")

# the JAX tests' TINY (tests/test_train_integration.py), built in each package
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=128, vocab=128, mlp_act="swiglu", tie_embeddings=True,
            remat="none")
LOSS_MODES = [("exact", 8, 8), ("amr_kernel", 8, 0), ("amr_lowrank", 6, 8)]
MATMUL_MODES = [("exact", 8, 8), ("amr_lut", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8),
                ("amr_lowrank", 8, 4)]


def _batch(data, i, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _operands(batched, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 2, 6, 16)).astype(np.float32)
    b = rng.standard_normal((2, 16, 8) if batched else (16, 8)).astype(np.float32)
    w = rng.standard_normal((3, 2, 6, 8)).astype(np.float32)  # the upstream gradient
    return a, b, w


def _torch_grads(fn, a, b, w):
    at, bt = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    (fn(at, bt) * torch.from_numpy(w)).sum().backward()
    return at.grad.numpy(), bt.grad.numpy()


# ------------------------------------------------------------ one matmul
@pytest.mark.parametrize("mode", MATMUL_MODES, ids=lambda m: f"{m[0]}-r{m[2]}")
def test_matmul_gradients_match_jax(mode):
    jnm, tnm = JN(*mode), TN(*mode)
    cases = [_operands(batched) for batched in (False, True)]

    def jgrads(operands):  # both B forms in one compile
        return [jax.grad(lambda x, y: jnp.sum(japprox.approx_matmul(x, y, jnm) * w),
                         argnums=(0, 1))(a, b) for a, b, w in operands]

    ref = jax.jit(jgrads)([(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
                           for a, b, w in cases])
    for batched, (a, b, w), (ga, gb) in zip((False, True), cases, ref):
        ta, tb = _torch_grads(lambda x, y: tapprox.approx_matmul(x, y, tnm), a, b, w)
        assert _max_rel(ta, ga) <= 1e-5 and _max_rel(tb, gb) <= 1e-5, (batched, mode)


def test_amr_inject_gradient_is_the_jax_surrogate():
    nm = TN("amr_inject", border=8)
    bwd = jax.jit(lambda a, b, g: japprox._lowrank_bwd(None, None, (a, b), g))
    for batched in (False, True):
        a, b, w = _operands(batched, seed=1)
        ga, gb = bwd(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
        ta, tb = _torch_grads(lambda x, y: tapprox.matmul_amr_inject(x, y, nm), a, b, w)
        assert _max_rel(ta, ga) <= 1e-5 and _max_rel(tb, gb) <= 1e-5, batched


def test_no_autograd_node_without_grad():
    """Serving: the forward runs as it is, with no autograd node."""
    a, b, _ = _operands(False)
    at = torch.from_numpy(a).requires_grad_(True)
    with torch.no_grad():
        out = tapprox.approx_matmul(at, torch.from_numpy(b), TN("amr_kernel", rank=8))
    assert out.grad_fn is None and not out.requires_grad


# ------------------------------------------------------- TINY loss + grads
def _tiny(mode):
    jcfg = dataclasses.replace(JConfig(**TINY), dtype="float32", numerics=JN(*mode))
    tcfg = dataclasses.replace(TConfig(**TINY), dtype="float32", numerics=TN(*mode))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_jax():
    """JAX's loss and gradients on TINY per mode, and the weights and batch."""
    jcfg, _ = _tiny(LOSS_MODES[0])
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    batch = JSynthetic(vocab=jcfg.vocab, seq_len=16, batch=4, seed=0).batch_at(0)
    out = {}
    for mode in LOSS_MODES:
        cfg = _tiny(mode)[0]
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(cfg, p, batch["tokens"], batch["targets"]), has_aux=True))(jp)
        out[mode] = (float(loss), jax.tree.map(np.asarray, grads))
    return jax.tree.map(np.asarray, jp), batch, out


@pytest.mark.parametrize("mode", LOSS_MODES, ids=lambda m: f"{m[0]}-r{m[2]}")
def test_loss_and_grads_match_jax_on_tiny(tiny_jax, mode):
    jp, batch, ref = tiny_jax
    _, tcfg = _tiny(mode)
    params = params_from_numpy(jp, tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, aux = loss_fn(tcfg, params, tb["tokens"], tb["targets"])
    jloss, jgrads = ref[mode]
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss) and float(aux) == 0.0
    grads = make_grads_step(tcfg)(params, tb)
    jflat = dict(tree_items(jgrads))
    for key, g in tree_items(grads):
        assert _max_rel(g.numpy(), jflat[key]) <= 1e-4, key


# ------------------------------------------------------------------ AdamW
def test_adamw_three_steps_match_jax():
    rng = np.random.default_rng(3)
    shapes = {"w": ((8, 16), jnp.bfloat16), "s": ((16,), jnp.float32),
              "layers": ({"u": ((2, 4, 4), jnp.bfloat16)},)}
    jparams = jax.tree.map(lambda sd: jnp.asarray(rng.standard_normal(sd[0]), sd[1]), shapes,
                           is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 3, p.dtype),
                          jparams) for _ in range(3)]
    tdev = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32), tree)
    tparams = tdev(jparams)
    jst, tst = jadamw_init(jparams), adamw_init(tparams)
    update = jax.jit(jadamw_update)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jparams, jst = update(g, jst, jparams, lr)
        tparams, tst = adamw_update(tdev(g), tst, tparams, torch.tensor(lr))
    assert int(tst.count) == int(jst.count) == 3
    for name, t, j in (("params", tparams, jparams), ("mu", tst.mu, jst.mu),
                       ("nu", tst.nu, jst.nu), ("master", tst.master, jst.master)):
        jflat = dict(tree_items(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), j)))
        for key, leaf in tree_items(t):
            got = leaf.float().numpy()
            tol = 1e-2 if leaf.dtype == torch.bfloat16 else 1e-6  # one bf16 ulp on a cast
            assert _max_rel(got, jflat[key]) <= tol, (name, key)


def test_cosine_warmup_matches_jax():
    for step in (0, 1, 5, 19, 20, 21, 50, 99, 100, 150):
        got = float(cosine_warmup(torch.tensor(step, dtype=torch.int32), peak_lr=3e-3,
                                  warmup=20, total=100))
        ref = float(jcosine(jnp.asarray(step, jnp.int32), peak_lr=3e-3, warmup=20, total=100))
        assert abs(got - ref) <= 1e-7 * max(abs(ref), 1e-30) + 1e-12, step


# ------------------------------------------------------------- the loop
def _train(cfg, steps, batch=8, seq=32):
    data = TSynthetic(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0, noise=0.02)
    state = make_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, peak_lr=5e-3, warmup=5, total_steps=steps)
    losses = []
    for i in range(steps):
        state, m = step(state, _batch(data, i))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("numerics,drop", [(TN("exact"), 0.5),
                                           (TN("amr_lowrank", border=6, rank=8), 0.3)],
                         ids=["exact", "amr_lowrank"])
def test_loss_decreases(numerics, drop):
    losses = _train(dataclasses.replace(TConfig(**TINY), numerics=numerics), steps=30)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - drop, losses[::6]


def test_microbatch_equals_full_batch_and_must_divide():
    cfg = dataclasses.replace(TConfig(**TINY), dtype="float32")
    b = _batch(TSynthetic(vocab=cfg.vocab, seq_len=16, batch=8, seed=0), 0)
    s1, m1 = make_train_step(cfg)(make_train_state(cfg, 0, device="cpu"), b)
    s2, m2 = make_train_step(cfg, microbatch=4)(make_train_state(cfg, 0, device="cpu"), b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6 * abs(float(m1["loss"]))
    for (key, p1), (_, p2) in zip(tree_items(s1.params), tree_items(s2.params)):
        assert float((p1 - p2).abs().max()) <= 1e-6, key
    with pytest.raises(ValueError, match=r"8 is not divisible by microbatch=3"):
        make_train_step(cfg, microbatch=3)(make_train_state(cfg, 0, device="cpu"), b)


def test_remat_block_gives_the_gradients_of_none():
    cfg = dataclasses.replace(TConfig(**TINY), dtype="float32",
                              numerics=TN("amr_kernel", border=8, rank=0))
    params = make_train_state(cfg, 0, device="cpu").params
    b = _batch(TSynthetic(vocab=cfg.vocab, seq_len=16, batch=2, seed=0), 0)
    g_none = make_grads_step(cfg)(params, b)
    g_block = make_grads_step(dataclasses.replace(cfg, remat="block"))(params, b)
    for (key, x), (_, y) in zip(tree_items(g_none), tree_items(g_block)):
        assert torch.equal(x, y), key


def test_synthetic_and_memmap_batches_equal_jax(tmp_path):
    for kw in (dict(vocab=128, seq_len=16, batch=4, seed=3),
               dict(vocab=32000, seq_len=33, batch=8, seed=0, n_hosts=2, host_id=1)):
        for i in (0, 1, 7):
            t, j = TSynthetic(**kw).batch_at(i), JSynthetic(**kw).batch_at(i)
            for k in ("tokens", "targets"):
                assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    for i in (0, 4):
        t = TMemmap(path, seq_len=32, batch=4, seed=1).batch_at(i)
        j = JMemmap(path, seq_len=32, batch=4, seed=1).batch_at(i)
        assert all(np.array_equal(t[k], j[k]) for k in ("tokens", "targets"))


def test_ssm_config_refuses_to_train():
    """The SSD scan has a backward now, so an SSM config trains (one step on
    the CPU, 20 tokens: a ragged last chunk); only a layer kind the port
    does not run ("none": every kind of the JAX package's layers runs now)
    is still refused, by every training entry point."""
    cfg = dataclasses.replace(mamba2_370m.reduced(), dtype="float32")
    b = _batch(TSynthetic(vocab=cfg.vocab, seq_len=20, batch=2, seed=0), 0)
    state, m = make_train_step(cfg)(make_train_state(cfg, 0, device="cpu"), b)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    unported = dataclasses.replace(cfg, default_mixer="none")
    with pytest.raises(NotImplementedError, match="not ported"):
        make_train_step(unported)
    with pytest.raises(NotImplementedError, match="not ported"):
        make_grads_step(unported)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="not ported"):
        loss_fn(unported, None, tokens, tokens)


def test_trainer_runs_on_cpu(capsys, tmp_path):
    tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "amr-paper-100m on cpu" in out and "amr_lowrank(b=8,r=16)" in out
    assert "done: 3 steps, 0 restarts, preempted=False" in out and "tok/s" in out
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000002", "step_00000003"]
