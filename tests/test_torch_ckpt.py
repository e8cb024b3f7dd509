"""Checkpoints and the restart loop of the port, on the CPU.

Everything here is compared bit for bit: a checkpoint round-trips every
leaf (bfloat16 params included); the same training state saved by the
JAX package and by the port gives the same manifest and the same leaf
files, and each package restores the other's checkpoint exactly
(``train_state_from_numpy`` carries a JAX state over); an async save
writes what a sync save writes; stale ``.tmp-step_*`` directories are
swept on restore and retention keeps step 0; and a ``FaultTolerantLoop``
on the JAX tests' ``TINY`` config (exact numerics) that fails once, or is
preempted by SIGTERM and resumed by a new loop, ends with the losses and
the state of the uninterrupted run.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

from repro.ckpt import restore_tree as jrestore
from repro.ckpt import save_tree as jsave
from repro.configs.base import ModelConfig as JConfig
from repro.train.steps import make_train_state as jmake_state
from repro_torch.ckpt import (CheckpointManager, clean_stale_tmp, latest_step, restore_tree,
                              save_tree)
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.data import SyntheticLM
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.tree import tree_items
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.train.steps import make_train_state, make_train_step

from _torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=128, vocab=128, mlp_act="swiglu", tie_embeddings=True,
            remat="none")
STEPS = 4


def _bits(x) -> tuple[str, tuple, bytes]:
    """A leaf's dtype name, shape and bytes (bf16 through its bit pattern)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        name = str(x.dtype).removeprefix("torch.")
        arr = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    else:
        arr = np.asarray(x)
        name = arr.dtype.name
        arr = arr.view(np.uint16) if name == "bfloat16" else arr
    return name, tuple(arr.shape), np.ascontiguousarray(arr).tobytes()


def _assert_same(a, b):
    ia, ib = tree_items(a), tree_items(b)
    assert [k for k, _ in ia] == [k for k, _ in ib]
    for (key, x), (_, y) in zip(ia, ib):
        assert _bits(x) == _bits(y), key


def _trained_state(steps: int = 1):
    cfg = TConfig(**TINY)
    state = make_train_state(cfg, 0, device="cpu")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, seed=0)
    step = make_train_step(cfg, peak_lr=5e-3, warmup=1)
    for i in range(steps):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
    return state


def test_round_trip_bit_for_bit(tmp_path):
    state = _trained_state()
    assert state.params["embed"].dtype == torch.bfloat16 and int(state.opt.count) == 1
    path = save_tree(tmp_path, state, 1)
    assert path.name == "step_00000001" and latest_step(tmp_path) == 1
    restored = restore_tree(path, make_train_state(TConfig(**TINY), 1, device="cpu"))
    _assert_same(restored, state)
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 1
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    assert list(manifest["leaves"])[:2] == ["params/embed", "params/final_norm"]
    assert manifest["leaves"]["step"] == {"file": f"leaf_{len(manifest['leaves']) - 1:05d}.npy",
                                          "shape": [], "dtype": "int32"}


def _jax_state():
    """A JAX TrainState of TINY with random moments (exported to numpy)."""
    jst = jmake_state(JConfig(**TINY), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    rand = lambda x: jax.numpy.asarray(rng.standard_normal(x.shape), x.dtype)  # noqa: E731
    jst = dataclasses.replace(jst, opt=dataclasses.replace(
        jst.opt, mu=jax.tree.map(rand, jst.opt.mu), nu=jax.tree.map(rand, jst.opt.nu)))
    return jax.tree.map(np.asarray, jst)


def test_checkpoints_cross_packages(tmp_path):
    jst = _jax_state()
    tst = train_state_from_numpy(jst, TConfig(**TINY), "cpu")
    _assert_same(tst, jst)
    jpath, tpath = jsave(tmp_path / "jax", jst, 5), save_tree(tmp_path / "port", tst, 5)
    # the same layout: manifests and leaf files identical
    assert (jpath / "manifest.json").read_text() == (tpath / "manifest.json").read_text()
    for f in sorted(jpath.glob("leaf_*.npy")):
        assert f.read_bytes() == (tpath / f.name).read_bytes(), f.name
    # each package restores the other's
    _assert_same(restore_tree(jpath, make_train_state(TConfig(**TINY), 1, device="cpu")), jst)
    _assert_same(jax.tree.map(np.asarray, jrestore(tpath, jst)), jst)


def test_async_save_sweep_and_retention(tmp_path):
    state = _trained_state()
    mgr = CheckpointManager(tmp_path / "m", keep=2)
    for s in range(5):
        mgr.save_async(state, s)
    mgr.wait()
    assert sorted(p.name for p in (tmp_path / "m").glob("step_*")) == \
        ["step_00000000", "step_00000003", "step_00000004"]
    sync = save_tree(tmp_path / "sync", state, 4)
    for f in sorted(sync.iterdir()):
        assert f.read_bytes() == (tmp_path / "m" / "step_00000004" / f.name).read_bytes()
    (tmp_path / "m" / ".tmp-step_00000009").mkdir()
    restored, step = mgr.restore_latest(make_train_state(TConfig(**TINY), 1, device="cpu"))
    assert step == 4 and not list((tmp_path / "m").glob(".tmp-*"))
    _assert_same(restored, state)
    assert clean_stale_tmp(tmp_path / "absent") == []
    assert mgr.restore_latest(state)[1] == 4


class _Run:
    """A TINY exact training run through ``FaultTolerantLoop``: the loss of
    every step index it ran (a replayed index overwrites its entry)."""

    def __init__(self, ckpt_dir, preempt_at=None):
        cfg = TConfig(**TINY)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, seed=0)
        step = make_train_step(cfg, peak_lr=5e-3, warmup=1, total_steps=STEPS)
        self.losses = {}

        def step_fn(state, batch):
            i = int(state.step)
            state, m = step(state, batch)
            self.losses[i] = float(m["loss"])
            if i == preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m

        self.loop = FaultTolerantLoop(
            ckpt_dir=ckpt_dir, make_state=lambda: make_train_state(cfg, 0, device="cpu"),
            step_fn=step_fn, ckpt_every=2,
            batch_at=lambda i: {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})

    def run(self):
        return self.loop.run(STEPS, log=lambda msg: None)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    run = _Run(tmp_path_factory.mktemp("straight"))
    return run.run(), run.losses


def test_restart_after_a_failure_is_bitwise(straight, tmp_path):
    ref, ref_losses = straight
    run = _Run(tmp_path)
    failed = []

    def fail_once(state, batch, inner=run.loop.step_fn):
        if int(state.step) == 2 and not failed:
            failed.append(True)
            raise RuntimeError("injected node failure")
        return inner(state, batch)

    run.loop.step_fn = fail_once
    res = run.run()
    assert failed and res.restarts == 1 and res.steps_done == STEPS and not res.preempted
    assert run.losses == ref_losses
    _assert_same(res.final_state, ref.final_state)


def test_preemption_saves_and_resumes_bitwise(straight, tmp_path):
    ref, ref_losses = straight
    old = signal.getsignal(signal.SIGTERM)
    try:
        run = _Run(tmp_path, preempt_at=1)
        run.loop.install_preemption_handler()
        res = run.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert res.preempted and res.steps_done == 2 and latest_step(tmp_path) == 2
    resumed = _Run(tmp_path)
    res2 = resumed.run()
    assert not res2.preempted and res2.steps_done == STEPS and sorted(resumed.losses) == [2, 3]
    assert {**run.losses, **resumed.losses} == ref_losses
    _assert_same(res2.final_state, ref.final_state)
