"""Checkpointing: atomic, async, with retention, in the JAX package's layout.

The port of the JAX package's ``ckpt/checkpoint.py``, with the same files::

    <dir>/step_00000123/
        manifest.json     # {"step": 123, "leaves": {key: {file, shape, dtype}}}
        leaf_00000.npy    # one full array per leaf, in the tree's flatten order

Keys and leaf order are the JAX package's (``models.tree.tree_items``:
``params/layers/0/attn/wq``, ``opt/mu/...``, ``opt/count``, ``step``), so
a checkpoint written by either package restores in the other, bit for bit.
bfloat16 leaves are stored as their uint16 bit patterns with the logical
dtype ``"bfloat16"`` in the manifest (through torch's own ``view``; numpy
has no bfloat16).

  * Atomic: a save writes ``.tmp-step_N`` and renames it, so a save cut
    short never leaves a torn ``step_N``; ``clean_stale_tmp`` sweeps the
    debris on the next restore.
  * Async: ``CheckpointManager.save_async`` copies the tree to host memory
    on the caller's thread and writes it in a background thread.
  * Retention: the newest ``keep`` checkpoints are kept, and step 0 always.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.models.tree import tree_items, tree_map, tree_unflatten

# numpy has no bfloat16: its bits go to disk as uint16
_BF16 = "bfloat16"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to save, logical dtype name) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:  # an ml_dtypes array handed over from numpy
        return arr.view(np.uint16), _BF16
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=logical))


def save_tree(directory: str | Path, tree: Any, step: int) -> Path:
    """Synchronous atomic save; returns the checkpoint's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp-step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for i, (key, leaf) in enumerate(tree_items(tree)):
        arr, logical = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest[key] = {"file": fname, "shape": list(arr.shape), "dtype": logical}
    (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def restore_tree(path: str | Path, abstract_tree: Any) -> Any:
    """Restore into the structure of ``abstract_tree``: each leaf takes the
    device of the abstract tree's leaf at its key (values are ignored).
    Raises where a key is missing or a shape or dtype differs."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())["leaves"]
    items = tree_items(abstract_tree)
    if len(items) != len(manifest):
        raise ValueError(f"{path}: {len(manifest)} leaves, the tree has {len(items)}")
    leaves = []
    for key, like in items:
        meta = manifest.get(key)
        if meta is None:
            raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
        t = _from_numpy(np.load(path / meta["file"]), meta["dtype"])
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"{path} leaf {key!r}: {tuple(t.shape)} {t.dtype}, the tree has "
                             f"{tuple(like.shape)} {like.dtype}")
        leaves.append(t.to(like.device))
    return tree_unflatten(abstract_tree, leaves)


def _steps(directory: Path) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*"))


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def clean_stale_tmp(directory: str | Path) -> list[str]:
    """Remove ``.tmp-step_*`` debris of saves killed mid-write (it never
    matches ``step_*``, so it cannot shadow a good checkpoint); returns the
    removed names."""
    directory = Path(directory)
    if not directory.exists():
        return []
    removed = []
    for p in directory.glob(".tmp-step_*"):
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p.name)
    return sorted(removed)


class CheckpointManager:
    """Async save + retention + restore-latest."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, tree: Any, step: int) -> None:
        """Copy ``tree`` to host memory now (the caller may then change the
        live tensors) and write it in a background thread."""
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self.wait()

        def write():
            try:
                save_tree(self.directory, host_tree, step)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def save(self, tree: Any, step: int) -> Path:
        self.wait()
        out = save_tree(self.directory, tree, step)
        self._gc()
        return out

    def wait(self) -> None:
        """Join the background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, abstract_tree: Any):
        """(tree, step) of the newest checkpoint, or (None, None)."""
        self.wait()
        clean_stale_tmp(self.directory)
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_tree(self.directory / f"step_{step:08d}", abstract_tree), step

    def _gc(self) -> None:
        for s in _steps(self.directory)[:-self.keep]:
            if s != 0:
                shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
