"""Data pipeline: the port's own copy of the JAX package's numpy-only
``data/pipeline.py`` (the port imports nothing of the JAX package); the
tests hold its batches bitwise against the original's.

``SyntheticLM`` — stateless, index-addressable batches (batch i is a pure
function of (seed, i)): restarts and elastic resharding resume mid-stream
with no iterator state to checkpoint. Sequences follow a noisy affine
recurrence over the vocab, so models *can* learn them — the quickstart
example shows a real loss drop, not noise.

``MemmapDataset`` — packed uint16/uint32 token files, windowed without
copying (np.memmap); per-host sharding by process index for multi-host.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.05
    n_hosts: int = 1
    host_id: int = 0

    def batch_at(self, index: int) -> dict[str, np.ndarray]:
        """Deterministic batch for global step ``index`` (host's slice)."""
        rng = np.random.default_rng((self.seed, index, self.host_id))
        b = self.batch // self.n_hosts
        a = 6364136223846793005 % self.vocab or 5
        c = 1442695040888963407 % self.vocab or 7
        x0 = rng.integers(0, self.vocab, (b, 1))
        toks = [x0]
        for _ in range(self.seq_len):
            nxt = (a * toks[-1] + c) % self.vocab
            flip = rng.random((b, 1)) < self.noise
            rand = rng.integers(0, self.vocab, (b, 1))
            toks.append(np.where(flip, rand, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, : self.seq_len], "targets": seq[:, 1 : self.seq_len + 1]}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


@dataclasses.dataclass
class MemmapDataset:
    path: str | Path
    seq_len: int
    batch: int
    dtype: str = "uint16"
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len

    def batch_at(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index, self.host_id))
        b = self.batch // self.n_hosts
        starts = rng.integers(0, self._n_windows, b) * self.seq_len
        toks = np.stack([self._data[s : s + self.seq_len + 1] for s in starts])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1
