"""Heartbeat and straggler detection: the serving half of the JAX package's
``runtime/fault.py``.

  * ``Heartbeat``        — a progress file that external watchdogs (a
                           liveness probe keyed off its mtime) poll;
  * ``StragglerMonitor`` — flags steps slower than ``threshold`` x the
                           running median of the last ``window`` steps.

The restart half (``FaultTolerantLoop``: retry from checkpoint, preemption,
elastic remesh) needs the checkpoint layer and comes with training.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path


class Heartbeat:
    """Writes ``{"t": time.time(), **payload}`` to ``path`` on each ``beat``
    and, between ``start`` and ``stop``, every ``interval_s`` seconds."""

    def __init__(self, path: str | Path, interval_s: float = 10.0):
        self.path = Path(path)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.payload: dict = {}

    def start(self) -> None:
        def run():
            while not self._stop.wait(self.interval_s):
                self.beat()

        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        # tmp + rename: watchdogs poll this file concurrently, and a reader
        # must never see a half-written payload
        tmp = self.path.with_name(self.path.name + ".tmp")
        tmp.write_text(json.dumps({"t": time.time(), **self.payload}))
        os.replace(tmp, self.path)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)


class StragglerMonitor:
    """Flags step times above ``threshold`` x the running median (window-robust)."""

    def __init__(self, window: int = 50, threshold: float = 2.5):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.flagged: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        med = self.median()
        is_straggler = med is not None and dt > self.threshold * med
        if is_straggler:
            self.flagged.append((step, dt, med))
        self.times.append(dt)
        return is_straggler

    def median(self) -> float | None:
        """The running median, once 5 steps have been seen."""
        if len(self.times) < 5:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]
