"""Fault tolerance: the port of the JAX package's ``runtime/fault.py``.

  * ``Heartbeat``         — a progress file that external watchdogs (a
                            liveness probe keyed off its mtime) poll;
  * ``StragglerMonitor``  — flags steps slower than ``threshold`` x the
                            running median of the last ``window`` steps;
  * ``FaultTolerantLoop`` — runs a training step function with retry from
                            the last checkpoint on an exception, a save and
                            a resumable return on SIGTERM (preemption),
                            async periodic saves and an ``on_restore`` hook.

``remesh`` stays a hook: on one card a restored state needs no resharding
(None), and the checkpoint restores each leaf onto the device of the fresh
state's leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from repro_torch.ckpt import CheckpointManager


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


@dataclasses.dataclass
class LoopResult:
    steps_done: int
    restarts: int
    preempted: bool
    final_state: Any


class FaultTolerantLoop:
    """Checkpoint/restart training loop with preemption and retry.

    ``step_fn(state, batch) -> (state, metrics)``; ``make_state()`` builds
    a fresh state, whose leaves' devices a restored state takes;
    ``remesh(state)`` reshards a restored state (None on one card);
    ``on_restore(state, step)`` re-establishes what a process must hold
    before stepping a restored state (a registered schedule, say).
    """

    def __init__(self, *, ckpt_dir: str | Path, make_state: Callable[[], Any],
                 step_fn: Callable[[Any, Any], tuple[Any, dict]],
                 batch_at: Callable[[int], Any], ckpt_every: int = 50, keep: int = 3,
                 max_retries: int = 3, remesh: Callable[[Any], Any] | None = None,
                 heartbeat: Heartbeat | None = None,
                 on_restore: Callable[[Any, int], None] | None = None):
        self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.make_state = make_state
        self.step_fn = step_fn
        self.batch_at = batch_at
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.remesh = remesh
        self.heartbeat = heartbeat
        self.on_restore = on_restore
        self.straggler = StragglerMonitor()
        self._preempted = threading.Event()

    def install_preemption_handler(self) -> None:
        """On SIGTERM, save at the next step boundary and return resumable."""
        def handler(signum, frame):  # noqa: ARG001
            self._preempted.set()

        signal.signal(signal.SIGTERM, handler)

    def run(self, total_steps: int, log_every: int = 10, log=print) -> LoopResult:
        restarts = 0
        state, step = self._restore_or_init()
        while step < total_steps:
            try:
                if self._preempted.is_set():
                    self.manager.save(state, step)
                    return LoopResult(step, restarts, True, state)
                t0 = time.time()
                state, metrics = self.step_fn(state, self.batch_at(step))
                dt = time.time() - t0
                if self.straggler.observe(step, dt):
                    log(f"[fault] step {step}: straggler ({dt:.2f}s vs median "
                        f"{self.straggler.median():.2f}s)")
                step += 1
                if self.heartbeat:
                    self.heartbeat.payload = {"step": step}
                if step % self.ckpt_every == 0:
                    self.manager.save_async(state, step)
                if step % log_every == 0:
                    loss = metrics.get("loss")
                    log(f"[train] step {step} loss {float(loss):.4f} ({dt:.2f}s)"
                        if loss is not None else f"[train] step {step} ({dt:.2f}s)")
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 - the node-failure surrogate
                restarts += 1
                log(f"[fault] step {step} failed ({type(e).__name__}: {e}); "
                    f"restart {restarts}/{self.max_retries} from checkpoint")
                if restarts > self.max_retries:
                    raise
                state, step = self._restore_or_init()
        self.manager.wait()
        self.manager.save(state, step)
        return LoopResult(step, restarts, False, state)

    def _restore_or_init(self) -> tuple[Any, int]:
        fresh = self.make_state()
        restored, step = self.manager.restore_latest(fresh)
        if restored is None:
            return fresh, 0
        if self.remesh is not None:
            restored = self.remesh(restored)
        if self.on_restore is not None:
            self.on_restore(restored, int(step))
        return restored, int(step)
