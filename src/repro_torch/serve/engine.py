"""ServeEngine: continuous batching over one shared slot-decode cache.

The port of the JAX package's ``serve/engine.py``.  Lifecycle of a
request:

  submit -> queue (FIFO) -> admit: allocate a slot, prefill
  (``prefill_with_cache``), write the request's cache into the slot row,
  first token from the prefill logits -> decode: one step advances every
  live slot under an active mask -> finish (EOS / max tokens): free the
  slot; the next queued request reuses it.

Correctness invariant: a row's computation depends on that row alone (the
integer AMR sums are exact, and the low-rank kernel sums in an order fixed
by K), so a request decoded in a busy engine yields the same tokens as the
same request served alone.

Fault wiring: an optional ``Heartbeat`` (runtime.fault) publishes
queue/slot/step progress after each admit and each decode step for
external watchdogs, and a ``StragglerMonitor`` flags decode steps slower
than the running median, so a host-side stall shows up as flagged steps
(``stats()["stragglers"]``, and a ``log`` line) rather than as silent tail
latency.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_cache, prefill_with_cache
from repro_torch.models.tree import tree_map
from repro_torch.runtime.fault import Heartbeat, StragglerMonitor
from repro_torch.train.steps import make_serve_step

from .request import Completion, Request, RequestQueue
from .slots import SlotAllocator


def _insert_request(engine_cache: tuple, request_cache: tuple, slot: int) -> None:
    """Write a batch-1 prefill cache into slot row ``slot`` of the engine
    cache, in place.  Leaves are stacked (n_repeat, B, ...): K/V, or an SSM
    layer's conv rings and state; scalar-position length leaves arrive as
    (n_repeat,) and fill the slot's column."""

    def one(e, r):
        e[:, slot] = r[:, 0] if r.dim() == e.dim() else r

    tree_map(one, engine_cache, request_cache)


class ServeEngine:
    """Continuous-batching greedy decoder with ``n_slots`` fixed slots.

    ``params`` must already lie on ``device`` (``init_params`` or
    ``convert.params_from_numpy`` put them there).
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, n_slots: int, capacity: int,
                 record_logits: bool = False, device: str | torch.device = "cuda",
                 heartbeat: Heartbeat | None = None,
                 straggler: StragglerMonitor | None = None,
                 log: Callable[[str], None] | None = None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.capacity = capacity
        self.record_logits = record_logits
        self.queue = RequestQueue()
        self.slots = SlotAllocator(n_slots)
        self.heartbeat = heartbeat
        self.straggler = straggler if straggler is not None else StragglerMonitor()
        self._log = log or (lambda msg: None)

        self.cache = init_cache(cfg, n_slots, capacity, device=self.device, per_slot=True)
        self._active = np.zeros(n_slots, bool)
        self._next_tok = np.zeros(n_slots, np.int32)
        self._slot_req: list[Request | None] = [None] * n_slots
        self._slot_toks: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_logits: list[list] = [[] for _ in range(n_slots)]
        self.completions: list[Completion] = []
        self.steps_done = 0
        self.prefill_seconds = 0.0  # cumulative prefill wall time, first token included
        self.prefill_tokens = 0     # prompt tokens prefilled
        self.decode_seconds = 0.0   # cumulative masked-decode-step wall time
        self.decode_tokens = 0      # tokens produced by decode steps (not prefill)
        self._decode = make_serve_step(cfg, with_logits=record_logits)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> int:
        """Queue a request; returns its uid.  Rejects a request that cannot
        fit the slot cache (prompt + generation exceeds capacity)."""
        need = len(req.prompt) + req.max_new_tokens
        if need > self.capacity:
            raise ValueError(
                f"request needs {need} cache positions "
                f"(prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens}) but slot capacity is {self.capacity}")
        req.t_submit = time.monotonic()
        return self.queue.submit(req)

    # ---------------------------------------------------------- scheduler
    @torch.inference_mode()
    def run(self, max_steps: int | None = None) -> list[Completion]:
        """Drive admit/decode until the queue and all slots drain (or
        ``max_steps`` decode steps ran).  Returns completions in uid order."""
        if self.heartbeat is not None:
            self.heartbeat.start()
        try:
            steps = 0
            while self.queue or self._active.any():
                self._admit()
                if self._active.any():
                    self._decode_once()
                    steps += 1
                    if max_steps is not None and steps >= max_steps:
                        break
        finally:
            if self.heartbeat is not None:
                self._beat()
                self.heartbeat.stop()
        return sorted(self.completions, key=lambda c: c.uid)

    def _beat(self) -> None:
        if self.heartbeat is None:
            return
        self.heartbeat.payload = {
            "step": self.steps_done,
            "active_slots": int(self._active.sum()),
            "queued": len(self.queue),
            "completed": len(self.completions),
        }
        # written now, not at the timer's next tick: liveness on disk tracks
        # the scheduler's progress
        self.heartbeat.beat()

    def _admit(self) -> None:
        """Admit queued requests into free slots, FIFO order."""
        while self.queue and self.slots.n_free:
            req = self.queue.pop()
            slot = self.slots.allocate()
            req.t_admit = time.monotonic()
            toks = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
            logits, rcache = prefill_with_cache(self.cfg, self.params, toks, self.capacity)
            _insert_request(self.cache, rcache, slot)
            last = logits[0, -1].float()
            first = int(torch.argmax(last))  # host read: waits for the prefill
            req.t_first_token = time.monotonic()
            self.prefill_seconds += req.t_first_token - req.t_admit
            self.prefill_tokens += len(req.prompt)
            self._slot_req[slot] = req
            self._slot_toks[slot] = [first]
            self._slot_logits[slot] = [last.cpu().numpy()] if self.record_logits else []
            self._active[slot] = True
            self._next_tok[slot] = first
            self._maybe_finish(slot)
            self._beat()

    def _decode_once(self) -> None:
        """One masked decode step for every live slot."""
        batch = {
            "token": torch.from_numpy(self._next_tok).to(self.device, torch.int64)[:, None],
            "active": torch.from_numpy(self._active).to(self.device),
        }
        t0 = time.monotonic()
        out = self._decode(self.params, self.cache, batch)
        if self.record_logits:
            next_tok, last_logits, self.cache = out
            logits_host = last_logits.cpu().numpy()
        else:
            next_tok, self.cache = out
            logits_host = None
        tok_host = next_tok.cpu().numpy()  # waits for the step: true step time
        dt = time.monotonic() - t0
        self.decode_seconds += dt
        self.steps_done += 1
        self.decode_tokens += int(self._active.sum())
        if self.straggler.observe(self.steps_done, dt):
            self._log(f"[serve] step {self.steps_done}: straggler ({dt * 1e3:.1f}ms vs "
                      f"median {self.straggler.median() * 1e3:.1f}ms)")
        for slot in np.flatnonzero(self._active):
            self._slot_toks[slot].append(int(tok_host[slot]))
            if logits_host is not None:
                self._slot_logits[slot].append(logits_host[slot])
            self._next_tok[slot] = int(tok_host[slot])
            self._maybe_finish(slot)
        self._beat()

    # ------------------------------------------------------------ finish
    def _maybe_finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        toks = self._slot_toks[slot]
        reason = None
        if req.eos_id is not None and toks and toks[-1] == req.eos_id:
            reason = "eos"
        elif len(toks) >= req.max_new_tokens:
            reason = "length"
        if reason is None:
            return
        self.completions.append(Completion(
            uid=req.uid, prompt=req.prompt, tokens=tuple(toks),
            finish_reason=reason, t_submit=req.t_submit, t_admit=req.t_admit,
            t_first_token=req.t_first_token, t_done=time.monotonic(),
            logits=self._slot_logits[slot] if self.record_logits else None))
        self._active[slot] = False
        self._next_tok[slot] = 0
        self._slot_req[slot] = None
        self._slot_toks[slot] = []
        self._slot_logits[slot] = []
        self.slots.free(slot)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "steps": self.steps_done,
            "completed": len(self.completions),
            "active_slots": int(self._active.sum()),
            "queued": len(self.queue),
            "stragglers": len(self.straggler.flagged),
        }
