"""The port's serving fault wiring: ``runtime.fault.Heartbeat`` and
``StragglerMonitor`` against the JAX package's, and their wiring into
``ServeEngine`` and the launcher (reduced gemma3-1b, float32, on the CPU),
as ``tests/test_serve_engine.py`` checks the JAX engine's."""
import dataclasses
import json
import time

import numpy as np
import pytest

from repro.runtime.fault import StragglerMonitor as JStragglerMonitor
from repro_torch.configs.gemma3_1b import reduced
from repro_torch.launch import serve as tlaunch
from repro_torch.models import init_params
from repro_torch.runtime import Heartbeat, StragglerMonitor
from repro_torch.serve import Request, ServeEngine

CAP = 24
PROMPTS = [(5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 11), (3, 11, 4, 1), (13, 2, 7), (9, 7, 9, 1, 2)]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced(), dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def test_heartbeat_writes_whole_payloads(tmp_path):
    hb = Heartbeat(tmp_path / "sub" / "hb.json", interval_s=0.01)
    hb.payload = {"step": 3}
    hb.start()
    try:
        deadline = time.monotonic() + 10
        while not hb.path.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hb.path.exists(), "the timer thread wrote no beat"
    finally:
        hb.stop()
    assert not hb._thread.is_alive()
    hb.payload = {"step": 4, "queued": 0}
    hb.beat()
    payload = json.loads(hb.path.read_text())
    assert payload["step"] == 4 and payload["queued"] == 0 and payload["t"] <= time.time()
    assert sorted(p.name for p in hb.path.parent.iterdir()) == ["hb.json"]  # no .tmp left


@pytest.mark.parametrize("window,threshold", [(50, 2.5), (6, 1.5)])
def test_straggler_monitor_matches_jax(window, threshold):
    """The same step times give the same flags, medians and window."""
    times = np.random.default_rng(window).exponential(1.0, 60)
    times[[7, 20, 41]] *= 10.0
    mine, ref = StragglerMonitor(window, threshold), JStragglerMonitor(window, threshold)
    for step, dt in enumerate(times):
        assert mine.observe(step, float(dt)) == ref.observe(step, float(dt))
        assert mine.median() == ref.median()
    assert mine.flagged == ref.flagged and list(mine.times) == list(ref.times)
    assert any(step in (7, 20, 41) for step, _, _ in mine.flagged)


def test_straggler_needs_five_steps_before_flagging():
    mon = StragglerMonitor(window=10, threshold=2.5)
    assert not any(mon.observe(i, dt) for i, dt in enumerate([1.0, 1.0, 1.0, 1.0, 100.0]))
    assert mon.median() == 1.0
    assert not mon.observe(5, 2.5) and mon.observe(6, 2.6)
    assert mon.flagged == [(6, 2.6, 1.0)]


def test_engine_heartbeat_and_straggler_wiring(model, tmp_path):
    cfg, params = model
    hb = Heartbeat(tmp_path / "hb.json", interval_s=60.0)
    mon = StragglerMonitor(window=10, threshold=2.5)
    eng = ServeEngine(cfg, params, n_slots=2, capacity=CAP, heartbeat=hb, straggler=mon,
                      device="cpu")
    for p in PROMPTS:
        eng.submit(Request(prompt=p, max_new_tokens=4))
    done = eng.run()
    payload = json.loads((tmp_path / "hb.json").read_text())
    assert payload["completed"] == len(done) == len(PROMPTS)
    assert payload["queued"] == 0 and payload["active_slots"] == 0
    assert payload["step"] == eng.steps_done
    # every decode step was observed by the straggler monitor
    assert len(mon.times) == min(eng.steps_done, 10)
    assert eng.stats() == {"steps": eng.steps_done, "completed": len(PROMPTS),
                           "active_slots": 0, "queued": 0, "stragglers": len(mon.flagged)}


def test_engine_logs_each_flagged_step(model):
    """threshold 0: every step after the first five is flagged, logged and
    counted in stats()."""
    cfg, params = model
    lines = []
    eng = ServeEngine(cfg, params, n_slots=2, capacity=CAP, device="cpu",
                      straggler=StragglerMonitor(window=10, threshold=0.0), log=lines.append)
    for p in PROMPTS:
        eng.submit(Request(prompt=p, max_new_tokens=5))
    eng.run()
    assert eng.steps_done > 5
    assert eng.stats()["stragglers"] == len(lines) == eng.steps_done - 5
    assert all("straggler" in line for line in lines)


def test_engine_without_heartbeat_writes_nothing(model, tmp_path, monkeypatch):
    cfg, params = model
    monkeypatch.chdir(tmp_path)
    eng = ServeEngine(cfg, params, n_slots=1, capacity=CAP, device="cpu")
    eng.submit(Request(prompt=PROMPTS[1], max_new_tokens=3))
    eng.run()
    assert eng.stats()["stragglers"] == 0 and not list(tmp_path.iterdir())


def test_launcher_serves_gemma3_with_a_heartbeat(tmp_path, capsys):
    path = tmp_path / "hb.json"
    tlaunch.main(["--arch", "gemma3-1b", "--device", "cpu", "--requests", "3", "--slots", "2",
                  "--prompt-len", "10", "--gen", "3", "--heartbeat", str(path)])
    out = capsys.readouterr().out
    assert "gemma3-1b on cpu" in out and "tok/s end-to-end" in out
    payload = json.loads(path.read_text())
    assert payload["completed"] == 3 and payload["queued"] == 0 and payload["active_slots"] == 0
