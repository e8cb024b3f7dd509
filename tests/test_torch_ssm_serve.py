"""The port's ServeEngine on reduced mamba2-370m: token streams against the
JAX engine, batched-vs-solo exactness, the slot state of an inactive
request, and the launcher.

Tokens are compared exactly (float32, where the two packages' logits agree
to about 1e-6, far inside the top-1 margins of these prompts); batched and
solo logits bit for bit: every float product whose rows belong to
different requests runs one request per call, and on the CPU the SSM
decode's elementwise step runs one row at a time.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.mamba2_370m import reduced as jreduced
from repro.models import init_params as jinit
from repro.numerics import AMRNumerics as JN
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs.mamba2_370m import reduced as treduced
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tree import tree_map
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.serve import Request, ServeEngine

from _torch_threads import one_intra_op_thread  # noqa: F401

# the four modes of tests/test_torch_serve.py; amr_inject is held to the JAX
# package op for op in tests/test_torch_ssm.py and on the card by chip_smoke
MODES = [("exact", 8, 8), ("amr_lut", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
CAP = 24
PROMPTS = [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]
GENS = [3, 5, 4, 3]


def _configs(mode):
    jcfg = dataclasses.replace(jreduced(), dtype="float32", numerics=JN(*mode))
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


# ---------------------------------------------------------------- the engine
def _serve(engine_cls, request_cls, cfg, params, n_slots, **kw):
    eng = engine_cls(cfg, params, n_slots=n_slots, capacity=CAP, **kw)
    for p, g in zip(PROMPTS, GENS):
        eng.submit(request_cls(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("mode", [MODES[0], MODES[2]], ids=_IDS)
def test_token_streams_match_jax_engine(mode):
    jcfg, jp, tcfg, tp = _configs(mode)
    ref = _serve(JEngine, JRequest, jcfg, jp, 2)
    got = _serve(ServeEngine, Request, tcfg, tp, 2, device="cpu")
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in ref]


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_batched_decode_bit_identical_to_solo(mode):
    _, _, tcfg, tp = _configs(mode)
    batched = _serve(ServeEngine, Request, tcfg, tp, 3, record_logits=True, device="cpu")
    solo = _serve(ServeEngine, Request, tcfg, tp, 1, record_logits=True, device="cpu")
    assert len(batched) == len(solo) == len(PROMPTS)
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)


def test_inactive_slot_state_kept_bit_for_bit():
    _, _, tcfg, tp = _configs(MODES[2])
    eng = ServeEngine(tcfg, tp, n_slots=2, capacity=CAP, device="cpu")
    eng.submit(Request(prompt=PROMPTS[0], max_new_tokens=4))
    eng._admit()
    before = tree_map(lambda t: t[:, 1].clone(), eng.cache)
    eng._decode_once()
    after = tree_map(lambda t: t[:, 1], eng.cache)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), after, before)
    assert not torch.equal(eng.cache[0].h[:, 0], torch.zeros_like(eng.cache[0].h[:, 0]))


def test_launcher_serves_mamba_on_cpu(capsys):
    tlaunch.main(["--arch", "mamba2-370m", "--device", "cpu", "--requests", "2", "--slots", "2",
                  "--prompt-len", "4", "--gen", "2", "--numerics", "amr_kernel", "--rank", "0"])
    out = capsys.readouterr().out
    assert "mamba2-370m" in out and "tok/s end-to-end" in out
