"""The port's ServeEngine: parity with the JAX engine, batched-vs-solo
exactness, EOS handling, device discipline of the entry points, and the
rule that the port imports nothing of JAX or the JAX package.

Token streams are compared exactly (float32 reduced gemma-2b, where the
logits of the two packages agree to ~3e-6, far inside the top-1 margins of
these prompts).  Batched-vs-solo inside the port holds the tokens and the
float32 logits bit for bit, as the JAX engine does: the integer AMR sums
are exact, and every float product whose rows belong to different requests
(the LM head, the exact matmuls, the rank > 0 attention product) runs one
request or one group per call.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs.gemma_2b import reduced as jreduced
from repro.models import init_params as jinit
from repro.numerics import AMRNumerics as JN
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs.gemma_2b import reduced as treduced
from repro_torch.launch import serve as tlaunch
from repro_torch.models import init_params as tinit
from repro_torch.models.convert import params_from_numpy
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.serve import Request, ServeEngine

from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CAP = 24
PROMPTS = [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]
GENS = [3, 5, 4, 3]


def _setup(mode):
    jcfg = dataclasses.replace(jreduced(), dtype="float32", numerics=JN(*mode))
    tcfg = dataclasses.replace(treduced(), dtype="float32", numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _serve(engine_cls, request_cls, cfg, params, n_slots, **kw):
    eng = engine_cls(cfg, params, n_slots=n_slots, capacity=CAP, **kw)
    for p, g in zip(PROMPTS, GENS):
        eng.submit(request_cls(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("mode", [("exact", 8, 8), ("amr_kernel", 8, 0), ("amr_kernel", 8, 8)],
                         ids=lambda m: f"{m[0]}-r{m[2]}")
def test_token_streams_match_jax_engine(mode):
    jcfg, jp, tcfg, tp = _setup(mode)
    ref = _serve(JEngine, JRequest, jcfg, jp, 2)
    got = _serve(ServeEngine, Request, tcfg, tp, 2, device="cpu")
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in ref]


@pytest.mark.parametrize("mode", [("exact", 8, 8), ("amr_lut", 8, 8), ("amr_kernel", 8, 0),
                                  ("amr_kernel", 8, 8)], ids=lambda m: f"{m[0]}-r{m[2]}")
def test_batched_decode_bit_identical_to_solo(mode):
    _, _, tcfg, tp = _setup(mode)
    batched = _serve(ServeEngine, Request, tcfg, tp, 3, record_logits=True, device="cpu")
    solo = _serve(ServeEngine, Request, tcfg, tp, 1, record_logits=True, device="cpu")
    assert len(batched) == len(solo) == len(PROMPTS)
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)


def test_eos_finishes_early():
    _, _, tcfg, tp = _setup(("amr_kernel", 8, 0))
    eng = ServeEngine(tcfg, tp, n_slots=1, capacity=CAP, device="cpu")
    eng.submit(Request(prompt=PROMPTS[1], max_new_tokens=8))
    [ref] = eng.run()
    # the first token whose first occurrence is at index >= 1: stopping there
    # proves the engine ran on past earlier tokens and stopped at the EOS
    idx = next(i for i, t in enumerate(ref.tokens) if i >= 1 and t not in ref.tokens[:i])
    eng2 = ServeEngine(tcfg, tp, n_slots=1, capacity=CAP, device="cpu")
    eng2.submit(Request(prompt=PROMPTS[1], max_new_tokens=8, eos_id=ref.tokens[idx]))
    [done] = eng2.run()
    assert done.finish_reason == "eos"
    assert done.tokens == ref.tokens[:idx + 1]


def test_capacity_guard_and_slot_reuse():
    _, _, tcfg, tp = _setup(("exact", 8, 8))
    eng = ServeEngine(tcfg, tp, n_slots=2, capacity=CAP, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(prompt=PROMPTS[0], max_new_tokens=CAP))
    for p in PROMPTS * 2:
        eng.submit(Request(prompt=p, max_new_tokens=2))
    done = eng.run()
    assert len(done) == 2 * len(PROMPTS) and eng.slots.n_free == 2 and not eng.queue


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    cfg = treduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit(cfg)
    params = tinit(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, n_slots=1, capacity=CAP)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--requests", "1", "--gen", "1", "--prompt-len", "2"])


def test_launcher_runs_on_cpu(capsys):
    tlaunch.main(["--device", "cpu", "--requests", "2", "--slots", "2", "--prompt-len", "4",
                  "--gen", "2", "--numerics", "amr_kernel", "--rank", "0"])
    assert "tok/s end-to-end" in capsys.readouterr().out


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
