"""Training on the card against training on the CPU: reduced amr-paper-100m.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided when the test runs, never at import).  Run
on a GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py

One AdamW step of reduced amr-paper-100m in float32 per training policy,
from the same weights (``init_params`` on the CPU, moved) on the same
``SyntheticLM`` batch: the card runs the hand kernels, the CPU their plain
versions.  The tolerances are ``chip_smoke.py`` phase 9a's.  Where the
products are integer sums (rank 0, amr_inject): the loss within 1e-4
relative, each gradient leaf within 1e-3 of its max |CPU| value.  Where
they are float sums whose int8 indices may sit at a rounding tie (rank 8,
amr_lowrank; a moved index moves every later layer): the loss within 1e-2
relative, the gradients by the correlation rule of
``tests/test_torch_gemma3.py`` (correlation >= 0.98, mean |diff| <= 0.15
mean |CPU|).  The next step's loss, on the updated params, likewise.  In
every mode the quantizations of one forward agree call by call: the
rounded values ``x / scale`` within 1e-3 int8 steps until and at the first
call where an index moves (so a moved index sat at a rounding tie).  The
card step also launches the kernels of its mode, and no other.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import amr_paper
from repro_torch.data import SyntheticLM
from repro_torch.kernels.amr_matmul import kernel
from repro_torch.kernels.attn_fused import kernel as akernel
from repro_torch.kernels.inject_replay import kernel as rkernel
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.models import init_params
from repro_torch.models.tree import tree_items, tree_map
from repro_torch.numerics import AMRNumerics
from repro_torch.numerics.quant import record_quantizations
from repro_torch.optim import adamw_init
from repro_torch.train.steps import TrainState, loss_fn, make_grads_step, make_train_step

pytestmark = pytest.mark.cuda

GATHERS = {"amr_matmul_int8_lut", "amr_matmul_int8_lut_grouped"}
POLICIES = [  # (numerics, kernels launched, float sums held by the correlation rule)
    (AMRNumerics("amr_lowrank", border=8, rank=16), set(), True),
    (AMRNumerics("amr_kernel", border=8, rank=0), GATHERS, False),
    (AMRNumerics("amr_kernel", border=8, rank=8), {"amr_matmul_int8"}, True),
    (AMRNumerics("amr_inject", border=8), {"inject_replay"}, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, statistical: bool) -> bool:
    g, w = got.detach().float().cpu().numpy().ravel(), want.detach().float().numpy().ravel()
    diff = np.abs(g - w)
    if not np.isfinite(g).all():
        return False
    if statistical:
        corr = np.corrcoef(g, w)[0, 1] if w.std() > 0 else 1.0
        return corr >= 0.98 and diff.mean() <= 0.15 * np.abs(w).mean()
    return diff.max() <= 1e-3 * max(np.abs(w).max(), 1e-30)


def _max_step_diff_to_first_move(got: list, want: list) -> float:
    """Two quantization traces: the largest |difference| of the rounded
    values, in int8 steps, over the calls until and at the first call
    where an int8 index moves."""
    assert len(got) == len(want)
    worst = 0.0
    for (xg, qg), (xw, qw) in zip(got, want):
        worst = max(worst, float((xg.cpu() - xw).abs().max()))
        if bool((qg.cpu() != qw).any()):
            break
    return worst


@pytest.mark.parametrize("numerics,uses,statistical", POLICIES,
                         ids=["amr_lowrank", "rank0", "rank8", "amr_inject"])
def test_one_training_step_on_the_card_equals_the_cpu(cuda, numerics, uses, statistical):
    cfg = dataclasses.replace(amr_paper.reduced(), dtype="float32", numerics=numerics)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    params = init_params(cfg, 0, device="cpu")
    kernels = kernel.KERNELS + rkernel.KERNELS + skernel.KERNELS + akernel.KERNELS
    out = []
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(0).items()}
        with torch.no_grad(), record_quantizations() as trace:
            loss_fn(cfg, p, batch["tokens"], batch["targets"])
        for k in kernels:
            k.launches = 0
        grads = make_grads_step(cfg)(p, batch)
        state = TrainState(p, adamw_init(p), torch.zeros((), dtype=torch.int32, device=dev))
        step = make_train_step(cfg, peak_lr=3e-3, warmup=1)
        state, m0 = step(state, batch)
        _, m1 = step(state, {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(1).items()})
        out.append((grads, [float(m0["loss"]), float(m1["loss"])], trace))
        torch.cuda.synchronize()
        launched = {k.name for k in kernels if k.launches}
    assert launched == uses
    (g_cpu, l_cpu, t_cpu), (g_card, l_card, t_card) = out
    assert _max_step_diff_to_first_move(t_card, t_cpu) <= 1e-3
    rtol = 1e-2 if statistical else 1e-4
    for a, b in zip(l_card, l_cpu):
        assert abs(a - b) <= rtol * abs(b), (l_card, l_cpu)
    want = dict(tree_items(g_cpu))
    for key, g in tree_items(g_card):
        assert _close(g, want[key], statistical), key
