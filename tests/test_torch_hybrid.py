"""SSM training and the hybrid family in the port against the JAX package, on
the CPU.

Inputs are made with numpy from a seed; the models load the JAX package's
``init_params`` through ``params_from_numpy``.

* The SSD scan's gradients (the plain route: autograd through
  ``ssd_scan.ref.ssd_ref``) against ``jax.vjp`` of the JAX package's
  ``ssd_chunked``, in full mode (exact numerics) and split mode (``amr_kernel``
  rank 0: the readout through the seam, its straight-through gradient
  handing d h_prev to the scan), S off the chunk grid, G < H: each
  gradient within 1e-4 of its largest |value| in float32 (sums in other
  orders); with bf16 inputs one bf16 rounding step more on the bf16
  gradients (``ref.ssd_grad_excess``).
* A torch model of the backward kernel's arithmetic (``ssd_scan_bwd.cu``,
  chunk by chunk: the reverse join, the masked tiles, the state and readout
  terms, the reverse cumsum) in float64 against autograd through
  ``ssd_ref``: 1e-5 of each gradient's max (``ssd_ref`` sums in float32).
* Reduced mamba2-370m and zamba2-1.2b in float32: the loss and every
  gradient leaf against ``jax.value_and_grad`` under exact and
  ``amr_kernel`` rank 0: loss within 1e-4 relative, each leaf within 1e-4 of
  its largest |value|; the leaves no computation reads (``unread_params``)
  get exactly zero in both packages; ``remat="block"`` gives the gradients
  of ``"none"`` bit for bit.
* Reduced zamba2-1.2b: the forward, prefill and 3 decode steps against
  JAX's in float32: 1e-4 of the max under exact; under rank 0 the second
  request's first layer output differs from JAX's by one float32 ulp
  (sums in another order), which moves an int8 index of the shared
  attention at a rounding tie (0.55 in that layer's output), so the
  end-to-end logits take the statistical rule of
  ``tests/test_torch_ssm.py`` (correlation >= 0.98, mean |diff| <= 0.2
  mean |JAX|) and each layer is held to JAX's on JAX's own input at
  1e-4; served batched equal to
  solo bit for bit (tokens and logits); its parameter layout through
  ``params_from_numpy``; its train state checkpointed in the JAX layout
  (the same manifest and leaf files as JAX's ``save_tree``, each package
  restoring the other's); the trainer and the server launchers on it.
* ``check_trainable`` refuses none of the registered archs.

No amr_inject run here (held on the card by ``chip_smoke.py``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import save_tree as jsave
from repro.configs.mamba2_370m import reduced as jmamba
from repro.configs.zamba2_1p2b import reduced as jzamba
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_with_cache as jprefill
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.numerics import AMRNumerics as JN
from repro.numerics import numerics_scope as jnumerics_scope
from repro.train.steps import loss_fn as jloss_fn
from repro.train.steps import make_train_state as jmake_state
from repro_torch.ckpt import restore_tree, save_tree
from repro_torch.configs import get_config
from repro_torch.configs.mamba2_370m import reduced as tmamba
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.configs.zamba2_1p2b import reduced as tzamba
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import model as tmodel
from repro_torch.models import prefill_with_cache as tprefill
from repro_torch.models import ssm as tssm
from repro_torch.models import unread_params
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.models.tree import tree_items, tree_map
from repro_torch.numerics import AMRNumerics as TN
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.steps import check_trainable, loss_fn, make_grads_step, make_train_state

from _torch_threads import one_intra_op_thread  # noqa: F401

MODES = [("exact", 8, 8), ("amr_kernel", 8, 0)]
_IDS = lambda m: f"{m[0]}-r{m[2]}"  # noqa: E731
ARCHS = {"mamba2-370m": (jmamba, tmamba), "zamba2-1.2b": (jzamba, tzamba)}
CAP = 24
PROMPTS = [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]
GENS = [3, 5, 4, 3]
# XLA on the CPU may keep a fused float32 chain in higher precision, which
# moves an int8 index at a rounding tie; the port rounds every op
_COMPILE = {"xla_allow_excess_precision": False}


def _jit(fn, *args):
    """``fn(*args)`` compiled without excess precision."""
    return jax.jit(fn).lower(*args).compile(_COMPILE)(*args)


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------- the scan's gradients
def _scan_inputs(B, S, H, P, N, G, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    if dtype == "bfloat16":  # values a bf16 input holds, in both packages
        x, b, c = (np.array(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32)) for t in (x, b, c))
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    a_log = rng.uniform(0.0, 1.5, (H,)).astype(np.float32)
    gy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    gh = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return (x, dt, a_log, b, c), (gy, gh)


def _to_jax(arrs, dtype):
    x, dt, a_log, b, c = arrs
    low = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(x, low), jnp.asarray(dt), jnp.asarray(a_log), jnp.asarray(b, low), \
        jnp.asarray(c, low)


def _to_torch(arrs, dtype):
    x, dt, a_log, b, c = (torch.from_numpy(t) for t in arrs)
    low = getattr(torch, dtype)
    return x.to(low), dt, a_log, b.to(low), c.to(low)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES, ids=["full", "split"])
def test_ssd_scan_gradients_match_jax_vjp(mode, dtype):
    B, S, H, P, N, G, chunk = 2, 40, 4, 8, 16, 2, 16  # G < H, S off the chunk grid
    arrs, (gy, gh) = _scan_inputs(B, S, H, P, N, G, seed=7, dtype=dtype)

    def jfun(*ins):
        return jssm.ssd_chunked(*ins, chunk, return_state=True, numerics=JN(*mode))

    _, vjp = jax.vjp(jfun, *_to_jax(arrs, dtype))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [t.requires_grad_(True) for t in _to_torch(arrs, dtype)]
    y, h = tssm.ssd_chunked(*ins, chunk, return_state=True, numerics=TN(*mode))
    got = torch.autograd.grad((y, h), ins, (torch.from_numpy(gy), torch.from_numpy(gh)))
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        w = torch.tensor(_np(w)).to(g.dtype)
        assert g.shape == w.shape, name
        assert sref.ssd_grad_excess(g, w) <= 1.0, (name, sref.ssd_grad_excess(g, w))


def _kernel_model(x, dt, a_log, b, c, chunk, h_prev, dy, dh_prev, dh_final):
    """ssd_scan_bwd.cu's arithmetic in float64, one (batch, head) and one
    chunk at a time, last chunk first."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep, nc = H // G, math.ceil(S / chunk)
    x, dt, b, c, dy = (t.double() for t in (x, dt, b, c, dy))
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    da = torch.zeros(H, dtype=torch.float64)
    dbh = torch.zeros((B, S, H, N), dtype=torch.float64)
    dch = torch.zeros_like(dbh)
    for bi in range(B):
        for hd in range(H):
            g, A = hd // rep, math.exp(float(a_log[hd]))
            D = dh_final[bi, hd].double()                   # dL/dh after the chunk
            for ci in reversed(range(nc)):
                rows = slice(ci * chunk, min(S, (ci + 1) * chunk))
                L = rows.stop - rows.start
                dts = dt[bi, rows, hd]
                cum = torch.cumsum(-A * dts, 0)
                u = x[bi, rows, hd] * dts[:, None]
                Bm, Cm, dY, hc = b[bi, rows, g], c[bi, rows, g], dy[bi, rows, hd], \
                    h_prev[bi, ci, hd].double()
                e, w, dq = torch.exp(cum), torch.exp(cum[-1] - cum), math.exp(float(cum[-1]))
                readout = dh_prev is None and ci > 0
                # the reverse join: dL/dh_c
                G_c = dq * D + ((Cm * e[:, None]).T @ dY if readout else 0)
                if dh_prev is not None:
                    G_c = G_c + dh_prev[bi, ci, hd].double()
                tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
                dec = torch.where(tri, torch.exp(torch.where(tri, cum[:, None] - cum, -1e30)), 0)
                M = (Cm @ Bm.T) * dec
                dM = dY @ u.T
                dcb, dseg = dM * dec, dM * M
                dC, dB, du = dcb @ Bm, dcb.T @ Cm, M.T @ dY
                dcum = dseg.sum(1) - dseg.sum(0)
                if readout:
                    Z = dY @ hc.T
                    dC = dC + e[:, None] * Z
                    dcum = dcum + e * (Z * Cm).sum(1)
                Y2 = u @ D.T
                dB = dB + w[:, None] * Y2
                du = du + w[:, None] * (Bm @ D)
                V = w * (Bm * Y2).sum(1)
                dcum = dcum - V
                dcum[-1] += dq * float((D * hc).sum()) + V.sum()
                dla = torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0), [0])
                ddt[bi, rows, hd] = (du * x[bi, rows, hd]).sum(1) - A * dla
                dx[bi, rows, hd] = du * dts[:, None]
                da[hd] += -A * float((dts * dla).sum())
                dbh[bi, rows, hd], dch[bi, rows, hd] = dB, dC
                D = G_c
    return (dx, ddt, da, dbh.view(B, S, G, rep, N).sum(3), dch.view(B, S, G, rep, N).sum(3))


@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_backward_kernel_arithmetic_matches_autograd(split):
    B, S, H, P, N, G, chunk = 2, 37, 4, 8, 8, 2, 16
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape))  # noqa: E731
    x, b, c = t(B, S, H, P), t(B, S, G, N), t(B, S, G, N)
    dt = torch.from_numpy(rng.uniform(0.0, 0.1, (B, S, H)))  # the carry shows
    a_log = torch.log(torch.linspace(1.0, 4.0, H, dtype=torch.float64))
    nc = math.ceil(S / chunk)
    dy, dh_final = t(B, S, H, P), t(B, H, N, P)
    dh_prev = t(B, nc, H, N, P) if split else None
    h_prev = sref.ssd_ref(x, dt, a_log, b, c, chunk, split=True)[1]
    grads = (dy, dh_prev, dh_final) if split else (dy, dh_final)
    want = sref.ssd_ref_grads(x, dt, a_log, b, c, chunk, grads, split=split)
    got = _kernel_model(x, dt, a_log, b, c, chunk, h_prev, dy, dh_prev, dh_final)
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        assert _max_rel(g, w) <= 1e-5, name


# ------------------------------------------------------ model loss + grads
def _configs(arch, mode, remat="none"):
    jred, tred = ARCHS[arch]
    jcfg = dataclasses.replace(jred(), dtype="float32", numerics=JN(*mode), remat=remat)
    tcfg = dataclasses.replace(tred(), dtype="float32", numerics=TN(*mode), remat=remat)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's loss and gradients per (arch, mode) on one seeded batch, and
    the weights; computed once per module."""
    toks = np.random.default_rng(0).integers(0, 256, (2, 21)).astype(np.int32)
    out = {}
    for arch in ARCHS:
        jcfg, _ = _configs(arch, MODES[0])
        jp = jinit(jcfg, jax.random.PRNGKey(0))
        for mode in MODES:
            cfg = _configs(arch, mode)[0]
            (loss, _), grads = _jit(jax.value_and_grad(
                lambda p: jloss_fn(cfg, p, toks[:, :-1], toks[:, 1:]), has_aux=True), jp)
            out[arch, mode] = (float(loss), jax.tree.map(np.asarray, grads))
        out[arch] = jax.tree.map(np.asarray, jp)
    return toks, out


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_jax(jax_grads, arch, mode):
    toks, ref = jax_grads
    _, tcfg = _configs(arch, mode)
    params = params_from_numpy(ref[arch], tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    with torch.no_grad():
        loss, _ = loss_fn(tcfg, params, batch["tokens"], batch["targets"])
    grads = make_grads_step(tcfg)(params, batch)
    jloss, jgrads = ref[arch, mode]
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss), (float(loss), jloss)
    jflat = dict(tree_items(jgrads))
    unread = unread_params(tcfg)
    assert unread, arch
    for key, g in tree_items(grads):
        if key in unread:
            assert not g.any() and not jflat[key].any(), key  # zero in both packages
        else:
            assert g.any() and _max_rel(g.numpy(), jflat[key]) <= 1e-4, key


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_block_gives_the_gradients_of_none(arch):
    _, cfg = _configs(arch, MODES[1])
    params = tinit(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)))
    batch = {"tokens": toks, "targets": toks}
    g_none = make_grads_step(cfg)(params, batch)
    g_block = make_grads_step(dataclasses.replace(cfg, remat="block"))(params, batch)
    for (key, a), (_, b) in zip(tree_items(g_none), tree_items(g_block)):
        assert torch.equal(a, b), key


def test_check_trainable_refuses_no_registered_arch():
    for name in ARCH_NAMES:
        check_trainable(get_config(name))
    assert unread_params(get_config("zamba2-1.2b")) == {
        *(f"layers/{i}/ln2" for i in range(19)), "layers/18/ln1", "layers/18/mlp/w_down",
        "layers/18/mlp/w_gate", "layers/18/mlp/w_up"}
    assert unread_params(get_config("mamba2-370m")) == {"layers/0/ln2"}
    assert not unread_params(get_config("gemma3-1b"))


# -------------------------------------------------------- zamba2 serving
def _zamba(mode):
    jcfg = dataclasses.replace(jzamba(), dtype="float32", numerics=JN(*mode))
    tcfg = dataclasses.replace(tzamba(), dtype="float32", numerics=TN(*mode))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _check(got, ref, mode) -> None:
    """float32 at 1e-4 of the max; under rank 0 the end-to-end logits by the
    statistical rule (see the docstring)."""
    got, ref = _np(got), _np(ref)
    if mode[0] == "exact":
        assert _max_rel(got, ref) <= 1e-4
        return
    diff = np.abs(got - ref)
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1] if diff.max() > 0 else 1.0
    assert corr >= 0.98 and diff.mean() <= 0.2 * np.abs(ref).mean(), (corr, diff.mean())


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_zamba2_forward_prefill_decode_match_jax(mode):
    jcfg, jp, tcfg, tp = _zamba(mode)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 20))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jf, (jl, jc) = _jit(lambda p, t: (jforward(jcfg, p, t)[0], jprefill(jcfg, p, t, CAP)),
                        jp, jt)
    with torch.inference_mode():
        _check(tforward(tcfg, tp, tt)[0], jf, mode)
        tl, tc = tprefill(tcfg, tp, tt, CAP)
    _check(tl, jl, mode)
    _check(tc[1].k, jc[1].k, mode)
    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c)).lower(jp, jt[:, -1:], jc).compile(
        _COMPILE)
    tok = toks[:, -1:]
    for _ in range(3):
        jl, jc = step(jp, jnp.asarray(tok, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tdecode(tcfg, tp, torch.from_numpy(tok), tc)
        _check(tl, jl, mode)
        tok = _np(jl)[:, -1].argmax(-1)[:, None]  # both continue from the JAX choice
    assert int(tc[1].length[0]) == int(jc[1].length[0]) == 23


def test_zamba2_rank0_layers_match_jax_on_the_same_input():
    """Each layer of reduced zamba2-1.2b under rank 0 (both kinds, both
    applications of the shared block) against the JAX package's
    ``_apply_layer_full`` on the JAX layer's own input (one compile a
    layer): 1e-4 of the max, where the end-to-end logits differ at a tie
    (see the docstring)."""
    mode = MODES[1]
    jcfg, jp, tcfg, tp = _zamba(mode)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 20))
    x = jnp.asarray(np.asarray(jp["embed"])[toks])
    kinds = jcfg.pattern.kinds
    for g in range(jcfg.pattern.n_repeat):
        for i, kind in enumerate(kinds):
            flat = g * len(kinds) + i
            lp = jax.tree.map(lambda v: v[g], jp["layers"][i])

            def layer(lp, x, kind=kind, flat=flat):
                with jnumerics_scope(layer=flat, static_layer=flat):
                    return jmodel._apply_layer_full(jcfg, lp, x, kind, jp["shared"], None,
                                                    jcfg.numerics)[0]

            want = _jit(layer, lp, x)
            with torch.inference_mode():
                got = tmodel._layer_full(tcfg, kind, flat, None,
                                         tmodel._block_params(tp, kind, i, g),
                                         torch.from_numpy(np.array(x)))[0]
            assert _max_rel(got, _np(want)) <= 1e-4, (g, kind)
            x = want


def _serve(cfg, params, n_slots):
    eng = ServeEngine(cfg, params, n_slots=n_slots, capacity=CAP, record_logits=True,
                      device="cpu")
    for p, g in zip(PROMPTS, GENS):
        eng.submit(Request(prompt=p, max_new_tokens=g))
    return eng.run()


@pytest.mark.parametrize("mode", MODES, ids=_IDS)
def test_zamba2_batched_decode_bit_identical_to_solo(mode):
    _, _, tcfg, tp = _zamba(mode)
    batched, solo = _serve(tcfg, tp, 3), _serve(tcfg, tp, 1)
    assert len(batched) == len(solo) == len(PROMPTS)
    for b, s in zip(batched, solo):
        assert b.tokens == s.tokens and len(b.tokens) > 1
        for lb, ls in zip(b.logits, s.logits):
            np.testing.assert_array_equal(lb, ls)


def test_zamba2_layout_through_params_from_numpy():
    cfg = tzamba()
    jp = jax.tree.map(np.asarray, jinit(jzamba(), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, cfg, "cpu")
    assert set(tp) == {"embed", "final_norm", "layers", "shared"}
    assert set(tp["shared"]) == {"attn", "ln1", "ln2", "mlp"}
    assert set(tp["layers"][0]) == {"ln1", "ln2", "ssm"}
    assert set(tp["layers"][1]) == {"ln1", "ln2", "mlp"}
    assert tp["shared"]["attn"]["wq"].shape == (64, 64)       # one copy, not stacked
    assert tp["layers"][1]["mlp"]["w_up"].shape == (2, 64, 128)  # stacked over the groups
    for key, leaf in tree_items(tp):
        assert np.array_equal(_np(leaf), np.asarray(dict(tree_items(jp))[key], np.float32)), key
    own = tinit(cfg, 0, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == tree_map(
        lambda t: (tuple(t.shape), t.dtype), tp)


def test_zamba2_train_state_checkpoints_in_the_jax_layout(tmp_path):
    jst = jax.tree.map(np.asarray, jmake_state(jzamba(), jax.random.PRNGKey(0)))
    tst = train_state_from_numpy(jst, tzamba(), "cpu")
    jpath, tpath = jsave(tmp_path / "jax", jst, 3), save_tree(tmp_path / "port", tst, 3)
    assert (jpath / "manifest.json").read_text() == (tpath / "manifest.json").read_text()
    for f in sorted(jpath.glob("leaf_*.npy")):
        assert f.read_bytes() == (tpath / f.name).read_bytes(), f.name
    assert any(k.startswith("params/shared/attn/") for k, _ in tree_items(tst))
    restored = restore_tree(jpath, make_train_state(tzamba(), 1, device="cpu"))
    for (key, a), (_, b) in zip(tree_items(restored), tree_items(tst)):
        assert torch.equal(a, b), key


def test_launchers_train_and_serve_zamba2_on_cpu(capsys, tmp_path):
    train_launch.main(["--device", "cpu", "--arch", "zamba2-1.2b", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "20", "--numerics", "amr_kernel", "--rank", "0",
                       "--ckpt-dir", str(tmp_path)])
    serve_launch.main(["--arch", "zamba2-1.2b", "--device", "cpu", "--requests", "2", "--slots",
                       "2", "--prompt-len", "4", "--gen", "2"])
    out = capsys.readouterr().out
    assert "zamba2-1.2b on cpu" in out and "done: 2 steps, 0 restarts" in out
    assert "tok/s end-to-end" in out
