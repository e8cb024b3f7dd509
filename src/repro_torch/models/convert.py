"""Load a parameter tree, or a training state, exported to numpy into the
port's layout.

The JAX package's ``init_params`` tree, exported with
``jax.tree.map(np.asarray, params)``, has the same nesting, shapes and
dtypes as the port's (``model.param_specs``), whisper's stacked
``encoder`` tree, ``enc_norm`` and each layer's ``xattn`` / ``ln_x`` and a
VLM's ``vision_proj`` included, so both packages can compute on the same
weights; the float32 leaves (norm scales, the SSM's ``a_log``,
``dt_bias``, ``d_skip``, the MoE router) stay float32.  bfloat16 arrays
arrive as ``ml_dtypes.bfloat16`` numpy arrays, which torch cannot read
directly; they are reinterpreted
through their 16-bit pattern.  This module never imports JAX.
``train_state_from_numpy`` does the same for a JAX ``TrainState``
(params, AdamW ``mu``/``nu``/``master``/``count``, ``step``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from .model import _is_spec, param_specs


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy torch may own
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree, cfg: ModelConfig, device: str | torch.device = "cuda"):
    """Numpy parameter tree -> the port's tensors on ``device``.

    Raises ``ValueError`` naming the leaf when a key, shape or dtype differs
    from the layout ``cfg`` implies.
    """
    dev = resolve_device(device)

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: keys {got} != expected {sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{path}.{k}" if path else k) for k in spec}
        if not _is_spec(spec):
            if not isinstance(node, (tuple, list)) or len(node) != len(spec):
                raise ValueError(f"{path}: expected a sequence of {len(spec)} entries")
            return tuple(convert(n, s, f"{path}[{i}]") for i, (n, s) in enumerate(zip(node, spec)))
        shape, dtype, _ = spec
        t = _tensor(np.asarray(node))
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} {dtype}")
        return t.to(dev)

    return convert(tree, param_specs(cfg), "")


def train_state_from_numpy(state, cfg: ModelConfig, device: str | torch.device = "cuda"):
    """A training state exported to numpy -> the port's ``TrainState`` on
    ``device``.  ``state`` has ``params``, ``opt`` (``mu``, ``nu``,
    ``master``, ``count``) and ``step`` as attributes (the JAX dataclasses
    after ``jax.tree.map(np.asarray, ...)``) or as dict keys.  The moments
    and the master copy are float32 in every leaf; ``count`` and ``step``
    int32 scalars."""
    from repro_torch.optim import AdamWState  # lazy: the optimizer imports the models
    from repro_torch.train.steps import TrainState

    def get(node, key):
        return node[key] if isinstance(node, dict) else getattr(node, key)

    dev = resolve_device(device)
    opt = get(state, "opt")
    f32 = dataclasses.replace(cfg, dtype="float32")

    def scalar(x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.shape != () or arr.dtype != np.int32:
            raise ValueError(f"expected an int32 scalar, got {arr.shape} {arr.dtype}")
        return torch.from_numpy(np.array(arr)).to(dev)

    return TrainState(
        params_from_numpy(get(state, "params"), cfg, dev),
        AdamWState(*(params_from_numpy(get(opt, k), f32, dev) for k in ("mu", "nu", "master")),
                   scalar(get(opt, "count"))),
        scalar(get(state, "step")))
