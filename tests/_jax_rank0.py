"""The JAX package's ``amr_kernel`` at rank 0 without its Pallas kernel,
for the port's CPU gradient tests.

JAX's ``matmul_amr_kernel`` at rank 0 has the ``amr_lut`` oracle's forward
(bit for bit: ``tests/test_torch_moe.py`` holds the port's rank 0 to the
oracle) and ``_lowrank_bwd``, the straight-through surrogate, as its
backward.  ``oracle_rank0()`` composes those two in a ``jax.custom_vjp``
and puts it in place of ``matmul_amr_kernel`` while it is entered, so
that a ``jax.value_and_grad`` under rank 0 runs no Pallas interpret
compile.  Import the fixture ``rank0_by_oracle`` into a test module
(``from _jax_rank0 import rank0_by_oracle  # noqa: F401``) and it applies
to every test there; a module-scoped fixture enters ``oracle_rank0()``
itself (it is set up before any function-scoped fixture).
"""
import contextlib
import importlib
from functools import partial

import jax
import pytest

japprox = importlib.import_module("repro.numerics.approx_matmul")


# one trace a (shapes, border): the models' sites repeat a few shapes
_oracle = jax.jit(japprox.matmul_amr_lut, static_argnums=(2,))


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _lut_ste(a, b, border, rank):
    return _oracle(a, b, border)


def _lut_ste_fwd(a, b, border, rank):
    return _oracle(a, b, border), (a, b)


_lut_ste.defvjp(_lut_ste_fwd, japprox._lowrank_bwd)


@contextlib.contextmanager
def oracle_rank0():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japprox, "matmul_amr_kernel", _lut_ste)
        yield


@pytest.fixture(autouse=True)
def rank0_by_oracle():
    with oracle_rank0():
        yield
