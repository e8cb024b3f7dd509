"""The port's product tables and low-rank factors against the JAX package's.

The port builds its tables with its own copy of the paper's arithmetic
(``repro_torch.core``); they must equal ``repro.core.lut``'s numpy-engine
tables bit for bit, and the SVD factors built from them must be the same
float32 arrays (same numpy SVD on the same table).
"""
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro_torch.core import lut as tlut

BORDERS = [None, 8, 13, 14]


@pytest.mark.parametrize("border", BORDERS)
def test_table_bitwise_equal(border):
    got = tlut.build_int8_lut(border, engine="numpy")
    assert got.dtype == np.int32 and got.shape == (256, 256)
    np.testing.assert_array_equal(got, jlut.build_int8_lut(border, engine="numpy"))
    assert tlut.table_max_abs(border) == jlut.table_max_abs(border, engine="numpy")


def test_exact_table_and_error_stats_equal():
    np.testing.assert_array_equal(tlut.exact_int8_table(), jlut.exact_int8_table())
    assert tlut.error_stats(8) == jlut.error_stats(8, engine="numpy")


@pytest.mark.parametrize("border,rank", [(8, 8), (8, 1), (13, 4), (14, 16)])
def test_lowrank_factors_equal(border, rank):
    got = tlut.lowrank_factor(border, rank)
    ref = jlut.lowrank_factor(border, rank, engine="numpy")
    np.testing.assert_array_equal(got.u, ref.u)
    np.testing.assert_array_equal(got.v, ref.v)
    assert got.residual_fro == ref.residual_fro
    # sigma_{r+1} bounds every entry of the residual E - U V^T
    err = tlut.build_int8_lut(border, engine="numpy").astype(np.float64) - tlut.exact_int8_table()
    resid = err - got.u.astype(np.float64) @ got.v.T.astype(np.float64)
    assert np.abs(resid).max() <= got.sigma_next * (1 + 1e-6)


def test_device_tensors_match_tables():
    cpu = torch.device("cpu")
    table = tlut.table_tensor(8, cpu)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), tlut.build_int8_lut(8, engine="numpy"))
    assert tlut.table_tensor(8, cpu) is table  # cached per (border, device)
    u, v = tlut.factor_tensors(8, 8, cpu)
    np.testing.assert_array_equal(u.numpy(), tlut.lowrank_factor(8, 8).u)
    np.testing.assert_array_equal(v.numpy(), tlut.lowrank_factor(8, 8).v)
