"""int8 quantization of the port against the JAX package, bit for bit.

Both packages are called op by op on the same numpy inputs; the int8
indices and the float32 scales must be identical on float32 and bfloat16
inputs (the division runs in the input dtype, the scale is cast after it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.numerics import quant as jq
from repro_torch.numerics import quant as tq

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 30.0, shape[:-1] + (1,))
    x[..., 0] = 0.0
    x.reshape(-1)[:7] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.5, -128.5]  # rounding ties
    return x.astype(np.float32)


def _pair(x, dtypes):
    jd, td = dtypes
    xj = jnp.asarray(x).astype(jd)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
    return xj, xt


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", [((48, 80), None), ((48, 80), -1), ((48, 80), 0),
                                        ((3, 16, 40), -2)])
def test_quantize_int8_bitwise(dtypes, shape, axis):
    xj, xt = _pair(_inputs(shape), dtypes)
    qj, sj = jq.quantize_int8(xj, axis=axis)
    qt, st = tq.quantize_int8(xt, axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_quantize_int8_ste_forward_bitwise(dtypes, axis):
    xj, xt = _pair(_inputs((4, 24, 32), seed=1), dtypes)
    qj, sj = jq.quantize_int8_ste(xj, axis=axis)
    qt, st = tq.quantize_int8_ste(xt, axis=axis)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_dequantize_matches():
    xj, xt = _pair(_inputs((16, 32), seed=2), DTYPES[0])
    qj, sj = jq.quantize_int8(xj, axis=-1)
    qt, st = tq.quantize_int8(xt, axis=-1)
    np.testing.assert_array_equal(tq.dequantize(qt, st).numpy(),
                                  np.asarray(jq.dequantize(qj, sj)))
