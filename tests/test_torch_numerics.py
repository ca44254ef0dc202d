"""The port's integer numerics held bit for bit against the JAX package.

Inputs are made from a seed with numpy and fed to both packages; the port
runs on the CPU, where its kernel wrappers take their plain versions, and the
JAX GEMM wrappers run their Pallas kernels in interpret mode (chosen by
``ops._on_tpu()`` off TPU). Every comparison here is exact: quantized values,
f32 scales, product tables and int32 accumulators. ``core.gemm`` is held
against the reference in ``test_torch_gemm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import emulate as j_emulate
from repro.core import quant as j_quant
from repro.kernels import ops as j_ops
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import emulate, quant
from repro_torch.kernels import approx_gemm, ops

KS = (0, 2, 4, 6, 8)


def _floats(shape, dtype, seed):
    """f32 or bf16 inputs as (jax array, torch tensor) with identical bits."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[0] = 0.0                      # an all-zero row exercises the eps floor
    jx = jnp.asarray(x, dtype)
    return jx, tensor_from_numpy(np.asarray(jx))


def _ints(shape, seed, lo=-127, hi=128):
    x = np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    """Torch tensor -> numpy, bf16 as its f32 value (exact)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((7, 13), -1), ((7, 13), 0),
                                        ((7, 13), None), ((3, 5, 33), -1)])
def test_quantize_bit_exact(dtype, shape, axis):
    jx, tx = _floats(shape, getattr(jnp, dtype), seed=1)
    jq = j_quant.quantize(jx, axis=axis)
    tq = quant.quantize(tx, axis=axis)
    np.testing.assert_array_equal(np.asarray(jq.values), _np(tq.values))
    assert tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq.scale), _np(tq.scale))


@pytest.mark.parametrize("n_bits,k", [(8, k) for k in range(9)] + [(4, 2)])
def test_product_table_bit_exact(n_bits, k):
    np.testing.assert_array_equal(j_emulate.product_table(n_bits, k, True, 24),
                                  emulate.product_table(n_bits, k, True, 24))


def test_pe_mac_bit_exact_with_accumulator():
    rng = np.random.default_rng(2)
    a, b = rng.integers(-128, 128, (2, 500))
    c = rng.integers(-(1 << 20), 1 << 20, 500)
    for k in (0, 5, 8):
        np.testing.assert_array_equal(
            np.asarray(j_emulate.pe_mac(a, b, c, k=k)),
            emulate.pe_mac(a, b, c, k=k))


ODD_SHAPES = [(5, 37, 11), (17, 130, 9)]


@pytest.mark.parametrize("m,kd,n", ODD_SHAPES)
def test_systolic_matmul_bit_exact(m, kd, n):
    ja, ta = _ints((m, kd), seed=3)
    jb, tb = _ints((kd, n), seed=4)
    np.testing.assert_array_equal(np.asarray(j_ops.systolic_matmul(ja, jb)),
                                  ops.systolic_matmul(ta, tb).numpy())


@pytest.mark.parametrize("k", KS)
def test_approx_matmul_bit_exact(k):
    for m, kd, n in ODD_SHAPES:
        ja, ta = _ints((m, kd), seed=5 + k, lo=-128)
        jb, tb = _ints((kd, n), seed=6 + k, lo=-128)
        np.testing.assert_array_equal(
            np.asarray(j_ops.approx_matmul(ja, jb, k=k)),
            ops.approx_matmul(ta, tb, k=k).numpy())


def test_approx_table_too_wide_for_int16_is_flagged():
    """Unsigned 8-bit products exceed int16: the kernel's int16 copy is
    refused (the CUDA wrapper raises on it), the int32 table stays exact."""
    t = approx_gemm.make_table(4, signed=False)
    assert t.flat16 is None and int(t.flat.max()) > np.iinfo(np.int16).max
    assert approx_gemm.make_table(4).flat16 is not None
