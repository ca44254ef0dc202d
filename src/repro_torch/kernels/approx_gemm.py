"""Approximate systolic GEMM (product-table model): the CUDA kernel
``csrc/approx_gemm.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/approx_gemm.py::approx_matmul_lut``:
``out[m, n] = sum_k T[a_u[m, k] * span + b_u[k, n]]`` with int32 accumulation,
where ``T`` is the PE's approximate-product table (``core.emulate.product_table``).
On the H100 every product is a shared-memory lookup, so the kernel is bound by
M*N*K lookups on the CUDA cores; the source note in ``csrc/approx_gemm.cu``
gives the design. The kernel stages an int16 copy of the table in shared
memory, so a table must fit int16 to run on the card (``ProductTable``).

``launches`` counts the kernel's launches; it changes only where the kernel
is launched.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import emulate
from . import _build
from .ref import approx_matmul_ref

NAME = "approx_gemm"
launches = 0


@dataclasses.dataclass(frozen=True)
class ProductTable:
    """The flattened (span*span,) product table of one PE configuration on one
    device: ``flat`` in int32 (the plain version's), ``flat16`` in int16 (the
    kernel's, ``None`` when an entry does not fit int16 — e.g. an unsigned
    8-bit table, whose products exceed 32767)."""
    span: int
    flat: torch.Tensor
    flat16: torch.Tensor | None


_TABLES: Dict[Tuple, ProductTable] = {}


def make_table(k: int, *, n_bits: int = 8, signed: bool = True,
               acc_bits: int = 24, device="cpu") -> ProductTable:
    """The product table for factor ``k`` on ``device``, built and uploaded once."""
    device = torch.device(device)
    key = (n_bits, k, signed, acc_bits, device)
    hit = _TABLES.get(key)
    if hit is None:
        flat = emulate.product_table(n_bits, k, signed, acc_bits).reshape(-1)
        fits = bool(flat.min() >= np.iinfo(np.int16).min
                    and flat.max() <= np.iinfo(np.int16).max)
        hit = ProductTable(
            span=1 << n_bits,
            flat=torch.from_numpy(flat.copy()).to(device),
            flat16=(torch.from_numpy(flat.astype(np.int16)).to(device)
                    if fits else None))
        _TABLES[key] = hit
    return hit


@functools.cache
def _lib():
    lib = _build.load(NAME)
    fn = lib.approx_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def approx_matmul_lut(a: torch.Tensor, b: torch.Tensor,
                      table: ProductTable) -> torch.Tensor:
    """(M, K) x (K, N) via table lookups -> (M, N) int32.

    ``a``/``b`` are int8 bit patterns (the low log2(span) bits index the
    table; ``a`` is the row index, ``b`` the column index). CPU tensors take
    the plain version (``ref.approx_matmul_ref``); CUDA tensors launch the
    kernel on the current stream, or raise — also ``ValueError`` when the
    table does not fit int16.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return approx_matmul_ref(a, b, table.flat, span=table.span)
    _build.check_gemm_operands(NAME, a, b, table.flat)
    if table.flat16 is None:
        raise ValueError("product table has entries outside int16; the CUDA "
                         "kernel stages the table as int16 in shared memory")
    n_bits = table.span.bit_length() - 1
    global launches
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), table.flat16.data_ptr(),
                 out.data_ptr(), m, n, k, n_bits, _build.sm_count(a.device),
                 stream)
    launches += 1
    _build.check(NAME, err)
    return out
