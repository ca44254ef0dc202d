"""Fused exact-plus-error-delta GEMM: the CUDA kernel ``csrc/delta_gemm.cu`` and
its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/delta_gemm.py::delta_matmul_fused``:
``out = sum over K-blocks of [dot_i8(a, b) + round(sum_j f_j[a_u] g_j[b_u])]``,
an exact int8 GEMM plus the rank-r float32 correction of
``core/error_delta.py``, rounded per K-block. At the exact rank it is
bit-identical to the product-table GEMM (``approx_gemm``). On the H100 the
correction's f32 FMAs on the CUDA cores bound it; the source note in
``csrc/delta_gemm.cu`` gives the design. The kernel masks ragged edges itself,
so no operand is padded.

``launches`` counts the kernel's launches; it changes only where the kernel
is launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import delta_matmul_fused_ref

NAME = "delta_gemm"
KERNEL_BK = 64           # the CUDA kernel's K-block (rounding granularity)
launches = 0


def plain_bk(kd: int, pref: int = 256, align: int = 8) -> int:
    """The K-block of the plain version: the block the JAX wrapper gives its
    kernel off the TPU (``ops._blocks(K, 256, 8)``), so that at a truncated
    rank without residual the plain version rounds where the reference does
    (for K a multiple of it)."""
    if kd <= align:
        return kd if kd > 0 else align
    return max(align, (min(pref, kd) // align) * align)


@functools.cache
def _lib():
    lib = _build.load(NAME)
    fn = lib.delta_gemm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def delta_matmul_fused(a_s: torch.Tensor, b_s: torch.Tensor,
                       f_flat: torch.Tensor, g_flat: torch.Tensor, *,
                       rank: int, span: int = 256) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) int32 via base product + rank-r correction.

    ``a_s``/``b_s`` hold the signed operand values as int8; ``f_flat`` /
    ``g_flat`` are the flat f32 factors of ``error_delta.factor_tables``
    (``(span * rank,)``, or ``(span,)`` zeros at rank 0). CPU tensors take the
    plain version (``ref.delta_matmul_fused_ref`` with the reference's block
    ``plain_bk(K)``); CUDA tensors launch the kernel on the current stream, or
    raise.
    """
    if span & (span - 1) or not 2 <= span <= 256:
        raise ValueError(f"span must be a power of two in [2, 256], got {span}")
    tab = span * max(rank, 1)
    if f_flat.shape != (tab,) or g_flat.shape != (tab,):
        raise ValueError(f"f/g must be ({tab},), got {tuple(f_flat.shape)} "
                         f"and {tuple(g_flat.shape)} at rank {rank}")
    if a_s.device.type == "cpu" and b_s.device.type == "cpu":
        return delta_matmul_fused_ref(a_s, b_s, f_flat, g_flat, rank=rank,
                                      span=span, bk=plain_bk(a_s.shape[1]))
    _build.check_gemm_operands(NAME, a_s, b_s, f_flat, g_flat)
    if (f_flat.dtype != torch.float32 or g_flat.dtype != torch.float32
            or not (f_flat.is_contiguous() and g_flat.is_contiguous())):
        raise TypeError("delta_gemm wants contiguous float32 factors")
    global launches
    m, k = a_s.shape
    n = b_s.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a_s.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    fn = _lib()
    with torch.cuda.device(a_s.device):
        stream = torch.cuda.current_stream(a_s.device).cuda_stream
        err = fn(a_s.data_ptr(), b_s.data_ptr(), f_flat.data_ptr(),
                 g_flat.data_ptr(), out.data_ptr(), m, n, k, rank,
                 span.bit_length() - 1, _build.sm_count(a_s.device), stream)
    launches += 1
    _build.check(NAME, err)
    return out
