"""Exact int8 systolic GEMM: the CUDA kernel ``csrc/systolic_gemm.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/systolic_gemm.py::systolic_matmul``
(the exact PE array on the MXU). On the H100 the decode GEMMs (M = batch = 4)
are bound by the weight bytes read from device memory; the source note in
``csrc/systolic_gemm.cu`` gives the design. The kernel masks ragged edges
itself, so unlike the TPU wrapper no operand is padded.

``launches`` counts the kernel's launches; it changes only where the kernel
is launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import systolic_matmul_ref

NAME = "systolic_gemm"
launches = 0


@functools.cache
def _lib():
    lib = _build.load(NAME)
    fn = lib.systolic_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def systolic_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact.

    CPU tensors take the plain version (``ref.systolic_matmul_ref``); CUDA
    tensors launch the kernel on the current stream, or raise.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return systolic_matmul_ref(a, b)
    _build.check_gemm_operands(NAME, a, b)
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
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                 _build.sm_count(a.device), stream)
    launches += 1
    _build.check(NAME, err)
    return out
