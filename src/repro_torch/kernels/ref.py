"""Plain PyTorch versions of the GEMM kernels (port of ``repro/kernels/ref.py``).

The kernel wrappers take these for tensors that lie on the CPU, and
``chip_smoke.py`` and the card tests hold each CUDA kernel against them on the
card. They run on any device.

* ``systolic_matmul_ref`` — exact integer GEMM with int32 results (what the
  exact PE array computes).
* ``approx_matmul_ref`` — approximate GEMM under the multiplier-approx model:
  product-table gathers with exact int32 accumulation over K.
"""
from __future__ import annotations

import torch


def systolic_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) exact integer GEMM with int32 results.

    Computed in float64, which is exact here: every product of int8 values is
    below 2^14 and every partial sum below 2^53 for K < 2^39, whatever the
    summation order. PyTorch has no integer matmul on CUDA.
    """
    out = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int64).to(torch.int32)


def approx_matmul_ref(a: torch.Tensor, b: torch.Tensor, table_flat: torch.Tensor,
                      *, span: int) -> torch.Tensor:
    """out[m, n] = sum_k table_flat[a_u[m, k] * span + b_u[k, n]], int32.

    ``a``/``b`` hold the operands' bit patterns (any integer dtype; only the
    low log2(span) bits are used). The sum is taken in int64 over chunks of K
    and wrapped to int32 at the end, which equals an int32 accumulation.
    """
    mask = span - 1
    a_idx = (a.to(torch.int64) & mask) * span
    b_idx = b.to(torch.int64) & mask
    table = table_flat.to(torch.int64)
    m, kd = a_idx.shape
    n = b_idx.shape[1]
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    step = max(1, (1 << 24) // max(1, m * n))     # ~16M gathered entries per chunk
    for k0 in range(0, kd, step):
        idx = a_idx[:, k0:k0 + step, None] + b_idx[None, k0:k0 + step, :]
        acc += table[idx].sum(dim=1)
    return acc.to(torch.int32)
