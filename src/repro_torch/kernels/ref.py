"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

The kernel wrappers take these for tensors that lie on the CPU, and
``chip_smoke.py`` and the card tests hold each CUDA kernel against them on the
card. They run on any device.

* ``systolic_matmul_ref`` — exact integer GEMM with int32 results (what the
  exact PE array computes).
* ``approx_matmul_ref`` — approximate GEMM under the multiplier-approx model:
  product-table gathers with exact int32 accumulation over K.
* ``paged_attention_ref`` — attention over a paged KV pool: the block-table
  gather path of ``models.layers.chunked_attention``.
* ``delta_matmul_fused_ref`` — the exact int8 base plus the rank-r f32
  correction of the error-delta decomposition, rounded per K-block.
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


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        kv_valid_len, q_positions: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        chunk: int = 1024) -> torch.Tensor:
    """What ``paged_attention.paged_attention`` computes, by the gather path:
    each KV chunk's blocks are gathered through the table (padded with the
    dump row to the chunk grid), int8 payloads dequantized, and attended to
    with the online softmax of ``layers.chunked_attention``."""
    from repro_torch.models.layers import chunked_attention
    return chunked_attention(q, k_pool, v_pool, q_positions, kv_valid_len,
                             causal=causal, window=window, softcap=softcap,
                             chunk=chunk, block_tables=block_tables)


def delta_matmul_fused_ref(a_s: torch.Tensor, b_s: torch.Tensor,
                           f_flat: torch.Tensor, g_flat: torch.Tensor, *,
                           rank: int, span: int = 256,
                           bk: int = 256) -> torch.Tensor:
    """What ``delta_gemm.delta_matmul_fused`` computes, block by block:
    ``sum over K-blocks of bk rows of [a_s @ b_s + round(sum_j F_j @ G_j)]``
    with ``F_j[m, kk] = f_flat[a_u[m, kk] * rank + j]`` and ``G_j[kk, n] =
    g_flat[j * span + b_u[kk, n]]``.

    The base is exact (``systolic_matmul_ref``); each block's correction is an
    f32 sum of the r rank-one products in the reference's order (one f32
    matrix product per j, added in turn) and rounded half to even. At the
    exact rank every block's correction rounds to the same integer whatever
    ``bk`` and the summation order; at a truncated rank it depends on both.
    """
    out = systolic_matmul_ref(a_s, b_s)
    if not rank:
        return out
    mask = span - 1
    kd = a_s.shape[1]
    a_u = a_s.to(torch.int64) & mask
    b_u = b_s.to(torch.int64) & mask
    f_t = f_flat.reshape(span, rank)
    g_t = g_flat.reshape(rank, span)
    for k0 in range(0, kd, bk):
        au, bu = a_u[:, k0:k0 + bk], b_u[k0:k0 + bk]
        corr = torch.zeros(out.shape, dtype=torch.float32, device=a_s.device)
        for j in range(rank):
            corr += torch.matmul(f_t[au, j], g_t[j][bu])
        out += torch.round(corr).to(torch.int32)
    return out
