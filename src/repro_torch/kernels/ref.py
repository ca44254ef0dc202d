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
* ``flash_attention_ref`` — causal/window/softcap attention of a whole
  sequence from position 0, on the (B, H, S, D) layout: the contiguous
  online softmax of ``models.layers.chunked_attention``.
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        kv_valid_len=None, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        bq: int = 1024, bk: int = 1024) -> torch.Tensor:
    """What ``flash_attention.flash_attention`` computes: q (B, H, Sq, D)
    against k/v (B, KH, Skv, D), ``H % KH == 0`` (query head h reads KV head
    ``h // (H // KH)``), query and key positions their row indices from 0.

    Scores are f32 products of q scaled by ``D ** -0.5`` and k; then the
    softcap ``cap * tanh(s / cap)``; keys at or past ``kv_valid_len`` (None:
    every key; an int; or a (B,) tensor) are masked, and when ``causal`` so
    are keys past the query (``qpos - kpos < 0``) or ``window`` or more
    behind it (``window > 0``), all to ``layers.BIG_NEG``. An online softmax
    over ``bk``-key chunks, ``bq`` queries at a time, keeps the running max,
    sum and output in f32; the output is ``acc / max(l, 1e-30)`` in q's
    dtype, (B, H, Sq, D). Rows that admit no key (``kv_valid_len == 0``)
    and ``kv_valid_len > Skv`` are out of contract.

    This is ``layers.chunked_attention`` on transposed views, with
    ``q_chunk = bq`` and ``chunk = bk``, so it scales q in q's dtype before
    the f32 cast, as that function, the JAX package's ``chunked_attention``
    and the paged-attention kernel do. The JAX Pallas kernel
    (``repro/kernels/flash_attention.py``) casts first and then scales: the
    two orders agree bit for bit in f32 and at D = 16, 64 and 256 (a power
    of two scale), and differ by one bf16 rounding of q at D = 80 and 128 in
    bf16, which the kernel tolerance (one bf16 ulp of the output) covers.
    """
    from repro_torch.models.layers import chunked_attention
    kvl = k.shape[2] if kv_valid_len is None else kv_valid_len
    qpos = torch.arange(q.shape[2], device=q.device)
    out = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), qpos, kvl, causal=causal,
                            window=window, softcap=softcap, chunk=bk,
                            q_chunk=bq)
    return out.transpose(1, 2)
