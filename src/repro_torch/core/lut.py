"""Product-table models of the approximate GEMM (port of ``repro/core/lut.py``).

The multiplier-approx model: ``approx(a*b + c) ~= T[a, b] + c`` with ``T``
the PE's 2^N x 2^N product table at c = 0 (``emulate.product_table``,
uploaded once per device by ``kernels/approx_gemm.make_table``).

* ``table_gather_matmul`` — out[m, n] = sum_kk T[a[m, kk], b[kk, n]] over any
  flat table; the loop shared by ``lut_matmul`` and the error-delta defect
  cancellation. Torch ops, chunked over K so one chunk's (M, K-chunk, N)
  gather stays small.
* ``lut_matmul`` — the gather GEMM over the int32 product table.
* ``build_onehot_weights`` / ``onehot_matmul`` — the one-hot rewrite:
  ``onehot(A) (M, K*V) @ T_B (K*V, N)`` with ``T_B[k*V + v, n] =
  T[v, b[k, n]]``, a plain matrix product (the reference leaves it to XLA).
  The product runs in full float32 (TF32 off): every partial sum is an
  integer below 2^24, so the result is exact in any order.
"""
from __future__ import annotations

import torch

GATHER_CHUNK = 1 << 24       # gathered entries per K-chunk
ONEHOT_CHUNK = 1 << 26       # one-hot entries per row chunk


def _flat_table(n_bits, k, signed, acc_bits, device) -> torch.Tensor:
    """The flat (span*span,) int32 product table on ``device``, uploaded once
    (the cache of ``kernels/approx_gemm``)."""
    from repro_torch.kernels import approx_gemm
    return approx_gemm.make_table(k, n_bits=n_bits, signed=signed,
                                  acc_bits=acc_bits, device=device).flat


def table_gather_matmul(a_u: torch.Tensor, b_u: torch.Tensor,
                        flat_table: torch.Tensor, *, span: int) -> torch.Tensor:
    """Gather-GEMM over any (span*span,) table: out[m, n] = sum_kk
    T[a[m, kk] * span + b[kk, n]], accumulated in the table's dtype (int32
    wraps as in the reference; f32 sums feed a rounding that is exact
    whatever their order)."""
    m, kd = a_u.shape
    n = b_u.shape[1]
    a_idx = a_u.long() * span
    b_idx = b_u.long()
    out = torch.zeros((m, n), dtype=flat_table.dtype, device=a_u.device)
    step = max(1, GATHER_CHUNK // max(1, m * n))
    for k0 in range(0, kd, step):
        idx = a_idx[:, k0:k0 + step, None] + b_idx[None, k0:k0 + step, :]
        out += flat_table[idx].sum(dim=1, dtype=flat_table.dtype)
    return out


def lut_matmul(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 8,
               k: int = 4, signed: bool = True,
               acc_bits: int = 24) -> torch.Tensor:
    """(M, K) x (K, N) approximate GEMM via product-table gathers, int32."""
    span = 1 << n_bits
    a_u = a.to(torch.int32) & (span - 1)
    b_u = b.to(torch.int32) & (span - 1)
    flat = _flat_table(n_bits, k, signed, acc_bits, a.device)
    return table_gather_matmul(a_u, b_u, flat, span=span)


def build_onehot_weights(b: torch.Tensor, *, n_bits: int = 8, k: int = 4,
                         signed: bool = True,
                         acc_bits: int = 24) -> torch.Tensor:
    """T_B (K*V, N) float32 for ``onehot_matmul`` from ``b`` (K, N)."""
    span = 1 << n_bits
    table = _flat_table(n_bits, k, signed, acc_bits, b.device).reshape(
        span, span)
    b_u = (b.to(torch.int32) & (span - 1)).long()
    t_b = table[:, b_u]                               # (V, K, N)
    kk, nn = b_u.shape
    return t_b.permute(1, 0, 2).reshape(kk * span, nn).to(torch.float32)


def onehot_matmul(a: torch.Tensor, t_b: torch.Tensor, *,
                  n_bits: int = 8) -> torch.Tensor:
    """Approximate GEMM as an exact product: onehot(A) (M, K*V) @ T_B.

    The one-hot is built in bf16 (0/1 is exact), as in the reference, and
    multiplied in float32. Rows are independent, so the product runs over
    row chunks that keep the one-hot operand below ``ONEHOT_CHUNK`` entries.
    """
    span = 1 << n_bits
    a_u = (a.to(torch.int32) & (span - 1)).long()
    m, kk = a_u.shape
    if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("onehot_matmul needs full-f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    out = torch.empty((m, t_b.shape[1]), dtype=torch.int32, device=a.device)
    rows = max(1, ONEHOT_CHUNK // max(1, kk * span))
    for r0 in range(0, m, rows):
        onehot = torch.nn.functional.one_hot(a_u[r0:r0 + rows], span).to(
            torch.bfloat16)                                   # (R, K, V)
        prod = torch.matmul(onehot.reshape(-1, kk * span).to(torch.float32),
                            t_b)
        out[r0:r0 + rows] = prod.to(torch.int32)
    return out
