"""Bit-level emulation of the paper's exact/approximate fused-MAC PE.

Port of ``repro/core/emulate.py``. ``pe_mac`` and ``product_table`` are numpy:
the table is built once per configuration on the host, and numpy's native
uint32 words carry the carry-save state exactly as the reference's jnp.uint32
words do. ``pe_mac_t`` and the GEMM-chain oracle ``matmul_oracle`` run the same
word-wide bit operations as torch ops on int64 words (every word is masked to
``acc_bits`` <= 32 bits, so the low 32 bits, which are all that is kept, are
those of the uint32 arithmetic), on the operands' device.

The PE computes ``a*b + c`` (N-bit operands, ``acc_bits``-bit accumulator) via a
carry-save array of PPC/NPPC cells; columns ``< k`` use the approximate cells of
Table I, the rest are exact. Bit ``w`` of the words ``S``/``C`` is the sum/carry
bit of column ``w``; one partial-product row is absorbed into (S, C) with a few
word-wide bitwise ops. The Baugh-Wooley decomposition supplies the NPPC
positions and the two's-complement correction constant.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

U32 = np.uint32


class PEConfig(NamedTuple):
    n_bits: int = 8        # operand width N
    k: int = 0             # approximation factor: columns < k use approximate cells
    signed: bool = True    # Baugh-Wooley signed vs plain unsigned array
    acc_bits: int = 24     # fused accumulator width (two's complement when signed)


def _rows_and_masks(cfg: PEConfig):
    """Per-row cell positions and the Baugh-Wooley constant (mod 2**acc_bits).

    rows[i] = (ppc_cols, nppc_cols), each a list of (col, a_bit, b_bit).
    """
    n, acc = cfg.n_bits, cfg.acc_bits
    rows = []
    if not cfg.signed:
        for i in range(n):
            rows.append(([(i + j, j, i) for j in range(n)], []))
        const = 0
    else:
        for i in range(n - 1):
            ppc = [(i + j, j, i) for j in range(n - 1)]
            nppc = [(i + n - 1, n - 1, i)]          # ~(a_{N-1} b_i)
            rows.append((ppc, nppc))
        # row N-1: ~(a_j b_{N-1}) for j<N-1, plus a_{N-1}b_{N-1} at 2N-2
        rows.append((
            [(2 * n - 2, n - 1, n - 1)],
            [(j + n - 1, j, n - 1) for j in range(n - 1)],
        ))
        # constant: +2^N - 2^{2N-1}  (mod 2^acc)
        const = (2 ** n - 2 ** (2 * n - 1)) % (2 ** acc)
    return rows, const


def _absorb_row(s, c, e, m_ppc, m_nppc, ak, acc_mask):
    """Absorb one addend row into the carry-save state (word-parallel cells).

    e: effective addend bits (p at PPC positions, ~p at NPPC positions).
    m_ppc/m_nppc: position masks. ak: mask of approximate columns.
    """
    ex = ~ak & acc_mask
    x = s ^ e                                   # exact full adder everywhere
    s_exact = x ^ c
    c_exact = (s & e) | (c & x)
    sc = s | c                                  # approximate PPC
    s_ap = sc & ~e
    c_ap = e
    c_an = sc & e                               # approximate NPPC (e holds ~p)
    s_an = ~c_an
    ap = ak & m_ppc
    an = ak & m_nppc
    s_new = (s_exact & ex) | (s_ap & ap) | (s_an & an)
    c_new = (c_exact & ex) | (c_ap & ap) | (c_an & an)
    return s_new & acc_mask, (c_new << U32(1)) & acc_mask


def _pe_mac_u32(a_u, b_u, c_u, cfg: PEConfig):
    acc_mask = U32((1 << cfg.acc_bits) - 1)
    rows, const = _rows_and_masks(cfg)
    s = (c_u + U32(const)) & acc_mask   # accumulator + BW constant seed the array
    c = np.zeros_like(s)
    k_mask = U32(((1 << cfg.k) - 1) if cfg.k > 0 else 0)
    one = U32(1)
    for ppc, nppc in rows:
        e = np.zeros_like(s)
        m_ppc = 0
        m_nppc = 0
        for col, abit, bbit in ppc:
            p = ((a_u >> U32(abit)) & one) & ((b_u >> U32(bbit)) & one)
            e = e | (p << U32(col))
            m_ppc |= 1 << col
        for col, abit, bbit in nppc:
            q = (((a_u >> U32(abit)) & one) & ((b_u >> U32(bbit)) & one)) ^ one
            e = e | (q << U32(col))
            m_nppc |= 1 << col
        ak = k_mask & U32(m_ppc | m_nppc)
        s, c = _absorb_row(s, c, e, U32(m_ppc), U32(m_nppc), ak, acc_mask)
    return (s + c) & acc_mask            # final carry-propagate add


def pe_mac(a, b, c=0, *, n_bits: int = 8, k: int = 0, signed: bool = True,
           acc_bits: int = 24) -> np.ndarray:
    """Emulate the PE's fused ``a*b + c``; broadcasts over any batch shape.

    a, b: integers (interpreted mod 2^n_bits, two's complement if signed).
    c: accumulator input (mod 2^acc_bits). Returns int32, sign-extended if
    signed. k=0 is the exact PE; k>0 approximates columns < k per Table I.
    """
    cfg = PEConfig(n_bits, k, signed, acc_bits)
    op_mask = (1 << n_bits) - 1
    a_u = (np.asarray(a, np.int64) & op_mask).astype(U32)
    b_u = (np.asarray(b, np.int64) & op_mask).astype(U32)
    c_u = (np.asarray(c, np.int64) & ((1 << acc_bits) - 1)).astype(U32)
    a_u, b_u, c_u = np.broadcast_arrays(a_u, b_u, c_u)
    out = _pe_mac_u32(a_u, b_u, c_u, cfg).astype(np.int64)
    if signed:
        half, full = 1 << (acc_bits - 1), 1 << acc_bits
        out = np.where(out >= half, out - full, out)
    return out.astype(np.int32)


@functools.lru_cache(maxsize=32)
def product_table(n_bits: int = 8, k: int = 0, signed: bool = True,
                  acc_bits: int = 24) -> np.ndarray:
    """(2^N, 2^N) int32 table T[a_u, b_u] = pe_mac(a, b, 0): the approximate product.

    Indexed by the *unsigned bit pattern* of each operand (``x & (2^N - 1)``).
    The cached array is read-only; copy it before writing.
    """
    span = 1 << n_bits
    av = np.arange(span, dtype=np.int64)
    out = pe_mac(np.repeat(av, span), np.tile(av, span), 0, n_bits=n_bits,
                 k=k, signed=signed, acc_bits=acc_bits).reshape(span, span)
    out.setflags(write=False)
    return out


def _pe_mac_words(a_u: torch.Tensor, b_u: torch.Tensor, c_u: torch.Tensor,
                  cfg: PEConfig) -> torch.Tensor:
    """``_pe_mac_u32`` on int64 torch words (values < 2^acc_bits)."""
    acc_mask = (1 << cfg.acc_bits) - 1
    rows, const = _rows_and_masks(cfg)
    s = (c_u + const) & acc_mask
    c = torch.zeros_like(s)
    k_mask = ((1 << cfg.k) - 1) if cfg.k > 0 else 0
    ex_all = acc_mask
    for ppc, nppc in rows:
        e = torch.zeros_like(s)
        m_ppc = 0
        m_nppc = 0
        for col, abit, bbit in ppc:
            p = ((a_u >> abit) & 1) & ((b_u >> bbit) & 1)
            e = e | (p << col)
            m_ppc |= 1 << col
        for col, abit, bbit in nppc:
            q = (((a_u >> abit) & 1) & ((b_u >> bbit) & 1)) ^ 1
            e = e | (q << col)
            m_nppc |= 1 << col
        ak = k_mask & (m_ppc | m_nppc)
        ex = ~ak & ex_all
        x = s ^ e
        s_exact = x ^ c
        c_exact = (s & e) | (c & x)
        sc = s | c
        s_ap = sc & ~e
        c_an = sc & e
        s_an = ~c_an
        ap = ak & m_ppc
        an = ak & m_nppc
        s_new = (s_exact & ex) | (s_ap & ap) | (s_an & an)
        c_new = (c_exact & ex) | (e & ap) | (c_an & an)
        s, c = s_new & acc_mask, (c_new << 1) & acc_mask
    return (s + c) & acc_mask


def pe_mac_t(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             n_bits: int = 8, k: int = 0, signed: bool = True,
             acc_bits: int = 24) -> torch.Tensor:
    """``pe_mac`` on torch tensors (broadcasting), int32 results."""
    if acc_bits > 32:
        raise ValueError(f"acc_bits must be <= 32, got {acc_bits}")
    cfg = PEConfig(n_bits, k, signed, acc_bits)
    a_u = a.to(torch.int64) & ((1 << n_bits) - 1)
    b_u = b.to(torch.int64) & ((1 << n_bits) - 1)
    c_u = c.to(torch.int64) & ((1 << acc_bits) - 1)
    a_u, b_u, c_u = torch.broadcast_tensors(a_u, b_u, c_u)
    out = _pe_mac_words(a_u, b_u, c_u, cfg)
    if signed:
        half, full = 1 << (acc_bits - 1), 1 << acc_bits
        out = torch.where(out >= half, out - full, out)
    return out.to(torch.int32)


def matmul_oracle(a_mat: torch.Tensor, b_mat: torch.Tensor, *,
                  n_bits: int = 8, k: int = 0, signed: bool = True,
                  acc_bits: int = 24) -> torch.Tensor:
    """GEMM through a chain of fused-MAC PEs, the systolic array's dataflow.

    (M, K) x (K, N) integers -> (M, N) int32: the partial sum flows through
    the same approximate PE for k = 0..K-1, as in the array. A K-step loop of
    word-wide bit operations on (M, N) tensors, on the operands' device.
    """
    m_dim, k_dim = a_mat.shape
    k2, n_dim = b_mat.shape
    if k_dim != k2:
        raise ValueError(f"matmul_oracle wants (M,K) x (K,N), got "
                         f"{tuple(a_mat.shape)} x {tuple(b_mat.shape)}")
    acc = torch.zeros((m_dim, n_dim), dtype=torch.int32, device=a_mat.device)
    for kk in range(k_dim):
        acc = pe_mac_t(a_mat[:, kk, None], b_mat[None, kk, :], acc,
                       n_bits=n_bits, k=k, signed=signed, acc_bits=acc_bits)
    return acc
