"""Exact-plus-error-delta decomposition of the approximate product table
(port of ``repro/core/error_delta.py``).

The approximate PE differs from the exact PE only in the columns ``< k`` of
its partial-product array, so its product table is the exact product plus a
structured error term:

    T_k[a, b] = a * b + E_k[a, b],      E_k = product_table(k) - product_table(0)

``E_k`` depends only on the low k bits of each operand, so its rank is far
below 2^N (for N = 8 signed: 0/1/2/4/7/12/21/37/62 at k = 0..8). An SVD gives
``f (span, r)`` and ``g (r, span)`` with ``E ~= f @ g``; at the exact rank
rounding recovers every entry, and the approximate GEMM becomes an exact int8
GEMM plus a rank-r float32 correction:

    out = A_s @ B_s + round(F_A @ G_B)

with ``F_A[m, kk*r + j] = f[a_u[m, kk], j]`` and ``G_B[kk*r + j, n] =
g[j, b_u[kk, n]]``. The tables (SVDs, factors, residual and defect) are numpy
float64/float32 exactly as in the reference, so the f32 factors are the same
bits; the GEMM paths are torch ops on the operands' device. On that device:

* ``delta_matmul_prepared`` (bound weights) runs the base through the exact
  int8 kernel (``kernels/systolic_gemm``) and the correction as one f32
  matrix product, rounded once, as the reference leaves it to XLA. An f32
  product on the card must run in full f32: with TF32 the sums lose their
  integer part, so it raises when ``torch.backends.cuda.matmul.allow_tf32``
  is on.
* the unbound GEMM (``kernels.ops.approx_delta_matmul``) runs the fused
  CUDA kernel ``kernels/delta_gemm``, which rounds per K-block.

For truncated ranks two residual views are kept: ``residual = E -
round(f @ g)`` (int32) and ``defect = E - f @ g`` (float32). Bit-exactness at
any rank comes from gathering ``defect`` and rounding **once** over
``correction + defect``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .emulate import product_table

# A rank is "exact" when the float64 reconstruction error is below this guard:
# small enough that per-entry rounding is exact and that float32 block-wise
# accumulation (error ~1e-2 at K-block 512) stays well below 0.5.
EXACT_RECON_EPS = 1e-6

# Restricted SVDs stay cheap: above this many distinct patterns the generic
# factors are reused.
RESTRICT_MAX_PATTERNS = 128


class DeltaFactors(NamedTuple):
    """Rank-r factorization of the error table for one (n_bits, k, signed, acc_bits)."""
    n_bits: int
    k: int
    signed: bool
    acc_bits: int
    rank: int
    f: np.ndarray          # (span, rank) float32 — indexed by a's bit pattern
    g: np.ndarray          # (rank, span) float32 — indexed by b's bit pattern
    residual: np.ndarray   # (span, span) int32 — E - round(f @ g)
    defect: np.ndarray     # (span, span) float32 — E - f @ g
    max_err: float         # max |f @ g - E| (float64 reconstruction)

    @property
    def exact(self) -> bool:
        return not self.residual.any()


@functools.lru_cache(maxsize=32)
def error_table(n_bits: int = 8, k: int = 4, signed: bool = True,
                acc_bits: int = 24) -> np.ndarray:
    """(2^N, 2^N) int32 table E[a_u, b_u] = T_k[a_u, b_u] - a*b (zero for k=0)."""
    t_k = product_table(n_bits, k, signed, acc_bits).astype(np.int64)
    t_0 = product_table(n_bits, 0, signed, acc_bits).astype(np.int64)
    return (t_k - t_0).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _svd(n_bits: int, k: int, signed: bool, acc_bits: int):
    e = error_table(n_bits, k, signed, acc_bits).astype(np.float64)
    return np.linalg.svd(e)


def _recon_err(n_bits: int, k: int, signed: bool, acc_bits: int,
               rank: int) -> float:
    e = error_table(n_bits, k, signed, acc_bits).astype(np.float64)
    if rank == 0:
        return float(np.abs(e).max()) if e.size else 0.0
    u, s, vt = _svd(n_bits, k, signed, acc_bits)
    recon = (u[:, :rank] * s[:rank]) @ vt[:rank]
    return float(np.abs(recon - e).max())


@functools.lru_cache(maxsize=64)
def rank_for_exact(n_bits: int = 8, k: int = 4, signed: bool = True,
                   acc_bits: int = 24) -> int:
    """Smallest r whose float64 rank-r reconstruction rounds to E exactly."""
    _, s, _ = _svd(n_bits, k, signed, acc_bits)
    for r in range(len(s) + 1):
        if _recon_err(n_bits, k, signed, acc_bits, r) <= EXACT_RECON_EPS:
            return r
    raise AssertionError("full-rank SVD failed to reconstruct the error table")


@functools.lru_cache(maxsize=64)
def rank_for_tol(tol: float, n_bits: int = 8, k: int = 4, signed: bool = True,
                 acc_bits: int = 24) -> int:
    """Smallest r with max-abs per-entry reconstruction error <= tol."""
    if tol < 0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    r_exact = rank_for_exact(n_bits, k, signed, acc_bits)
    for r in range(r_exact + 1):
        if _recon_err(n_bits, k, signed, acc_bits, r) <= tol:
            return r
    return r_exact


@functools.lru_cache(maxsize=32)
def delta_factors(n_bits: int = 8, k: int = 4, signed: bool = True,
                  acc_bits: int = 24, rank: Optional[int] = None,
                  tol: Optional[float] = None) -> DeltaFactors:
    """Factor the error table at the requested rank (default: exact rank).

    ``rank`` wins over ``tol``; with neither, ``rank_for_exact`` is used.
    """
    if rank is None:
        rank = (rank_for_exact(n_bits, k, signed, acc_bits) if tol is None
                else rank_for_tol(tol, n_bits, k, signed, acc_bits))
    span = 1 << n_bits
    e = error_table(n_bits, k, signed, acc_bits)
    rank = max(0, min(rank, span))
    if rank == 0:
        f = np.zeros((span, 0), np.float32)
        g = np.zeros((0, span), np.float32)
        recon = np.zeros((span, span), np.float64)
    else:
        u, s, vt = _svd(n_bits, k, signed, acc_bits)
        sq = np.sqrt(s[:rank])
        f = (u[:, :rank] * sq).astype(np.float32)
        g = (sq[:, None] * vt[:rank]).astype(np.float32)
        recon = f.astype(np.float64) @ g.astype(np.float64)
    residual = (e.astype(np.int64)
                - np.round(recon).astype(np.int64)).astype(np.int32)
    defect = (e.astype(np.float64) - recon).astype(np.float32)
    max_err = float(np.abs(recon - e).max()) if e.size else 0.0
    return DeltaFactors(n_bits, k, signed, acc_bits, rank, f, g, residual,
                        defect, max_err)


_DEVICE_TABLES = {}


def _on(device, key, build):
    """Memoize a device tensor built from the host tables, per device."""
    key = key + (str(torch.device(device)),)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = _DEVICE_TABLES[key] = build()
    return hit


def factor_tables(fac: DeltaFactors, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (f, g) on ``device`` for the fused kernel, uploaded once:
    ``f_flat[v * r + j]`` (row-major (span, r)), ``g_flat[j * span + v]``.
    Rank 0 yields (span,)-zeros dummies, as in the reference."""
    span = 1 << fac.n_bits

    def build():
        if fac.rank == 0:
            z = torch.zeros((span,), dtype=torch.float32, device=device)
            return z, z
        return (torch.from_numpy(np.ascontiguousarray(fac.f).reshape(-1))
                .to(device),
                torch.from_numpy(np.ascontiguousarray(fac.g).reshape(-1))
                .to(device))
    return _on(device, ("fg", fac.n_bits, fac.k, fac.signed, fac.acc_bits,
                        fac.rank), build)


def _device_factors(fac: DeltaFactors, device):
    """(f, g, defect_flat) on ``device`` for the torch paths, uploaded once."""
    return _on(device, ("fgd", fac.n_bits, fac.k, fac.signed, fac.acc_bits,
                        fac.rank),
               lambda: tuple(torch.from_numpy(np.ascontiguousarray(x))
                             .to(device)
                             for x in (fac.f, fac.g, fac.defect.reshape(-1))))


def _check_f32_matmul(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the approx_delta correction needs full-f32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (TF32 keeps about "
            "three decimal digits and the sums lose their integer part)")


def _correction(a_u: torch.Tensor, b_u: torch.Tensor,
                fac: DeltaFactors) -> torch.Tensor:
    """Unrounded rank-r correction: (M, rK) x (rK, N) float32 product."""
    m, kd = a_u.shape
    n = b_u.shape[1]
    _check_f32_matmul(a_u.device)
    f_dev, g_dev, _ = _device_factors(fac, a_u.device)
    f_a = f_dev[a_u.long()]                                   # (M, K, r)
    g_b = g_dev[:, b_u.long()]                                # (r, K, N)
    return torch.matmul(f_a.reshape(m, kd * fac.rank),
                        g_b.permute(1, 0, 2).reshape(kd * fac.rank, n))


def defect_gather_matmul(a_u: torch.Tensor, b_u: torch.Tensor,
                         fac: DeltaFactors) -> torch.Tensor:
    """sum_kk defect[a, b] via the shared gather loop (cached device table)."""
    from . import lut
    _, _, defect_flat = _device_factors(fac, a_u.device)
    return lut.table_gather_matmul(a_u, b_u, defect_flat,
                                   span=1 << fac.n_bits)


@dataclasses.dataclass(frozen=True)
class PreparedDelta:
    """Weight-stationary half of the delta decomposition for a fixed operand.

    The fixed operand's factor of the correction — ``G_B[kk, j, n] =
    g[j, b_u[kk, n]]`` when the weights sit on the right, ``F_A[m, kk, j] =
    f[a_u[m, kk], j]`` on the left (the product table is not symmetric) — is
    gathered once on the weights' device; each call then costs one exact int8
    GEMM, the moving operand's rank-r' gathers and one f32 contraction.

    With ``restrict``, the factorization is specialized to the ``d`` distinct
    low-k patterns the weights reach (``_restricted_factors``), which lowers
    the rank (the 8x8 DCT matrix: 10 instead of 21 at k=6). Only at the exact
    rank; truncated ranks keep the generic factors.
    """
    side: str              # "right": fixed B (K, N); "left": fixed A (M, K)
    rank: int              # effective (possibly weight-restricted) rank
    spec: Tuple            # (n_bits, k, signed, acc_bits, rank_req, tol_req)
    w_u: torch.Tensor      # fixed operand's unsigned bit patterns, int32
    w_s: torch.Tensor      # its signed values: int8 (signed) or int32
    gather_tab: torch.Tensor  # moving-side factor, (r', span) float32
    factor: torch.Tensor   # stationary factor: (K, r', N) right / (M, K, r') left

    @property
    def fac(self) -> DeltaFactors:
        n_bits, k, signed, acc_bits, rank_req, tol_req = self.spec
        return delta_factors(n_bits, k, signed, acc_bits, rank=rank_req,
                             tol=tol_req)


def _signed_values(w_u: torch.Tensor, n_bits: int, signed: bool) -> torch.Tensor:
    half = (1 << n_bits) >> 1
    return (w_u ^ half) - half if signed else w_u


def _base_matmul(a_s: torch.Tensor, b_s: torch.Tensor,
                 signed: bool) -> torch.Tensor:
    """Exact integer base product: signed int8 operands through the exact
    int8 GEMM (``kernels/systolic_gemm`` on the card); unsigned values do not
    fit int8 and take the plain exact integer product."""
    from repro_torch.kernels import ops
    if signed:
        return ops.systolic_matmul(a_s, b_s)
    return ops.exact_int_matmul(a_s, b_s)


@functools.lru_cache(maxsize=256)
def _restricted_factors(n_bits: int, k: int, signed: bool, acc_bits: int,
                        axis: int, patterns: Tuple[int, ...]):
    """Exact-rank factors of E restricted to the fixed operand's patterns.

    ``axis=1`` restricts columns (fixed right operand), ``axis=0`` rows.
    Returns (f, g, rank): f (span, r') / g (r', d) for axis=1, f (d, r') /
    g (r', span) for axis=0, the d-sized side indexed by position in
    ``patterns``."""
    e = error_table(n_bits, k, signed, acc_bits).astype(np.float64)
    sub = e[:, list(patterns)] if axis == 1 else e[list(patterns), :]
    u, s, vt = np.linalg.svd(sub, full_matrices=False)
    rank = len(s)
    for r in range(len(s) + 1):
        recon = (u[:, :r] * s[:r]) @ vt[:r]
        if np.abs(recon - sub).max() <= EXACT_RECON_EPS:
            rank = r
            break
    sq = np.sqrt(s[:rank])
    f = (u[:, :rank] * sq).astype(np.float32)
    g = (sq[:, None] * vt[:rank]).astype(np.float32)
    return f, g, rank


def _low_patterns(w_u: torch.Tensor, n_bits: int, k: int) -> Tuple[int, ...]:
    """The sorted distinct low-k bit patterns of ``w_u`` (reduced on its
    device; only the distinct values cross to the host)."""
    low_mask = (1 << min(k, n_bits)) - 1
    return tuple(int(v) for v in torch.unique(w_u & low_mask).tolist())


def _restrict_eligible(fac: DeltaFactors, patterns: Tuple[int, ...]) -> bool:
    """Whether the weight-restricted re-factorization applies (shared by
    ``prepare_delta`` and ``restricted_rank``)."""
    return (fac.rank > 0 and fac.exact
            and len(patterns) <= RESTRICT_MAX_PATTERNS)


def _patterns_of(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    return w.to(torch.int32) & ((1 << n_bits) - 1)


def restricted_rank(w: torch.Tensor, *, side: str = "right", n_bits: int = 8,
                    k: int = 4, signed: bool = True, acc_bits: int = 24,
                    rank: Optional[int] = None,
                    tol: Optional[float] = None) -> int:
    """The correction rank ``prepare_delta(..., restrict=True)`` would use."""
    fac = delta_factors(n_bits, k, signed, acc_bits, rank=rank, tol=tol)
    if fac.rank == 0:
        return 0
    patterns = _low_patterns(_patterns_of(w, n_bits), n_bits, k)
    if not _restrict_eligible(fac, patterns):
        return fac.rank
    axis = 1 if side == "right" else 0
    return _restricted_factors(n_bits, k, signed, acc_bits, axis, patterns)[2]


def prepare_delta(w: torch.Tensor, *, side: str = "right", n_bits: int = 8,
                  k: int = 4, signed: bool = True, acc_bits: int = 24,
                  rank: Optional[int] = None, tol: Optional[float] = None,
                  restrict: bool = True) -> PreparedDelta:
    """Precompute the fixed 2-D operand's correction factor (G_B or F_A) once,
    by a gather on ``w``'s device (a gather of f32 values gives the same bits
    wherever it runs).

    ``restrict=False`` keeps the generic rank-r factors, so the rank is a
    function of the policy alone (``core.gemm.bind`` uses it for the layer
    weights, which the reference prepares as one stacked leaf).
    """
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    if w.dim() != 2:
        raise ValueError(f"prepared operand must be 2-D, got shape "
                         f"{tuple(w.shape)}")
    fac = delta_factors(n_bits, k, signed, acc_bits, rank=rank, tol=tol)
    spec = (n_bits, k, signed, acc_bits, rank, tol)
    span = 1 << n_bits
    dev = w.device
    w_u = _patterns_of(w, n_bits).contiguous()
    w_s = _signed_values(w_u, n_bits, signed)
    if signed and n_bits <= 8:
        w_s = w_s.to(torch.int8)          # the exact int8 kernel's operand
    patterns = _low_patterns(w_u, n_bits, k) if (restrict and fac.rank) else ()
    restrict = restrict and _restrict_eligible(fac, patterns)
    idx = w_u.long()
    if restrict:
        axis = 1 if side == "right" else 0
        f_np, g_np, r_eff = _restricted_factors(n_bits, k, signed, acc_bits,
                                                axis, patterns)
        low = torch.tensor(patterns, dtype=torch.int32, device=dev)
        pos = torch.searchsorted(low, w_u & ((1 << min(k, n_bits)) - 1))
        if side == "right":
            gather_tab = torch.from_numpy(f_np.T.copy()).to(dev)  # (r', span)
            g_t = torch.from_numpy(g_np).to(dev)                  # (r', d)
            factor = g_t[:, pos].permute(1, 0, 2).contiguous()    # (K, r', N)
        else:
            gather_tab = torch.from_numpy(g_np).to(dev)           # (r', span)
            factor = torch.from_numpy(f_np).to(dev)[pos]          # (M, K, r')
    else:
        r_eff = fac.rank
        if r_eff == 0:
            gather_tab = torch.zeros((0, span), dtype=torch.float32,
                                     device=dev)
            shape = ((w.shape[0], 0, w.shape[1]) if side == "right"
                     else (*w.shape, 0))
            factor = torch.zeros(shape, dtype=torch.float32, device=dev)
        elif side == "right":
            f_dev, g_dev, _ = _device_factors(fac, dev)
            gather_tab = f_dev.T.contiguous()                     # (r, span)
            factor = g_dev[:, idx].permute(1, 0, 2).contiguous()  # (K, r, N)
        else:
            f_dev, g_dev, _ = _device_factors(fac, dev)
            gather_tab = g_dev                                    # (r, span)
            factor = f_dev[idx]                                   # (M, K, r)
    return PreparedDelta(side, r_eff, spec, w_u, w_s, gather_tab, factor)


def _delta_prepared_impl(x, w_u, w_s, factor, gather_tab, defect_flat, *,
                         side: str, rank: int, n_bits: int, signed: bool,
                         use_defect: bool) -> torch.Tensor:
    span = 1 << n_bits
    x_u = x.to(torch.int32) & (span - 1)
    x_s = _signed_values(x_u, n_bits, signed)
    if signed and n_bits <= 8:
        x_s = x_s.to(torch.int8)
    if side == "right":
        a_u, b_u = x_u, w_u
        base = _base_matmul(x_s, w_s, signed)
    else:
        a_u, b_u = w_u, x_u
        base = _base_matmul(w_s, x_s, signed)
    if rank:
        _check_f32_matmul(x.device)
        # the moving operand's r' gathers, then one contraction over (K, r')
        # against the stationary factor
        mov = gather_tab[:, x_u.reshape(-1).long()]
        if side == "right":
            m, kd = x_u.shape                     # (r,M,K) x (K,r,N)
            lhs = mov.reshape(rank, m, kd).permute(1, 2, 0).reshape(
                m, kd * rank)
            corr = torch.matmul(lhs, factor.reshape(kd * rank, -1))
        else:
            kd, n = x_u.shape                     # (M,K,r) x (r,K,N)
            rhs = mov.reshape(rank, kd, n).permute(1, 0, 2).reshape(
                kd * rank, n)
            corr = torch.matmul(factor.reshape(factor.shape[0], kd * rank),
                                rhs)
    else:
        corr = torch.zeros(base.shape, dtype=torch.float32, device=x.device)
    if use_defect:
        from . import lut
        corr = corr + lut.table_gather_matmul(a_u, b_u, defect_flat,
                                              span=span)
    return base + torch.round(corr).to(torch.int32)


def delta_matmul_prepared(x: torch.Tensor, prep: PreparedDelta, *,
                          apply_residual: bool = True) -> torch.Tensor:
    """Weight-stationary delta GEMM: only the moving operand ``x`` is gathered.

    ``x`` is (M, K) when the prepared weights are on the right, (K, N) on the
    left. Bit-identical to ``delta_matmul_ref`` / ``lut.lut_matmul`` at the
    exact rank, and at any rank with ``apply_residual=True`` (one rounding
    over correction + defect)."""
    fac = prep.fac
    use_defect = apply_residual and not fac.exact
    defect_flat = (_device_factors(fac, x.device)[2] if use_defect
                   else None)
    return _delta_prepared_impl(x, prep.w_u, prep.w_s, prep.factor,
                                prep.gather_tab, defect_flat, side=prep.side,
                                rank=prep.rank, n_bits=fac.n_bits,
                                signed=fac.signed, use_defect=use_defect)


def delta_matmul_ref(a: torch.Tensor, b: torch.Tensor, *, k: int = 4,
                     n_bits: int = 8, signed: bool = True, acc_bits: int = 24,
                     rank: Optional[int] = None, tol: Optional[float] = None,
                     apply_residual: bool = True) -> torch.Tensor:
    """Plain torch version of the delta backend: exact base product + rank-r
    correction, rounded once. Bit-identical to ``lut.lut_matmul`` at the
    exact rank, and at any rank with ``apply_residual=True``."""
    from repro_torch.kernels import ops
    fac = delta_factors(n_bits, k, signed, acc_bits, rank=rank, tol=tol)
    span = 1 << n_bits
    a_u = a.to(torch.int32) & (span - 1)
    b_u = b.to(torch.int32) & (span - 1)
    a_s = _signed_values(a_u, n_bits, signed)
    b_s = _signed_values(b_u, n_bits, signed)
    out = ops.exact_int_matmul(a_s, b_s)
    corr = (_correction(a_u, b_u, fac) if fac.rank
            else torch.zeros(out.shape, dtype=torch.float32, device=a.device))
    if apply_residual and not fac.exact:
        corr = corr + defect_gather_matmul(a_u, b_u, fac)
    return out + torch.round(corr).to(torch.int32)
