"""Public wrappers over the GEMM kernels (port of ``repro/kernels/ops.py``).

* ``systolic_matmul`` / ``approx_matmul`` / ``approx_delta_matmul`` take
  integer operands of any shape and integer dtype, convert them to the
  kernels' int8 operands and call the kernel wrappers. The CUDA kernels mask
  ragged edges themselves, so nothing is padded: no padded K row adds
  ``T[0,0]`` (or ``round(f[0] . g[:,0])``), and the reference's ``k_pad``
  corrections have nothing to correct.
* ``PreparedOperand`` / ``prepare_operand`` / ``prepared_matmul``: the
  weight-stationary operand for every backend, on either side.
* ``batched_app_matmul``: the pad-and-batch shim of the integer path.

On the CPU the kernel wrappers run their plain versions; on CUDA they launch
the kernels. Nothing here chooses the device but the tensors themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import emulate, error_delta, lut
from . import approx_gemm, delta_gemm, systolic_gemm
from .ref import systolic_matmul_ref


def systolic_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 GEMM (int32 results) for arbitrary (M, K) x (K, N).

    Operands are cast to int8 as the reference casts them (``astype(int8)``
    keeps the low 8 bits).
    """
    return systolic_gemm.systolic_matmul(a.to(torch.int8).contiguous(),
                                         b.to(torch.int8).contiguous())


def approx_matmul(a: torch.Tensor, b: torch.Tensor, *, k: int = 4,
                  n_bits: int = 8, acc_bits: int = 24,
                  signed: bool = True) -> torch.Tensor:
    """Approximate GEMM at factor k for arbitrary shapes (signed operands).

    Each operand indexes the table by its bit pattern ``x & (span-1)``; the
    int8 cast keeps the low 8 bits, which hold that pattern for n_bits <= 8.
    """
    if n_bits > 8:
        raise ValueError(f"approx_matmul takes n_bits <= 8, got {n_bits}")
    table = approx_gemm.make_table(k, n_bits=n_bits, signed=signed,
                                   acc_bits=acc_bits, device=a.device)
    return approx_gemm.approx_matmul_lut(a.to(torch.int8).contiguous(),
                                         b.to(torch.int8).contiguous(), table)


def approx_delta_matmul(a: torch.Tensor, b: torch.Tensor, *, k: int = 4,
                        n_bits: int = 8, acc_bits: int = 24,
                        signed: bool = True, rank: Optional[int] = None,
                        tol: Optional[float] = None,
                        apply_residual: bool = True) -> torch.Tensor:
    """Approximate GEMM via the exact-plus-error-delta decomposition.

    ``A_s @ B_s + round(F_A @ G_B)`` (``core/error_delta.py``) through the
    fused kernel ``delta_gemm``. At the default (exact) rank the result is
    bit-identical to ``approx_matmul``; a truncated ``rank``/``tol`` with
    ``apply_residual=True`` runs the kernel at rank 0 for the base and rounds
    correction + defect once (per-block rounding does not commute with the
    defect cancellation), which is exact again.
    """
    fac = error_delta.delta_factors(n_bits, k, signed, acc_bits, rank=rank,
                                    tol=tol)
    if not signed:
        # unsigned 8-bit values do not fit the kernel's int8 base
        return error_delta.delta_matmul_ref(a, b, k=k, n_bits=n_bits,
                                            signed=signed, acc_bits=acc_bits,
                                            rank=rank, tol=tol,
                                            apply_residual=apply_residual)
    span = 1 << n_bits
    half = span >> 1
    a_u = a.to(torch.int32) & (span - 1)
    b_u = b.to(torch.int32) & (span - 1)
    a_s = ((a_u ^ half) - half).to(torch.int8).contiguous()
    b_s = ((b_u ^ half) - half).to(torch.int8).contiguous()
    if apply_residual and not fac.exact:
        zero, _ = error_delta.factor_tables(fac._replace(rank=0), a.device)
        base = delta_gemm.delta_matmul_fused(a_s, b_s, zero, zero, rank=0,
                                             span=span)
        corr = (error_delta._correction(a_u, b_u, fac) if fac.rank
                else torch.zeros(base.shape, dtype=torch.float32,
                                 device=a.device))
        corr = corr + error_delta.defect_gather_matmul(a_u, b_u, fac)
        return base + torch.round(corr).to(torch.int32)
    f_flat, g_flat = error_delta.factor_tables(fac, a.device)
    return delta_gemm.delta_matmul_fused(a_s, b_s, f_flat, g_flat,
                                         rank=fac.rank, span=span)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``exact`` backend's integer GEMM, int32 results (a plain product,
    as the reference leaves it to XLA).

    Runs in float64, which is exact while every partial sum stays below
    2^53; on CUDA that is checked, since PyTorch has no integer matmul there.
    """
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)
    bound = (a.abs().max().to(torch.float64) * b.abs().max().to(torch.float64)
             * a.shape[-1])
    if bound >= 2.0 ** 53:
        raise ValueError("exact integer GEMM on CUDA runs in float64 and "
                         "needs max|a| * max|b| * K < 2^53")
    return systolic_matmul_ref(a, b)


@dataclasses.dataclass(frozen=True)
class PreparedOperand:
    """A fixed GEMM operand with its backend-specific precompute done once.

    ``side`` says which operand of the product the matrix is: ``"right"`` for
    ``x @ W``, ``"left"`` for ``W @ x`` (the approximate product table is not
    symmetric, so the two differ). ``values`` holds the operand the kernels
    take: int8 (the low 8 bits of integer weights, which is all they read)
    for the integer backends, the weights as given for ``exact`` and
    ``approx_oracle``. ``approx_delta`` also stores the rank-r ``G_B`` /
    ``F_A`` factor (``delta``: ``core.error_delta.PreparedDelta``) with the
    policy's requested ``rank``/``tol``; ``approx_onehot`` the (K*2^N, N)
    ``T_B`` table (``t_b``, right side only: a fixed left operand's T_B
    depends on the moving operand). ``scale`` is the f32 per-output-channel
    dequantization scale when the operand was prepared from float weights
    (``core.gemm.prepare_weights``), else ``None``.
    """
    backend: str
    side: str
    k: int
    n_bits: int
    acc_bits: int
    values: torch.Tensor
    delta: Optional[error_delta.PreparedDelta] = None
    t_b: Optional[torch.Tensor] = None
    rank: Optional[int] = None
    tol: Optional[float] = None
    scale: Optional[torch.Tensor] = None


BACKENDS = ("exact", "mxu_int8", "approx_lut", "approx_oracle",
            "approx_onehot", "approx_delta")


def prepare_operand(w: torch.Tensor, *, backend: str, k: int = 4,
                    n_bits: int = 8, acc_bits: int = 24,
                    side: str = "right", rank: Optional[int] = None,
                    tol: Optional[float] = None,
                    restrict: bool = True) -> PreparedOperand:
    """Prepare the fixed integer operand ``w`` (2-D) for ``backend``.

    ``restrict=False`` keeps ``approx_delta``'s generic rank instead of the
    weight-restricted one (``error_delta.prepare_delta``).
    """
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    if w.dim() != 2:
        raise ValueError(f"prepared operand must be 2-D, got shape "
                         f"{tuple(w.shape)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if w.is_floating_point():
        raise TypeError("prepare_operand takes integer weights; "
                        "core.gemm.prepare_weights quantizes float weights")
    delta = t_b = None
    if backend == "approx_delta":
        delta = error_delta.prepare_delta(w, side=side, n_bits=n_bits, k=k,
                                          acc_bits=acc_bits, rank=rank,
                                          tol=tol, restrict=restrict)
    elif backend == "approx_onehot" and side == "right":
        t_b = lut.build_onehot_weights(w, n_bits=n_bits, k=k,
                                       acc_bits=acc_bits)
    if backend not in ("exact", "approx_oracle"):
        w = w.to(torch.int8)      # the kernels' operand type (low 8 bits)
    return PreparedOperand(backend, side, k, n_bits, acc_bits, w.contiguous(),
                           delta, t_b, rank, tol)


def prepared_matmul(x: torch.Tensor, prep: PreparedOperand) -> torch.Tensor:
    """2-D integer GEMM of moving operand ``x`` against a prepared operand.

    ``side="right"`` computes ``x @ values``, so the moving operand is the
    table's row index under the approximate backends, as in the reference.
    """
    a, b = (x, prep.values) if prep.side == "right" else (prep.values, x)
    if prep.backend == "exact":
        return exact_int_matmul(a, b)
    if prep.backend == "mxu_int8":
        return systolic_matmul(a, b)
    if prep.backend == "approx_lut":
        return approx_matmul(a, b, k=prep.k, n_bits=prep.n_bits,
                             acc_bits=prep.acc_bits)
    if prep.backend == "approx_oracle":
        return emulate.matmul_oracle(a, b, n_bits=prep.n_bits, k=prep.k,
                                     acc_bits=prep.acc_bits)
    if prep.backend == "approx_onehot":
        t_b = prep.t_b
        if t_b is None:     # left-fixed operand: T_B depends on the moving b
            t_b = lut.build_onehot_weights(b, n_bits=prep.n_bits, k=prep.k,
                                           acc_bits=prep.acc_bits)
        return lut.onehot_matmul(a, t_b, n_bits=prep.n_bits)
    if prep.backend == "approx_delta":
        return error_delta.delta_matmul_prepared(x, prep.delta)
    raise ValueError(f"unknown backend {prep.backend!r}")


def batched_app_matmul(matmul2d: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                       a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Map batched integer GEMMs onto a 2-D GEMM.

    * ``(..., M, K) x (K, N)`` — batch flattened into the M (rows) dimension.
    * ``(M, K) x (..., K, N)`` — batch flattened into the N (columns)
      dimension. The operand order is kept (no transpose trick): the
      approximate product table is not symmetric.

    At most one operand may carry batch dimensions.
    """
    if a.dim() == 2 and b.dim() == 2:
        return matmul2d(a, b)
    if a.dim() > 2 and b.dim() > 2:
        raise ValueError(f"at most one batched operand, got shapes "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if b.dim() == 2:                                  # (..., M, K) x (K, N)
        lead = a.shape[:-2]
        m, kd = a.shape[-2:]
        out = matmul2d(a.reshape(-1, kd), b)
        return out.reshape(*lead, m, b.shape[-1])
    lead = b.shape[:-2]                               # (M, K) x (..., K, N)
    kd, n = b.shape[-2:]
    b2 = b.reshape(-1, kd, n).movedim(1, 0).reshape(kd, -1)
    out = matmul2d(a, b2)                             # (M, batch*N)
    m = a.shape[0]
    return out.reshape(m, -1, n).movedim(0, 1).reshape(*lead, m, n)
