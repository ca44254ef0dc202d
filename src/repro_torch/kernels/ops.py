"""Public wrappers over the GEMM kernels (port of ``repro/kernels/ops.py``).

* ``systolic_matmul`` / ``approx_matmul`` take integer operands of any shape
  and integer dtype, convert them to the kernels' int8 operands and call the
  kernel wrappers. The CUDA kernels mask ragged edges themselves, so nothing
  is padded: no padded K row adds ``T[0,0]``, and the reference's
  ``k_pad*T[0,0]`` correction has nothing to correct.
* ``PreparedOperand`` / ``prepare_operand`` / ``prepared_matmul``: the
  weight-stationary operand for the ``exact``, ``mxu_int8`` and
  ``approx_lut`` backends. The other backends arrive with later slices of
  the port and raise ``NotImplementedError`` here.
* ``batched_app_matmul``: the pad-and-batch shim of the integer path.

On the CPU the kernel wrappers run their plain versions; on CUDA they launch
the kernels. Nothing here chooses the device but the tensors themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import approx_gemm, systolic_gemm
from .ref import systolic_matmul_ref

LATER_BACKENDS = {
    "approx_delta": "the approx_delta slice (core/error_delta.py and the "
                    "delta kernel)",
    "approx_onehot": "a later slice (core/lut.py one-hot rewrite)",
    "approx_oracle": "a later slice (core/emulate.matmul_oracle)",
}


def not_ported(backend: str) -> NotImplementedError:
    return NotImplementedError(
        f"backend {backend!r} is not ported yet: it comes with "
        f"{LATER_BACKENDS[backend]}, see ROADMAP.md")


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
    symmetric, so the two differ). For the backends of this slice the only
    precompute is the quantization: ``values`` holds the int8 operand the
    kernels take (the low 8 bits of integer weights, which is all either
    kernel reads; ``exact`` keeps the weights as given), ``scale`` the f32
    per-output-channel dequantization scale when the operand was prepared
    from float weights (``core.gemm.prepare_weights``), else ``None``.
    """
    backend: str
    side: str
    k: int
    n_bits: int
    acc_bits: int
    values: torch.Tensor
    scale: Optional[torch.Tensor] = None


def prepare_operand(w: torch.Tensor, *, backend: str, k: int = 4,
                    n_bits: int = 8, acc_bits: int = 24,
                    side: str = "right") -> PreparedOperand:
    """Prepare the fixed integer operand ``w`` (2-D) for ``backend``."""
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    if w.dim() != 2:
        raise ValueError(f"prepared operand must be 2-D, got shape "
                         f"{tuple(w.shape)}")
    if backend in LATER_BACKENDS:
        raise not_ported(backend)
    if backend not in ("exact", "mxu_int8", "approx_lut"):
        raise ValueError(f"unknown backend {backend!r}")
    if w.is_floating_point():
        raise TypeError("prepare_operand takes integer weights; "
                        "core.gemm.prepare_weights quantizes float weights")
    if backend != "exact":
        w = w.to(torch.int8)      # the kernels' operand type (low 8 bits)
    return PreparedOperand(backend, side, k, n_bits, acc_bits, w.contiguous())


def prepared_matmul(x: torch.Tensor, prep: PreparedOperand) -> torch.Tensor:
    """2-D integer GEMM of moving operand ``x`` against a prepared operand.

    ``side="right"`` computes ``x @ values``, so the moving operand is the
    table's row index under ``approx_lut``, as in the reference.
    """
    a, b = (x, prep.values) if prep.side == "right" else (prep.values, x)
    if prep.backend == "exact":
        return exact_int_matmul(a, b)
    if prep.backend == "mxu_int8":
        return systolic_matmul(a, b)
    if prep.backend == "approx_lut":
        return approx_matmul(a, b, k=prep.k, n_bits=prep.n_bits,
                             acc_bits=prep.acc_bits)
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
