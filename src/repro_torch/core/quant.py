"""Symmetric int8 quantization for routing real-valued matmuls through the PE.

Port of ``repro/core/quant.py`` (``quantize``/``dequantize``; the QAT
straight-through estimator comes with the training slice). The arithmetic is
pinned to the reference's, so the int payloads and the f32 scales are
bit-identical for f32 and bf16 inputs:

* the scale is ``max(amax, eps) * float32(1/qmax)`` — a multiply by the
  reciprocal computed on the host, not a division by ``qmax``;
* the payload is ``clip(round(x / scale), -qmax, qmax)`` with a true f32
  division and round-half-to-even (``torch.round``).

The payload is held as int8 when ``n_bits <= 8`` (the operand type of the
GEMM kernels) and as int32 otherwise; the values equal the reference's int32
payload.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Quantized(NamedTuple):
    values: torch.Tensor   # int8 payload (int32 for n_bits > 8)
    scale: torch.Tensor    # f32 per-tensor scalar or per-row/column vector


def quantize(x: torch.Tensor, *, n_bits: int = 8, axis: Optional[int] = None,
             eps: float = 1e-8) -> Quantized:
    """Symmetric quantization to [-2^{N-1}+1, 2^{N-1}-1] in float32.

    ``axis`` is the reduced axis of the absolute maximum (kept as a size-1
    dimension of the scale), ``None`` for one per-tensor scale.
    """
    qmax = (1 << (n_bits - 1)) - 1
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, eps) * float(np.float32(1.0 / qmax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return Quantized(q.to(torch.int8 if n_bits <= 8 else torch.int32), scale)


def dequantize(q: Quantized) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scale
