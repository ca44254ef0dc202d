"""8x8 integer-scaled DCT image compression through the approximate systolic
GEMM (paper §V-A; port of ``repro/apps/dct.py``; integer DCT per Meher et al.
[18], HEVC T8 matrix).

Pipeline (all multiplies are 8-bit PE GEMMs routed through ``GemmPolicy``):
  X (centered int8 block) -> T. X  (>>7, saturate int8) -> . T^T (>>7) = coeffs
  reconstruction uses the exact transpose pipeline; PSNR/SSIM measured against
  the exact-arithmetic output of the same pipeline, as in the paper.

``T8`` is the fixed weight of both stages: it multiplies from the *left* in
the first stage (``gemm.prepare_weights(..., side="left")``) and, transposed,
from the right in the second. The product table is not symmetric, so the
operand roles are kept end to end.

Backends: the default ``approx_oracle`` chains the bit-level fused-MAC PE;
``approx_lut`` is the product-table model and ``approx_delta`` the
weight-stationary delta path (bit-identical to each other).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import errors, gemm
from . import images

# HEVC-style 8x8 integer DCT matrix (fits signed 8-bit operands)
T8 = np.array([
    [64, 64, 64, 64, 64, 64, 64, 64],
    [89, 75, 50, 18, -18, -50, -75, -89],
    [83, 36, -36, -83, -83, -36, 36, 83],
    [75, -18, -89, -50, 50, 89, 18, -75],
    [64, -64, -64, 64, 64, -64, -64, 64],
    [50, -89, 18, 75, -75, -18, 89, 50],
    [36, -83, 83, -36, -36, 83, -83, 36],
    [18, -50, 89, -75, 75, -89, 50, -18]], dtype=np.int32)

# The paper's Table VI simulates the fused-MAC PE chain (incl. accumulator
# error), which is backend "approx_oracle" in the GemmPolicy registry.
DEFAULT_BACKEND = "approx_oracle"


def _sat8(x: np.ndarray, shift: int) -> np.ndarray:
    return np.clip(x >> shift, -128, 127).astype(np.int32)


def forward_dct_blocks(blocks: np.ndarray, k: int = None, policy=None, *,
                       device="cuda") -> np.ndarray:
    """blocks: (N, 8, 8) uint8 -> (N, 8, 8) int coefficients under the policy.

    ``policy`` may be None (paper-default backend at factor ``k``), a backend
    name, or a ``GemmPolicy``; ``k`` (when given) overrides the policy's
    approximation factor.
    """
    dev = resolve_device(device)
    pol = gemm.as_policy(policy, backend=DEFAULT_BACKEND, k=k)
    x = torch.from_numpy(blocks.astype(np.int32) - 128).to(dev)
    t8 = torch.from_numpy(T8).to(dev)
    t_fwd = gemm.prepare_weights_cached(t8, pol, layer="dct.fwd", side="left")
    t_tr = gemm.prepare_weights_cached(t8.T.contiguous(), pol,
                                       layer="dct.fwd", side="right")
    s1 = _sat8(gemm.dot(t_fwd, x, pol, layer="dct.fwd").cpu().numpy(), 7)
    return gemm.dot(torch.from_numpy(s1).to(dev), t_tr, pol,
                    layer="dct.fwd").cpu().numpy()


def inverse_dct_blocks(coeff: np.ndarray) -> np.ndarray:
    """Exact float inverse of the integer pipeline (shared by approx & exact).

    Forward was C = (T.X >> 7) . T^T  ~=  T.X.T^T / 128, so
    X = 128 * T^{-1} . C . (T^{-1})^T.
    """
    tinv = np.linalg.inv(T8.astype(np.float64))
    x = 128.0 * np.einsum("ij,njk,kl->nil", tinv, coeff.astype(np.float64),
                          tinv.T)
    return x + 128.0


def run(size: int = 256, ks=(0, 2, 4, 6, 8), seed: int = 0, policy=None, *,
        device="cuda") -> Dict[int, Dict]:
    """Returns {k: {psnr, ssim}} of approx-DCT reconstruction vs exact-DCT
    reconstruction (the paper's methodology) under the chosen backend."""
    pol = gemm.as_policy(policy, backend=DEFAULT_BACKEND)
    img = images.test_image(size, seed)
    blocks = images.to_blocks(img)
    h = w = size
    recon = {}
    for k in ks:
        coeff = forward_dct_blocks(blocks, k, policy=pol, device=device)
        rec = inverse_dct_blocks(coeff)
        recon[k] = images.from_blocks(np.clip(rec, 0, 255), h, w)
    exact = recon.get(0)
    if exact is None:
        coeff = forward_dct_blocks(blocks, 0, policy=pol, device=device)
        exact = images.from_blocks(np.clip(inverse_dct_blocks(coeff), 0, 255),
                                   h, w)
    out = {}
    for k in ks:
        if k == 0:
            continue
        out[k] = {"psnr": errors.psnr(exact, recon[k]),
                  "ssim": errors.ssim(exact, recon[k])}
    return out
