"""Kernel-based edge detection through the approximate systolic GEMM (paper
§V-B; port of ``repro/apps/edge.py``).

The Laplacian convolution is lowered to im2col GEMM — (H*W, 9) x (9, 1) — and
routed through ``GemmPolicy``; output quality is measured against the
exact-arithmetic output of the identical pipeline. The convolution kernel is
a fixed weight, prepared once per k (``gemm.prepare_weights_cached``). The
default ``approx_lut`` backend is the paper's product-table model.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import errors, gemm
from . import images

LAPLACIAN = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=np.int32)
LAPLACIAN8 = np.array([[1, 1, 1], [1, -8, 1], [1, 1, 1]], dtype=np.int32)

DEFAULT_BACKEND = "approx_lut"


def im2col(img: np.ndarray, kh: int = 3, kw: int = 3) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view
    v = sliding_window_view(img, (kh, kw))           # (H-2, W-2, 3, 3)
    return v.reshape(-1, kh * kw)


def conv_gemm(img: np.ndarray, kernel: np.ndarray, k: int, policy=None, *,
              device="cuda") -> np.ndarray:
    """Approximate-GEMM convolution under the policy. img uint8 -> int32
    response map."""
    dev = resolve_device(device)
    pol = gemm.as_policy(policy, backend=DEFAULT_BACKEND, k=k)
    h, w = img.shape
    cols = im2col(img.astype(np.int32) - 128)        # center into int8 range
    kflat = torch.from_numpy(kernel.reshape(-1, 1).astype(np.int32)).to(dev)
    prep = gemm.prepare_weights_cached(kflat, pol, layer="edge.conv")
    out = gemm.dot(torch.from_numpy(np.ascontiguousarray(cols)).to(dev), prep,
                   pol, layer="edge.conv").cpu().numpy()
    return out[:, 0].reshape(h - 2, w - 2)


def edge_map(resp: np.ndarray) -> np.ndarray:
    mag = np.abs(resp).astype(np.float64)
    mag = 255.0 * mag / max(mag.max(), 1.0)
    return np.clip(mag, 0, 255)


def run(size: int = 256, ks=(2, 4, 6, 8), seed: int = 0,
        kernel: np.ndarray = LAPLACIAN, policy=None, *,
        device="cuda") -> Dict[int, Dict]:
    pol = gemm.as_policy(policy, backend=DEFAULT_BACKEND)
    img = images.test_image(size, seed)
    exact = edge_map(conv_gemm(img, kernel, 0, policy=pol, device=device))
    out = {}
    for k in ks:
        approx = edge_map(conv_gemm(img, kernel, k, policy=pol,
                                    device=device))
        out[k] = {"psnr": errors.psnr(exact, approx),
                  "ssim": errors.ssim(exact, approx)}
    return out
