"""CNN-based edge detection: compact BDCN-style bi-directional cascade (paper
§V-B, He et al. [17]; port of ``repro/apps/bdcn.py``) with the paper's hybrid
policy — the first two blocks run on approximate PEs, later blocks exact.

Fixed seeded weights whose first-layer filters are edge-selective
(Sobel/Laplacian banks), evaluated with the paper's methodology: PSNR/SSIM of
the hybrid-approximate network's edge map against the exact-arithmetic edge
map of the same network. The hybrid is a ``GemmPolicy`` with per-layer
overrides (``hybrid_policy``). Each layer's quantized weight matrix is
prepared once per (layer, k); the numpy glue is the reference's and every
GEMM runs on the caller's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import errors, gemm, quant
from . import images

DEFAULT_BACKEND = "approx_lut"

_SOBELS = [
    np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]]),
    np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]]),
    np.array([[0, 1, 2], [-1, 0, 1], [-2, -1, 0]]),
    np.array([[2, 1, 0], [1, 0, -1], [0, -1, -2]]),
    np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]]),
    np.array([[1, 1, 1], [1, -8, 1], [1, 1, 1]]),
]


def layer_name(li: int) -> str:
    """Zero-padded so prefix-matching overrides can't alias across blocks."""
    return f"block{li:02d}"


def hybrid_policy(k: int, backend: str = DEFAULT_BACKEND,
                  n_approx_blocks: int = 2,
                  n_blocks: int = 4) -> gemm.GemmPolicy:
    """The paper's hybrid as a GemmPolicy: approximate early blocks, exact
    later blocks (k=0 degenerates to exact everywhere)."""
    pol = gemm.as_policy(backend, k=k)    # validates the backend name
    if k == 0:
        return gemm.GemmPolicy(backend="exact", k=0)
    overrides = {layer_name(li): "exact"
                 for li in range(n_approx_blocks, n_blocks)}
    return dataclasses.replace(pol, overrides=overrides or None)


def make_weights(channels: List[int], seed: int = 0) -> List[np.ndarray]:
    """Conv stack weights (C_out, C_in, 3, 3), first layer edge-selective."""
    rng = np.random.default_rng(seed)
    ws = []
    c_prev = 1
    for li, c in enumerate(channels):
        w = rng.normal(0, (9 * c_prev) ** -0.5, size=(c, c_prev, 3, 3))
        if li == 0:
            for i in range(c):
                w[i, 0] = _SOBELS[i % len(_SOBELS)] * 0.25
        ws.append(w.astype(np.float32))
        c_prev = c
    return ws


def _im2col_nchw(x: np.ndarray) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1)))
    v = sliding_window_view(xp, (3, 3), axis=(1, 2))    # (C, H, W, 3, 3)
    return v.transpose(1, 2, 0, 3, 4).reshape(h * w, c * 9)


def conv_layer(x: np.ndarray, w: np.ndarray, policy: gemm.GemmPolicy,
               layer: str = "", *, device="cuda") -> np.ndarray:
    """x: (C_in, H, W) float -> (C_out, H, W); int8-quantized GEMM under the
    layer's backend; ReLU applied."""
    dev = resolve_device(device)
    c_out = w.shape[0]
    _, h, wd = x.shape
    cols = _im2col_nchw(x)                              # (H*W, C_in*9)
    wmat = w.reshape(c_out, -1).T                       # (C_in*9, C_out)
    xq = quant.quantize(torch.from_numpy(np.ascontiguousarray(cols)).to(dev))
    wq = quant.quantize(torch.from_numpy(np.ascontiguousarray(wmat)).to(dev),
                        axis=0)
    prep = gemm.prepare_weights_cached(wq.values, policy, layer=layer)
    acc = gemm.dot(xq.values, prep, policy, layer=layer).cpu().numpy()
    out = (acc.astype(np.float64) * xq.scale.cpu().numpy()
           * wq.scale.cpu().numpy())
    out = np.maximum(out, 0.0)                          # ReLU
    return out.T.reshape(c_out, h, wd).astype(np.float32)


def bdcn_forward(img: np.ndarray, ws: List[np.ndarray], k: int = None,
                 n_approx_blocks: int = 2, policy=None, *,
                 device="cuda") -> np.ndarray:
    """Bi-directional cascade: shallow-to-deep and deep-to-shallow edge maps
    fused. With the default policy, blocks < n_approx_blocks use approximate
    arithmetic (the paper's hybrid); pass a ``GemmPolicy`` to override."""
    if policy is None or isinstance(policy, str):
        pol = hybrid_policy(0 if k is None else k,
                            backend=policy or DEFAULT_BACKEND,
                            n_approx_blocks=n_approx_blocks,
                            n_blocks=len(ws))
    else:
        pol = gemm.as_policy(policy, k=k)
    x = (img.astype(np.float32) - 128.0) / 128.0
    x = x[None]                                          # (1, H, W)
    side_maps = []
    for li, w in enumerate(ws):
        x = conv_layer(x, w, pol, layer=layer_name(li), device=device)
        side_maps.append(np.abs(x).mean(axis=0))         # side output per block
    # bi-directional fusion: forward cascade + backward cascade
    fwd = np.zeros_like(side_maps[0])
    for m in side_maps:
        fwd = 0.5 * fwd + m
    bwd = np.zeros_like(side_maps[0])
    for m in reversed(side_maps):
        bwd = 0.5 * bwd + m
    fused = fwd + bwd
    fused = 255.0 * fused / max(fused.max(), 1e-9)
    return np.clip(fused, 0, 255)


def run(size: int = 64, ks=(2, 4, 6, 8), seed: int = 0,
        channels=(8, 16, 16, 16), policy=None, n_approx_blocks: int = 2, *,
        device="cuda") -> Dict[int, Dict]:
    """``policy`` may be None / a backend name (hybrid per the paper: that
    backend on the first ``n_approx_blocks`` blocks, exact after) or a full
    ``GemmPolicy`` (used as-is, with k swept)."""
    img = images.test_image(size, seed)
    ws = make_weights(list(channels), seed)
    exact = bdcn_forward(img, ws, 0, n_approx_blocks, policy=policy,
                         device=device)
    out = {}
    for k in ks:
        approx = bdcn_forward(img, ws, k, n_approx_blocks, policy=policy,
                              device=device)
        out[k] = {"psnr": errors.psnr(exact, approx),
                  "ssim": errors.ssim(exact, approx)}
    return out
