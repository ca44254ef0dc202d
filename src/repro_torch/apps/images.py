"""Synthetic test images (a numpy copy of ``repro/apps/images.py``; offline:
no image files). Deterministic photo-like composites — smooth gradients,
shapes, texture — so DCT/edge results are reproducible."""
from __future__ import annotations

import numpy as np


def test_image(size: int = 256, seed: int = 0) -> np.ndarray:
    """uint8 grayscale (size, size) with edges, gradients and texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64) / size
    img = 96 + 80 * x + 40 * np.sin(6.28 * 2 * y)
    # shapes (hard edges)
    cy, cx, r = 0.35, 0.4, 0.18
    img = np.where((y - cy) ** 2 + (x - cx) ** 2 < r ** 2, 210.0, img)
    img = np.where((np.abs(y - 0.7) < 0.12) & (np.abs(x - 0.65) < 0.2), 40.0, img)
    tri = (x + y > 1.35) & (x - y < 0.2)
    img = np.where(tri, 160.0, img)
    # texture + noise
    img += 8 * np.sin(6.28 * 16 * x) * np.sin(6.28 * 16 * y)
    img += rng.normal(0, 3, (size, size))
    return np.clip(img, 0, 255).astype(np.uint8)


def to_blocks(img: np.ndarray, n: int = 8) -> np.ndarray:
    h, w = img.shape
    hb, wb = h // n, w // n
    return (img[: hb * n, : wb * n]
            .reshape(hb, n, wb, n).transpose(0, 2, 1, 3).reshape(-1, n, n))


def from_blocks(blocks: np.ndarray, h: int, w: int, n: int = 8) -> np.ndarray:
    hb, wb = h // n, w // n
    return (blocks.reshape(hb, wb, n, n).transpose(0, 2, 1, 3)
            .reshape(hb * n, wb * n))
