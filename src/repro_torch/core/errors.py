"""Error metrics for approximate arithmetic (Liang/Han/Lombardi metrics [16]);
a numpy copy of ``repro/core/errors.py``.

Reproduces the paper's Table V methodology: exhaustively sweep all 2^{2N} operand
pairs of the N-bit PE (c = 0), compare approximate vs exact output, and report

* ER    — error rate, fraction of pairs with any deviation
* MED   — mean |error distance|
* NMED  — MED normalized by the maximum output magnitude
* MRED  — mean relative error distance |ED| / max(1, |exact|)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .emulate import pe_mac


def _all_pairs(n_bits: int, signed: bool):
    span = 1 << n_bits
    if signed:
        vals = np.arange(span, dtype=np.int32) - (span >> 1)
    else:
        vals = np.arange(span, dtype=np.int32)
    a = np.repeat(vals, span)
    b = np.tile(vals, span)
    return a, b


def max_output_magnitude(n_bits: int, signed: bool) -> int:
    if signed:
        return (1 << (n_bits - 1)) ** 2          # (-2^{N-1})^2
    return ((1 << n_bits) - 1) ** 2


def pe_error_metrics(n_bits: int = 8, k: int = 6, signed: bool = True,
                     acc_bits: int = 24) -> Dict[str, float]:
    """Exhaustive Table-V style metrics for the approximate PE at factor k."""
    a, b = _all_pairs(n_bits, signed)
    approx = np.asarray(pe_mac(a, b, 0, n_bits=n_bits, k=k, signed=signed,
                               acc_bits=acc_bits), np.int64)
    exact = (a.astype(np.int64) * b.astype(np.int64))
    ed = np.abs(approx - exact)
    denom = np.maximum(1, np.abs(exact))
    return {
        "ER": float((ed > 0).mean()),
        "MED": float(ed.mean()),
        "NMED": float(ed.mean() / max_output_magnitude(n_bits, signed)),
        "MRED": float((ed / denom).mean()),
        "MAX_ED": int(ed.max()),
    }


def gemm_error_metrics(approx: np.ndarray, exact: np.ndarray) -> Dict[str, float]:
    """Error metrics between two GEMM outputs (used by application benchmarks)."""
    approx = np.asarray(approx, np.int64)
    exact = np.asarray(exact, np.int64)
    ed = np.abs(approx - exact)
    denom = np.maximum(1, np.abs(exact))
    scale = max(1, int(np.abs(exact).max()))
    return {
        "ER": float((ed > 0).mean()),
        "MED": float(ed.mean()),
        "NMED": float(ed.mean() / scale),
        "MRED": float((ed / denom).mean()),
    }


def psnr(ref: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB of `test` against `ref` (paper compares against exact output)."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    mse = np.mean((ref - test) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def ssim(ref: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    """Global-window SSIM with gaussian 11x11, matching the standard definition."""
    from numpy.lib.stride_tricks import sliding_window_view

    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    if ref.ndim != 2:
        ref = ref.reshape(ref.shape[-2:])
        test = test.reshape(test.shape[-2:])
    k1, k2, win = 0.01, 0.03, 11
    c1, c2 = (k1 * peak) ** 2, (k2 * peak) ** 2
    if min(ref.shape) < win:
        win = min(ref.shape) | 1
    ax = np.arange(win) - win // 2
    g = np.exp(-(ax ** 2) / (2 * 1.5 ** 2))
    kern = np.outer(g, g)
    kern /= kern.sum()

    def filt(img):
        v = sliding_window_view(img, (win, win))
        return np.einsum("ijkl,kl->ij", v, kern)

    mu_r, mu_t = filt(ref), filt(test)
    sig_r = filt(ref * ref) - mu_r ** 2
    sig_t = filt(test * test) - mu_t ** 2
    sig_rt = filt(ref * test) - mu_r * mu_t
    num = (2 * mu_r * mu_t + c1) * (2 * sig_rt + c2)
    den = (mu_r ** 2 + mu_t ** 2 + c1) * (sig_r + sig_t + c2)
    return float((num / den).mean())
