"""Paged attention: the CUDA kernel ``csrc/paged_attention.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::paged_attention``:
flash attention and flash decoding over a shared KV block pool, with each
row's block table walked inside the kernel, so no gathered K/V copy is ever
written to device memory and each row's scan stops at its live length. On the
H100 it is bound by the live KV bytes; the source note in
``csrc/paged_attention.cu`` gives the design.

``n_splits == 1`` is the sequential scan; ``n_splits > 1`` splits the KV
chunk range over thread blocks, each writing a partial ``(acc, m, l)``, and
merges them here with the log-sum-exp combine (as the reference does outside
its kernel). The plain version (``ref.paged_attention_ref``) is the
block-table gather path of ``models.layers.chunked_attention``; the two agree
within float rounding (they sum in different orders).

``launches`` counts the kernel's launches; it changes only where the kernel
is launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import paged_attention_ref

NAME = "paged_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
launches = 0


@functools.cache
def _lib():
    lib = _build.load(NAME)
    fn = lib.paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_tables):
    devices = {t.device for t in (q, k_pool, v_pool, block_tables)}
    if q.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"{NAME}: tensors on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device or all on the CPU")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{NAME} wants q (B,Sq,H,D) and pools "
                         f"(n_pool,bs,KH,D), got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, _, h, d = q.shape
    kh = k_pool.shape[2]
    if k_pool.shape[3] != d or h % kh or d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {d} (pool {k_pool.shape[3]}) not "
                         f"in {HEAD_DIMS}, or {h} heads not a multiple of "
                         f"{kh} KV heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{NAME}: block tables {tuple(block_tables.shape)} "
                         f"for batch {b}")
    if q.dtype not in Q_DTYPES or k_pool.dtype not in KV_DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{NAME}: q {q.dtype}, pools {k_pool.dtype}/"
                        f"{v_pool.dtype}; wants q in bf16/f32 and pools in "
                        "bf16/f32/int8")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError(f"{NAME} wants contiguous q and pools")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    kv_valid_len, q_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, chunk: int = 1024,
                    n_splits: int = 1) -> torch.Tensor:
    """Attention of q (B, Sq, H, D), *unscaled*, over the pools
    ``(n_blocks + 1, block_size, KH, D)`` (float, or int8 payloads
    dequantized at ``layers.CACHE_INT8_SCALE``) through ``block_tables``
    (B, max_blocks), the dump row ``n_blocks`` in unused entries.
    kv_valid_len: an int or (B,); q_positions: (Sq,) or (B, Sq). The KV
    chunk is ``min(chunk, max_blocks * block_size)`` and must be a multiple
    of the block size. Returns (B, Sq, H, D) in q's dtype.

    CPU tensors take the plain version (``ref.paged_attention_ref``, the
    gather path); CUDA tensors launch the kernel on the current stream, or
    raise. Rows with kv_valid_len == 0 come back zero from the kernel (the
    plain version returns a masked mean there; no caller reads either).
    """
    if q.device.type == "cpu" and k_pool.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables,
                                   kv_valid_len, q_positions, causal=causal,
                                   window=window, softcap=softcap, chunk=chunk)
    _check(q, k_pool, v_pool, block_tables)
    from repro_torch.models.layers import CACHE_INT8_SCALE
    global launches
    b, sq, h, d = q.shape
    n_pool, bs, kh, _ = k_pool.shape
    width = block_tables.shape[1]
    if chunk % bs:
        raise ValueError(f"attention chunk {chunk} must be a multiple of "
                         f"the KV block size {bs}")
    chunk = min(chunk, width * bs)
    nk = -(-width * bs // chunk)
    n_splits = max(1, min(int(n_splits), nk))
    dev = q.device
    tables = block_tables.to(torch.int32).contiguous()
    kvl = torch.as_tensor(kv_valid_len, device=dev).to(torch.int32)
    kvl = kvl.reshape(-1).expand(b).contiguous()
    qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32)
    qpos = (qpos[None] if qpos.dim() == 1 else qpos).expand(b, sq).contiguous()
    if n_splits == 1:
        out = torch.empty_like(q)
        parts = (None, None, None)
    else:
        parts = (torch.empty((n_splits, b, sq, h, d), dtype=torch.float32,
                             device=dev),
                 torch.empty((n_splits, b, sq, h), dtype=torch.float32,
                             device=dev),
                 torch.empty((n_splits, b, sq, h), dtype=torch.float32,
                             device=dev))
        out = None
    fn = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()       # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), kvl.data_ptr(), qpos.data_ptr(),
                 ptr(out), *map(ptr, parts), b, sq, h, kh, d, n_pool, bs,
                 width, chunk, n_splits, int(causal), int(window),
                 Q_DTYPES[q.dtype], KV_DTYPES[k_pool.dtype], float(softcap),
                 d ** -0.5, CACHE_INT8_SCALE, stream)
    launches += 1
    _build.check(NAME, err)
    if n_splits == 1:
        return out
    acc, m, l = parts                      # log-sum-exp combine of the splits
    m_tot = m.amax(dim=0)
    w = torch.exp(m - m_tot)
    l_tot = (l * w).sum(dim=0)
    acc_tot = (acc * w[..., None]).sum(dim=0)
    return (acc_tot / torch.clamp_min(l_tot, 1e-30)[..., None]).to(q.dtype)
