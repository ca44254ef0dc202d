"""Paged attention: the CUDA kernel ``csrc/paged_attention.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::paged_attention``:
flash attention and flash decoding over a shared KV block pool, with each
row's block table walked inside the kernel, so no gathered K/V copy is ever
written to device memory and each row's scan stops at its live length. On the
H100 it is bound by the live KV bytes; the source note in
``csrc/paged_attention.cu`` gives the design.

One call is one launch. The kernel splits each row's table pages over
thread blocks when the grid is short (``geometry``: from the table's width
and the SM count, the caller's ``n_splits`` a floor), and the last block of
each split tile merges the partial states by log-sum-exp inside the launch;
the wrapper runs no arithmetic after it. The plain version
(``ref.paged_attention_ref``) is the block-table gather path of
``models.layers.chunked_attention``; the two agree within float rounding
(they sum in different orders).

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
# The kernel's geometry. It has one owner, this module: ``_build`` passes
# ``NVCC_DEFINES`` to nvcc, and csrc/paged_attention.cu takes every one of
# these values from them. Rows (query position x query head of one KV head)
# per block, warps per block, elements of a KV row per lane, positions per
# lane group per stage, table pages per split, splits of a row tile at most,
# blocks resident on an SM (the kernel's __launch_bounds__), and the bytes
# of the warps' K/V rings together.
ROWS = 2
WARPS = 8
LANE_ELEMENTS = 8
STAGE_POSITIONS = 2
TABLE_MAX = 1024
SPLIT_MAX = 256
BLOCKS_PER_SM = 2
RING_BYTES = 65536
NVCC_DEFINES = {"PA_ROWS": ROWS, "PA_WARPS": WARPS,
                "PA_LANE_ELEMENTS": LANE_ELEMENTS,
                "PA_STAGE_POSITIONS": STAGE_POSITIONS,
                "PA_TABLE_MAX": TABLE_MAX, "PA_SPLIT_MAX": SPLIT_MAX,
                "PA_BLOCKS_PER_SM": BLOCKS_PER_SM,
                "PA_RING_BYTES": RING_BYTES}
# dynamic shared memory of a block at most: the rings and the split's table
SMEM_BYTES = RING_BYTES + 4 * TABLE_MAX
# The kernel splits a row on its own only where each split keeps at least
# this many positions.
SPLIT_MIN_POSITIONS = 128
_counters = {}


@functools.cache
def _lib():
    lib = _build.load(NAME)
    fn = lib.paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 14
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(index: int) -> int:
    return _build.sm_count(torch.device("cuda", index))


def geometry(b: int, rows: int, kh: int, n_pages: int, block_size: int,
             n_splits: int, sms: int) -> int:
    """The splits of a launch. ``rows`` is Sq x H / KH, the rows of one
    (batch row, KV head); a block takes ``ROWS`` of them. Each row tile
    splits its ``n_pages`` table pages over at least ``n_splits`` blocks,
    enough that a split holds at most ``TABLE_MAX`` pages, and as many as
    keep the grid within the blocks resident on ``sms`` SMs, each split
    keeping ``SPLIT_MIN_POSITIONS`` positions; ``SPLIT_MAX`` at most."""
    tiles = b * kh * -(-rows // ROWS)
    n = max(n_splits, -(-n_pages // TABLE_MAX),
            min(BLOCKS_PER_SM * sms // tiles,
                n_pages * block_size // SPLIT_MIN_POSITIONS))
    return min(n, n_pages, SPLIT_MAX)


def _counters_for(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters of the in-kernel split merge, one per tile,
    kept per device and stream: every launch leaves them at 0."""
    key = (dev.index, stream)
    have = _counters.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _counters[key] = have
    return have


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
    n_pages = nk * chunk // bs                 # the reference's chunk grid
    dev = q.device
    if q.data_ptr() % 16:
        q = q.clone()                          # the kernel reads q in 16 bytes
    n_split = geometry(b, sq * (h // kh), kh, n_pages, bs,
                       max(1, min(int(n_splits), nk)), _sms(dev.index))
    tables = block_tables.to(torch.int32).contiguous()
    kvl = torch.as_tensor(kv_valid_len, device=dev).to(torch.int32)
    kvl = kvl.reshape(-1).expand(b).contiguous()
    qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32)
    qpos = (qpos[None] if qpos.dim() == 1 else qpos).expand(b, sq).contiguous()
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        parts = [None] * 4
        if n_split > 1:
            parts = [torch.empty((n_split, b, sq, h, d), dtype=torch.float32,
                                 device=dev),
                     torch.empty((n_split, b, sq, h), dtype=torch.float32,
                                 device=dev),
                     torch.empty((n_split, b, sq, h), dtype=torch.float32,
                                 device=dev),
                     _counters_for(dev, stream,
                                   b * kh * -(-sq * (h // kh) // ROWS))]
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), kvl.data_ptr(), qpos.data_ptr(),
                 out.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in parts),
                 b, sq, h, kh, d, n_pool, bs, width, n_pages, n_split,
                 int(causal), int(window), Q_DTYPES[q.dtype],
                 KV_DTYPES[k_pool.dtype], float(softcap), d ** -0.5,
                 CACHE_INT8_SCALE, stream)
    launches += 1
    if err:
        # a launch that failed part-way may leave its counters nonzero: the
        # next launch on this stream takes new, zeroed ones
        _counters.pop((dev.index, stream), None)
    _build.check(NAME, err)
    return out
