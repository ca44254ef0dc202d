"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::flash_attention``:
the forward pass of causal / sliding-window / softcap attention over a whole
sequence from position 0, an online softmax over K/V tiles with f32 running
max, sum and output, so no score matrix is ever written to device memory.
The port routes the whole-prompt attention of ``models.layers`` (lockstep
prefill, and a forward without a cache) through it on the card; the source
note in ``csrc/flash_attention.cu`` gives the design and what bounds it.

The signature and layout are the reference's, (B, H, S, D), with two
widenings: k/v may carry ``KH`` heads with ``H % KH == 0`` (query head h
reads KV head ``h // (H // KH)``: the broadcast the reference's callers do,
without the copy), and ``Sq``/``Skv`` need not be multiples of a tile (the
kernel masks the tails). ``bq``/``bk`` are taken for parity: they set the
chunks of the plain version (``ref.flash_attention_ref``), while the kernel
uses its own tiles; the two agree within float rounding.

The kernel has two variants, chosen by dtype alone: q, k and v all bf16
(every served model) take the tensor-core kernel, any f32 operand the SIMT
kernel (``variant``). ``launches`` counts every launch of either and
``tc_launches`` those of the tensor-core kernel; both change only where the
kernel is launched.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from . import _build
from .ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (16, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_BQ = 128
DEFAULT_BK = 128
VARIANTS = ("simt", "tensor_core")
launches = 0
tc_launches = 0


@functools.cache
def _lib():
    lib = _build.load(NAME)
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name, n_args in (("flash_attention_variant", 2),
                         ("flash_attention_smem", 3)):
        f = getattr(lib, name)
        f.argtypes, f.restype = [ctypes.c_int] * n_args, ctypes.c_int
    return lib


def variant(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The kernel variant a launch with these dtypes runs (``VARIANTS``), as
    the C launcher chooses it."""
    return VARIANTS[_lib().flash_attention_variant(DTYPES[q_dtype],
                                                   DTYPES[kv_dtype])]


def smem_bytes(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of one block of that variant at head dim d."""
    return _lib().flash_attention_smem(DTYPES[q_dtype], DTYPES[kv_dtype], d)


def _check(q, k, v, kvl):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME} wants q (B,H,Sq,D) and k/v (B,KH,Skv,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    kh = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or h % kh or d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {d} (k/v {k.shape[3]}) not in "
                         f"{HEAD_DIMS}, batch {b} against {k.shape[0]}, or "
                         f"{h} heads not a multiple of {kh} KV heads")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"{NAME}: q {q.dtype}, k/v {k.dtype}/{v.dtype}; "
                        "wants float32 or bfloat16, k and v alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(t.stride(i) * size % 16 for i in range(3))):
            raise ValueError(f"{NAME}: {name} with strides {t.stride()}: "
                             "wants the last dim contiguous and every row "
                             "16-byte aligned")
    devices = {t.device for t in (q, k, v)}
    if isinstance(kvl, torch.Tensor):
        if kvl.numel() not in (1, b):
            raise ValueError(f"{NAME}: kv_valid_len of shape "
                             f"{tuple(kvl.shape)} for batch {b}")
        devices.add(kvl.device)
    if q.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"{NAME}: tensors on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device or all on the CPU")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_valid_len: Optional[Union[int, torch.Tensor]] = None,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, bq: int = DEFAULT_BQ,
                    bk: int = DEFAULT_BK) -> torch.Tensor:
    """Attention of q (B, H, Sq, D) over k/v (B, KH, Skv, D), query and key
    positions their row indices from 0; see ``ref.flash_attention_ref`` for
    the arithmetic. ``kv_valid_len``: the live key count, None (all Skv), an
    int or a (B,) tensor. Returns (B, H, Sq, D) in q's dtype, laid out as q
    is where q is dense (a transposed view of a (B, Sq, H, D) tensor gives
    one back).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (the tensor-core variant when q, k and v are all
    bfloat16, else the SIMT one), or raise: on another device, dtype
    (float32 and bfloat16, k and v alike), layout (last dim contiguous, rows
    16-byte aligned) or head dim (``HEAD_DIMS``).
    """
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, kv_valid_len=kv_valid_len,
                                   causal=causal, window=window,
                                   softcap=softcap, bq=bq, bk=bk)
    _check(q, k, v, kv_valid_len)
    global launches, tc_launches
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    kvl_ptr, kvl_all = None, skv
    if isinstance(kv_valid_len, torch.Tensor):
        kvl = kv_valid_len.to(torch.int32).reshape(-1).expand(b).contiguous()
        kvl_ptr = kvl.data_ptr()
    elif kv_valid_len is not None:
        kvl_all = int(kv_valid_len)
    out = torch.empty_like(q)
    if not out.numel():
        return out
    lib = _lib()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl_ptr,
                 out.data_ptr(), b, h, kh, sq, skv, d, kvl_all, *strides,
                 int(causal), int(window), DTYPES[q.dtype], DTYPES[k.dtype],
                 float(softcap), d ** -0.5, stream)
    launches += 1
    tc_launches += lib.flash_attention_variant(DTYPES[q.dtype],
                                               DTYPES[k.dtype])
    _build.check(NAME, err)
    return out
