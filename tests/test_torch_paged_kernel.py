"""The paged-attention kernel's arithmetic, emulated in torch on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/paged_attention.cu``) runs
only on the card; ``tests/test_torch_cuda.py`` holds it there against its
plain version. Here ``_emulate`` repeats what it computes, block by block, in
f32 on the CPU: its split of each row's table pages over blocks
(``paged_attention.geometry`` at the H100's 132 SMs; the rows and warps
of a block are the wrapper's constants, which the build passes to the
kernel), each block's live
range (its pages, the live length, the causal frontier of its last row, the
window of its first), the positions dealt to warps in stages of
``STAGE_POSITIONS`` per lane group, each lane group's own online softmax
(masked positions carry no weight; positions past the range are zero-filled
and never read), the lane groups' merge by shuffle pairs, the warps' merge
and the blocks' log-sum-exp merge. The emulated pools hold NaN in the dump
row, which the kernel never reads for a live position.

Held against ``ref.paged_attention_ref`` (the gather path) within one bf16
ulp plus 1e-4 (``chip_smoke.py``'s gate: both round an f32 result to bf16
once, after sums in another order), or 1e-5 of |x| plus 1e-6 for f32 q,
rows with kv_valid_len == 0 zero; at every head dim, operand type and mask
path, and on the grid the wrapper picks for cards of 1 to 132 SMs. The
control drops the ``exp(m_i - m)`` rescale from the merges, and the gate
must fail it. No JAX: the plain version is the port's own.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.models.layers import BIG_NEG, cache_load

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
F32_RTOL, F32_ATOL = 1e-5, 1e-6
SMS = 132                                   # the H100's SMs


def _merge(m1, l1, a1, m2, l2, a2, rescale):
    """Two online-softmax states (m, l, acc) into one, by log-sum-exp."""
    mn = torch.maximum(m1, m2)
    c1, c2 = ((torch.exp(m1 - mn), torch.exp(m2 - mn)) if rescale
              else (torch.ones_like(m1), torch.ones_like(m2)))
    return mn, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def _emulate(q, k_pool, v_pool, tables, kvl, qpos, *, causal=True, window=0,
             softcap=0.0, chunk=1024, n_splits=1, rescale=True, sms=SMS):
    """What the kernel computes, in its order, on CPU tensors, on a card of
    ``sms`` SMs; returns (out in q's dtype, the split count it took). Every block of the grid at once: a block runs as many stages
    as the longest, and positions past its range leave its state as it was,
    as the stages it never runs do."""
    b, sq, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    g, width = h // kh, tables.shape[1]
    chunk = min(chunk, width * bs)
    nk = -(-width * bs // chunk)
    n_pages = nk * chunk // bs
    n_split = pa.geometry(b, sq * g, kh, n_pages, bs,
                          max(1, min(n_splits, nk)), sms)
    span = -(-n_pages // n_split)
    rb, nw, npos = pa.ROWS, pa.WARPS, pa.STAGE_POSITIONS
    pw = 32 // (d // pa.LANE_ELEMENTS)       # lane groups of a warp
    ps = pw * npos
    qs = (q * d ** -0.5).float()            # scaled in q's dtype
    kf, vf = cache_load(k_pool).float(), cache_load(v_pool).float()
    dump = kf.shape[0] - 1
    win = window if window > 0 else 1 << 30
    # the grid: (batch row, KV head, row tile, split), split fastest
    blocks = [(bi, kv, r0, sp) for bi in range(b) for kv in range(kh)
              for r0 in range(0, sq * g, rb) for sp in range(n_split)]
    rows = torch.tensor([[r0 + r for r in range(rb)] for _, _, r0, _ in blocks])
    r_ok = rows < sq * g
    rows = rows.clamp(max=sq * g - 1)
    bi_t = torch.tensor([x[0] for x in blocks])
    kv_t = torch.tensor([x[1] for x in blocks])
    qr = torch.where(r_ok[..., None],
                     qs[bi_t[:, None], rows // g, kv_t[:, None] * g + rows % g],
                     0.)                                        # (NB, RT, D)
    qp = qpos[bi_t[:, None], rows // g]                        # (NB, RT)
    lo, hi = [], []
    for i, (bi, _, _, sp) in enumerate(blocks):   # each block's live range
        page0 = sp * span
        a = page0 * bs
        z = min((page0 + max(min(span, n_pages - page0), 0)) * bs,
                int(kvl[bi]))
        if causal:
            z = min(z, int(qp[i][r_ok[i]].max()) + 1)
            if window > 0:
                a = max(a, int(qp[i][r_ok[i]].min()) - window + 1)
        lo.append(a)
        hi.append(z)
    lo, hi = torch.tensor(lo), torch.tensor(hi)
    n_st = -(-int((hi - lo).clamp(min=0).max()) // (nw * ps))
    nb = len(blocks)
    m = torch.full((nb, nw, pw, rb), BIG_NEG)
    l = torch.zeros(nb, nw, pw, rb)
    acc = torch.zeros(nb, nw, pw, rb, d)
    w_i = torch.arange(nw)[:, None, None]
    g_i = torch.arange(pw)[None, :, None]
    j_i = torch.arange(npos)[None, None, :]
    lo4, hi4 = lo[:, None, None, None], hi[:, None, None, None]
    bi4, kv4 = bi_t[:, None, None, None], kv_t[:, None, None, None]
    for t in range(n_st):
        pos = lo4 + (t * nw + w_i) * ps + j_i * pw + g_i       # (NB, W, PW, NP)
        live = pos < hi4
        at = torch.where(live, pos, lo4)
        page = at // bs
        blk = torch.where(page < width, tables[bi4, page.clamp(max=width - 1)],
                          dump).clamp(0, dump).long()
        krow = torch.where(live[..., None], kf[blk, at % bs, kv4], 0.)  # zero-fill
        vrow = torch.where(live[..., None], vf[blk, at % bs, kv4], 0.)
        s = torch.einsum("bwgjd,brd->bwgjr", krow, qr)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        ok = live[..., None] & r_ok[:, None, None, None, :]
        if causal:
            delta = qp[:, None, None, None, :] - pos[..., None]
            ok = ok & (delta >= 0) & (delta < win)
        mx = torch.maximum(m, torch.where(ok, s, BIG_NEG).amax(dim=3))
        corr = torch.exp(m - mx)
        p = torch.where(ok, torch.exp(s - mx[:, :, :, None]), 0.)
        l = l * corr + p.sum(dim=3)
        acc = (acc * corr[..., None]
               + torch.einsum("bwgjr,bwgjd->bwgrd", p, vrow))
        m = mx
    off = 1                                 # lane groups: shuffle pairs
    while off < pw:
        idx = torch.arange(pw) ^ off
        m, l, acc = _merge(m, l, acc, m[:, :, idx], l[:, :, idx],
                           acc[:, :, idx], rescale)
        off *= 2
    m, l, acc = m[:, :, 0], l[:, :, 0], acc[:, :, 0]   # (NB, W, RT[, D])
    mx = m.max(dim=1).values                # the warps, through shared memory
    c = torch.exp(m - mx[:, None]) if rescale else torch.ones_like(m)
    m, l, acc = mx, (l * c).sum(dim=1), (acc * c[..., None]).sum(dim=1)
    # each tile's last block merges its splits (empty ones wrote no acc)
    m, l, acc = (x.reshape(nb // n_split, n_split, *x.shape[1:])
                 for x in (m, l, acc))
    mx = m.max(dim=1).values
    c = torch.exp(m - mx[:, None]) if rescale else torch.ones_like(m)
    wrote = l > 0
    c = torch.where(wrote, c, 0.)
    acc = (torch.where(wrote[..., None], acc, 0.) * c[..., None]).sum(dim=1)
    res = acc / (l * c).sum(dim=1).clamp_min(1e-30)[..., None]   # (tiles, RT, D)
    out = torch.zeros(b, sq, h, d)
    for i in range(res.shape[0]):
        k = i * n_split
        r = rows[k][r_ok[k]]
        out[bi_t[k], r // g, kv_t[k] * g + r % g] = res[i][r_ok[k]]
    return out.to(q.dtype), n_split


def _inputs(seed, *, b, sq, h, kh, d, bs, width, kvl, kv_dtype,
            q_dtype=torch.bfloat16):
    """q in q_dtype; pools in kv_dtype (int8 payloads at scale 32); a permuted
    table per row with the dump index past its live blocks; query positions
    ending at each row's live length."""
    rng = np.random.default_rng(seed)
    n_blocks = b * width + 5
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((n_blocks + 1, bs, kh, d),
                                                 np.float32))
            for _ in range(2))
    if kv_dtype == torch.int8:
        k, v = (torch.clamp(torch.round(x * 32), -127, 127) for x in (k, v))
    perm = torch.from_numpy(rng.permutation(n_blocks)[:b * width]
                            .reshape(b, width))
    kvl_t = torch.tensor(kvl, dtype=torch.int32)
    tables = torch.where(torch.arange(width)[None, :] * bs < kvl_t[:, None],
                         perm, n_blocks).to(torch.int32)
    qpos = torch.clamp_min(kvl_t[:, None] - sq + torch.arange(sq)[None, :],
                           0).to(torch.int32)
    return (q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype), tables,
            kvl_t, qpos)


def _with_nan_dump(pool):
    """The pool with NaN in its dump row (the last): a read of it for a live
    position would reach the output."""
    x = cache_load(pool).float().clone()
    x[-1] = float("nan")
    return x


# (head dim, KV dtype, window, softcap): GQA 6/2 heads, block 8, 32-page
# tables (256 positions) in 64-position chunks, rows live to 0, 37, 200 and
# 256 positions (37 is shorter than one split), Sq 1 and 5, n_splits 1
# (the kernel's own split: 2 at 132 SMs) and 3
CASES = [(16, torch.bfloat16, 0, 0.0), (64, torch.bfloat16, 0, 0.0),
         (128, torch.bfloat16, 0, 0.0), (256, torch.bfloat16, 0, 0.0),
         (64, torch.int8, 0, 0.0), (64, torch.bfloat16, 24, 30.0)]
KVL = [0, 37, 200, 256]


def _gate(got, want, kvl, rtol=BF16_RTOL, atol=BF16_ATOL):
    live = kvl > 0
    err = (got.float() - want.float())[live].abs()
    ok = bool((err <= rtol * want.float()[live].abs() + atol).all())
    return ok, float(err.max())


def _tol(q_dtype):
    """One bf16 ulp plus 1e-4 for a bf16 result; for f32, where nothing is
    rounded but the sums' order differs, 1e-5 of |x| plus 1e-6."""
    return ((BF16_RTOL, BF16_ATOL) if q_dtype == torch.bfloat16
            else (F32_RTOL, F32_ATOL))


@pytest.mark.parametrize("d,kv_dtype,window,softcap", CASES)
def test_paged_kernel_emulation_within_one_bf16_ulp(d, kv_dtype, window,
                                                    softcap):
    for sq in (1, 5):
        q, k, v, tables, kvl, qpos = _inputs(
            d + sq, b=len(KVL), sq=sq, h=6, kh=2, d=d, bs=8, width=32,
            kvl=KVL, kv_dtype=kv_dtype)
        kw = dict(window=window, softcap=softcap, chunk=64)
        want = paged_attention_ref(q, k, v, tables, kvl, qpos, **kw)
        splits = set()
        for n_splits in (1, 3):
            got, n_split = _emulate(q, _with_nan_dump(k),
                                         _with_nan_dump(v), tables, kvl, qpos,
                                         n_splits=n_splits, **kw)
            splits.add(n_split)
            ok, worst = _gate(got, want, kvl)
            assert ok, (sq, n_splits, worst)
            assert not got[kvl == 0].any()       # kv_valid_len == 0: zeros
        assert splits == {2, 3}, splits          # split on its own, and floored


def test_paged_kernel_emulation_without_rescale_breaks_the_gate():
    """The control: the same merges without exp(m_i - m) fail the gate."""
    q, k, v, tables, kvl, qpos = _inputs(
        7, b=len(KVL), sq=5, h=6, kh=2, d=64, bs=8, width=32, kvl=KVL,
        kv_dtype=torch.bfloat16)
    want = paged_attention_ref(q, k, v, tables, kvl, qpos, chunk=64)
    got, _ = _emulate(q, k, v, tables, kvl, qpos, chunk=64, rescale=False)
    ok, worst = _gate(got, want, kvl)
    assert not ok, worst


# (id, causal, window, softcap): the kernel's mask paths
MASKS = [("causal", True, 0, 0.0), ("noncausal", False, 0, 0.0),
         ("window_softcap", True, 12, 5.0)]
# (q dtype, pool dtype)
DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.int8)]


@pytest.mark.parametrize("sq", (1, 4))
@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES,
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("d", pa.HEAD_DIMS)
def test_paged_kernel_emulation_grid(d, q_dtype, kv_dtype, mask, sq):
    """Every head dim, operand type and mask path at a small size: GQA 4/2
    heads, block 4, 16-page tables (64 positions) in 32-position chunks,
    rows live to 0, 27 and 64, n_splits 1 and 2."""
    _, causal, window, softcap = mask
    q, k, v, tables, kvl, qpos = _inputs(
        1000 * d + sq, b=3, sq=sq, h=4, kh=2, d=d, bs=4, width=16,
        kvl=[0, 27, 64], kv_dtype=kv_dtype, q_dtype=q_dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=32)
    want = paged_attention_ref(q, k, v, tables, kvl, qpos, **kw)
    for n_splits in (1, 2):
        got, geo = _emulate(q, _with_nan_dump(k), _with_nan_dump(v), tables,
                            kvl, qpos, n_splits=n_splits, **kw)
        assert geo == n_splits
        ok, worst = _gate(got, want, kvl, *_tol(q_dtype))
        assert ok, (n_splits, worst)
        assert not got[kvl == 0].any()           # kv_valid_len == 0: zeros


@pytest.mark.parametrize("q_dtype", (torch.bfloat16, torch.float32),
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("sms,n_split", [
    (1, 1), (8, 1), (32, 1),
    (63, 1),                     # 126 resident blocks: one 64-tile grid
    (64, 2),                     # 128: room for two splits of each tile
    (100, 2), (132, 2), (264, 2)])
def test_paged_kernel_emulation_on_any_card(sms, n_split, q_dtype):
    """The grid the wrapper picks on a card of ``sms`` SMs computes the same
    result: a 256-position row splits in two once the 64 tiles of 2 rows
    leave room on the resident blocks, and never further (128 positions a
    split at least). GQA 6/2 heads, Sq 5, block 8, 32-page tables."""
    q, k, v, tables, kvl, qpos = _inputs(
        sms, b=len(KVL), sq=5, h=6, kh=2, d=64, bs=8, width=32, kvl=KVL,
        kv_dtype=q_dtype, q_dtype=q_dtype)
    want = paged_attention_ref(q, k, v, tables, kvl, qpos, chunk=64)
    got, geo = _emulate(q, _with_nan_dump(k), _with_nan_dump(v), tables, kvl,
                        qpos, chunk=64, sms=sms)
    assert geo == n_split
    ok, worst = _gate(got, want, kvl, *_tol(q_dtype))
    assert ok, worst
    assert not got[kvl == 0].any()


@pytest.mark.parametrize("b,rows,kh,pages,n_splits,want", [
    (4, 3, 5, 8, 1, 1),          # smollm-360m's engine decode: no split
    (4, 24, 5, 8, 1, 1),         # and its 8-token prefill chunk
    (4, 2, 8, 8, 1, 1),          # gemma3-12b's engine decode
    (4, 16, 8, 8, 1, 1),         # and its prefill chunk
    (4, 3, 5, 512, 1, 6),        # a 4096-position decode row, smollm's heads
    (4, 2, 8, 512, 1, 8),        # the same at gemma3-12b's
    (4, 2, 8, 512, 20, 20),      # the caller's floor above the kernel's own
    (4, 2, 8, 512, 999, 256),    # SPLIT_MAX at most
    (1, 8, 1, 4096, 1, 66),      # 32768 positions, one KV head
    (64, 8, 8, 4096, 1, 4),      # a full grid: splits to fit the table
    (512, 2, 8, 8, 1, 1),        # 2 rows stay one tile on any grid
    (64, 3, 8, 8, 1, 1),         # 3 rows on a full grid: two tiles, no split
    (1, 1, 1, 8192, 1, 256),     # 65536 positions: SPLIT_MAX caps the fill
    (1, 1, 1, 3, 1, 1),          # 24 positions never split on their own
    (2, 4, 4, 64, 3, 4),         # 512 positions: 128 a split past the floor
])
def test_geometry(b, rows, kh, pages, n_splits, want):
    assert pa.geometry(b, rows, kh, pages, 8, n_splits, SMS) == want


def test_kernel_takes_its_geometry_from_the_wrapper():
    """Every geometry macro the CUDA source reads is one of the wrapper's
    ``NVCC_DEFINES``, and the build passes each of them: the source holds
    no copy of the values that ``geometry`` and ``_emulate`` use."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert set(re.findall(r"\bPA_[A-Z_]+\b", src)) == set(pa.NVCC_DEFINES)
    assert sorted(_build.defines(pa.NAME)) == sorted(
        f"-D{k}={v}" for k, v in pa.NVCC_DEFINES.items())
