"""Shared layers (port of ``repro/models/layers.py``): RMSNorm, RoPE, chunked
GQA attention over a contiguous or paged KV cache, SwiGLU MLP.

All matmuls with weights route through ``core.gemm.dot``, so the exact and
approximate systolic backends are selectable per layer and ``bind``-prepared
weights run weight-stationary. Attention scores and probabilities are f32
(``torch.backends.cuda.matmul.allow_tf32`` must stay False, its default, for
the f32 einsums to be f32 on the card). Caches are contiguous (lockstep) or
paged block pools read through per-slot block tables (the engine); the ring
caches of windowed families come with a later slice. Attention over a whole
prompt from position 0 goes through the flash-attention kernel
(``kernels.flash_attention``), whose plain version on CPU tensors is
``chunked_attention`` itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.gemm import EXACT, GemmPolicy, dot
from repro_torch.kernels.flash_attention import flash_attention

BIG_NEG = -2.3819763e38  # min bf16


def head_weight(params, dtype):
    """Vocab-projection weight: the untied ``lm_head`` leaf, a ``bind``-prepared
    head (present even for tied embeddings), or the transposed embedding table.
    Raw tensors are cast to the activation dtype; prepared operands pass
    through."""
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return w.to(dtype) if isinstance(w, torch.Tensor) else w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + w.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved). x: (B, S, H, D);
    positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(float(theta), -torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def _as_batched(x: torch.Tensor) -> torch.Tensor:
    """A per-sequence vector in batched form: (S,) -> (1, S)."""
    return x[None, :] if x.dim() == 1 else x


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, kv_valid_len, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, chunk: int = 1024,
                      q_chunk: int = 1024, block_tables=None,
                      paged_kernel=None) -> torch.Tensor:
    """Flash-style attention: outer loop over Q chunks, inner online-softmax
    loop over KV chunks, so score tensors never exceed (B, H, q_chunk, chunk).

    q: (B, Sq, H, D); k/v: (B, Skv, KH, D) (the cache, possibly partly
    unwritten). q_positions: (Sq,) global positions of the queries, or
    (B, Sq) per-slot positions (ragged continuous batching). kv_valid_len: an
    int or a per-slot (B,) tensor; entries at kv index >= kv_valid_len are
    masked. `window` > 0 limits each query to the last `window` positions.

    **Paged KV** (``block_tables`` given): k/v are *block pools*
    ``(n_blocks + 1, block_size, KH, D)`` (float, or int8 payloads that are
    dequantized as they are gathered) and ``block_tables`` is the per-slot
    ``(B, max_blocks)`` map from logical block to pool block. Each KV chunk
    gathers only its own blocks, padding the table with the dump row
    ``n_blocks`` up to the chunk grid, and reconstructs the positional
    layout of a contiguous cache. This gather path is the plain version of
    the paged-attention kernel.

    ``paged_kernel`` (paged pools only): truthy sends the read to the
    paged-attention kernel (``kernels.paged_attention``), which walks the
    table itself; the integer is a floor on the blocks each row's KV range
    is split over (the kernel splits long rows further on its own and
    merges the splits inside the launch). On CPU tensors the kernel's
    wrapper runs this gather path.
    """
    if block_tables is not None and paged_kernel:
        from repro_torch.kernels.paged_attention import paged_attention
        return paged_attention(q, k, v, block_tables, kv_valid_len,
                               q_positions, causal=causal, window=window,
                               softcap=softcap, chunk=chunk,
                               n_splits=int(paged_kernel))
    b, sq, h, d = q.shape
    kh = k.shape[-2]
    g = h // kh
    dev = q.device
    qh = (q * d ** -0.5).reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    qpos = _as_batched(q_positions)                               # (Bq, Sq)
    if block_tables is not None:
        blk_sz = k.shape[1]
        if chunk % blk_sz:
            raise ValueError(f"attention chunk {chunk} must be a multiple of "
                             f"the KV block size {blk_sz}")
        skv = block_tables.shape[1] * blk_sz
        chunk = min(chunk, skv)
        nbpc = chunk // blk_sz
        nk = -(-skv // chunk)
        pad_b = nk * nbpc - block_tables.shape[1]
        bt = block_tables.long()
        if pad_b:   # pad with the dump block: masked like zero padding
            bt = F.pad(bt, (0, pad_b), value=k.shape[0] - 1)
        kt = vt = None
    else:
        skv = k.shape[1]
        kt = k.permute(0, 2, 1, 3).to(torch.float32)          # (B, KH, Skv, D)
        vt = v.permute(0, 2, 1, 3).to(torch.float32)

    def kv_chunk(k0):
        if block_tables is None:
            return kt[:, :, k0:k0 + chunk], vt[:, :, k0:k0 + chunk]
        cols = bt[:, k0 // blk_sz:k0 // blk_sz + nbpc]            # (B, nbpc)
        k_blk = cache_load(k[cols]).reshape(b, chunk, kh, d)
        v_blk = cache_load(v[cols]).reshape(b, chunk, kh, d)
        return (k_blk.permute(0, 2, 1, 3).to(torch.float32),
                v_blk.permute(0, 2, 1, 3).to(torch.float32))

    window_eff = window if window > 0 else torch.iinfo(torch.int32).max
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_blk = qh[:, :, :, q0:q0 + q_chunk].to(torch.float32)  # (B,KH,G,qc,D)
        qp = qpos[:, q0:q0 + q_chunk]                              # (Bq, qc)
        qc = q_blk.shape[3]
        acc = torch.zeros((b, kh, g, qc, d), dtype=torch.float32, device=dev)
        m = torch.full((b, kh, g, qc), BIG_NEG, dtype=torch.float32,
                       device=dev)
        denom = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, chunk):
            k_blk, v_blk = kv_chunk(k0)
            kpos = torch.arange(k0, k0 + k_blk.shape[2], device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk)
            s = _softcap(s, softcap)
            if isinstance(kv_valid_len, torch.Tensor):             # (B, 1, C)
                valid = (kpos[None, :] < kv_valid_len[:, None])[:, None, :]
            else:                                                  # (1, 1, C)
                valid = (kpos < kv_valid_len)[None, None, :]
            if causal:
                delta = qp[:, :, None] - kpos[None, None, :]      # (Bq, qc, C)
                valid = valid & (delta >= 0) & (delta < window_eff)
            s = torch.where(valid[:, None, None], s, BIG_NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p,
                                                       v_blk)
            m = m_new
        outs.append(acc / torch.clamp_min(denom, 1e-30)[..., None])
    out = torch.cat(outs, dim=3)                                 # (B,KH,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# KV-cache payload helpers and the paged cache's block tables
# ---------------------------------------------------------------------------

CACHE_INT8_SCALE = 32.0


def init_block_tables(batch: int, max_len: int, n_blocks: int,
                      block_size: int, device="cpu") -> torch.Tensor:
    """The per-slot block-table leaf of a paged cache: ``(batch,
    ceil(max_len / block_size))`` int32, every entry the dump index
    ``n_blocks`` (the pool's scratch row), as ``launch.paged.BlockPool``
    sizes its rows."""
    return torch.full((batch, -(-max_len // block_size)), n_blocks,
                      dtype=torch.int32, device=device)


def cache_store(x: torch.Tensor, dtype) -> torch.Tensor:
    """K/V in the cache's payload type: int8 at ``CACHE_INT8_SCALE``
    (round half to even, clipped to +-127), else a cast."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.to(torch.float32) * CACHE_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def cache_load(x: torch.Tensor) -> torch.Tensor:
    """A cache payload as values: int8 dequantized to float32."""
    if x.dtype == torch.int8:
        return x.to(torch.float32) / CACHE_INT8_SCALE
    return x


def _normal(generator: torch.Generator, shape, std: float, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * std
    return w.to(dtype).to(device)


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool, dtype,
                   device):
    std = d_model ** -0.5
    p = {
        "wq": _normal(generator, (d_model, n_heads * head_dim), std, dtype, device),
        "wk": _normal(generator, (d_model, n_kv_heads * head_dim), std, dtype, device),
        "wv": _normal(generator, (d_model, n_kv_heads * head_dim), std, dtype, device),
        "wo": _normal(generator, (n_heads * head_dim, d_model), std, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=device)
    return p


def attention_block(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                    q_positions, kv_cache=None, cache_pos=0, kv_valid_len=None,
                    causal=True, window=0, softcap=0.0, chunk=1024,
                    policy: GemmPolicy = EXACT, layer: str = "",
                    block_tables=None, token_valid=None, paged_kernel=None):
    """GQA attention. Returns (out, kv_cache).

    kv_cache=(k, v): contiguous (B, S, KH, D) cache tensors. The new K/V are
    written **in place** at ``cache_pos`` (a Python int: lockstep, the whole
    batch at one position) and attention runs over the first
    ``cache_pos + Sq`` entries. Without a cache, attention runs over the
    block's own K/V.

    With ``block_tables`` the cache is a *paged block pool*
    ``(n_blocks + 1, block_size, KH, D)`` per leaf: ``cache_pos`` is the
    per-slot (B,) write position, the token at logical position p is
    scattered (in place) to pool block ``block_tables[b, p // block_size]``
    at offset ``p % block_size``, and tokens masked by ``token_valid``
    (B, Sq) go to the dump block (pool row ``n_blocks``). Reads go through
    the table: the gather path, or the paged-attention kernel when
    ``paged_kernel`` is truthy. ``kv_valid_len`` is the per-slot (B,) count
    of valid cache entries.

    Contiguous attention over a whole prompt from position 0 (no cache, or
    ``cache_pos == 0``; ``q_positions`` are then ``0 .. Sq - 1``, as
    ``transformer.forward`` gives them) goes through ``flash_attention``:
    the kernel on the card, and on the CPU its plain version, which is the
    ``chunked_attention`` call of the other positions with this ``chunk``.
    Decode and later chunks (``cache_pos > 0``) take ``chunked_attention``:
    the kernel, like the reference's, has no query offset.
    """
    b, sq, _ = x.shape
    q = dot(x, p["wq"], policy, layer=layer + "/wq")
    k = dot(x, p["wk"], policy, layer=layer + "/wk")
    v = dot(x, p["wv"], policy, layer=layer + "/wv")
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, sq, n_heads, head_dim)
    k = k.reshape(b, sq, n_kv_heads, head_dim)
    v = v.reshape(b, sq, n_kv_heads, head_dim)
    q = rope(q, q_positions, rope_theta)
    k = rope(k, q_positions, rope_theta)
    if kv_cache is not None and block_tables is not None:
        ck, cv = kv_cache
        blk_sz = ck.shape[1]
        idx = cache_pos[:, None] + torch.arange(sq, device=x.device)[None, :]
        lblk = torch.clamp_max(torch.div(idx, blk_sz, rounding_mode="floor"),
                               block_tables.shape[1] - 1)
        blk = torch.gather(block_tables, 1, lblk.to(block_tables.dtype)).long()
        off = torch.remainder(idx, blk_sz)
        if token_valid is not None:
            blk = torch.where(token_valid, blk, ck.shape[0] - 1)
        ck[blk, off] = cache_store(k, ck.dtype)
        cv[blk, off] = cache_store(v, cv.dtype)
        valid = kv_valid_len if kv_valid_len is not None else cache_pos + sq
        out = chunked_attention(q, ck, cv, q_positions, valid, causal=causal,
                                window=window, softcap=softcap, chunk=chunk,
                                block_tables=block_tables,
                                paged_kernel=paged_kernel)
    else:
        if kv_cache is not None:
            ck, cv = kv_cache
            ck[:, cache_pos:cache_pos + sq] = k
            cv[:, cache_pos:cache_pos + sq] = v
            k_all, v_all, valid = ck, cv, cache_pos + sq
        else:
            k_all, v_all, valid = k, v, sq
        if kv_cache is None or cache_pos == 0:
            # (B, H, S, D) views: no copies; q_chunk 1024 as chunked_attention's
            out = flash_attention(
                q.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2),
                kv_valid_len=valid, causal=causal, window=window,
                softcap=softcap, bq=1024, bk=chunk).transpose(1, 2)
        else:
            out = chunked_attention(q, k_all, v_all, q_positions, valid,
                                    causal=causal, window=window,
                                    softcap=softcap, chunk=chunk)
    out = out.reshape(b, sq, n_heads * head_dim)
    return dot(out, p["wo"], policy, layer=layer + "/wo"), kv_cache


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype, device):
    std = d_model ** -0.5
    return {
        "w1": _normal(generator, (d_model, d_ff), std, dtype, device),
        "w3": _normal(generator, (d_model, d_ff), std, dtype, device),
        "w2": _normal(generator, (d_ff, d_model), d_ff ** -0.5, dtype, device),
    }


def mlp_block(p, x, *, act: str = "silu", policy: GemmPolicy = EXACT,
              layer: str = ""):
    h1 = dot(x, p["w1"], policy, layer=layer + "/w1")
    h3 = dot(x, p["w3"], policy, layer=layer + "/w3")
    actf = F.silu if act == "silu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    return dot(actf(h1) * h3, p["w2"], policy, layer=layer + "/w2")
