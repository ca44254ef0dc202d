"""Shared layers (port of ``repro/models/layers.py``): RMSNorm, RoPE, chunked
GQA attention over a contiguous KV cache, SwiGLU MLP.

All matmuls with weights route through ``core.gemm.dot``, so the exact and
approximate systolic backends are selectable per layer and ``bind``-prepared
weights run weight-stationary. Attention scores and probabilities are f32
(``torch.backends.cuda.matmul.allow_tf32`` must stay False, its default, for
the f32 einsums to be f32 on the card). Paged caches, ring caches and the
per-slot (ragged) forms come with the engine slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.gemm import EXACT, GemmPolicy, dot

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, kv_valid_len: int, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, chunk: int = 1024,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention: outer loop over Q chunks, inner online-softmax
    loop over KV chunks, so score tensors never exceed (B, H, q_chunk, chunk).

    q: (B, Sq, H, D); k/v: (B, Skv, KH, D) (the cache, possibly partly
    unwritten). q_positions: (Sq,) global positions of the queries.
    kv_valid_len: entries at kv index >= kv_valid_len are masked. `window`
    > 0 limits each query to the last `window` positions.
    """
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qh = (q * d ** -0.5).reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3).to(torch.float32)             # (B, KH, Skv, D)
    vt = v.permute(0, 2, 1, 3).to(torch.float32)
    window_eff = window if window > 0 else torch.iinfo(torch.int32).max
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_blk = qh[:, :, :, q0:q0 + q_chunk].to(torch.float32)  # (B,KH,G,qc,D)
        qp = q_positions[q0:q0 + q_chunk]
        qc = q_blk.shape[3]
        acc = torch.zeros((b, kh, g, qc, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, kh, g, qc), BIG_NEG, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, chunk):
            k_blk = kt[:, :, k0:k0 + chunk]
            v_blk = vt[:, :, k0:k0 + chunk]
            kpos = torch.arange(k0, k0 + k_blk.shape[2], device=q.device)
            s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk)
            s = _softcap(s, softcap)
            valid = (kpos < kv_valid_len)[None, :]
            if causal:
                delta = qp[:, None] - kpos[None, :]              # (qc, C)
                valid = valid & (delta >= 0) & (delta < window_eff)
            s = torch.where(valid, s, BIG_NEG)
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
                    q_positions, kv_cache=None, cache_pos: int = 0,
                    causal=True, window=0, softcap=0.0, chunk=1024,
                    policy: GemmPolicy = EXACT, layer: str = ""):
    """GQA attention. Returns (out, kv_cache).

    kv_cache=(k, v): contiguous (B, S, KH, D) cache tensors. The new K/V are
    written **in place** at ``cache_pos`` (a Python int: lockstep, the whole
    batch at one position) and attention runs over the first
    ``cache_pos + Sq`` entries. Without a cache, attention runs over the
    block's own K/V.
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
    if kv_cache is not None:
        ck, cv = kv_cache
        ck[:, cache_pos:cache_pos + sq] = k
        cv[:, cache_pos:cache_pos + sq] = v
        k_all, v_all, valid = ck, cv, cache_pos + sq
    else:
        k_all, v_all, valid = k, v, sq
    out = chunked_attention(q, k_all, v_all, q_positions, valid, causal=causal,
                            window=window, softcap=softcap, chunk=chunk)
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
