"""Decoder transformer LM, dense family (port of ``repro/models/transformer.py``).

The reference stacks the layers and runs one traced layer under ``lax.scan``;
PyTorch runs eagerly, so here the parameters hold a list of per-layer dicts and
``forward`` loops over it. The MoE, audio and VLM variants, the two-tier
windowed cache, the paged cache and ``chunk_step`` come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import EXACT, GemmPolicy, dot
from . import layers as L

PyTree = Any


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (only "
            "'dense'), see ROADMAP.md")


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer window sizes; 0 = global/full attention."""
    if cfg.window_size and cfg.global_every:
        return [0 if (i + 1) % cfg.global_every == 0 else cfg.window_size
                for i in range(cfg.n_layers)]
    return [cfg.window_size] * cfg.n_layers


def init_layer(generator: torch.Generator, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, dt,
                                 device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> PyTree:
    """Random parameters drawn from ``generator`` (on its own device) and
    placed on ``device``. ``layers`` is a list of per-layer dicts."""
    _check_ported(cfg)
    dt = _dtype(cfg)
    params = {
        "embed": L._normal(generator, (cfg.vocab_size, cfg.d_model),
                           cfg.d_model ** -0.5, dt, device),
        "layers": [init_layer(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(generator, (cfg.d_model, cfg.vocab_size),
                                      cfg.d_model ** -0.5, dt, device)
    return params


def _layer_body(lp, x, window, kv_cache, *, cfg: ModelConfig, positions,
                cache_pos: int, policy: GemmPolicy, chunk: int):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, _ = L.attention_block(
        lp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, q_positions=positions,
        kv_cache=kv_cache, cache_pos=cache_pos, causal=cfg.causal,
        window=window, softcap=cfg.attn_softcap, chunk=chunk, policy=policy,
        layer="attn")
    x = x + attn_out
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_block(lp["mlp"], h, act=cfg.act, policy=policy,
                           layer="mlp")


def forward(params: PyTree, cfg: ModelConfig, *, tokens: torch.Tensor,
            cache: Optional[Dict] = None, cache_pos: int = 0,
            policy: GemmPolicy = EXACT, attn_chunk: int = 1024):
    """Returns (hidden, cache). tokens: (B, S). With a cache, the new K/V are
    written **in place** at ``cache_pos`` (a Python int shared by the batch)
    and the same cache dict is returned."""
    _check_ported(cfg)
    x = params["embed"][tokens]                                  # (B, S, d)
    # the scale rounded to the activation dtype first, as in the reference;
    # a host-side scalar, so no device copy
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    s = x.shape[1]
    base = cache_pos if cache is not None else 0
    positions = torch.arange(base, base + s, device=x.device)
    for i, (lp, window) in enumerate(zip(params["layers"], layer_windows(cfg))):
        kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        x = _layer_body(lp, x, window, kv, cfg=cfg, positions=positions,
                        cache_pos=cache_pos, policy=policy, chunk=attn_chunk)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def logits_from_hidden(params, cfg: ModelConfig, hidden,
                       policy: GemmPolicy = EXACT):
    w = L.head_weight(params, hidden.dtype)
    logits = dot(hidden, w, policy, layer="lm_head")
    return L._softcap(logits.to(torch.float32), cfg.final_softcap)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    """Uniform (L, B, S, KH, hd) cache of a float dtype (the int8 KV payload
    comes with the engine slice)."""
    _check_ported(cfg)
    if not dtype.is_floating_point:
        raise NotImplementedError("the int8 KV-cache payload is not ported "
                                  "yet, see ROADMAP.md")
    if (cfg.window_size and cfg.global_every and max_len > cfg.window_size
            and cfg.n_layers % cfg.global_every == 0):
        raise NotImplementedError(
            f"{cfg.name}: the two-tier windowed (ring) cache is not ported "
            "yet, see ROADMAP.md")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params, cfg: ModelConfig, tokens, cache, *,
            policy: GemmPolicy = EXACT, attn_chunk: int = 1024):
    """Whole-prompt prefill from position 0: (B, 1, V) f32 logits of the last
    position, and the cache (written in place)."""
    hidden, cache = forward(params, cfg, tokens=tokens, cache=cache,
                            cache_pos=0, policy=policy, attn_chunk=attn_chunk)
    return logits_from_hidden(params, cfg, hidden[:, -1:], policy), cache


def decode_step(params, cfg: ModelConfig, token, cache, pos: int, *,
                policy: GemmPolicy = EXACT, attn_chunk: int = 1024):
    """One lockstep decode step. token: (B, 1); pos: the current length (a
    Python int, the whole batch at one position). Returns (B, 1, V) f32
    logits and the cache (written in place)."""
    hidden, cache = forward(params, cfg, tokens=token, cache=cache,
                            cache_pos=int(pos), policy=policy,
                            attn_chunk=attn_chunk)
    return logits_from_hidden(params, cfg, hidden, policy), cache
