"""Model API (port of ``repro/models/api.py``): one handle per architecture family.

Only the dense family is ported; ``get_model`` raises ``NotImplementedError``
for the others. The dry-run shape specs stay with the JAX package. The paged
cache's helpers for the engine (``reset_slot``, ``copy_pool_blocks``) work
in place on the cache's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gemm
from repro_torch.core.gemm import EXACT, GemmPolicy
from . import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    """Family-agnostic model handle.

    Step functions accept raw params or a ``gemm.BoundParams`` tree from
    ``bind_params``. Caches are updated in place.
    """
    cfg: ModelConfig
    init_params: Callable        # (generator, device) -> params
    prefill: Callable            # (params, batch, cache, policy) -> (logits, cache)
    decode_step: Callable        # (params, token, cache, pos, policy) -> (logits, cache)
    init_cache: Callable         # (batch, max_len, device=...) -> cache
    chunk_step: Callable         # (params, tokens, cache, pos, q_len, policy,
    #                               paged_kernel) -> (logits, cache)
    init_paged_cache: Callable   # (batch, max_len, n_blocks, block_size,
    #                               device=..., dtype=...) -> paged cache

    def bind_params(self, params, policy: GemmPolicy,
                    **kw) -> "gemm.BoundParams":
        """Prepare every policy-routed weight leaf once (see ``gemm.bind``)."""
        return gemm.bind(params, policy, **kw)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (only "
            "'dense'), see ROADMAP.md")

    def prefill(params, batch, cache, policy=EXACT):
        return transformer.prefill(params, cfg, batch["tokens"], cache,
                                   policy=policy)

    def decode(params, token, cache, pos, policy=EXACT):
        return transformer.decode_step(params, cfg, token, cache, pos,
                                       policy=policy)

    def chunk(params, tokens, cache, pos, q_len, policy=EXACT,
              paged_kernel=None):
        return transformer.chunk_step(params, cfg, tokens, cache, pos, q_len,
                                      policy=policy, paged_kernel=paged_kernel)

    def init_paged(b, s, n_blocks, block_size, **kw):
        return transformer.init_cache(cfg, b, s, paged=(n_blocks, block_size),
                                      **kw)

    return Model(cfg,
                 lambda generator, device="cpu":
                 transformer.init_params(cfg, generator, device),
                 prefill, decode,
                 lambda b, s, **kw: transformer.init_cache(cfg, b, s, **kw),
                 chunk, init_paged)


# Leaves that become shared block pools under a paged cache: they carry no
# batch axis. Everything else (ring buffers and recurrent state, in families
# of later slices) stays per-slot and is wiped by `reset_slot`.
PAGED_POOL_LEAVES = frozenset({"k", "v", "k_glob", "v_glob"})

# Batch axis of each per-slot cache leaf of the ported families (none yet:
# the dense paged cache is pools and tables only).
CACHE_BATCH_AXIS: Dict[str, int] = {}
# Per-slot fill values used when wiping a slot (default 0).
CACHE_SLOT_FILL: Dict[str, int] = {}


def reset_slot(cache, slot: int):
    """Wipe one slot's per-slot state leaves in place, so nothing of the
    slot's previous occupant survives. Pool leaves and ``block_tables`` are
    left alone: the host allocator owns the tables, and pool blocks are only
    read through them. Returns the cache."""
    for key, leaf in cache.items():
        if key == "block_tables" or key in PAGED_POOL_LEAVES:
            continue
        leaf.select(CACHE_BATCH_AXIS[key], slot).fill_(
            CACHE_SLOT_FILL.get(key, 0))
    return cache


def copy_pool_blocks(cache, src: torch.Tensor, dst: torch.Tensor):
    """Clone pool block rows ``src`` into ``dst`` (``(n,)`` integer block
    ids) on every paged pool leaf, in place: the copy-on-write half of
    prefix caching (``launch.paged.BlockPool.ensure`` retargets a writing
    slot's table at fresh blocks and queues these copies). Pool leaves put
    the block axis at 1, ``(L, n_blocks + 1, block_size, KH, hd)``; other
    leaves pass through. Returns the cache."""
    for key, leaf in cache.items():
        if key in PAGED_POOL_LEAVES:
            leaf[:, dst] = leaf[:, src]
    return cache
