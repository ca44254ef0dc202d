"""Serving step builders (port of the serving part of ``repro/launch/steps.py``).

The reference builds jit-compiled steps; PyTorch runs eagerly, so these are
plain functions closed over the model and policy. The train, prefill and
decode step builders and the sharding assembly come with the training slice;
``make_multi_step`` with multi-step decode (ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import EXACT, GemmPolicy
from repro_torch.models import api as model_api


def make_chunk_step(cfg: ModelConfig, policy: GemmPolicy = EXACT,
                    paged_kernel=None):
    """The unified serving step behind the paged engine: decode (T == 1,
    q_len == 1) and chunked prefill (T = chunk budget, per-slot q_len <= T,
    trailing padding masked) in one function, so a mixed prefill+decode
    batch is rows with different q_len.

    ``chunk_step(params, tokens, cache, pos, q_len)``: tokens (B, T), pos the
    per-slot (B,) write position of each row's first token, q_len (B,).
    Returns each slot's last-valid-token logits (B, 1, V) and the cache,
    updated in place. ``paged_kernel`` is the paged-attention kernel's split
    count (1 = sequential scan, > 1 = split-KV); falsy reads through the
    gather path."""
    model = model_api.get_model(cfg)

    def chunk_step(params, tokens, cache, pos, q_len):
        return model.chunk_step(params, tokens, cache, pos, q_len,
                                policy=policy, paged_kernel=paged_kernel)

    return chunk_step


def make_copy_blocks_step():
    """Pool-block clone for copy-on-write prefix sharing:
    ``(cache, src, dst) -> cache`` with pool rows ``dst`` overwritten by
    ``src`` on every paged pool leaf, in place
    (``models.api.copy_pool_blocks``). The engine runs it between the host
    allocator's COW decision (``paged.BlockPool.drain_copies``) and the next
    step, so a retargeted table row reads an exact clone of the block it
    shared. One call per step however many copies it queued (``src``/``dst``
    are ``(n,)`` integer tensors)."""

    def copy_blocks_step(cache, src, dst):
        return model_api.copy_pool_blocks(cache, src, dst)

    return copy_blocks_step
