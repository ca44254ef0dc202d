"""Model API (port of ``repro/models/api.py``): one handle per architecture family.

Only the dense family is ported; ``get_model`` raises ``NotImplementedError``
for the others. The dry-run shape specs stay with the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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

    return Model(cfg,
                 lambda generator, device="cpu":
                 transformer.init_params(cfg, generator, device),
                 prefill, decode,
                 lambda b, s, **kw: transformer.init_cache(cfg, b, s, **kw))
