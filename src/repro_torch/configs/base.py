"""Config system: architecture + input-shape cells (--arch / --shape selectable)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int
    skip: bool = False     # per-arch skip (encoder-only decode, quadratic 500k)
    skip_reason: str = ""


def lm_shapes(*, decode_ok: bool = True, long_ok: bool = False,
              long_reason: str = "full attention is quadratic at 500k",
              decode_reason: str = "encoder-only arch has no decode step"):
    return (
        ShapeSpec("train_4k", "train", 4096, 256),
        ShapeSpec("prefill_32k", "prefill", 32768, 32),
        ShapeSpec("decode_32k", "decode", 32768, 128,
                  skip=not decode_ok, skip_reason=decode_reason),
        ShapeSpec("long_500k", "decode", 524288, 1,
                  skip=(not decode_ok) or (not long_ok),
                  skip_reason=decode_reason if not decode_ok else long_reason),
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    causal: bool = True             # False for encoder-only
    # sliding-window pattern: every `global_every`-th layer is global; others use
    # `window_size` (0 = all layers full attention)
    window_size: int = 0
    global_every: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    n_active_experts: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0             # zamba2: one shared attn block per N mamba blocks
    slstm_every: int = 0            # xlstm: every N-th block is sLSTM
    # modality frontend stub (audio/vlm): inputs are precomputed embeddings
    embed_inputs: bool = False
    prefix_len_frac: float = 0.0    # vlm: fraction of seq that is patch embeddings
    tie_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    shapes: Tuple[ShapeSpec, ...] = ()
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}")

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm",):
            per = _xlstm_block_params(self)
            blocks = self.n_layers * per
        elif self.family == "hybrid":
            blocks = _zamba_params(self)
        else:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            if self.is_moe:
                ffn = self.n_experts * 3 * d * self.moe_d_ff \
                    + self.n_shared_experts * 3 * d * self.moe_d_ff \
                    + d * self.n_experts
            else:
                ffn = 3 * d * self.d_ff
            blocks = self.n_layers * (attn + ffn + 2 * d)
        return emb + blocks + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.n_active_experts) \
            * 3 * d * self.moe_d_ff
        return total - inactive


def _xlstm_block_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    # mLSTM: up/gate/down projections + qkv + gates
    return 2 * d * di + di * d + 3 * di * di // 4 + 3 * di


def _zamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n_attn = cfg.n_layers // max(1, cfg.attn_every)
    mamba = cfg.n_layers * (2 * d * di + di * d + di * (2 * cfg.ssm_state) + di)
    attn = 4 * d * d + 3 * d * cfg.d_ff  # one shared block, counted once
    return mamba + attn + n_attn * 2 * d
