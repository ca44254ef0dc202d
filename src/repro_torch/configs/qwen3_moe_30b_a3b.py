"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151936, head_dim=128, rope_theta=1e6,
    n_experts=128, n_active_experts=8, moe_d_ff=768,
    shapes=lm_shapes(long_ok=False),
    source="hf:Qwen/Qwen3-30B-A3B",
)
