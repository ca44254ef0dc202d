"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840, head_dim=128,
    n_experts=64, n_active_experts=6, moe_d_ff=1408, n_shared_experts=2,
    shapes=lm_shapes(long_ok=False),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
