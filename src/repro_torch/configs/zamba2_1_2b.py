"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_state=64, ssm_conv=4, ssm_expand=2,
    attn_every=6,   # one shared attention block per 6 mamba blocks
    shapes=lm_shapes(long_ok=True, long_reason=""),  # SSM state: runnable
    source="arXiv:2411.15242",
)
