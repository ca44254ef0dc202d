"""pixtral-12b — pixtral-ViT (stubbed frontend) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=131072, head_dim=128, rope_theta=1e6,
    prefix_len_frac=0.25,   # leading quarter of the sequence is patch embeddings
    shapes=lm_shapes(long_ok=False),
    source="hf:mistralai/Pixtral-12B-2409",
)
