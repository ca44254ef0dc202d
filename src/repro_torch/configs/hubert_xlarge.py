"""hubert-xlarge — encoder-only audio transformer (w2v2 arch) [arXiv:2106.07447]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, causal=False, embed_inputs=True, act="gelu",
    shapes=lm_shapes(decode_ok=False),   # encoder-only: no decode shapes
    source="arXiv:2106.07447",
)
