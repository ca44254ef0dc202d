"""smollm-360m — llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49152, head_dim=64, tie_embeddings=True,
    shapes=lm_shapes(long_ok=False),
    source="hf:HuggingFaceTB/SmolLM-135M",
)
