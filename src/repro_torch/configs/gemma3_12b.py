"""gemma3-12b — dense GQA, 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab_size=262144, head_dim=256, rope_theta=1e6,
    window_size=1024, global_every=6,   # 5 local : 1 global
    tie_embeddings=True,
    # 5/6 of layers have O(W) caches; global layers hold a sharded 500k KV and
    # decode is O(S) per token -> runnable (DESIGN.md §4)
    shapes=lm_shapes(long_ok=True),
    source="hf:google/gemma-3-1b-pt",
)
