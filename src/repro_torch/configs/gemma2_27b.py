"""gemma2-27b — local+global alternating attention with logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab_size=256000, head_dim=128,
    window_size=4096, global_every=2,   # alternating local / global
    attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    # half the layers are full-attention global -> 500k decode cache dominated by
    # them; treated as full-attention for the long_500k skip rule
    shapes=lm_shapes(long_ok=False,
                     long_reason="23/46 layers are global full attention"),
    source="arXiv:2408.00118",
)
