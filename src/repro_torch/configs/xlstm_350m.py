"""xlstm-350m — sLSTM + mLSTM blocks (linear-time recurrent) [arXiv:2405.04517]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, ssm_expand=2, slstm_every=6,  # every 6th block sLSTM
    shapes=lm_shapes(long_ok=True, long_reason=""),  # linear-time: runnable
    source="arXiv:2405.04517",
)
