"""xlstm-1.3b — 48L sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    block_type="xlstm", ssm_expand=2,
)
