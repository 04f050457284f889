"""gemma3-27b — 62L dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144,
    sliding_window=1024, local_global_period=6,   # 5 local + 1 global
    mlp_type="geglu", rope_theta=1e6,
)
