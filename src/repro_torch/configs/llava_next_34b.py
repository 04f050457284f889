"""llava-next-34b — yi-34b backbone + anyres vision frontend STUB
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

The assignment specifies the transformer backbone only; ``input_specs``
provides precomputed patch embeddings (B, n_patches, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    mlp_type="swiglu", frontend="vision", rope_theta=5e6,
)
