"""jamba-v0.1-52b — 32L hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 [arXiv:2403.19887; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_period=2, block_type="jamba", attn_period=8,
    ssm_state=16, ssm_expand=2, ssm_conv=4, mlp_type="swiglu",
)
