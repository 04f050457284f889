"""mellum2-12b-a2.5b — 28L sparse MoE (64 experts of width 896, top-8, no
shared expert), GQA 32/4 heads of 128, 3:1 sliding-window (1,024) / full
attention, YaRN on the full layers
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct config.json].  No counterpart in
the JAX package.  fp32: the configuration the port's benchmark states
(the published weights are bf16)."""
from .base import PortConfig

CONFIG = PortConfig(
    name="mellum2-12b-a2.5b", family="moe", n_layers=28, d_model=2304,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=896, vocab=98304,
    n_experts=64, top_k=8, moe_impl="ragged", mlp_type="swiglu",
    sliding_window=1024, local_global_period=4,   # 3 window + 1 full
    rope_theta=5e5,
    # rope_parameters.full_attention: factor, original context, beta_fast,
    # beta_slow, attention_factor
    yarn=(16.0, 8192, 32.0, 1.0, 1.2772588722239782),
    block_type="transformer", dtype="float32",
)
