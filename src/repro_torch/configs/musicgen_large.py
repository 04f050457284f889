"""musicgen-large — 48L decoder-only over EnCodec tokens (4 codebooks)
[arXiv:2306.05284; hf].  Audio frontend is a STUB: input_specs provides
the 4-stream token ids; embeddings are summed, output heads per stream."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
    mlp_type="gelu", norm_type="layernorm", frontend="audio",
    n_codebooks=4,
)
