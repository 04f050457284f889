"""Assigned input-shape suite (LM transformer shapes, seq_len × batch)."""

from __future__ import annotations

from .base import ModelConfig, ShapeConfig

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}

#: archs with a sub-quadratic path for 500k-token decode (SSM/hybrid/
#: windowed); pure full-attention archs skip long_500k (see DESIGN.md §6).
_LONG_OK_FAMILIES = {"ssm", "hybrid"}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.kind == "long_decode":
        if cfg.family in _LONG_OK_FAMILIES:
            return True
        # gemma3: 5:1 local:global — local layers are windowed (sub-quad)
        return cfg.local_global_period > 0
    return True


def cells(configs: dict[str, ModelConfig]):
    """All live (arch × shape) dry-run cells."""
    out = []
    for name, cfg in configs.items():
        for shape in SHAPES.values():
            if applicable(cfg, shape):
                out.append((name, shape.name))
    return out
