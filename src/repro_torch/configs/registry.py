"""Architecture registry: --arch <id> resolution."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = [
    "grok-1-314b", "olmoe-1b-7b", "gemma3-27b", "yi-34b", "minitron-4b",
    "starcoder2-7b", "jamba-v0.1-52b", "xlstm-1.3b", "llava-next-34b",
    "musicgen-large",
]

#: configurations of the port alone: the JAX package has none of them, so
#: the tests that hold the port to it run over ARCH_IDS
PORT_IDS = ["mellum2-12b-a2.5b"]

_MODULES = {
    "grok-1-314b": "grok_1_314b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma3-27b": "gemma3_27b",
    "yi-34b": "yi_34b",
    "minitron-4b": "minitron_4b",
    "starcoder2-7b": "starcoder2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llava-next-34b": "llava_next_34b",
    "musicgen-large": "musicgen_large",
    "mellum2-12b-a2.5b": "mellum2_12b_a2_5b",
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
