"""Model configurations: shape-only dataclasses, copied from the
reference's ``configs`` (no weights, no framework).  ``meshes`` waits with
the dry-run tools (ROADMAP.md queue A item 7)."""

from .base import ModelConfig, ShapeConfig
from .registry import ARCH_IDS, all_configs, get_config
from .shapes import SHAPES, applicable, cells
