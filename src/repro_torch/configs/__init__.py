"""Model configurations: shape-only dataclasses, copied from the
reference's ``configs`` (no weights, no framework), and the named
production mesh shapes the layout planner costs."""

from .base import ModelConfig, ShapeConfig
from .meshes import MESH_SHAPES, mesh_devices
from .registry import ARCH_IDS, all_configs, get_config
from .shapes import SHAPES, applicable, cells
