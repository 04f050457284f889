from . import adamw
from .adamw import OptConfig
