from .lm import LM, LayerSpec, build_pattern, lm_loss
