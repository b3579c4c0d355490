"""Model stack of the port: config, layers, blocks and the decoder LM."""
from .config import ModelConfig, smoke
from .lm import (LM, cache_specs, init_cache, init_model, layer_cache,
                 layer_is_moe, model_specs)

__all__ = ["LM", "ModelConfig", "cache_specs", "init_cache", "init_model",
           "layer_cache", "layer_is_moe", "model_specs", "smoke"]
