"""Model stack of the port: config, layers, blocks and the decoder LM."""
from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     TRAIN_4K, ModelConfig, ShapeConfig, smoke)
from .lm import (LM, cache_specs, init_cache, init_model, layer_cache,
                 layer_is_moe, model_specs)

__all__ = ["LM", "ModelConfig", "ShapeConfig", "smoke", "ALL_SHAPES",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "cache_specs", "init_cache", "init_model", "layer_cache",
           "layer_is_moe", "model_specs"]
