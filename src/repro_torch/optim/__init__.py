"""Optimizer of the port: AdamW, the LR schedules and int8 gradient
compression."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, wsd_schedule
from .compress import (CompressionConfig, compress_gradients,
                       decompress_gradients, error_feedback_update)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "wsd_schedule", "cosine_schedule", "CompressionConfig",
           "compress_gradients", "decompress_gradients",
           "error_feedback_update"]
