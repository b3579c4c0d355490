"""Optimizer of the port: AdamW and the LR schedules.  The JAX package's
int8 gradient compression (``optim/compress.py``) waits for ROADMAP Queue 1
item 8."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "wsd_schedule", "cosine_schedule"]
