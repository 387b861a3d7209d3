"""Optimizers + LR schedules (port of ``repro.optim``)."""
from .adamw import adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "wsd_schedule"]
