"""Optimizer of the port: AdamW over float32 master weights, the LR
schedules, and the gradient sync, norm and clip over the data axis (the
mirror of :mod:`repro.optim`)."""
from .adamw import AdamWConfig, OptState, adamw_init, adamw_update
from .grad_sync import clip_by_global_norm, global_norm, grad_sync
from .schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "linear_warmup", "grad_sync", "global_norm",
           "clip_by_global_norm"]
