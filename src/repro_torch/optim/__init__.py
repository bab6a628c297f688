"""Optimizers and LR schedules of the training path (the JAX package's
``repro.optim``), functional, on trees of tensors."""
from .adafactor import AdafactorState, adafactor_init, adafactor_update
from .adamw import AdamWState, adamw_init, adamw_update, global_norm_sq
from .schedule import warmup_cosine

__all__ = ["AdafactorState", "AdamWState", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update",
           "global_norm_sq", "warmup_cosine"]
