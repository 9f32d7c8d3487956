"""Optimizers: the fused AdamW and the LR schedules."""

from .base import default_wd_mask, global_norm, is_vector_like_path
from .factory import build_optimizer
from .fused import FusedTransform, fused_adamw
from .schedules import (
    build_schedule,
    cosine_decay,
    join_schedules,
    linear_schedule,
    schedule_value,
    warmup_cosine,
)

__all__ = [
    "FusedTransform", "build_optimizer", "build_schedule", "cosine_decay",
    "default_wd_mask", "fused_adamw", "global_norm", "is_vector_like_path",
    "join_schedules", "linear_schedule", "schedule_value", "warmup_cosine",
]
