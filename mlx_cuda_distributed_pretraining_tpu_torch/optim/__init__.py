"""Optimizers: every update rule of the JAX package's factory (the fused
AdamW, the chained AdamW / Adam / SGD / Lion with their EMA variants,
Muon, Shampoo, Adafactor, hybrid partitions) and the LR schedules."""

from .adafactor import adafactor
from .base import (
    FusedTransform,
    Transform,
    default_wd_mask,
    global_norm,
    is_vector_like_path,
    partition,
)
from .factory import build_optimizer, build_transform
from .fused import fused_adamw
from .schedules import (
    build_schedule,
    cosine_decay,
    join_schedules,
    linear_schedule,
    schedule_value,
    warmup_cosine,
)

__all__ = [
    "FusedTransform", "Transform", "adafactor", "build_optimizer", "build_schedule",
    "build_transform", "cosine_decay", "default_wd_mask", "fused_adamw", "global_norm",
    "is_vector_like_path", "join_schedules", "linear_schedule", "partition",
    "schedule_value", "warmup_cosine",
]
