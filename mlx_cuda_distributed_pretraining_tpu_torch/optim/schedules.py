"""LR schedules as closed-form functions of the step, in fp32.

The JAX package evaluates its schedules inside the jitted update on an
int32 step, so every intermediate is fp32 (Python constants are weakly
typed). These do the same arithmetic on fp32 CPU scalars, in the same
order, so the learning rate the optimizer applies is the JAX value, not a
float64 one an ulp away. :func:`schedule_value` returns it as a Python float
(exactly the fp32 value).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

Schedule = Callable[[int], torch.Tensor]  # step -> fp32 0-dim tensor


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(value: float) -> Schedule:
    return lambda step: _f32(value)


def _frac(step, steps: int) -> torch.Tensor:
    return torch.clamp(_f32(step) / _f32(max(steps, 1)), 0.0, 1.0)


def linear_schedule(init_value: float, end_value: float, steps: int) -> Schedule:
    def fn(step):
        return _f32(init_value) + _f32(end_value - init_value) * _frac(step, steps)

    return fn


def cosine_decay(init_value: float, decay_steps: int, end_value: float = 0.0) -> Schedule:
    def fn(step):
        cos = _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * _frac(step, decay_steps)))
        return _f32(end_value) + _f32(init_value - end_value) * cos

    return fn


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def fn(step):
        out = schedules[0](step)
        for i, b in enumerate(boundaries):
            if step >= b:
                out = schedules[i + 1](step - b)
        return out

    return fn


def warmup_cosine(peak: float, total_steps: int, warmup_steps: int,
                  end_value: float = 0.0) -> Schedule:
    return join_schedules(
        [linear_schedule(0.0, peak, max(warmup_steps, 1)),
         cosine_decay(peak, max(total_steps - warmup_steps, 1), end_value)],
        [warmup_steps])


def schedule_value(schedule: Schedule, step: int) -> float:
    return float(schedule(step))


def build_schedule(training_cfg: Any, total_steps: int) -> Schedule:
    """From the config's ``training.scheduler`` section (cosine_with_warmup,
    cosine, linear, else constant)."""
    lr = training_cfg.learning_rate
    sched = dict(getattr(training_cfg, "scheduler", None) or {})
    kind = str(sched.get("type", "constant")).lower()
    min_lr = lr * float(sched.get("min_lr_ratio", 0.0))
    warmup = int(sched.get("warmup_steps", 0))
    if kind == "cosine_with_warmup":
        return warmup_cosine(lr, total_steps, warmup, min_lr)
    if kind == "cosine":
        return cosine_decay(lr, total_steps, min_lr)
    if kind == "linear":
        return linear_schedule(lr, min_lr, total_steps)
    return constant(lr)
