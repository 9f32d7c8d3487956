"""Optimizer factory: config name -> update rule (``adamw``, ``adam`` and
``adafactor``)."""

from __future__ import annotations

from typing import Any, Optional

from .adafactor import adafactor
from .base import FusedTransform, in_place
from .fused import fused_adamw
from .schedules import Schedule, build_schedule

_NOT_PORTED = ("optimizer {!r} is not ported (ROADMAP queue 1 item 4: the other "
               "optimizers — sgd, lion, muon, shampoo, enhanced, hybrid)")


def _opt(training_cfg: Any, key: str, default=None):
    return (getattr(training_cfg, "optimization", None) or {}).get(key, default)


def build_optimizer(training_cfg: Any, total_steps: int,
                    name: Optional[str] = None,
                    schedule: Optional[Schedule] = None) -> FusedTransform:
    """The JAX factory's ``adamw`` / ``adam`` branches (both run the fused
    AdamW; ``adam`` without weight decay) and its ``adafactor`` branch (the
    chain of ``optim/adafactor.py``, applied in place). Any other name
    raises."""
    name = (name or training_cfg.optimizer_name).lower()
    schedule = schedule or build_schedule(training_cfg, total_steps)
    clip = training_cfg.gradient_clip
    betas = _opt(training_cfg, "betas", [0.9, 0.999])
    eps = float(_opt(training_cfg, "eps", 1e-8))
    if name == "adamw":
        return fused_adamw(schedule, b1=float(betas[0]), b2=float(betas[1]),
                           eps=eps, weight_decay=float(training_cfg.weight_decay),
                           grad_clip=clip,
                           amsgrad=bool(_opt(training_cfg, "amsgrad", False)))
    if name == "adam":
        return fused_adamw(schedule, b1=float(betas[0]), b2=float(betas[1]),
                           eps=eps, weight_decay=0.0, grad_clip=clip)
    if name == "adafactor":
        momentum = _opt(training_cfg, "momentum")
        return in_place(adafactor(
            schedule, weight_decay=float(training_cfg.weight_decay),
            decay_rate=float(_opt(training_cfg, "decay_rate", 0.8)),
            clipping_threshold=_opt(training_cfg, "clipping_threshold", 1.0),
            momentum=float(momentum) if momentum else None,
            multiply_by_parameter_scale=bool(
                _opt(training_cfg, "multiply_by_parameter_scale", True)),
            grad_clip=clip))
    raise NotImplementedError(_NOT_PORTED.format(name))
