"""Optimizer factory: config name -> update rule, every branch of the JAX
package's ``optim/factory.py``.

:func:`build_transform` returns the chain (a :class:`base.Transform`) a
name builds; :func:`build_optimizer` returns what the train step runs (a
:class:`base.FusedTransform`): the one-pass fused AdamW for ``adamw`` /
``adam`` unless ``optimization.fused: false`` or an EMA asks for the chain,
else the chain applied in place (``base.in_place``). ``hybrid`` partitions
two chains built by name, each clipped by the norm of its own leaves, as
the JAX ``partition`` of two ``Transform`` s does.
"""

from __future__ import annotations

from typing import Any, Optional

from .adafactor import adafactor
from .base import FusedTransform, Transform, in_place, partition
from .enhanced import adam, adamw, lion, sgd
from .fused import fused_adamw
from .muon import embedding_rest_label_fn, matrix_label_fn, muon
from .schedules import Schedule, build_schedule
from .shampoo import shampoo


def _opt(training_cfg: Any, key: str, default=None):
    return (getattr(training_cfg, "optimization", None) or {}).get(key, default)


def _fused_adam(training_cfg: Any, name: str, schedule: Schedule) -> Optional[FusedTransform]:
    """The fused AdamW where the JAX factory returns ``fused_adamw`` (its
    ``update`` is the same chain :func:`build_transform` builds)."""
    betas = _opt(training_cfg, "betas", [0.9, 0.999])
    kw = dict(b1=float(betas[0]), b2=float(betas[1]), eps=float(_opt(training_cfg, "eps", 1e-8)),
              grad_clip=training_cfg.gradient_clip)
    if not bool(_opt(training_cfg, "fused", True)):
        return None
    if name == "adamw":
        return fused_adamw(schedule, weight_decay=float(training_cfg.weight_decay),
                           amsgrad=bool(_opt(training_cfg, "amsgrad", False)), **kw)
    if name == "adam":
        return fused_adamw(schedule, weight_decay=0.0, **kw)
    return None


def build_transform(training_cfg: Any, total_steps: int, name: Optional[str] = None,
                    schedule: Optional[Schedule] = None) -> Transform:
    """The chain of optimizer ``name`` (default ``training.optimizer_name``)."""
    name = (name or training_cfg.optimizer_name).lower()
    schedule = schedule or build_schedule(training_cfg, total_steps)
    wd = float(training_cfg.weight_decay)
    clip = training_cfg.gradient_clip
    betas = _opt(training_cfg, "betas", [0.9, 0.999])
    eps = float(_opt(training_cfg, "eps", 1e-8))
    ema_decay = _opt(training_cfg, "ema_decay")

    if name in ("adamw", "adamw_enhanced"):
        return adamw(schedule, b1=float(betas[0]), b2=float(betas[1]), eps=eps,
                     weight_decay=wd, grad_clip=clip,
                     amsgrad=bool(_opt(training_cfg, "amsgrad", False)),
                     ema_decay=ema_decay if name == "adamw_enhanced" else None)
    if name == "adam":
        return adam(schedule, b1=float(betas[0]), b2=float(betas[1]), eps=eps, grad_clip=clip)
    if name in ("sgd", "sgd_enhanced"):
        return sgd(schedule, momentum=float(_opt(training_cfg, "momentum", 0.9)),
                   nesterov=bool(_opt(training_cfg, "nesterov", name == "sgd_enhanced")),
                   weight_decay=wd, grad_clip=clip,
                   ema_decay=ema_decay if name == "sgd_enhanced" else None)
    if name in ("lion", "lion_enhanced"):
        lb = _opt(training_cfg, "betas", [0.9, 0.99])
        return lion(schedule, b1=float(lb[0]), b2=float(lb[1]), weight_decay=wd,
                    grad_clip=clip, ema_decay=ema_decay if name == "lion_enhanced" else None)
    if name == "muon":
        return muon(schedule, momentum=float(_opt(training_cfg, "momentum", 0.95)),
                    nesterov=bool(_opt(training_cfg, "nesterov", True)),
                    ns_steps=int(_opt(training_cfg, "ns_steps", 5)),
                    weight_decay=wd, grad_clip=clip,
                    adamw_lr_ratio=float(_opt(training_cfg, "adamw_lr_ratio", 1.0)))
    if name == "shampoo":
        return shampoo(
            schedule, beta2=float(_opt(training_cfg, "beta2", 0.99)),
            update_period=int(_opt(training_cfg, "update_period", 10)),
            start_step=int(_opt(training_cfg, "start_preconditioning_step", 10)),
            max_preconditioner_dim=int(_opt(training_cfg, "max_preconditioner_dim", 1024)),
            momentum=float(_opt(training_cfg, "momentum", 0.9)),
            graft_type=str(_opt(training_cfg, "graft_type", "adam")),
            weight_decay=wd, grad_clip=clip)
    if name == "adafactor":
        momentum = _opt(training_cfg, "momentum")
        return adafactor(
            schedule, weight_decay=wd,
            decay_rate=float(_opt(training_cfg, "decay_rate", 0.8)),
            clipping_threshold=_opt(training_cfg, "clipping_threshold", 1.0),
            momentum=float(momentum) if momentum else None,
            multiply_by_parameter_scale=bool(
                _opt(training_cfg, "multiply_by_parameter_scale", True)),
            grad_clip=clip)
    if name == "hybrid":
        matrix_name = str(_opt(training_cfg, "matrix_optimizer", "muon"))
        rest_name = str(_opt(training_cfg, "non_matrix_optimizer", "adamw"))
        emb_to = str(_opt(training_cfg, "hybrid_embeddings", "matrix"))
        if emb_to not in ("matrix", "rest"):
            raise ValueError(
                f"hybrid_embeddings must be 'matrix' or 'rest', got {emb_to!r}")
        label_fn = embedding_rest_label_fn if emb_to == "rest" else matrix_label_fn
        return partition(label_fn, {
            "matrix": build_transform(training_cfg, total_steps, matrix_name, schedule),
            "rest": build_transform(training_cfg, total_steps, rest_name, schedule),
        })
    raise ValueError(f"unknown optimizer {name!r}")


def build_optimizer(training_cfg: Any, total_steps: int, name: Optional[str] = None,
                    schedule: Optional[Schedule] = None) -> FusedTransform:
    """What the train step runs for optimizer ``name``: the fused AdamW
    for ``adamw`` / ``adam`` (unless ``optimization.fused: false``), every
    other chain through ``base.in_place``."""
    name = (name or training_cfg.optimizer_name).lower()
    schedule = schedule or build_schedule(training_cfg, total_steps)
    return (_fused_adam(training_cfg, name, schedule)
            or in_place(build_transform(training_cfg, total_steps, name, schedule)))
