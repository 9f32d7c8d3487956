"""AdamW / Adam / SGD / Lion as chained transforms: the JAX package's
``optim/enhanced.py``.

Each is ``[global-norm clip] -> core -> decoupled weight decay (the house
mask of ``base.default_wd_mask``) -> x(-lr)``, optionally wrapped in the
fp32 EMA shadow of ``base.with_ema`` (the ``*_enhanced`` names). The states
are the JAX states leaf for leaf: fp32 moments, int32 0-dim CPU counts.
The factory wraps a chain with ``base.in_place`` for the train step.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import (
    Transform,
    add_decayed_weights,
    chain,
    count_tensor,
    default_wd_mask,
    maybe_clip,
    scale_by_schedule,
    tmap,
    trace_momentum,
    with_ema,
)
from .schedules import Schedule


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  amsgrad: bool = False) -> Transform:
    """Bias-corrected Adam direction ``(mu / bc1) / (sqrt(nu / bc2) + eps)``
    (``nu_max`` in the denominator with ``amsgrad``)."""

    def init(params):
        state = {"count": count_tensor(0), "mu": tmap(_zeros, params),
                 "nu": tmap(_zeros, params)}
        if amsgrad:
            state["nu_max"] = tmap(_zeros, params)
        return state

    def update(grads, state, params):
        count = state["count"] + 1
        mu = tmap(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
        nu = tmap(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state["nu"], grads)
        cf = count.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)
        new_state = {"count": count, "mu": mu, "nu": nu}
        denom_src = nu
        if amsgrad:
            denom_src = tmap(torch.maximum, state["nu_max"], nu)
            new_state["nu_max"] = denom_src

        def direction(m, v):
            c1, c2 = bc1.to(m.device), bc2.to(m.device)
            return torch.div(torch.div(m, c1), torch.sqrt(torch.div(v, c2)) + eps)

        return tmap(direction, mu, denom_src), new_state

    return Transform(init, update)


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> Transform:
    """Lion: ``sign(b1 * mu + (1 - b1) * g)``, then ``mu = b2 * mu + (1 -
    b2) * g``."""

    def init(params):
        return {"mu": tmap(_zeros, params)}

    def update(grads, state, params):
        updates = tmap(lambda m, g: torch.sign(b1 * m + (1 - b1) * g.float()),
                       state["mu"], grads)
        mu = tmap(lambda m, g: b2 * m + (1 - b2) * g.float(), state["mu"], grads)
        return updates, {"mu": mu}

    return Transform(init, update)


def _finish(core: Transform, schedule: Schedule, weight_decay: float,
            grad_clip: Optional[float], ema_decay: Optional[float]) -> Transform:
    t = chain(maybe_clip(grad_clip), core,
              add_decayed_weights(weight_decay, default_wd_mask),
              scale_by_schedule(schedule))
    return with_ema(t, ema_decay) if ema_decay else t


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: Optional[float] = None,
          amsgrad: bool = False, ema_decay: Optional[float] = None) -> Transform:
    return _finish(scale_by_adam(b1, b2, eps, amsgrad), schedule, weight_decay,
                   grad_clip, ema_decay)


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         grad_clip: Optional[float] = None) -> Transform:
    return _finish(scale_by_adam(b1, b2, eps), schedule, 0.0, grad_clip, None)


def sgd(schedule: Schedule, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0, grad_clip: Optional[float] = None,
        ema_decay: Optional[float] = None) -> Transform:
    core = (trace_momentum(momentum, nesterov) if momentum
            else Transform(lambda p: {}, lambda g, s, p: (g, s)))
    return _finish(core, schedule, weight_decay, grad_clip, ema_decay)


def lion(schedule: Schedule, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.0, grad_clip: Optional[float] = None,
         ema_decay: Optional[float] = None) -> Transform:
    return _finish(scale_by_lion(b1, b2), schedule, weight_decay, grad_clip, ema_decay)
