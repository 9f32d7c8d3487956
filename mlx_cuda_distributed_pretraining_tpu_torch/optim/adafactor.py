"""Adafactor (Shazeer & Stern 2018): the JAX package's ``optim/adafactor.py``
on tensor trees.

The chain, in the optax order: [global-norm clip] -> factored RMS ->
update-RMS clip -> x lr -> [x param RMS] -> [momentum EMA] -> [+ wd *
param, under the house mask of ``base.default_wd_mask``] -> x(-1). The
state is fp32 and matches the JAX state leaf for leaf under the same
flattened names: the factored RMS keeps ``count``, ``v_row``, ``v_col`` and
``v``, with ``(1,)`` zero placeholders where a leaf is not factored (a
matrix whose second-largest dim is under ``min_dim_size_to_factor``
keeps a full ``v``; a factored one keeps a row and a column vector), so an
optimizer file from either package loads in the other. The second-moment
decay is ``1 - t^-0.8``: the first step uses the raw squared gradient.

:func:`adafactor` returns the chain as a :class:`base.Transform`; the
factory wraps it with :func:`base.in_place` for the train step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.tree import tree_map
from .base import (
    Transform,
    add_decayed_weights,
    chain,
    count_tensor,
    f32,
    identity,
    maybe_clip,
    scale,
    scale_by_schedule,
)
from .schedules import Schedule


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest axes ``(second, largest)`` to reduce over, or None
    (no factoring) when the second-largest dim is under the threshold
    (the JAX function, on the same ``np.argsort``)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _without(shape, axis: int) -> tuple:
    return tuple(int(d) for i, d in enumerate(shape) if i != axis)


def scale_by_factored_rms(decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                          eps: float = 1e-30) -> Transform:
    """Scale by a factored estimate of the gradient RMS: a leaf with two
    dims >= ``min_dim_size_to_factor`` keeps a row and a column second
    moment (O(n+m) memory); any other leaf a full one."""

    def init(params):
        def zeros(shape, like):
            return torch.zeros(shape, dtype=torch.float32, device=like.device)

        def slots(p):
            f = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if f is None:
                return zeros((1,), p), zeros((1,), p), zeros(tuple(p.shape), p)
            d1, d0 = f
            return zeros(_without(p.shape, d0), p), zeros(_without(p.shape, d1), p), \
                zeros((1,), p)

        leaves = tree_map(slots, params)
        pick = lambda i: tree_map(lambda p, s: s[i], params, leaves)
        return {"count": count_tensor(0), "v_row": pick(0), "v_col": pick(1),
                "v": pick(2)}

    def update(grads, state, params):
        count = state["count"]
        # decay_rate_t = 1 - t^-0.8, in fp32 as the JAX update computes it
        t = count.float() + 1.0
        decay_cpu = 1.0 - t ** (-decay_rate)

        def upd(g, v_row, v_col, v):
            g = g.float()
            decay = decay_cpu.to(g.device)
            keep = 1.0 - decay
            f = _factored_dims(tuple(g.shape), min_dim_size_to_factor)
            grad_sqr = torch.square(g) + eps
            if f is None:
                new_v = decay * v + keep * grad_sqr
                return g * new_v ** -0.5, v_row, v_col, new_v
            d1, d0 = f
            new_v_row = decay * v_row + keep * grad_sqr.mean(dim=d0)
            new_v_col = decay * v_col + keep * grad_sqr.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = new_v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (new_v_row / row_col_mean) ** -0.5
            col_factor = new_v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            return u, new_v_row, new_v_col, v

        out = tree_map(upd, grads, state["v_row"], state["v_col"], state["v"])
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)
        return pick(0), {"count": count + 1, "v_row": pick(1), "v_col": pick(2),
                         "v": pick(3)}

    return Transform(init, update)


def clip_update_rms(threshold: float) -> Transform:
    """Per-leaf update-RMS clip: each leaf divided by ``max(1, rms /
    threshold)`` (Adafactor's update clipping, d = 1)."""

    def update(updates, state, params):
        def clip(u):
            rms = torch.sqrt(torch.mean(torch.square(u)))
            return u / torch.clamp(torch.div(rms, f32(threshold, rms)), min=1.0)

        return tree_map(clip, updates), state

    return Transform(lambda p: {}, update)


def scale_by_param_rms(min_scale: float = 1e-3) -> Transform:
    """Relative step sizes: each leaf's update times ``max(rms(param),
    min_scale)``."""

    def update(updates, state, params):
        def times_rms(u, p):
            rms = torch.sqrt(torch.mean(torch.square(p.float())))
            return u * torch.clamp(rms, min=min_scale)

        return tree_map(times_rms, updates, params), state

    return Transform(lambda p: {}, update)


def ema_of_updates(decay: float) -> Transform:
    """Momentum as an un-debiased EMA of the updates, after the LR."""

    def init(params):
        return {"ema": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(updates, state, params):
        ema = tree_map(lambda e, u: decay * e + (1.0 - decay) * u, state["ema"], updates)
        return ema, {"ema": ema}

    return Transform(init, update)


def adafactor(
    schedule: Schedule,
    weight_decay: float = 0.0,
    decay_rate: float = 0.8,
    clipping_threshold: Optional[float] = 1.0,
    momentum: Optional[float] = None,
    multiply_by_parameter_scale: bool = True,
    min_dim_size_to_factor: int = 128,
    eps: float = 1e-30,
    grad_clip: Optional[float] = None,
) -> Transform:
    """The full chain, in the JAX (and optax) order."""
    return chain(
        maybe_clip(grad_clip),
        scale_by_factored_rms(decay_rate, min_dim_size_to_factor, eps),
        clip_update_rms(clipping_threshold) if clipping_threshold else identity(),
        scale_by_schedule(schedule, flip_sign=False),
        scale_by_param_rms() if multiply_by_parameter_scale else identity(),
        ema_of_updates(momentum) if momentum else identity(),
        add_decayed_weights(weight_decay) if weight_decay else identity(),
        scale(-1.0),
    )
