"""The train step: gradients, accumulation, the fused optimizer update.

The JAX package compiles this into one donated-buffer XLA program; here it
runs eagerly on one device. Params stay fp32 masters (the forward casts
them to the compute dtype); ``accum_steps`` micro-batches sum their
gradients into ``.grad`` and are scaled by ``1/A`` before the update, as
the JAX scan does; the metrics carry a ``nonfinite`` flag. Metric values
stay device tensors, so the loop does not wait on the device until it logs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..utils.tree import leaves_with_path, tree_map
from ..optim.base import global_norm
from ..optim.fused import FusedTransform

TrainState = Dict[str, Any]  # {"params", "opt_state", "step"}


def init_train_state(params: Any, optimizer: FusedTransform) -> TrainState:
    for _, p in leaves_with_path(params):
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


def make_train_step(loss_fn: Callable, optimizer: FusedTransform,
                    accum_steps: int = 1, log_grad_norm: bool = False
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step_fn(state, batch) -> (state, metrics)``; ``loss_fn(params,
    batch) -> (loss, token_count)``. The state is updated in place."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        leaves = [p for _, p in leaves_with_path(params)]
        for p in leaves:
            p.grad = None
        if accum_steps > 1:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])
                     for k, v in batch.items()}
            loss, toks = 0.0, 0.0
            for i in range(accum_steps):
                l_i, t_i = loss_fn(params, {k: v[i] for k, v in micro.items()})
                l_i.backward()
                loss, toks = loss + l_i.detach(), toks + t_i
            inv = 1.0 / accum_steps
            loss = loss * inv
            with torch.no_grad():
                for p in leaves:
                    p.grad.mul_(inv)
        else:
            loss, toks = loss_fn(params, batch)
            loss.backward()
            loss = loss.detach()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = optimizer.fused_apply(grads, state["opt_state"], params)
        metrics = {"loss": loss, "toks": toks,
                   "nonfinite": (~torch.isfinite(loss)).to(torch.int32)}
        if log_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        for p in leaves:
            p.grad = None
        state.update(params=params, opt_state=opt_state, step=state["step"] + 1)
        return state, metrics

    return train_step


def make_eval_step(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, token_count)`` without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)

    return eval_step
