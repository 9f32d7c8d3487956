"""The train step: the model loss, gradients, accumulation, the fused
optimizer update.

The JAX package compiles this into one donated-buffer XLA program; here it
runs eagerly on one device. :func:`make_loss_fn` binds the model's loss
options (compute dtype, remat policy and ratio, fused-CE chunk, z-loss)
as the JAX trainer's closure does. Params stay fp32 masters (the forward casts
them to the compute dtype); ``accum_steps`` micro-batches sum their
gradients into ``.grad`` and are scaled by ``1/A`` before the update, as
the JAX scan does; the metrics carry a ``nonfinite`` flag. Metric values
stay device tensors, so the loop does not wait on the device until it logs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import llama
from ..optim.base import FusedTransform, global_norm
from ..utils.tree import leaves_with_path, tree_map

TrainState = Dict[str, Any]  # {"params", "opt_state", "step"}


def make_loss_fn(args: "llama.LlamaArgs", compute_dtype: torch.dtype,
                 remat: Optional[str] = None, remat_ratio: float = 1.0,
                 ce_chunk: int = -1, scan_layers: bool = False,
                 z_loss_weight: float = 0.0, overlap: bool = False,
                 include_aux: bool = True, with_moe_stats: bool = False) -> Callable:
    """``loss_fn(params, batch) -> (loss, token_count)`` over
    ``models/llama.py::loss_fn`` with these options bound."""

    def loss_fn(params, batch):
        return llama.loss_fn(params, batch, args, compute_dtype=compute_dtype,
                             remat=remat, remat_ratio=remat_ratio, ce_chunk=ce_chunk,
                             scan_layers=scan_layers, z_loss_weight=z_loss_weight,
                             overlap=overlap, include_aux=include_aux,
                             with_moe_stats=with_moe_stats)

    return loss_fn


def init_train_state(params: Any, optimizer: FusedTransform) -> TrainState:
    for _, p in leaves_with_path(params):
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


def make_train_step(loss_fn: Callable, optimizer: FusedTransform,
                    accum_steps: int = 1, log_grad_norm: bool = False,
                    moe_stats_experts: int = 0
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step_fn(state, batch) -> (state, metrics)``; ``loss_fn(params,
    batch) -> (loss, token_count)``. The state is updated in place.

    ``moe_stats_experts > 0`` declares that ``loss_fn`` was built
    ``with_moe_stats`` and returns ``(loss, (token_count, stats))``: the
    expert-load vector and the dropped-selection count then ride the
    metrics as ``moe_load [E]`` and ``moe_dropped``."""

    def micro_step(params, batch):
        loss, aux = loss_fn(params, batch)
        toks, stats = aux if moe_stats_experts else (aux, None)
        loss.backward()
        return loss.detach(), toks, stats

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        leaves = [p for _, p in leaves_with_path(params)]
        for p in leaves:
            p.grad = None
        if accum_steps > 1:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])
                     for k, v in batch.items()}
            loss, toks, stats = 0.0, 0.0, None
            for i in range(accum_steps):
                l_i, t_i, s_i = micro_step(params, {k: v[i] for k, v in micro.items()})
                loss, toks = loss + l_i, toks + t_i
                if s_i is not None:
                    stats = s_i if stats is None else {k: stats[k] + s_i[k] for k in stats}
            inv = 1.0 / accum_steps
            loss = loss * inv
            with torch.no_grad():
                for p in leaves:
                    p.grad.mul_(inv)
        else:
            loss, toks, stats = micro_step(params, batch)
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = optimizer.fused_apply(grads, state["opt_state"], params)
        metrics = {"loss": loss, "toks": toks,
                   "nonfinite": (~torch.isfinite(loss)).to(torch.int32)}
        if stats is not None:
            metrics["moe_load"] = stats["moe_load"]
            metrics["moe_dropped"] = stats["moe_dropped"]
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
