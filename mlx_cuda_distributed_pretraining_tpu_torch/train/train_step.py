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

Under a mesh (``make_train_step(..., mesh=)``, dp, fsdp and ep axes) each rank
holds its blocks of the state (:func:`shard_state`) and runs its rows of
the global batch, split as ``batch_pspec`` splits them (with accumulation,
each micro-batch's rows). The loss is JAX's global token-weighted mean:
every rank divides its sum of token losses by the global token count (one
all-reduce of the per-micro-batch counts first), so the ranks' losses and
gradients sum to the global ones. fsdp-split parameters are gathered layer
by layer and their gradients reduce-scattered in the backward
(``parallel/overlap.py``); then every gradient is all-reduced over the data
axes its parameter is not split over, and the update runs on the blocks
(``optim/sharded.py``). The loss, token count, routing stats and
``grad_norm`` (a sum of the blocks' squares over the ranks) are global, so
``nonfinite`` is the same on every rank.

A ``tp`` axis splits the weights as the rules say and the model issues its
own sums over tp (``models/llama.py``); the batch is split over the data
axes only, so the ranks of one tp group run the same rows and compute the
same loss. A gradient then needs no sum over tp: a split leaf's is its
block's, and a tp-replicated leaf's (the norms, the router) comes out the
same on every tp rank, because every path into it from a split
computation passes a ``copy`` whose backward sums over tp.

An ``ep`` axis is a data axis (``parallel.mesh.DATA_AXES``) that also
splits the expert banks: the MoE layers exchange rows with the ranks that
hold their experts (``models/moe.py`` ``_grouped_moe_ep``), so a bank's
gradient holds every ep rank's rows and is summed over the other data
axes only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import llama
from ..optim.base import FusedTransform, global_norm
from ..optim.sharded import _map_state, make_sharded_apply
from ..parallel.context import use_mesh
from ..parallel.collectives import (all_reduce_axes, all_reduce_bucketed, gather_full,
                                    gather_to_chief, shard_of, sharded_sum_squares,
                                    spec_axes)
from ..parallel.mesh import DATA_AXES, refuse_unported_axes
from ..parallel.overlap import FsdpPlan, use_plan
from ..parallel.sharding_rules import batch_pspec, spec_items, state_sharding
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
                    moe_stats_experts: int = 0, mesh: Any = None,
                    zero_level: int = 0, params_like: Optional[Any] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step_fn(state, batch) -> (state, metrics)``; ``loss_fn(params,
    batch) -> (loss, token_count)``. The state is updated in place.

    ``moe_stats_experts > 0`` declares that ``loss_fn`` was built
    ``with_moe_stats`` and returns ``(loss, (token_count, stats))``: the
    expert-load vector and the dropped-selection count then ride the
    metrics as ``moe_load [E]`` and ``moe_dropped``.

    With a ``mesh`` the state holds this rank's blocks (:func:`shard_state`)
    and ``batch`` this rank's rows; ``params_like`` (full shapes: tensors or
    ``meta`` tensors) gives the layout, and ``step_fn.shardings`` the spec
    tree of the state (``state_sharding`` with ``zero_level``)."""
    if mesh is not None:
        return _mesh_train_step(loss_fn, optimizer, accum_steps, log_grad_norm,
                                moe_stats_experts, mesh, zero_level, params_like)

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


def make_eval_step(loss_fn: Callable, mesh: Any = None,
                   params_like: Optional[Any] = None) -> Callable:
    """``(params, batch) -> (loss, token_count)`` without gradients. With a
    ``mesh``: this rank's blocks and rows in, the global token-weighted loss
    and count out (the same on every rank)."""
    if mesh is None:
        @torch.no_grad()
        def eval_step(params, batch):
            return loss_fn(params, batch)

        return eval_step
    plan = _fsdp_plan(mesh, params_like)
    data_axes = DATA_AXES

    @torch.no_grad()
    def mesh_eval_step(params, batch):
        count = batch["mask"].float().sum()
        all_reduce_axes(count, mesh, data_axes)
        with use_plan(plan), use_mesh(mesh):
            view = plan.gather_top(params) if plan is not None else params
            loss, toks = loss_fn(view, dict(batch, global_count=count.clamp_min(1.0)))
        out = torch.stack([loss.float(), toks.float()])
        all_reduce_axes(out, mesh, data_axes)
        return out[0], out[1]

    return mesh_eval_step


# -- the mesh path -----------------------------------------------------------------


def _fsdp_plan(mesh, params_like):
    return FsdpPlan(params_like, mesh) if mesh.axis_size("fsdp") > 1 else None


def mesh_shardings(optimizer: FusedTransform, params_like: Any, mesh,
                   zero_level: int = 0) -> Dict[str, Any]:
    """``state_sharding`` of the state ``optimizer`` builds for
    ``params_like`` (full shapes; ``meta`` tensors do)."""
    probe = {"params": params_like, "opt_state": optimizer.init(params_like), "step": 0}
    return state_sharding(probe, mesh, zero_level)


def shard_state(state: TrainState, shardings: Dict[str, Any], mesh) -> TrainState:
    """A full train state (the same on every rank) cut to this rank's
    blocks (new tensors where a spec splits; the same storage where it does
    not); params keep ``requires_grad``."""
    with torch.no_grad():
        params = tree_map(lambda p, s: (shard_of(p.detach(), s, mesh).clone()
                                        if spec_axes(s) else p.detach()).requires_grad_(True),
                          state["params"], shardings["params"])
        opt_state = _map_state(lambda x, s: shard_of(x, s, mesh).clone()
                               if spec_axes(s) else x, state["opt_state"],
                               shardings["opt_state"])
    return {"params": params, "opt_state": opt_state, "step": state["step"]}


def gather_state(state: TrainState, shardings: Dict[str, Any], mesh,
                 chief_only: bool = False) -> TrainState:
    """The full train state from every rank's blocks (a collective), on
    every rank; with ``chief_only`` on rank 0 alone (the other ranks'
    leaves are None): what a checkpoint save needs, without every rank
    receiving and holding the whole state."""
    def full(x, s):
        return (gather_to_chief if chief_only else gather_full)(x.detach(), s, mesh)

    with torch.no_grad():
        params = tree_map(full, state["params"], shardings["params"])
        opt_state = _map_state(full, state["opt_state"], shardings["opt_state"])
    return {"params": params, "opt_state": opt_state, "step": state["step"]}


def local_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (``batch_pspec``'s block)."""
    spec = batch_pspec(mesh)
    return {k: shard_of(v, spec, mesh) for k, v in batch.items()}


def _micro_batches(batch, accum_steps: int, mesh) -> list:
    """This rank's rows of each micro-batch. A micro-batch is a slice of the
    GLOBAL batch (JAX's reshape), so with accumulation over several ranks
    the ranks first gather the global batch (token ids: small)."""
    if accum_steps == 1:
        return [batch]
    spec = batch_pspec(mesh)
    if spec_axes(spec):
        batch = {k: gather_full(v, spec, mesh) for k, v in batch.items()}
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} rows does not split into {accum_steps} micro-batches")
    m = n // accum_steps
    return [{k: shard_of(v[i * m:(i + 1) * m], spec, mesh) for k, v in batch.items()}
            for i in range(accum_steps)]


def _mesh_train_step(loss_fn, optimizer, accum_steps, log_grad_norm,
                     moe_stats_experts, mesh, zero_level, params_like):
    if params_like is None:
        raise ValueError("a mesh train step needs params_like (the full shapes)")
    refuse_unported_axes(mesh.shape)
    shardings = mesh_shardings(optimizer, params_like, mesh, zero_level)
    plan = _fsdp_plan(mesh, params_like)
    apply = make_sharded_apply(optimizer, mesh, shardings, params_like, zero_level)
    pspecs = [s for _, s in spec_items(shardings["params"])]
    # each gradient is summed over the data axes its parameter is not split
    # on: an ep-split expert bank's leaves out ep (the exchange's backward
    # brought every ep rank's rows into it), every other leaf keeps it
    reduce_axes = [tuple(a for a in DATA_AXES if a not in {ax for _, ax in spec_axes(s)})
                   for s in pspecs]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        leaves = [p for _, p in leaves_with_path(params)]
        for p in leaves:
            p.grad = None
        micro = _micro_batches(batch, accum_steps, mesh)
        counts = torch.stack([mb["mask"].float().sum() for mb in micro])
        all_reduce_axes(counts, mesh, DATA_AXES)
        counts = counts.clamp_min(1.0)
        loss = toks = 0.0
        stats = None
        with use_plan(plan), use_mesh(mesh):
            for i, mb in enumerate(micro):
                view = plan.gather_top(params) if plan is not None else params
                l_i, aux = loss_fn(view, dict(mb, global_count=counts[i]))
                t_i, s_i = aux if moe_stats_experts else (aux, None)
                l_i.backward()
                loss, toks = loss + l_i.detach(), toks + t_i
                if s_i is not None:
                    stats = s_i if stats is None else {k: stats[k] + s_i[k] for k in stats}
        with torch.no_grad():
            by_axes: Dict[tuple, list] = {}
            for p, axes in zip(leaves, reduce_axes):
                by_axes.setdefault(axes, []).append(p.grad)
            for axes, grads in by_axes.items():
                all_reduce_bucketed(grads, mesh, axes)
            if accum_steps > 1:
                inv = 1.0 / accum_steps
                for p in leaves:
                    p.grad.mul_(inv)
                loss = loss * inv
            out = torch.stack([torch.as_tensor(loss, dtype=torch.float32),
                               torch.as_tensor(toks, dtype=torch.float32)
                               .to(counts.device)])
            all_reduce_axes(out, mesh, DATA_AXES)
            loss, toks = out[0], out[1]
            if stats is not None:  # the layers' drop counts are global already
                all_reduce_axes(stats["moe_load"], mesh, DATA_AXES)
        grads = tree_map(lambda p: p.grad, params)
        metrics = {"loss": loss, "toks": toks,
                   "nonfinite": (~torch.isfinite(loss)).to(torch.int32)}
        if stats is not None:
            metrics["moe_load"] = stats["moe_load"]
            metrics["moe_dropped"] = stats["moe_dropped"]
        if log_grad_norm:
            metrics["grad_norm"] = (global_norm(grads) if mesh.size == 1 else torch.sqrt(
                sharded_sum_squares([(p.grad, s) for p, s in zip(leaves, pspecs)], mesh)))
        params, opt_state = apply(grads, state["opt_state"], params)
        for p in leaves:
            p.grad = None
        state.update(params=params, opt_state=opt_state, step=state["step"] + 1)
        return state, metrics

    train_step.shardings = shardings
    train_step.plan = plan
    return train_step

