"""The optimizer update on sharded state: each rank holds its block of
every parameter, gradient and state leaf (``parallel/sharding_rules.py``
``state_sharding``), and the update gives the numbers the one-device
update gives on the full tensors.

- **Elementwise rules** (``FusedTransform.elementwise``: AdamW, Adam, SGD,
  Lion and their EMA forms) run on local blocks. Under ZeRO-1 the state
  is split one step further than the parameter (over ``dp``), so each rank
  updates the block of the parameter its state covers, through views, and
  the blocks are all-gathered over ``dp`` back into the parameter. The
  gradient clip's global norm sums the blocks' squares over the ranks
  (``base.norm_override``).
- **Matrix rules** (Muon's Newton-Schulz, Adafactor's factored moments,
  Shampoo's statistics, hybrid) gather the full gradient, parameter and
  state, run the one-device update (every rank the same), and keep their
  blocks: the state stays sharded at rest.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..parallel.collectives import gather_full, shard_of, sharded_sum_squares, spec_axes
from ..parallel.sharding_rules import P, spec_items, zero_pspec
from ..utils.tree import leaves_with_path, tree_map
from .base import FusedTransform, norm_override


def _extra_spec(full: P, base: P) -> P:
    """The entries of ``full`` that ``base`` lacks (ZeRO's dp split)."""
    base = tuple(base) + (None,) * (len(full) - len(base))
    return P(*[f if f != b else None for f, b in zip(full, base)])


def make_sharded_apply(optimizer: FusedTransform, mesh, shardings: Dict[str, Any],
                       params_like: Any, zero_level: int = 0
                       ) -> Callable[[Any, Any, Any], Tuple[Any, Any]]:
    """``apply(grads, state, params) -> (params, state)`` over local blocks,
    in place where the one-device update is. ``grads`` hold the parameter
    layout (reduced over the data axes); ``params_like`` gives the full
    shapes."""
    if mesh.size == 1:  # the blocks are the tensors: the one-device update
        return optimizer.fused_apply
    pspecs = dict(spec_items(shardings["params"]))
    shapes = {path: tuple(x.shape) for path, x in leaves_with_path(params_like)}
    ospecs = shardings["opt_state"]

    if optimizer.elementwise:
        zspecs = {k: zero_pspec(s, shapes[k], mesh, zero_level) for k, s in pspecs.items()}
        extras = {k: _extra_spec(zspecs[k], s) for k, s in pspecs.items()}

        def norm(tree):
            leaves = [(x, zspecs[k]) for k, x in leaves_with_path(tree) if x is not None]
            return torch.sqrt(sharded_sum_squares(leaves, mesh))

        @torch.no_grad()
        def apply(grads, state, params):
            views = {k: shard_of(p, extras[k], mesh) for k, p in leaves_with_path(params)}
            gviews = {k: shard_of(g, extras[k], mesh) for k, g in leaves_with_path(grads)}
            ptree = _rebuild(params, views)
            gtree = _rebuild(params, gviews)
            with norm_override(norm):
                _, state = optimizer.fused_apply(gtree, state, ptree)
            for k, p in leaves_with_path(params):
                if spec_axes(extras[k]):
                    p.copy_(gather_full(views[k], extras[k], mesh))
            return params, state

        return apply

    @torch.no_grad()
    def apply(grads, state, params):
        full_g = tree_map(lambda g, s: gather_full(g, s, mesh), grads, shardings["params"])
        full_p = tree_map(lambda p, s: gather_full(p.detach(), s, mesh), params,
                          shardings["params"])
        full_s = _map_state(lambda x, s: gather_full(x, s, mesh), state, ospecs)
        full_p, full_s = optimizer.fused_apply(full_g, full_s, full_p)
        for (k, p), (_, fp) in zip(leaves_with_path(params), leaves_with_path(full_p)):
            if fp.data_ptr() != p.data_ptr():
                p.copy_(shard_of(fp, pspecs[k], mesh))
        return params, _map_state(lambda x, s: shard_of(x, s, mesh).clone()
                                  if spec_axes(s) else x, full_s, ospecs)

    return apply


def _rebuild(like: Any, by_path: Dict[tuple, Any], _path: tuple = ()) -> Any:
    """``like``'s structure with the leaves of ``by_path`` (keyed by the
    ``leaves_with_path`` tuples)."""
    if isinstance(like, dict):
        return {k: _rebuild(v, by_path, _path + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, by_path, _path + (str(i),)) for i, v in enumerate(like)]
    return by_path[_path]


def _map_state(fn, state: Any, specs: Any) -> Any:
    """``fn(tensor, spec)`` over the tensor leaves of an optimizer state
    (other leaves pass through)."""
    if isinstance(state, dict):
        return {k: _map_state(fn, v, specs[k]) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_map_state(fn, v, specs[i]) for i, v in enumerate(state)]
    if isinstance(state, torch.Tensor) and specs is not None:
        return fn(state, specs)
    return state
