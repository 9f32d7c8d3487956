"""Partition rules: which dim of each parameter, batch and optimizer-state
leaf is split over which mesh axis (the JAX package's
``parallel/sharding_rules.py``, rule for rule).

A spec (:class:`P`) is a tuple with one entry per dim: an axis name, a
tuple of axis names, or None (replicated along that dim), as
``jax.sharding.PartitionSpec``. The rules are pure functions of the leaf's
path, its full shape and the mesh's axis sizes, so a test holds the port's
spec against JAX's leaf by leaf. The trainer acts on dp and fsdp; the tp,
ep and quantized rows are kept so that the specs stay JAX's.

ZeRO-1 (``system.zero_optimization_level``): optimizer-state leaves inherit
their parameter's spec, then split their first still-replicated dim over
``dp`` when it divides.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Tuple

from ..utils.tree import flatten_dict, unflatten_dict


class P(tuple):
    """A partition spec: ``P("fsdp", None)`` splits dim 0 over fsdp. A
    one-axis tuple entry is that axis, as ``PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


# (path regex, dims). fsdp shards the non-tp dim of every matrix; stacked
# [E, ...] expert banks lead with ep; int8 ``weight_q`` / packed int4
# ``weight_q4`` shard as the fp ``weight`` they replace, and the
# per-output-channel ``weight_s`` scales with the OUT dim of their matrix.
_RULES = [
    (r"tok_embeddings\.weight$", ("tp", "fsdp")),  # [V, D] vocab-parallel
    (r"output\.weight$", ("fsdp", "tp")),          # [D, V]
    (r"attention\.w[qkv]\.weight(_q4?)?$", ("fsdp", "tp")),  # [D, H*Dh] column
    (r"attention\.w[qkv]\.weight_s$", ("tp",)),              # [H*Dh]
    (r"attention\.wo\.weight(_q4?)?$", ("tp", "fsdp")),      # [H*Dh, D] row
    (r"attention\.wo\.weight_s$", ("fsdp",)),                # [D]
    (r"experts\.w_(gate|up)\.weight(_q4?)?$", ("ep", "fsdp", "tp")),  # [E, D, I]
    (r"experts\.w_(gate|up)\.weight_s$", ("ep", "tp")),               # [E, I]
    (r"experts\.w_down\.weight(_q4?)?$", ("ep", "tp", "fsdp")),       # [E, I, D]
    (r"experts\.w_down\.weight_s$", ("ep", "fsdp")),                  # [E, D]
    (r"feed_forward\.router\.weight$", ("fsdp", None)),        # [D, E]
    (r"feed_forward\.w_(gate|up)\.weight(_q4?)?$", ("fsdp", "tp")),  # [D, I] column
    (r"feed_forward\.w_(gate|up)\.weight_s$", ("tp",)),              # [I]
    (r"feed_forward\.w_down\.weight(_q4?)?$", ("tp", "fsdp")),       # [I, D] row
    (r"feed_forward\.w_down\.weight_s$", ("fsdp",)),                 # [D]
    (r"\.bias$", (None,)),
    (r"norm\.weight$", (None,)),
]


def _axis(mesh, name: Optional[str]) -> Optional[str]:
    return name if (name is not None and name in mesh.axis_names
                    and mesh.shape[name] > 1) else None


def param_pspec(path: str, shape, mesh) -> P:
    """The spec of the parameter at dotted ``path`` with full ``shape``:
    the first matching rule, each axis kept only where it divides."""
    shape = tuple(shape)
    for pattern, dims in _RULES:
        if re.search(pattern, path):
            out = []
            for i, d in enumerate(dims[: len(shape)]):
                ax = _axis(mesh, d)
                out.append(ax if ax is not None and shape[i] % mesh.shape[ax] == 0 else None)
            out += [None] * (len(shape) - len(out))
            return P(*out)
    return P()  # replicated default


def batch_pspec(mesh) -> P:
    """Batch dim over dp x fsdp x ep; sequence dim over sp."""
    data_axes = tuple(a for a in ("dp", "fsdp", "ep") if _axis(mesh, a))
    return P(data_axes if data_axes else None, _axis(mesh, "sp"))


def moe_dispatch_specs(mesh) -> dict:
    """The grouped-MoE dispatch's boundary specs (JAX's shard_map specs):
    activations and routing batch-sharded as :func:`batch_pspec`, expert
    banks split over ``ep``."""
    data_axes = tuple(a for a in ("dp", "fsdp", "ep") if _axis(mesh, a))
    batch = data_axes if data_axes else None
    ep = _axis(mesh, "ep")
    return {
        "batch_axes": data_axes,
        "activation": P(batch, None, None),
        "gate": P(batch, None, None),
        "expert_weight": P(ep, None, None),
        "replicated": P(),
    }


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def tree_pspecs(params: Any, mesh) -> Any:
    """The spec tree of a param tree (paths joined with '.')."""
    flat = flatten_dict(params)
    specs = {k: param_pspec(k, _shape(v), mesh) for k, v in flat.items()}
    return _match_structure(params, unflatten_dict(specs))


def _match_structure(like: Any, nested: Any) -> Any:
    if isinstance(like, dict):
        return {k: _match_structure(v, nested[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_match_structure(v, nested[str(i)]) for i, v in enumerate(like)]
    return nested


def match_opt_leaf_spec(k: str, shape, ordered_paths, param_specs, param_shapes) -> Optional[P]:
    """An optimizer-state leaf's spec from its parameter's, matched by path
    suffix against the leaf path and its parent (Shampoo's
    ``...wq.weight.stats_l`` matches ``...wq.weight``). An exact-shape match
    inherits the whole spec; a leaf sharing only the leading dim (a bank's
    ``[*lead, m, m]`` statistics) inherits the leading axis."""
    shape = tuple(shape)
    candidates = (k, k.rsplit(".", 1)[0])
    for cand in candidates:
        for p in ordered_paths:
            if (cand == p or cand.endswith("." + p)) and param_shapes[p] == shape:
                return param_specs[p]
    for cand in candidates:
        for p in ordered_paths:
            if cand == p or cand.endswith("." + p):
                pspec = list(param_specs[p])
                pshape = param_shapes[p]
                if (pspec and pspec[0] is not None and len(shape) >= 1
                        and len(pshape) >= 1 and shape[0] == pshape[0]):
                    return P(pspec[0], *([None] * (len(shape) - 1)))
                return None
    return None


def zero_pspec(spec: P, shape, mesh, zero_level: int) -> P:
    """``spec`` with ZeRO-1's extra split: the first replicated dim of size
    > 1 that ``dp`` divides goes over ``dp`` (``zero_level >= 1``)."""
    dp = _axis(mesh, "dp")
    shape = tuple(shape)
    if zero_level < 1 or dp is None or not shape:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, d in enumerate(dims):
        if d is None and shape[i] % mesh.shape[dp] == 0 and shape[i] > 1:
            dims[i] = dp
            break
    return P(*dims)


def state_sharding(state: Any, mesh, zero_level: int = 0) -> Any:
    """Specs for a ``{params, opt_state, step}`` train state of full-shape
    leaves (tensors, or ``meta`` tensors). Optimizer-state leaves match
    their parameter by path suffix (``1.mu.layers.0.attention.wq.weight``
    -> ``layers.0.attention.wq.weight``): matching by shape would collide
    for wq and wo when heads x head_dim == hidden. ``zero_level >= 1``
    adds ZeRO-1's dp split (:func:`zero_pspec`)."""
    param_specs: dict = {}
    param_shapes: dict = {}
    for k, leaf in flatten_dict(state["params"]).items():
        param_specs[k] = param_pspec(k, _shape(leaf), mesh)
        param_shapes[k] = _shape(leaf)
    ordered_paths = sorted(param_specs, key=len, reverse=True)

    def opt_leaf(k: str, leaf) -> Optional[P]:
        if leaf is None:
            return None
        shape = _shape(leaf)
        spec = P()
        if shape:
            matched = match_opt_leaf_spec(k, shape, ordered_paths, param_specs, param_shapes)
            if matched is not None:
                spec = matched
            spec = zero_pspec(spec, shape, mesh, zero_level)
        return spec

    return {
        "params": _match_structure(state["params"], unflatten_dict(param_specs)),
        "opt_state": map_leaves_with_key(opt_leaf, state["opt_state"]),
        "step": P(),
    }


def spec_items(tree: Any, _path: tuple = ()) -> list:
    """``[(path, spec)]`` of a spec tree, a :class:`P` (or None) being a
    leaf, in ``utils.tree.leaves_with_path``'s order and path form."""
    if tree is None or isinstance(tree, P):
        return [(_path, tree)]
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in spec_items(tree[k], _path + (str(k),))]
    return [it for i, v in enumerate(tree) for it in spec_items(v, _path + (str(i),))]


def map_leaves_with_key(fn, tree: Any, _prefix: str = "") -> Any:
    """``fn(dotted_key, leaf)`` over a nested dict/list tree, keeping its
    structure (``None`` leaves and empty containers included)."""
    if isinstance(tree, dict):
        return {k: map_leaves_with_key(fn, v, f"{_prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves_with_key(fn, v, f"{_prefix}{i}.") for i, v in enumerate(tree)]
    return fn(_prefix[:-1], tree)
