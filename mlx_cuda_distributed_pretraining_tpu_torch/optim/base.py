"""Optimizer helpers shared by the update rules: the global gradient norm,
the weight-decay routing by parameter name, and the gradient transforms
that chained update rules (Adafactor, the ``enhanced`` cores, Muon,
Shampoo) are built from, with the EMA wrapper and :func:`partition`.

A :class:`Transform` is the JAX package's ``(init, update)`` pair on tensor
trees: ``update(grads, state, params) -> (updates, new_state)``, with
``new_params = params + updates`` (updates carry the negative LR). The
states are the JAX states leaf for leaf (counts as int32 0-dim CPU
tensors), so an optimizer file maps name for name. The arithmetic is fp32
in the JAX order; every division is by a tensor, as in ``optim/fused.py``.
A ``None`` leaf is a parameter another branch of :func:`partition` owns, as
in JAX (where ``None`` is an empty subtree): every transform passes it
through, and the global norm skips it.
:func:`in_place` turns a chain into the :class:`FusedTransform` the train
step runs, which updates parameters and state tensors in place.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from ..utils.tree import leaves_with_path, tree_map
from .schedules import Schedule


class FusedTransform(NamedTuple):
    """``init(params) -> state``; ``fused_apply(grads, state, params) ->
    (params, state)`` updates params and state in place. ``elementwise``:
    each element's update reads only that element of the gradient, the
    parameter and the state (and the global gradient norm), so a mesh runs
    it on local shards (``optim/sharded.py``)."""

    init: Callable[[Any], Any]
    fused_apply: Callable[[Any, Any, Any], tuple]
    elementwise: bool = False


class Transform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)


def count_tensor(n: int) -> torch.Tensor:
    """An optimizer step counter: int32, 0-dim, on the CPU."""
    return torch.tensor(n, dtype=torch.int32)


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as an fp32 0-dim tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def tmap(fn, tree: Any, *rest: Any) -> Any:
    """:func:`tree_map` that keeps a ``None`` leaf of ``tree`` as ``None``
    (JAX maps over the leaves of a tree with ``None`` subtrees)."""
    return tree_map(lambda x, *r: None if x is None else fn(x, *r), tree, *rest)


def map_with_path(fn, tree: Any, _path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree, ``path`` the tuple of keys (list
    indices as strings); a ``None`` leaf stays ``None``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, _path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, _path + (str(i),)) for i, v in enumerate(tree)]
    return None if tree is None else fn(_path, tree)


# A sharded update's norm (``optim/sharded.py``): the trees it hands the
# update rule hold local shards, whose norm is a sum over the ranks.
_NORM_OVERRIDE: list = []


@contextlib.contextmanager
def norm_override(fn: Callable[[Any], torch.Tensor]):
    """Inside the block :func:`global_norm` is ``fn(tree)``."""
    _NORM_OVERRIDE.append(fn)
    try:
        yield
    finally:
        _NORM_OVERRIDE.pop()


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaves in the JAX
    pytree order (``None`` leaves are not leaves there)."""
    if _NORM_OVERRIDE:
        return _NORM_OVERRIDE[-1](tree)
    total = None
    for _, x in leaves_with_path(tree):
        if x is None:
            continue
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    if total is None:  # a branch of a partition that owns no leaf: JAX sqrt(0)
        total = torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def is_vector_like_path(path: Sequence[str]) -> bool:
    """True when a parameter's name marks a per-layer vector (a bias or a
    norm gain) whatever its rank: ``(..., "*bias*")`` or
    ``(..., "*norm*", "weight")``."""
    keys = [str(k) for k in path]
    if not keys:
        return False
    if "bias" in keys[-1]:
        return True
    return keys[-1] == "weight" and len(keys) >= 2 and "norm" in keys[-2]


def default_wd_mask(params: Any) -> Any:
    """Tree of bools: True where decoupled weight decay applies (matrices
    whose name is not vector-like)."""
    return map_with_path(lambda path, p: p.dim() >= 2 and not is_vector_like_path(path),
                         params)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return Transform(init, update)


def identity() -> Transform:
    return Transform(lambda p: {}, lambda g, s, p: (g, s))


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``."""

    def update(grads, state, params):
        norm = global_norm(grads)
        factor = torch.clamp(torch.div(f32(max_norm, norm), torch.clamp(norm, min=1e-9)),
                             max=1.0)
        return tmap(lambda g: g * factor, grads), state

    return Transform(lambda p: {}, update)


def maybe_clip(max_norm: Optional[float]) -> Transform:
    return clip_by_global_norm(max_norm) if max_norm else identity()


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Callable[[Any], Any]] = default_wd_mask
                        ) -> Transform:
    """``g + weight_decay * p`` where ``mask(params)`` is True."""

    def update(grads, state, params):
        if weight_decay == 0.0 or params is None:
            return grads, state
        m = mask(params) if mask is not None else tmap(lambda p: True, params)
        return tmap(lambda g, p, use: g + weight_decay * p.to(g.dtype) if use else g,
                    grads, params, m), state

    return Transform(lambda p: {}, update)


def scale(factor: float) -> Transform:
    return Transform(lambda p: {}, lambda g, s, p: (tmap(lambda x: x * factor, g), s))


def scale_by_schedule(schedule: Schedule, flip_sign: bool = True) -> Transform:
    """Multiply by ``-lr(step)`` (``lr(step)`` with ``flip_sign=False``);
    owns the step counter."""

    def init(params):
        return {"count": count_tensor(0)}

    def update(grads, state, params):
        count = state["count"] + 1
        lr = schedule(int(count))  # fp32; as a Python float it is the same value
        factor = float(-lr if flip_sign else lr)
        return tmap(lambda g: g * factor, grads), {"count": count}

    return Transform(init, update)


def trace_momentum(beta: float, nesterov: bool = False) -> Transform:
    """fp32 momentum ``trace = beta * trace + g``; Nesterov returns
    ``beta * trace + g`` of the new trace."""

    def init(params):
        return {"trace": tmap(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params):
        new_trace = tmap(lambda t, g: beta * t + g.float(), state["trace"], grads)
        out = (tmap(lambda t, g: beta * t + g.float(), new_trace, grads)
               if nesterov else new_trace)
        return out, {"trace": new_trace}

    return Transform(init, update)


def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates`` in fp32, rounded to each param's dtype."""
    return tmap(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def with_ema(inner: Transform, decay: float) -> Transform:
    """An fp32 EMA shadow of the parameters beside any optimizer: state
    ``{"shadow", "inner"}``, the shadow tracking the parameters after each
    update."""

    def init(params):
        return {"shadow": tmap(lambda p: p.detach().float().clone(), params),
                "inner": inner.init(params)}

    def update(grads, state, params):
        updates, inner_state = inner.update(grads, state["inner"], params)
        new_params = apply_updates(params, updates)
        shadow = tmap(lambda s, p: decay * s + (1.0 - decay) * p.float(),
                      state["shadow"], new_params)
        return updates, {"shadow": shadow, "inner": inner_state}

    return Transform(init, update)


def partition(label_fn: Callable[[Any], Any], transforms: dict) -> Transform:
    """Route each parameter to the transform of its label (optax's
    ``multi_transform``, as the JAX ``partition``): each transform sees the
    whole tree with the other labels' leaves set to ``None``, so its state
    has ``None`` there and a clip inside it takes the norm of its own
    leaves only. State ``{label: state}``."""

    def masked(tree, labels, label):
        return tree_map(lambda x, l: x if l == label else None, tree, labels)

    def init(params):
        labels = label_fn(params)
        return {k: t.init(masked(params, labels, k)) for k, t in transforms.items()}

    def update(grads, state, params):
        labels = label_fn(params)
        outs, new_state = [], {}
        for k, t in transforms.items():
            u_k, new_state[k] = t.update(masked(grads, labels, k), state[k],
                                         masked(params, labels, k))
            outs.append(u_k)

        def pick(*xs):
            return next((x for x in xs if x is not None), None)

        return tree_map(pick, *outs), new_state

    return Transform(init, update)


def in_place(transform: Transform) -> FusedTransform:
    """The train step's form of a chain: ``params += updates`` (in fp32,
    rounded to the param dtype, as the JAX ``apply_updates``) and every
    state tensor overwritten with its new value, all in place."""

    def assign(old, new):
        if isinstance(old, torch.Tensor) and old.shape == new.shape:
            return old.copy_(new)
        return new

    @torch.no_grad()
    def fused_apply(grads, state, params):
        updates, new_state = transform.update(grads, state, params)
        for (_, p), (_, u) in zip(leaves_with_path(params), leaves_with_path(updates)):
            p.copy_((p.float() + u.float()).to(p.dtype))
        return params, tree_map(assign, state, new_state)

    return FusedTransform(transform.init, fused_apply)
