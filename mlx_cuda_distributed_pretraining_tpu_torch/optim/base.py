"""Optimizer helpers shared by the update rules: the global gradient norm
and the weight-decay routing by parameter name."""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..utils.tree import leaves_with_path


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaves in the JAX
    pytree order."""
    total = None
    for _, x in leaves_with_path(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
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


def default_wd_mask(params: Any, _path: tuple = ()) -> Any:
    """Tree of bools: True where decoupled weight decay applies (matrices
    whose name is not vector-like)."""
    if isinstance(params, dict):
        return {k: default_wd_mask(v, _path + (str(k),)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [default_wd_mask(v, _path + (str(i),)) for i, v in enumerate(params)]
    return params.dim() >= 2 and not is_vector_like_path(_path)
