"""Muon: momentum plus Newton-Schulz-5 orthogonalization for matrix
parameters, AdamW for the rest (the JAX package's ``optim/muon.py``).

The NS iteration is plain matrix products in fp32 (JAX leaves them to XLA,
outside any Pallas kernel), so it runs on ``torch.matmul``. The JAX update
orthogonalizes leaf by leaf (a stacked ``[L, m, n]`` leaf through ``vmap``).
Here the leaves of one step that share an oriented shape (wide, after the
tall ones are transposed) are stacked and orthogonalized in one batched
iteration: the same arithmetic per matrix in a few launches instead of
~35 per leaf. :func:`newton_schulz5` takes any ``[..., m, n]``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import leaves_with_path
from .base import (
    Transform,
    add_decayed_weights,
    chain,
    default_wd_mask,
    is_vector_like_path,
    map_with_path,
    maybe_clip,
    partition,
    scale_by_schedule,
    tmap,
)
from .enhanced import scale_by_adam
from .schedules import Schedule

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def _ns_wide(x: torch.Tensor, steps: int, eps: float) -> torch.Tensor:
    """NS5 on fp32 ``[..., m, n]`` with ``m <= n``, each trailing matrix
    normalized by its own Frobenius norm."""
    a, b, c = NS_COEFFS
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    for _ in range(steps):
        xxt = x @ x.mT
        bxxt = b * xxt + c * (xxt @ xxt)
        x = a * x + bxxt @ x
    return x


def newton_schulz5(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalize each trailing matrix of ``g`` (``[..., m, n]``) by the
    quintic Newton-Schulz iteration in fp32; a tall matrix is transposed
    first and back after, as in JAX."""
    x = g.float()
    tall = x.shape[-2] > x.shape[-1]
    x = _ns_wide(x.mT if tall else x, steps, eps)
    return x.mT if tall else x


def _rms_scale(shape) -> float:
    """``sqrt(max(1, rows / cols))`` in fp32, as JAX computes it."""
    return float(np.sqrt(np.float32(max(1.0, shape[-2] / shape[-1]))))


def orthogonalize(tree: Any, steps: int = 5, eps: float = 1e-7) -> Any:
    """NS5 of every ``ndim >= 2`` leaf of ``tree`` times its RMS scale, the
    leaves grouped by oriented matrix shape into one batched iteration per
    group; ``None`` leaves stay ``None``."""
    groups: Dict[Tuple, List] = {}
    for path, m in leaves_with_path(tree):
        if m is None:
            continue
        rows, cols = m.shape[-2], m.shape[-1]
        flat = m.float().reshape((-1, rows, cols))
        tall = rows > cols
        key = (min(rows, cols), max(rows, cols))
        groups.setdefault(key, []).append((path, m.shape, tall, flat.mT if tall else flat))
    out = {}
    for members in groups.values():
        stack = torch.cat([x for *_, x in members]) if len(members) > 1 else members[0][3]
        o = _ns_wide(stack, steps, eps)
        start = 0
        for path, shape, tall, x in members:
            piece = o[start:start + x.shape[0]]
            start += x.shape[0]
            piece = piece.mT if tall else piece
            out[path] = piece.reshape(shape) * _rms_scale(shape)
    return map_with_path(lambda path, m: out[path], tree)


def scale_by_muon(momentum: float = 0.95, nesterov: bool = True,
                  ns_steps: int = 5) -> Transform:
    """fp32 momentum (Nesterov: ``momentum * mu + g`` of the new ``mu``),
    then :func:`orthogonalize`."""

    def init(params):
        return {"mu": tmap(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params):
        mu = tmap(lambda m, g: momentum * m + g.float(), state["mu"], grads)
        eff = tmap(lambda m, g: momentum * m + g.float(), mu, grads) if nesterov else mu
        return orthogonalize(eff, ns_steps), {"mu": mu}

    return Transform(init, update)


def matrix_label_fn(params: Any) -> Any:
    """"matrix" for ``ndim >= 2`` leaves whose name is not a bias or a norm
    gain, else "rest" (by path, as JAX routes)."""
    return map_with_path(
        lambda path, p: "matrix" if p.dim() >= 2 and not is_vector_like_path(path)
        else "rest", params)


def embedding_rest_label_fn(params: Any) -> Any:
    """:func:`matrix_label_fn` with the embedding and output-head leaves
    sent to "rest" by path (``hybrid_embeddings: rest``)."""
    base = matrix_label_fn(params)
    return map_with_path(
        lambda path, label: "rest" if {"tok_embeddings", "output"} & set(path) else label,
        base)


def muon(schedule: Schedule, momentum: float = 0.95, nesterov: bool = True,
         ns_steps: int = 5, weight_decay: float = 0.0,
         grad_clip: Optional[float] = None, adamw_lr_ratio: float = 1.0) -> Transform:
    """Matrix leaves get NS5 (clip, Muon, weight decay, ``-lr``); the rest
    Adam(0.9, 0.95) at ``adamw_lr_ratio * lr``, each branch clipped by the
    norm of its own leaves."""
    matrix_t = chain(
        maybe_clip(grad_clip),
        scale_by_muon(momentum, nesterov, ns_steps),
        add_decayed_weights(weight_decay, default_wd_mask),
        scale_by_schedule(schedule),
    )
    rest_t = chain(
        maybe_clip(grad_clip),
        scale_by_adam(0.9, 0.95),
        scale_by_schedule(lambda s: schedule(s) * adamw_lr_ratio),
    )
    return partition(matrix_label_fn, {"matrix": matrix_t, "rest": rest_t})
