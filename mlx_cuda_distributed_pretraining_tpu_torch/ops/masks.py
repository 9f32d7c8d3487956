"""Mask predicates and score mods over index tensors (the JAX package's
``ops/masks.py``).

A mask mod maps broadcastable integer tensors ``(q_idx, kv_idx)`` to a bool
tensor (True = attend). Each named builder tags its mod with
``_plan = (mask_type, window, prefix_len)``, the block-sparsity plan the
flash kernels run, and is cached so equal arguments give the same function.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch

NEG_INF = -1e30  # large-but-finite: keeps softmax well-defined on fully-masked rows

MaskMod = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _tag(mod: MaskMod, mask_type: str, window: int = 0, prefix: int = 0) -> MaskMod:
    mod._plan = (mask_type, window, prefix)
    return mod


@lru_cache(maxsize=None)
def causal() -> MaskMod:
    return _tag(lambda q, k: q >= k, "causal")


@lru_cache(maxsize=None)
def full() -> MaskMod:
    def mod(q, k):
        return torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                          dtype=torch.bool, device=q.device)

    return _tag(mod, "full")


@lru_cache(maxsize=None)
def sliding_window(window: int) -> MaskMod:
    """Causal, attending to the last ``window`` positions."""
    return _tag(lambda q, k: (q >= k) & ((q - k) < window),
                "sliding_window", window)


@lru_cache(maxsize=None)
def band(window: int) -> MaskMod:
    """Left band alone: ``q - k < window`` with no causal bound."""
    return _tag(lambda q, k: (q - k) < window, "band", window)


@lru_cache(maxsize=None)
def prefix_lm(prefix_len: int) -> MaskMod:
    """Bidirectional over the first ``prefix_len`` tokens, causal after."""
    return _tag(lambda q, k: (q >= k) | (k < prefix_len), "prefix_lm", 0,
                prefix_len)


def materialize_mask(mod: Optional[MaskMod], q_len: int, kv_len: int,
                     device=None) -> Optional[torch.Tensor]:
    """Evaluate ``mod`` on the full ``[q_len, kv_len]`` index lattice."""
    if mod is None:
        return None
    q = torch.arange(q_len, device=device)[:, None]
    k = torch.arange(kv_len, device=device)[None, :]
    return mod(q, k)


# -- score mods of the reference path: (scores, q_idx, kv_idx) -> scores ------
def alibi(slope: float):
    """ALiBi's linear positional bias for one head."""
    return lambda s, q, k: s - slope * (q - k).abs()


def alibi_slopes(num_heads: int) -> np.ndarray:
    """The standard geometric ALiBi slopes, ``2^(-8 i / H)`` for heads
    ``i = 1 .. H`` (float64, as JAX's numpy builds them)."""
    base = 2.0 ** (-8.0 / num_heads)
    return base ** np.arange(1, num_heads + 1)


def soft_cap(cap: float):
    """tanh soft-capping of the scores at ``cap``."""
    return lambda s, q, k: cap * torch.tanh(s / cap)
