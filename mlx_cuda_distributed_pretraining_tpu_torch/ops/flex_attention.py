"""Flex attention over the flash kernels (the JAX package's
``ops/flex_attention.py``).

A mask mod is one of ``ops/masks.py``'s named mods, whose ``_plan`` names
the mask the kernels run; a score mod is :func:`alibi_score_fn` or
:func:`soft_cap_score_fn`. Each keeps the JAX signature ``(scores, row,
col, head) -> scores`` (the plain reference of the kernels' arithmetic)
and carries ``_code``, the ``(score_mod, score_arg)`` the CUDA kernels take
instead, since a kernel cannot trace a Python function; a non-additive mod
carries its Jacobian as ``_d_score``. A mask mod without a ``_plan`` raises
(``ops/flash_attention.py``): the kernels evaluate the named masks only.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import torch

from .flash_attention import flash_attention

KernelScoreMod = Callable  # (scores [.., bq, bkv], row, col, head) -> scores


@lru_cache(maxsize=None)
def alibi_score_fn(num_heads: int) -> KernelScoreMod:
    """``s - 2^(-8 (h + 1) / H) |row - col|``, h the query head."""

    def fn(s, row, col, head):
        slope = torch.exp2(-8.0 * (torch.as_tensor(head, dtype=torch.float32) + 1.0)
                           / num_heads)
        return s - slope * (row - col).abs().float()

    fn._d_score = None  # additive: d(mod)/ds == 1
    fn._code = ("alibi", float(num_heads))
    return fn


@lru_cache(maxsize=None)
def soft_cap_score_fn(cap: float) -> KernelScoreMod:
    """``cap tanh(s / cap)``, with its Jacobian ``1 - tanh^2(s / cap)``."""

    def fn(s, row, col, head):
        return cap * torch.tanh(s / cap)

    def d_score(s, row, col, head):
        t = torch.tanh(s / cap)
        return 1.0 - t * t

    fn._d_score = d_score
    fn._code = ("soft_cap", float(cap))
    return fn


def kernel_score_mod(kind: Optional[str], num_heads: int,
                     soft_cap: float) -> Optional[KernelScoreMod]:
    """The config-named score mod (``model.attention.score_mod``) of the
    flex path, or None."""
    if kind == "alibi":
        return alibi_score_fn(num_heads)
    if kind == "soft_cap":
        return soft_cap_score_fn(float(soft_cap))
    return None


def _plan_for(mask_mod) -> tuple:
    """The block-sparsity plan of a mask mod: its ``_plan``; None
    (no mask) is ("full", 0, 0). A mod without one keeps the JAX default
    ("full", 0, 0) here and is refused by the kernels' wrapper."""
    if mask_mod is None:
        return ("full", 0, 0)
    return getattr(mask_mod, "_plan", ("full", 0, 0))


def flex_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask_mod: Optional[Callable] = None,
                   score_mod: Optional[KernelScoreMod] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """``[B, S, H, D]`` layout: the flash kernels under the mask mod's plan
    and the score mod's code (JAX's block sizes are the TPU's; the kernels
    plan at their own tiles)."""
    mask_type, window, prefix = _plan_for(mask_mod)
    return flash_attention(q, k, v, mask_type=mask_type, window_size=window,
                           prefix_len=prefix, scale=scale, mask_fn=mask_mod,
                           score_fn=score_mod)
