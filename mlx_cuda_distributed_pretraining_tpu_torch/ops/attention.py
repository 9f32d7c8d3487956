"""Reference attention — plain tensor code, the serving path's attention.

Layout: ``q [B, Sq, Hq, D]``, ``k/v [B, Skv, Hkv, D]`` with Hq a multiple of
Hkv (GQA by reshaping query heads into groups; nothing is repeated). Scores
and softmax are fp32. ``scaled_dot_product_attention`` is deliberately not
used so the numerics follow the JAX reference op for op.
"""

from __future__ import annotations

from typing import Optional

import torch

from .masks import NEG_INF


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    explicit_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA. ``explicit_mask`` is a bool tensor
    broadcastable to ``[B, Hkv, G, Sq, Skv]`` (True = attend)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale

    # [B, Hkv, G, Sq, D] x [B, Hkv, Skv, D] -> [B, Hkv, G, Sq, Skv]
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, Sq, D)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kh) * scale
    scores = scores.float()
    if explicit_mask is not None:
        scores = scores.masked_fill(~explicit_mask, NEG_INF)

    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = probs.to(v.dtype)

    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vh)
    return out.reshape(B, Hq, Sq, D).permute(0, 2, 1, 3)
