"""Reference attention — plain tensor code: the serving path's attention, the
training path's ``simple`` attention, and the oracle of the flash kernels.

Layout: ``q [B, Sq, Hq, D]``, ``k/v [B, Skv, Hkv, D]`` with Hq a multiple of
Hkv (GQA by reshaping query heads into groups; nothing is repeated). Scores
and softmax are fp32. ``scaled_dot_product_attention`` is deliberately not
used so the numerics follow the JAX reference op for op.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .masks import NEG_INF, MaskMod, materialize_mask

# score_mod(scores [B, Hkv, G, Sq, Skv], q_idx [Sq, 1], k_idx [1, Skv])
ScoreMod = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    explicit_mask: Optional[torch.Tensor] = None,
    mask_mod: Optional[MaskMod] = None,
    score_mod: Optional[ScoreMod] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA. ``explicit_mask`` is a bool tensor
    broadcastable to ``[B, Hkv, G, Sq, Skv]`` (True = attend); ``mask_mod``
    is evaluated on the ``[Sq, Skv]`` index lattice and combined with it."""
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
    if score_mod is not None:
        q_idx = torch.arange(Sq, device=q.device)[:, None]
        k_idx = torch.arange(Skv, device=q.device)[None, :]
        scores = score_mod(scores, q_idx, k_idx)
    m = explicit_mask
    if mask_mod is not None:
        mm = materialize_mask(mask_mod, Sq, Skv, device=q.device)
        m = mm if m is None else (m & mm)
    if m is not None:
        scores = scores.masked_fill(~m, NEG_INF)

    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = probs.to(v.dtype)

    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vh)
    return out.reshape(B, Hq, Sq, D).permute(0, 2, 1, 3)
