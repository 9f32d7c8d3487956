"""AdamW in one pass over the parameters, updating them in place.

The JAX package's ``fused_adamw`` (one XLA-fused traversal, no Pallas
kernel) in plain tensor ops under ``torch.no_grad()``: per leaf, clip ->
Adam moments -> bias correction -> decoupled weight decay -> ``-lr`` ->
apply, with the JAX expression order (``torch.optim.AdamW`` orders the
arithmetic differently). Parameters and moments are updated in place, which
JAX's functional update reaches through buffer donation.

The state mirrors the JAX chain state ``[s_clip, {"count", "mu", "nu"},
s_wd, {"count"}]`` (``mu``/``nu`` fp32 trees like the params, counts int32
0-dim CPU tensors), so an optimizer checkpoint maps name for name. The
scalars are fp32 as inside the JAX update: bias corrections from an fp32
count, the learning rate from the fp32 schedule (``optim/schedules.py``),
and every division is by a tensor (PyTorch turns a division by a Python
scalar into a multiplication by its reciprocal on the GPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.tree import leaves_with_path, tree_map
from .base import FusedTransform, count_tensor, global_norm, is_vector_like_path
from .schedules import Schedule


def fused_adamw(
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
    amsgrad: bool = False,
) -> FusedTransform:

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        adam = {"count": count_tensor(0), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}
        if amsgrad:
            adam["nu_max"] = tree_map(zeros, params)
        return [{}, adam, {}, {"count": count_tensor(0)}]

    @torch.no_grad()
    def fused_apply(grads, state, params):
        s_clip, s_adam, s_wd, s_sched = state
        count = s_adam["count"] + 1
        sched_count = s_sched["count"] + 1
        lr = float(schedule(int(sched_count)))
        cf = count.float()
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        device = next(iter(leaves_with_path(params)))[1].device
        bc1 = (f32(1.0) - torch.pow(f32(b1), cf)).to(device)
        bc2 = (f32(1.0) - torch.pow(f32(b2), cf)).to(device)
        if grad_clip:
            norm = global_norm(grads)
            clip_scale = torch.clamp(
                torch.div(torch.full_like(norm, grad_clip), torch.clamp(norm, min=1e-9)),
                max=1.0)
        moments = [leaves_with_path(s_adam["mu"]), leaves_with_path(s_adam["nu"])]
        if amsgrad:
            moments.append(leaves_with_path(s_adam["nu_max"]))
        for (path, p), (_, g), *ms in zip(leaves_with_path(params),
                                         leaves_with_path(grads), *moments):
            m, v = ms[0][1], ms[1][1]
            g32 = g.float()
            if grad_clip:
                g32 = g32 * clip_scale
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            denom = v_new
            if amsgrad:
                denom = torch.maximum(ms[2][1], v_new)
                ms[2][1].copy_(denom)
            u = torch.div(torch.div(m_new, bc1), torch.sqrt(torch.div(denom, bc2)) + eps)
            if weight_decay != 0.0 and p.dim() >= 2 and not is_vector_like_path(path):
                u = u + weight_decay * p.float()
            u = u * (-lr)
            p.copy_((p.float() + u).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        s_adam = dict(s_adam, count=count)
        return params, [s_clip, s_adam, s_wd, {"count": sched_count}]

    return FusedTransform(init, fused_apply)
