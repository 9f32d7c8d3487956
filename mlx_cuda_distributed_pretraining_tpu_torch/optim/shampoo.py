"""Shampoo: Kronecker-factored preconditioning with grafting (the JAX
package's ``optim/shampoo.py``).

Per matrix leaf (a stacked ``[..., m, n]`` leaf matrix by matrix): the
left and right statistics ``G G^T`` / ``G^T G`` as fp32 EMAs (a side over
``max_preconditioner_dim`` keeps the diagonal only); every
``update_period`` steps, and at ``start_step``, the preconditioners become
their inverse 4th roots; the preconditioned gradient takes the norm of the
grafting direction (Adam by default); momentum on top. Vectors and norm
gains take the grafting direction alone. JAX decides the refresh with
``lax.cond`` inside the compiled step; here the step count is a host
integer and a Python ``if`` decides it.

The inverse root is ``eigh`` in fp32 with trace normalization and relative
eigenvalue clamping, as in JAX; LAPACK builds (and cuSOLVER on the card)
differ in the last bits of ``eigh``, so roots agree with JAX's to about
1e-5 relative, not bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import (
    Transform,
    add_decayed_weights,
    chain,
    count_tensor,
    default_wd_mask,
    is_vector_like_path,
    map_with_path,
    maybe_clip,
    scale_by_schedule,
)
from .schedules import Schedule


def inverse_pth_root(mat: torch.Tensor, p: int, eps: float = 1e-6) -> torch.Tensor:
    """``mat^(-1/p)`` of a symmetric PSD fp32 matrix (or a stack of them) by
    eigendecomposition, eigenvalues clamped at ``eps`` times the largest."""
    dim = mat.shape[-1]
    tr = torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1) / dim
    scale = torch.clamp(tr, min=eps)[..., None, None]
    sym = mat / scale
    lam, vec = torch.linalg.eigh((sym + sym.mT) / 2)  # JAX's eigh symmetrizes its input
    lam = torch.maximum(lam, eps * lam.amax(dim=-1, keepdim=True))
    root = (vec * (lam ** (-1.0 / p))[..., None, :]) @ vec.mT
    return root * (scale ** (-1.0 / p))


def shampoo_core(beta2: float = 0.99, update_period: int = 10, start_step: int = 10,
                 max_preconditioner_dim: int = 1024, momentum: float = 0.9,
                 graft_type: str = "adam", eps: float = 1e-12) -> Transform:
    """State ``{"count", "per_param": {leaf: {stats_l, stats_r, prec_l,
    prec_r, g_mu, g_nu, mom}}}`` (the statistics and roots only on matrix
    leaves), as the JAX state."""

    def sides(p):
        m, n = p.shape[-2], p.shape[-1]
        return m <= max_preconditioner_dim, n <= max_preconditioner_dim

    def preconditioned(path, p):
        return p.dim() >= 2 and not is_vector_like_path(path)

    def init(params):
        def per_param(path, p):
            st = {}
            if preconditioned(path, p):
                use_l, use_r = sides(p)
                m, n = p.shape[-2], p.shape[-1]
                lead = tuple(p.shape[:-2])
                kw = dict(dtype=torch.float32, device=p.device)
                st["stats_l"] = torch.zeros(lead + ((m, m) if use_l else (m,)), **kw)
                st["stats_r"] = torch.zeros(lead + ((n, n) if use_r else (n,)), **kw)
                st["prec_l"] = (torch.eye(m, **kw).expand(lead + (m, m)).clone() if use_l
                                else torch.ones(lead + (m,), **kw))
                st["prec_r"] = (torch.eye(n, **kw).expand(lead + (n, n)).clone() if use_r
                                else torch.ones(lead + (n,), **kw))
            for k in ("g_mu", "g_nu", "mom"):
                st[k] = torch.zeros_like(p, dtype=torch.float32)
            return st

        return {"count": count_tensor(0), "per_param": map_with_path(per_param, params)}

    def update(grads, state, params):
        count = state["count"] + 1
        n = int(count)
        refresh = n % update_period == 0 or n == start_step
        active = n >= start_step
        cf = count.float()
        bc1 = 1.0 - torch.pow(torch.tensor(0.9, dtype=torch.float32), cf)
        bc2 = 1.0 - torch.pow(torch.tensor(0.999, dtype=torch.float32), cf)

        def per_param(path, g, st):
            g32 = g.float()
            new = dict(st)
            mu = 0.9 * st["g_mu"] + 0.1 * g32
            nu = 0.999 * st["g_nu"] + 0.001 * torch.square(g32)
            new["g_mu"], new["g_nu"] = mu, nu
            if graft_type == "adam":
                c1, c2 = bc1.to(g.device), bc2.to(g.device)
                graft = torch.div(torch.div(mu, c1), torch.sqrt(torch.div(nu, c2)) + 1e-8)
            else:
                graft = g32
            if not preconditioned(path, g):
                direction = graft
            else:
                use_l, use_r = sides(g)
                sl = beta2 * st["stats_l"] + (1 - beta2) * (
                    g32 @ g32.mT if use_l else torch.sum(g32 * g32, dim=-1))
                sr = beta2 * st["stats_r"] + (1 - beta2) * (
                    g32.mT @ g32 if use_r else torch.sum(g32 * g32, dim=-2))
                if refresh:
                    pl = inverse_pth_root(sl, 4) if use_l else (sl + eps) ** -0.25
                    pr = inverse_pth_root(sr, 4) if use_r else (sr + eps) ** -0.25
                else:
                    pl, pr = st["prec_l"], st["prec_r"]
                pg = pl @ g32 if use_l else pl[..., :, None] * g32
                pg = pg @ pr if use_r else pg * pr[..., None, :]
                pg_norm = torch.linalg.vector_norm(pg, dim=(-2, -1), keepdim=True)
                graft_norm = torch.linalg.vector_norm(graft, dim=(-2, -1), keepdim=True)
                pg = pg * torch.div(graft_norm, torch.clamp(pg_norm, min=eps))
                new.update(stats_l=sl, stats_r=sr, prec_l=pl, prec_r=pr)
                direction = pg if active else graft
            new["mom"] = momentum * st["mom"] + direction
            return new["mom"], new

        def walk(g, st, path=()):  # the grads tree, each leaf beside its state dict
            if isinstance(g, dict):
                pairs = {k: walk(g[k], st[k], path + (str(k),)) for k in g}
                return ({k: v[0] for k, v in pairs.items()},
                        {k: v[1] for k, v in pairs.items()})
            if isinstance(g, (list, tuple)):
                pairs = [walk(x, st[i], path + (str(i),)) for i, x in enumerate(g)]
                return [v[0] for v in pairs], [v[1] for v in pairs]
            return (None, None) if g is None else per_param(path, g, st)

        updates, per = walk(grads, state["per_param"])
        return updates, {"count": count, "per_param": per}

    return Transform(init, update)


def shampoo(schedule: Schedule, beta2: float = 0.99, update_period: int = 10,
            start_step: int = 10, max_preconditioner_dim: int = 1024,
            momentum: float = 0.9, graft_type: str = "adam", weight_decay: float = 0.0,
            grad_clip: Optional[float] = None) -> Transform:
    return chain(
        maybe_clip(grad_clip),
        shampoo_core(beta2, update_period, start_step, max_preconditioner_dim,
                     momentum, graft_type),
        add_decayed_weights(weight_decay, default_wd_mask),
        scale_by_schedule(schedule),
    )
