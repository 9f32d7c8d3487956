"""Chunked (fused) cross-entropy over the vocabulary projection: the JAX
package's ``ops/fused_ce.py``.

The plain loss builds fp32 logits ``[B, S, V]``. This folds the output
projection into the loss and works in chunks of ``chunk`` rows: each
chunk's logits (bf16 operands cast to fp32, so their products are exact,
accumulated in fp32 as JAX's ``preferred_element_type=float32``), its
logsumexp and gold logit, and a masked partial sum. Peak logits memory is
``chunk x V`` fp32. The backward (a ``torch.autograd.Function``)
recomputes each chunk's logits instead of keeping them: the softmax's
Jacobian never exists whole either, dW accumulates in fp32 across chunks
and each chunk's dX is written once. The same math as the plain path;
sums run in another order.

Under tensor parallelism (``tp``: the projection holds this rank's block of
the vocabulary) each chunk's logits stay local (:class:`_FusedCETp`): the
row max is reduced over tp, then the sum of exps and the gold logit in one
more reduction, so every rank has the global logsumexp; the backward
writes only the local block of dW, and dX, this rank's partial sum, is
summed over tp by the ``copy`` in front of it.

``fused_cross_entropy_sp`` (sequence-sharded, under a mesh) is not ported:
ROADMAP queue 1 item 10c (sequence parallelism).
"""

from __future__ import annotations

from typing import Optional

import torch


def _chunk_logits(xc, wf, bias, logit_scale):
    logits = xc.float() @ wf.t()
    if bias is not None:
        logits = logits + bias.float()
    if logit_scale:
        logits = logits * logit_scale
    return logits


class _FusedCE(torch.autograd.Function):
    """``(x [N, D], w [V, D], bias [V] or None, targets [N], mask [N])`` ->
    ``(nll_sum, z_sum)``, fp32 scalars; z_sum is the masked sum of
    logsumexp^2 (the z-loss numerator)."""

    @staticmethod
    def forward(ctx, x, w, bias, targets, mask, logit_scale, chunk):
        wf = w.float()
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        z = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, x.shape[0], chunk):
            logits = _chunk_logits(x[lo:lo + chunk], wf, bias, logit_scale)
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, targets[lo:lo + chunk, None])[:, 0]
            m = mask[lo:lo + chunk]
            nll = nll + ((logz - gold) * m).sum()
            z = z + (torch.square(logz) * m).sum()
        ctx.save_for_backward(x, w, bias, targets, mask)
        ctx.logit_scale, ctx.chunk = logit_scale, chunk
        return nll, z

    @staticmethod
    def backward(ctx, g_nll, g_z):
        x, w, bias, targets, mask = ctx.saved_tensors
        wf = w.float()
        dx = torch.empty_like(x)
        dw = torch.zeros_like(wf)
        db = None if bias is None else torch.zeros(bias.shape, dtype=torch.float32,
                                                   device=bias.device)
        for lo in range(0, x.shape[0], ctx.chunk):
            xc = x[lo:lo + ctx.chunk]
            logits = _chunk_logits(xc, wf, bias, ctx.logit_scale)
            logz = torch.logsumexp(logits, dim=-1)
            m = mask[lo:lo + ctx.chunk]
            # d/dlogits of sum(m (logz - gold)) g_nll + sum(m logz^2) g_z
            row = m * g_nll + 2.0 * m * logz * g_z
            dlogits = torch.exp(logits - logz[:, None]) * row[:, None]
            dlogits.scatter_add_(-1, targets[lo:lo + ctx.chunk, None],
                                 -(m * g_nll)[:, None])
            if ctx.logit_scale:
                dlogits = dlogits * ctx.logit_scale
            dx[lo:lo + ctx.chunk] = (dlogits @ wf).to(x.dtype)
            dw += dlogits.t() @ xc.float()
            if db is not None:
                db += dlogits.sum(dim=0)
        return (dx, dw.to(w.dtype), None if db is None else db.to(bias.dtype),
                None, None, None, None)


class _FusedCETp(torch.autograd.Function):
    """:class:`_FusedCE` over a vocab-parallel ``w [V/tp, D]`` (and bias):
    the same sums, the same on every tp rank. The rows' logsumexp is kept
    for the backward, which then needs no collective."""

    @staticmethod
    def forward(ctx, x, w, bias, targets, mask, logit_scale, chunk, tp):
        import torch.distributed as dist

        wf = w.float()
        lo = tp.coord * w.shape[0]
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        z = torch.zeros((), dtype=torch.float32, device=x.device)
        logz_all = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for c in range(0, x.shape[0], chunk):
            logits = _chunk_logits(x[c:c + chunk], wf, bias, logit_scale)
            row_max = logits.amax(dim=-1)
            dist.all_reduce(row_max, op=dist.ReduceOp.MAX, group=tp.group)
            local = targets[c:c + chunk] - lo
            inside = (local >= 0) & (local < w.shape[0])
            gold = logits.gather(-1, local.clamp(0, w.shape[0] - 1)[:, None])[:, 0]
            sums = torch.stack([torch.exp(logits - row_max[:, None]).sum(dim=-1),
                                torch.where(inside, gold, torch.zeros_like(gold))])
            dist.all_reduce(sums, group=tp.group)
            logz = row_max + torch.log(sums[0])
            logz_all[c:c + chunk] = logz
            m = mask[c:c + chunk]
            nll = nll + ((logz - sums[1]) * m).sum()
            z = z + (torch.square(logz) * m).sum()
        ctx.save_for_backward(x, w, bias, targets, mask, logz_all)
        ctx.logit_scale, ctx.chunk, ctx.lo = logit_scale, chunk, lo
        return nll, z

    @staticmethod
    def backward(ctx, g_nll, g_z):
        x, w, bias, targets, mask, logz_all = ctx.saved_tensors
        wf = w.float()
        V_local = w.shape[0]
        dx = torch.empty_like(x)
        dw = torch.zeros_like(wf)
        db = None if bias is None else torch.zeros(bias.shape, dtype=torch.float32,
                                                   device=bias.device)
        for c in range(0, x.shape[0], ctx.chunk):
            xc = x[c:c + ctx.chunk]
            logits = _chunk_logits(xc, wf, bias, ctx.logit_scale)
            logz = logz_all[c:c + ctx.chunk]
            m = mask[c:c + ctx.chunk]
            row = m * g_nll + 2.0 * m * logz * g_z
            dlogits = torch.exp(logits - logz[:, None]) * row[:, None]
            local = targets[c:c + ctx.chunk] - ctx.lo
            inside = (local >= 0) & (local < V_local)
            dlogits.scatter_add_(-1, local.clamp(0, V_local - 1)[:, None],
                                 -(m * g_nll * inside)[:, None])
            if ctx.logit_scale:
                dlogits = dlogits * ctx.logit_scale
            dx[c:c + ctx.chunk] = (dlogits @ wf).to(x.dtype)
            dw += dlogits.t() @ xc.float()
            if db is not None:
                db += dlogits.sum(dim=0)
        return (dx, dw.to(w.dtype), None if db is None else db.to(bias.dtype),
                None, None, None, None, None)


def fused_cross_entropy(
    hidden: torch.Tensor,
    w_vd: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    bias_v: Optional[torch.Tensor] = None,
    logit_scale: Optional[float] = None,
    chunk: int = 2048,
    with_z: bool = False,
    tp=None,
):
    """Masked NLL sum without the full logits.

    hidden [B, S, D] (compute dtype), w_vd [V, D], targets [B, S] int,
    mask [B, S] 0/1, bias_v [V] optional. Returns the fp32 sum of masked
    token NLLs (the caller divides by the token count); with ``with_z``
    ``(nll_sum, z_sum)``. ``tp`` (``parallel.collectives.Tp``): ``w_vd``
    holds this rank's vocab rows (``bias_v`` stays whole)."""
    B, S, D = hidden.shape
    N = B * S
    chunk = max(min(int(chunk), N), 1)
    x = hidden.reshape(N, D)
    t, m = targets.reshape(N).long(), mask.reshape(N).float()
    if tp is not None:
        lo = tp.coord * w_vd.shape[0]
        if bias_v is not None:
            bias_v = tp.copy(bias_v).narrow(-1, lo, w_vd.shape[0])
        nll, z = _FusedCETp.apply(tp.copy(x), w_vd, bias_v, t, m, logit_scale, chunk, tp)
    else:
        nll, z = _FusedCE.apply(x, w_vd, bias_v, t, m, logit_scale, chunk)
    return (nll, z) if with_z else nll


def auto_chunk(batch: int, seq: int, vocab: int) -> int:
    """``fused_ce_chunk: -1`` (auto): 2048-row chunks once the fp32 ``[B,
    S, V]`` logits reach 256 MB, else 0 (the plain path)."""
    if batch * seq * vocab * 4 < 256 * 1024 * 1024:
        return 0
    return 2048
