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

``fused_cross_entropy_sp`` (sequence-sharded, under a mesh) is not ported:
ROADMAP queue 1 item 10.
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


def fused_cross_entropy(
    hidden: torch.Tensor,
    w_vd: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    bias_v: Optional[torch.Tensor] = None,
    logit_scale: Optional[float] = None,
    chunk: int = 2048,
    with_z: bool = False,
):
    """Masked NLL sum without the full logits.

    hidden [B, S, D] (compute dtype), w_vd [V, D], targets [B, S] int,
    mask [B, S] 0/1, bias_v [V] optional. Returns the fp32 sum of masked
    token NLLs (the caller divides by the token count); with ``with_z``
    ``(nll_sum, z_sum)``."""
    B, S, D = hidden.shape
    N = B * S
    chunk = max(min(int(chunk), N), 1)
    nll, z = _FusedCE.apply(hidden.reshape(N, D), w_vd, bias_v,
                            targets.reshape(N).long(),
                            mask.reshape(N).float(), logit_scale, chunk)
    return (nll, z) if with_z else nll


def auto_chunk(batch: int, seq: int, vocab: int) -> int:
    """``fused_ce_chunk: -1`` (auto): 2048-row chunks once the fp32 ``[B,
    S, V]`` logits reach 256 MB, else 0 (the plain path)."""
    if batch * seq * vocab * 4 < 256 * 1024 * 1024:
        return 0
    return 2048
