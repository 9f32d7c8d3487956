"""Mixture-of-Experts feed-forward block, grouped (dropless) dispatch.

fp32 router -> top-k -> stable argsort by expert id -> gather into a
per-expert ``block_t``-aligned buffer -> three grouped GEMMs (SwiGLU,
``ops/grouped_matmul.gmm``) -> gate-weighted scatter-add combine. No expert
capacity and no dropped tokens; every shape follows from the token count, so
nothing waits on the host. This is the local path of the JAX package's
``models/moe.py::moe_block``; the expert-parallel and einsum dispatches and
the auxiliary losses (which serving discards) are not ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops import grouped_matmul as gm

Params = Dict[str, Any]


def init_moe_params(args, generator: torch.Generator, device="cuda",
                    dtype=torch.float32) -> Params:
    """Router ``[D, E]`` + stacked expert weights ``[E, ...]`` (drawn on the
    CPU from ``generator``, then moved)."""
    D, I, E = args.hidden_size, args.intermediate_size, args.num_local_experts
    std = 0.02
    res_std = std / (2 * args.num_layers) ** 0.5

    def dense(shape, s):
        return (torch.randn(shape, generator=generator) * s).to(device, dtype)

    return {
        "router": {"weight": dense((D, E), std)},
        "experts": {
            "w_gate": {"weight": dense((E, D, I), std)},
            "w_up": {"weight": dense((E, D, I), std)},
            "w_down": {"weight": dense((E, I, D), res_std)},
        },
    }


def _grouped_ffn(experts: Params, x_flat: torch.Tensor, gate_idx: torch.Tensor,
                 gate_w: torch.Tensor, num_experts: int,
                 block_t: int) -> torch.Tensor:
    """Sorted dropless expert FFN: ``x_flat [T, D]``, ``gate_idx [T, K]``,
    ``gate_w [T, K]`` -> ``[T, D]``.

    Selections are stably sorted by expert id (token-major inside each
    expert) and placed in a buffer where every expert's group is rounded up
    to a whole ``block_t`` tile; pad rows stay zero. The combine is an
    ``index_add_``: on CUDA it uses atomics, so the order of the K additions
    per token can change between runs (at most about one ulp per add)."""
    T, D = x_flat.shape
    K = gate_idx.shape[-1]
    TK = T * K
    dev = x_flat.device
    ids = gate_idx.reshape(TK)
    tok = torch.arange(TK, device=dev) // K

    # [E] selections per expert. Not torch.bincount: on CUDA it reads the
    # max id back to the host to size its output, a sync in every layer.
    counts = torch.zeros(num_experts, dtype=ids.dtype, device=dev) \
        .index_add_(0, ids, torch.ones_like(ids))
    padded = (counts + block_t - 1) // block_t * block_t
    p_off = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    raw_off = torch.cumsum(counts, 0) - counts  # group starts in sorted order

    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    rank = torch.arange(TK, device=dev) - raw_off[ids_s]
    dest = p_off[ids_s] + rank

    T_buf = gm.round_up(TK + num_experts * (block_t - 1), block_t)
    x_buf = x_flat.new_zeros((T_buf, D))
    x_buf[dest] = x_flat[tok[order]]  # dest rows are unique

    gs = padded.to(torch.int32)
    h = F.silu(gm.gmm(x_buf, experts["w_gate"]["weight"], gs, block_t)) \
        * gm.gmm(x_buf, experts["w_up"]["weight"], gs, block_t)
    y_buf = gm.gmm(h, experts["w_down"]["weight"], gs, block_t)

    w_s = gate_w.reshape(TK)[order].to(y_buf.dtype)
    out = x_flat.new_zeros((T, D))
    out.index_add_(0, tok[order], y_buf[dest] * w_s[:, None])
    return out


def moe_block(p: Params, x: torch.Tensor, args) -> torch.Tensor:
    """``x [B, S, D]`` -> ``[B, S, D]``: the router projects in the
    activation dtype and routes in fp32 (softmax, top-k, renormalised
    gates), then the grouped expert FFN runs over all ``B * S`` tokens."""
    B, S, D = x.shape
    E, K = args.num_local_experts, args.num_experts_per_tok
    router_logits = (x @ p["router"]["weight"].to(x.dtype)).float()
    probs = torch.softmax(router_logits, dim=-1)  # [B, S, E]
    gate_w, gate_idx = torch.topk(probs, K, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    out = _grouped_ffn(
        p["experts"], x.reshape(B * S, D), gate_idx.reshape(B * S, K),
        gate_w.reshape(B * S, K), E, gm.pick_block_t(B * S * K, E))
    return out.reshape(B, S, D)
