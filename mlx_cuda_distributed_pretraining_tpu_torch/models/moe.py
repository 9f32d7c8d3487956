"""Mixture-of-Experts feed-forward block: the JAX package's ``models/moe.py``
on one device.

Two dispatch implementations (``moe.impl`` in the model config,
``LlamaArgs.moe_impl``):

- ``grouped`` (default), dropless: fp32 router -> top-k -> stable argsort by
  expert id -> gather into a per-expert ``block_t``-aligned buffer -> three
  grouped GEMMs (SwiGLU, ``ops/grouped_matmul.gmm``, differentiable through
  the gmm and tgmm kernels) -> gate-weighted scatter-add combine. No expert
  capacity and no dropped tokens; every shape follows from the token count,
  so nothing waits on the host.
- ``einsum``, the GShard/Switch dispatch/combine-tensor formulation with a
  per-group expert capacity (tokens past it are dropped to the residual
  path). It is the JAX package's parity oracle for the grouped path and
  reaches no kernel, so it stays plain PyTorch.

Quantized expert banks (``models/quantize.py``: ``weight_q`` / ``weight_q4``
with per-(expert, out-channel) ``weight_s``) are cast to the activation
dtype whole and run the same grouped GEMMs; the scales multiply each
GEMM's result (:func:`_expert_bank`). The router stays full precision.

The router's load-balancing and z losses come back pre-scaled beside the
output. Routing stats (``moe_load`` per expert, ``moe_dropped``) go to a list
the caller passes in, where the JAX package uses a trace-time tap; they stay
device tensors, so collecting them never waits on the device.

Under tensor parallelism the experts are split on their intermediate dim
(gate/up hold this rank's I/tp columns, down its rows): each rank runs the
grouped SwiGLU on its columns, the gate-weighted combine gives a partial
sum on ``[T, D]``, and one sum over tp follows it. The router stays
replicated; its gates enter the combine through ``tp.copy``, so their
gradient (and the router's) is the same on every tp rank. The
expert-parallel (``ep`` mesh) dispatch is not ported (ROADMAP queue 1 item
10b).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import grouped_matmul as gm
from ..parallel.collectives import all_reduce_axes, tp_of
from ..parallel.context import current_mesh

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


# -- routing stats and router losses ---------------------------------------------
def zero_stats(num_experts: int, device="cpu") -> Dict[str, torch.Tensor]:
    return {"moe_load": torch.zeros(num_experts, device=device),
            "moe_dropped": torch.zeros((), device=device)}


def merge_stats(entries: List[Dict[str, torch.Tensor]], num_experts: int,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Sum a list of stats dicts (layers, micro-batches) into one."""
    total = zero_stats(num_experts, device)
    for e in entries:
        total = {k: total[k] + e[k] for k in total}
    return total


def expert_capacity(seq_len: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Per-group slots each expert accepts (einsum impl only; the grouped
    impl is dropless)."""
    c = int(capacity_factor * k * seq_len / num_experts + 0.5)
    return max(1, min(c, seq_len * k))


def load_balancing_loss(probs: torch.Tensor, gate_idx_top1: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch Transformer aux loss ``E * sum_e f_e * P_e``: ``f_e`` the share
    of tokens whose top-1 expert is e, ``P_e`` the mean router probability."""
    f = F.one_hot(gate_idx_top1, num_experts).float().mean(dim=(0, 1))
    return num_experts * (f * probs.mean(dim=(0, 1))).sum()


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Mean squared logsumexp of the router logits."""
    z = torch.logsumexp(router_logits, dim=-1)
    return (z * z).mean()


def _data_ranks(mesh) -> int:
    return mesh.axis_size("dp") * mesh.axis_size("fsdp")


# -- quantized expert banks ------------------------------------------------------
def _expert_bank(experts: Params, name: str, dtype: torch.dtype):
    """One expert bank as ``(weights in dtype, scales [E, out] or None)``.
    A quantized bank (``models/quantize.py``: ``weight_q`` int8 ``[E, in,
    out]`` or ``weight_q4`` ``[E, in//2, out]``) is cast whole here, and the
    caller multiplies the matmul's result by its per-(expert, out-channel)
    scales, as in JAX. The cast banks go through the same gmm kernels as fp
    ones."""
    leaf = experts[name]
    if "weight_q4" in leaf:
        from .quantize import unpack_int4

        return unpack_int4(leaf["weight_q4"]).to(dtype), leaf["weight_s"]
    if "weight_q" in leaf:
        return leaf["weight_q"].to(dtype), leaf["weight_s"]
    return leaf["weight"], None


# -- einsum (GShard/Switch) implementation ---------------------------------------
def _dispatch_combine(probs: torch.Tensor, k: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``probs [B, S, E]`` -> dispatch ``[B, S, E, C]`` in {0, 1} and combine
    ``[B, S, E, C]`` carrying the renormalised top-k gates. Selections queue
    token-major per expert; those past ``capacity`` are dropped."""
    B, S, E = probs.shape
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    ohf = F.one_hot(gate_idx, E).to(probs.dtype).reshape(B, S * k, E)
    pos = torch.cumsum(ohf, dim=1) - ohf
    pos_in_expert = (pos * ohf).sum(-1)  # [B, S*K]
    keep = ((pos_in_expert < capacity) & (ohf.sum(-1) > 0)).to(probs.dtype)
    # one-hot over slots; a position past the capacity has none
    pos_oh = (pos_in_expert[..., None]
              == torch.arange(capacity, device=probs.device)).to(probs.dtype)
    dispatch_f = ohf[..., None] * pos_oh[:, :, None, :] * keep[..., None, None]
    combine_f = dispatch_f * gate_w.reshape(B, S * k)[..., None, None]
    dispatch = dispatch_f.reshape(B, S, k, E, capacity).sum(2)
    combine = combine_f.reshape(B, S, k, E, capacity).sum(2)
    return dispatch, combine


def _einsum_moe(p: Params, x: torch.Tensor, probs: torch.Tensor, args
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch/combine einsums over groups of ``moe_group_size`` tokens ->
    ``(out, dropped selections)``. Pad rows route on uniform probabilities,
    as zero-padded activations would; their outputs are sliced off."""
    B, S, D = x.shape
    E, K = args.num_local_experts, args.num_experts_per_tok
    g = min(int(args.moe_group_size or 256), S)
    S_pad = -(-S // g) * g
    x_in, probs_in = x, probs
    if S_pad != S:
        x_in = F.pad(x, (0, 0, 0, S_pad - S))
        probs_in = F.pad(probs, (0, 0, 0, S_pad - S), value=1.0 / E)
    xg = x_in.reshape(B * (S_pad // g), g, D)
    probs_g = probs_in.reshape(B * (S_pad // g), g, E)
    C = expert_capacity(g, E, K, args.moe_capacity_factor)

    dispatch, combine = _dispatch_combine(probs_g, K, C)
    kept = dispatch.sum((2, 3)).reshape(B, S_pad)[:, :S]
    dropped = (K * B * S - kept.sum()).detach()
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), xg)
    wg, sg = _expert_bank(p["experts"], "w_gate", expert_in.dtype)
    wu, su = _expert_bank(p["experts"], "w_up", expert_in.dtype)
    wd, sd = _expert_bank(p["experts"], "w_down", expert_in.dtype)

    def scaled(y, s):  # per-(expert, out-channel) dequant epilogue
        return y if s is None else y * s[:, None, None, :].to(y.dtype)

    h = F.silu(scaled(torch.einsum("ebcd,edi->ebci", expert_in, wg), sg)) \
        * scaled(torch.einsum("ebcd,edi->ebci", expert_in, wu), su)
    expert_out = scaled(torch.einsum("ebci,eid->ebcd", h, wd), sd)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), expert_out)
    return out.reshape(B, S_pad, D)[:, :S], dropped


# -- grouped (sort-based dropless) implementation ------------------------------------
def _grouped_ffn(experts: Params, x_flat: torch.Tensor, gate_idx: torch.Tensor,
                 gate_w: torch.Tensor, num_experts: int, block_t: int,
                 precision: Optional[str] = None) -> torch.Tensor:
    """Sorted dropless expert FFN: ``x_flat [T, D]``, ``gate_idx [T, K]``,
    ``gate_w [T, K]`` -> ``[T, D]`` in x's dtype. ``precision`` is
    ``model.matmul_precision``, handed to each gmm.

    Selections are stably sorted by expert id (token-major inside each
    expert) and placed in a buffer where every expert's group is rounded up
    to a whole ``block_t`` tile; pad rows stay zero. The combine is an
    ``index_add_``, and so is the backward of the gather from ``x_flat``
    (each token is read K times): on CUDA both use atomics, so the order of
    the K additions per token can change between runs (at most about one
    ulp per add)."""
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
    wg, sg = _expert_bank(experts, "w_gate", x_buf.dtype)
    wu, su = _expert_bank(experts, "w_up", x_buf.dtype)
    wd, sd = _expert_bank(experts, "w_down", x_buf.dtype)
    if sg is not None or su is not None or sd is not None:
        # expert of each buffer row (pad rows clamp to the last group; they
        # are zero, any scale will do)
        row_e = torch.searchsorted(torch.cumsum(gs, 0),
                                   torch.arange(T_buf, device=dev, dtype=gs.dtype),
                                   right=True).clamp_max(num_experts - 1)

        def scaled(y, s):  # per-row dequant epilogue
            return y if s is None else y * s[row_e].to(y.dtype)
    else:
        def scaled(y, s):
            return y

    h = F.silu(scaled(gm.gmm(x_buf, wg, gs, block_t, precision), sg)) \
        * scaled(gm.gmm(x_buf, wu, gs, block_t, precision), su)
    y_buf = scaled(gm.gmm(h, wd, gs, block_t, precision), sd)

    w_s = gate_w.reshape(TK)[order].to(y_buf.dtype)
    out = x_flat.new_zeros((T, D))
    out.index_add_(0, tok[order], (y_buf[dest] * w_s[:, None]).to(out.dtype))
    return out


# -- block entry point -----------------------------------------------------------
def moe_block(p: Params, x: torch.Tensor, args,
              stats: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> ``(out [B, S, D], aux)``.

    The router projects in the activation dtype and routes in fp32
    (softmax, top-k, renormalised gates). ``aux`` is fp32 and fully
    pre-scaled, ``moe_aux_weight * load_balance + router_z_weight *
    z_loss``; it depends on the router only, so both impls give the same.
    When ``stats`` is a list, this layer's ``{"moe_load" [E],
    "moe_dropped"}`` (fp32, no gradient) is appended to it."""
    B, S, D = x.shape
    E, K = args.num_local_experts, args.num_experts_per_tok
    impl = args.moe_impl or "grouped"
    router_logits = (x @ p["router"]["weight"].to(x.dtype)).float()
    probs = torch.softmax(router_logits, dim=-1)  # [B, S, E]
    mesh = current_mesh()
    tp = tp_of(mesh)
    gate = p["experts"]["w_gate"]
    if tp is not None and next(iter(gate.values())).shape[-1] == args.intermediate_size:
        tp = None  # whole experts: the one-device path
    xe = x if tp is None else tp.copy(x)

    if impl == "einsum":
        out, dropped = _einsum_moe(p, xe, probs if tp is None else tp.copy(probs), args)
        gate_idx = torch.topk(probs, K, dim=-1)[1]  # stats only
    elif impl == "grouped":
        gate_w, gate_idx = torch.topk(probs, K, dim=-1)
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        if tp is not None:
            gate_w = tp.copy(gate_w)
        out = _grouped_ffn(
            p["experts"], xe.reshape(B * S, D), gate_idx.reshape(B * S, K),
            gate_w.reshape(B * S, K), E, gm.pick_block_t(B * S * K, E),
            precision=args.matmul_precision).reshape(B, S, D)
        dropped = None
    else:
        raise ValueError(f"unknown moe impl {impl!r} (grouped|einsum)")
    if tp is not None:
        out = tp.reduce(out)

    aux = torch.zeros((), device=x.device)
    aw = float(args.moe_aux_weight or 0.0)
    zw = float(args.router_z_weight or 0.0)
    if mesh is not None and _data_ranks(mesh) > 1:
        # A mesh train step: the means are over the GLOBAL batch. f (no
        # gradient) is summed over the ranks first; the rest is linear in
        # this rank's rows, so the ranks' aux terms sum to the global one.
        rows = B * S * _data_ranks(mesh)
        if aw:
            f = F.one_hot(router_logits.argmax(-1), E).float().sum(dim=(0, 1))
            f = all_reduce_axes(f, mesh, ("dp", "fsdp")) / rows
            aux = aux + aw * (E * (f * probs.sum(dim=(0, 1)) / rows).sum())
        if zw:
            z = torch.logsumexp(router_logits, dim=-1)
            aux = aux + zw * ((z * z).sum() / rows)
    else:
        if aw:
            aux = aux + aw * load_balancing_loss(probs, router_logits.argmax(-1), E)
        if zw:
            aux = aux + zw * router_z_loss(router_logits)

    if stats is not None:
        ids = gate_idx.reshape(-1)
        load = torch.zeros(E, device=x.device).index_add_(
            0, ids, torch.ones(ids.shape, device=x.device))
        stats.append({"moe_load": load,
                      "moe_dropped": (torch.zeros((), device=x.device)
                                      if dropped is None else dropped.float())})
    return out, aux
