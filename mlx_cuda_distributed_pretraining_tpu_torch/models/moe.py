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
gradient (and the router's) is the same on every tp rank.

Under a mesh that names ``ep`` (more than one rank, E divisible by ep) the
grouped impl takes the expert-parallel sorted dispatch, as the JAX
package's ``moe_block`` does under its current mesh
(:func:`_grouped_moe_ep`): each rank routes its rows, sends them to the
ranks that hold their experts through one ``all_to_all`` over the ep group,
runs the grouped SwiGLU over its E/ep experts and sends the rows back
through a second. ``moe_ep_capacity_factor > 0`` caps the send slots and
counts the selections past them as dropped. On a mesh that names no
``ep`` the local path runs (JAX fails there: ``unbound axis name: ep``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import grouped_matmul as gm
from ..parallel.collectives import Tp, all_reduce_axes, all_to_all, tp_of
from ..parallel.context import current_mesh
from ..parallel.mesh import DATA_AXES

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
    n = 1
    for a in DATA_AXES:
        n *= mesh.axis_size(a)
    return n


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


def _maybe_dequant_experts(p: Params, dtype: torch.dtype) -> Params:
    """``p`` with fp expert banks in ``dtype``: the expert-parallel dispatch
    ships whole fp banks (JAX's ``_maybe_dequant_experts``), where the
    local path scales each matmul's result instead."""
    experts = p["experts"]
    if not any("weight_q" in leaf or "weight_q4" in leaf for leaf in experts.values()):
        return p
    from .quantize import dequantize_leaf

    return {**p, "experts": {name: {"weight": dequantize_leaf(leaf, dtype)}
                             for name, leaf in experts.items()}}


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


# -- expert parallelism -----------------------------------------------------------
def _usable_ep_mesh(num_experts: int):
    """The current mesh when the expert-parallel dispatch applies, else None
    (the local path): JAX's ``_usable_ep_mesh`` over a mesh of more than one
    rank whose ``ep`` divides E, that also names ``ep`` (JAX takes the
    dispatch on a mesh without it and fails on the unbound axis; the port
    keeps the local path there). JAX also returns None inside another
    shard_map (a pipeline stage's body); the port has no such body."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1 or "ep" not in mesh.axis_names:
        return None
    if num_experts % mesh.axis_size("ep"):
        return None
    return mesh


def ep_capacity(tk: int, ep: int, factor: float) -> int:
    """Send slots per (source, destination) pair of the ep exchange for
    ``tk`` local selections: all of them at ``factor <= 0`` (dropless),
    else ``factor * tk / ep`` rounded, within ``[1, tk]``."""
    return tk if factor <= 0 else max(1, min(tk, int(factor * tk / ep + 0.5)))


def _local_bank(w: torch.Tensor, num_experts: int, mesh) -> torch.Tensor:
    """This rank's ``[E/ep, ...]`` block of an expert bank: the bank itself
    when the train step already split it over ep, else its slice."""
    ep = mesh.axis_size("ep")
    if ep > 1 and w.shape[0] == num_experts:
        e_loc = num_experts // ep
        return w.narrow(0, mesh.coord("ep") * e_loc, e_loc)
    return w


def _whole_banks(p: Params, num_experts: int, mesh) -> Params:
    """``p`` with every ep-split expert leaf gathered whole over ep (the
    einsum impl, which JAX runs under GSPMD on the whole banks); the
    backward sums the ranks' gradients and keeps this rank's block."""
    ep = Tp(mesh, "ep")
    return {**p, "experts": {
        name: {k: (ep.gather_sum(v, 0) if v.shape[0] * ep.n == num_experts else v)
               for k, v in leaf.items()}
        for name, leaf in p["experts"].items()}}


def _grouped_moe_ep(p: Params, x: torch.Tensor, gate_idx: torch.Tensor,
                    gate_w: torch.Tensor, args, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel sorted dispatch (JAX's ``_grouped_moe_ep``, its
    shard_map body on this rank) -> ``(out [b, S, D], dropped)``, ``x``
    this rank's rows and ``dropped`` the selections past capacity summed
    over every mesh axis (no gradient).

    Selections are stably sorted by the rank that holds their expert
    (``id // (E/ep)``), token-major within each, and the first ``cap`` of
    each go into that rank's ``cap`` send slots; one ``all_to_all`` over
    the ep group delivers them with their local expert ids (empty slots
    carry the sentinel id ``E/ep``, which sorts past every real group).
    The receiver runs the grouped SwiGLU over its ``ep * cap`` rows in
    ``block_t``-aligned groups (``gm.pick_block_t(ep * cap, E/ep)``) and a
    second ``all_to_all`` returns the rows; the gate weighting and the
    combine's scatter-add stay on the source rank, so the gradients run
    back through the same two exchanges."""
    tp = tp_of(mesh)
    if tp is not None:
        raise NotImplementedError(
            f"mesh {mesh.shape}: expert parallelism with tp > 1 is not ported "
            "(ROADMAP queue 1 item 10b-tp); train ep without tp")
    b_l, S, D = x.shape
    E, K = args.num_local_experts, args.num_experts_per_tok
    ep = mesh.axis_size("ep")
    e_loc = E // ep
    T_l = b_l * S
    TK = T_l * K
    cap = ep_capacity(TK, ep, float(args.moe_ep_capacity_factor or 0.0))
    block_t = gm.pick_block_t(ep * cap, e_loc)
    dev = x.device
    p = _maybe_dequant_experts(p, x.dtype)
    wg, wu, wd = (_local_bank(p["experts"][n]["weight"], E, mesh)
                  for n in ("w_gate", "w_up", "w_down"))

    xf = x.reshape(T_l, D)
    ids = gate_idx.reshape(TK)
    gwf = gate_w.reshape(TK)
    tok = torch.arange(TK, device=dev) // K
    dest_shard = ids // e_loc
    local_eid = ids % e_loc

    # send slots: a stable sort by destination rank (token-major within each)
    order = torch.argsort(dest_shard, stable=True)
    ds_s = dest_shard[order]
    cnt = torch.zeros(ep, dtype=ids.dtype, device=dev).index_add_(
        0, dest_shard, torch.ones_like(dest_shard))
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(TK, device=dev) - start[ds_s]
    keep = rank < cap
    slot = ds_s * cap + rank
    R = ep * cap
    slot_put = torch.where(keep, slot, torch.full_like(slot, R))  # row R: dropped
    send_x = xf.new_zeros((R + 1, D))
    send_x[slot_put] = xf[tok[order]]
    send_id = torch.full((R + 1,), e_loc, dtype=ids.dtype, device=dev)
    send_id[slot_put] = local_eid[order]

    rx = all_to_all(send_x[:R], mesh, "ep")
    rid = all_to_all(send_id[:R], mesh, "ep")

    # the local grouped FFN over the E/ep resident experts
    counts = torch.zeros(e_loc + 1, dtype=rid.dtype, device=dev).index_add_(
        0, rid, torch.ones_like(rid))[:e_loc]  # the sentinels fall off
    padded = (counts + block_t - 1) // block_t * block_t
    p_off = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    raw_off = torch.cumsum(counts, 0) - counts
    order2 = torch.argsort(rid, stable=True)
    rid_s = rid[order2]
    real2 = rid_s < e_loc
    rid_c = rid_s.clamp_max(e_loc - 1)
    rank2 = torch.arange(R, device=dev) - raw_off[rid_c]
    T_buf = gm.round_up(R + e_loc * (block_t - 1), block_t)
    dest2 = torch.where(real2, p_off[rid_c] + rank2, torch.full_like(rank2, T_buf))
    x_buf = rx.new_zeros((T_buf + 1, D))
    x_buf[dest2] = rx[order2]
    x_buf = x_buf[:T_buf]

    gs = padded.to(torch.int32)
    prec = args.matmul_precision
    h = F.silu(gm.gmm(x_buf, wg, gs, block_t, prec)) * gm.gmm(x_buf, wu, gs, block_t, prec)
    y_buf = gm.gmm(h, wd, gs, block_t, prec)

    y_sorted = y_buf[dest2.clamp_max(T_buf - 1)] * real2[:, None].to(y_buf.dtype)
    y_recv = y_sorted.new_zeros((R, D)).index_copy(0, order2, y_sorted)
    y_back = all_to_all(y_recv, mesh, "ep")

    y_sel = y_back[slot.clamp_max(R - 1)] * keep[:, None].to(y_back.dtype)
    out = x.new_zeros((T_l, D))
    out.index_add_(0, tok[order], (y_sel * gwf[order][:, None].to(y_sel.dtype)).to(out.dtype))
    # JAX's psum over every mesh axis
    dropped = all_reduce_axes((TK - keep.sum()).float().detach(), mesh, mesh.axis_names)
    return out.reshape(b_l, S, D), dropped


# -- block entry point -----------------------------------------------------------
def moe_block(p: Params, x: torch.Tensor, args,
              stats: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> ``(out [B, S, D], aux)``.

    The router projects in the activation dtype and routes in fp32
    (softmax, top-k, renormalised gates). ``aux`` is fp32 and fully
    pre-scaled, ``moe_aux_weight * load_balance + router_z_weight *
    z_loss``; it depends on the router only, so both impls give the same.
    When ``stats`` is a list, this layer's ``{"moe_load" [E],
    "moe_dropped"}`` (fp32, no gradient) is appended to it: the load counts
    this rank's rows (the train step sums it over the data axes), the drops
    are the global count under a mesh, as in JAX."""
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
        if mesh is not None and mesh.axis_size("ep") > 1:
            p = _whole_banks(p, E, mesh)
        out, dropped = _einsum_moe(p, xe, probs if tp is None else tp.copy(probs), args)
        gate_idx = torch.topk(probs, K, dim=-1)[1]  # stats only
        if mesh is not None and _data_ranks(mesh) > 1:
            dropped = all_reduce_axes(dropped.float(), mesh, DATA_AXES)  # global rows
    elif impl == "grouped":
        gate_w, gate_idx = torch.topk(probs, K, dim=-1)
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        ep_mesh = _usable_ep_mesh(E)
        if ep_mesh is not None:
            out, dropped = _grouped_moe_ep(p, x, gate_idx, gate_w, args, ep_mesh)
        else:
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
            f = all_reduce_axes(f, mesh, DATA_AXES) / rows
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
