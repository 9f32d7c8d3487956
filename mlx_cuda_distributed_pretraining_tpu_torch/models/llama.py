"""Llama decoder: the building blocks of the serving steps, the cache-free
training forward and loss, and the static KV cache of the locked
generation path (``infer/generate.py``).

Parameters are the JAX package's nested dict with torch tensors as leaves and
the same layout: every linear weight is ``[in, out]`` (``y = x @ W``), expert
banks are ``[E, in, out]``, and ``layers`` is a list. So a checkpoint written
by either package maps name for name (``layers.3.attention.wq.weight``) with
no transposes. RMSNorm and RoPE compute in fp32 whatever the input dtype.

Under a mesh with a ``tp`` axis (``parallel/context.py``'s current mesh)
the blocks take this rank's tp blocks of the weights (the rules of
``parallel/sharding_rules.py``) and issue the Megatron collectives
(``parallel/collectives.py`` :class:`Tp`): q/k/v, gate and up are
column-parallel, wo and w_down row-parallel and summed over tp, the
embedding and the output projection vocab-parallel. Whether a weight is
split is read from its shape, so full weights under a tp mesh run the
one-device path, and the sums over tp are issued in the same order on
every rank (the recompute of a remat'd layer issues them again, in the
same order).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..ops import fused_ce
from ..parallel.collectives import tp_of
from ..parallel.context import current_mesh
from ..parallel.overlap import active_plan
from ..utils.tree import flatten_dict

Params = Dict[str, Any]

# -- named remat policies ----------------------------------------------------
# The JAX package's policies (its models/llama.py:37-110), on
# torch.utils.checkpoint (non-reentrant) per wrapped layer:
#   "full"      keeps nothing: the layer's forward runs again in the backward;
#   "dots"      keeps the matmul outputs without batch dims (the projections,
#               ``aten.mm``; attention's batched products are other ops and
#               are recomputed), as checkpoint_dots_with_no_batch_dims;
#   "save_attn" keeps the activations tagged "qkv" (the q/k/v projections,
#               pre-RoPE) and "attn_out" (the attention output, pre-wo), as
#               save_only_these_names("qkv", "attn_out").
# The tags are ``aten.alias`` views (no copy), which only those two sites
# make, so the save_attn policy saves exactly the tagged tensors. JAX also
# tags "ffn_up" and "ffn_down"; no policy reads them, and they are left out.
SAVE_ATTN_NAMES = ("qkv", "attn_out")
REMAT_POLICIES = ("none", "dots", "full", "save_attn")
_SAVED_OPS = {
    "dots": [torch.ops.aten.mm.default],
    "save_attn": [torch.ops.aten.alias.default],
}


def normalize_remat(remat: Optional[str]) -> Optional[str]:
    """"none"/"" -> None; unknown names raise (a typo'd policy must not
    train without remat)."""
    if remat is None or remat == "":
        return None
    name = str(remat).lower()
    if name == "none":
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r} (expected one of "
                         f"{REMAT_POLICIES})")
    return name


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag an activation for the ``save_attn`` policy (``name`` is one of
    :data:`SAVE_ATTN_NAMES`): a view of ``x`` through ``aten.alias``."""
    return torch.ops.aten.alias(x)


def remat_wrap(remat: Optional[str]):
    """``wrap(fn, *args)`` that runs ``fn(*args)`` under the named policy's
    checkpoint, or None for no remat. The layer draws no random numbers,
    so the RNG state is not saved for the recompute."""
    remat = normalize_remat(remat)
    if remat is None:
        return None
    kw = {}
    if remat in _SAVED_OPS:
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _SAVED_OPS[remat])

    def wrap(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return wrap


@dataclass(frozen=True)
class LlamaArgs:
    vocab_size: int = 259
    hidden_size: int = 128
    intermediate_size: int = 256
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 16
    max_position_embeddings: int = 1024
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_traditional: bool = False
    rope_scaling_factor: Optional[float] = None
    attention_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = True
    logit_scale: Optional[float] = None
    attention_type: str = "simple"  # simple | flash | flex | ring
    mask_type: str = "causal"  # causal | sliding_window | prefix_lm
    window_size: int = 512
    prefix_len: int = 0
    score_mod_type: Optional[str] = None  # None | alibi | soft_cap
    soft_cap: float = 50.0
    num_local_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25  # einsum impl only
    moe_aux_weight: float = 0.01
    router_z_weight: float = 0.0
    moe_group_size: int = 256  # einsum impl only
    moe_impl: str = "grouped"  # grouped | einsum
    moe_ep_capacity_factor: float = 0.0  # ep meshes: send slots (0 = dropless)
    matmul_precision: Optional[str] = None  # None/fp32 | bf16 | int8

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0 and self.num_experts_per_tok > 0

    @classmethod
    def from_config(cls, model_cfg: Any, vocab_size: int) -> "LlamaArgs":
        """Same field mapping as the JAX ``LlamaArgs.from_config``, for the
        fields the port reads (``aux_loss_weight: 0`` or null reads as 0.0,
        an absent one as 0.01)."""
        att = dict(getattr(model_cfg, "attention", None) or {})
        rope = dict(getattr(model_cfg, "rope", None) or {})
        misc = dict(getattr(model_cfg, "misc", None) or {})
        norm = dict(getattr(model_cfg, "normalization", None) or {})
        moe = dict(getattr(model_cfg, "moe", None) or {})
        scaling = rope.get("scaling") or {}
        scale_factor = scaling.get("factor") if isinstance(scaling, dict) else None
        args = cls(
            vocab_size=vocab_size,
            hidden_size=model_cfg.hidden_size,
            intermediate_size=model_cfg.intermediate_size,
            num_layers=model_cfg.num_layers,
            num_heads=model_cfg.num_heads,
            num_kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.head_dim,
            max_position_embeddings=int(att.get("max_position_embeddings") or 0)
            or 4096,
            rms_norm_eps=float(norm.get("rms_norm_eps", 1e-5)),
            rope_theta=float(rope.get("theta", 10000.0)),
            rope_traditional=bool(rope.get("traditional", False)),
            rope_scaling_factor=float(scale_factor) if scale_factor else None,
            attention_bias=bool(misc.get("attention_bias", False)),
            mlp_bias=bool(misc.get("mlp_bias", False)),
            tie_word_embeddings=bool(misc.get("tie_word_embeddings", True)),
            logit_scale=misc.get("logit_scale"),
            attention_type=model_cfg.attention_type,
            mask_type=str(att.get("mask_type", "causal")),
            window_size=int(att.get("window_size", 512)),
            prefix_len=int(att.get("prefix_len", 0)),
            score_mod_type=att.get("score_mod"),
            soft_cap=float(att.get("soft_cap", 50.0)),
            num_local_experts=int(moe.get("num_local_experts", 0) or 0),
            num_experts_per_tok=int(moe.get("num_experts_per_tok", 0) or 0),
            moe_capacity_factor=float(moe.get("capacity_factor", 1.25) or 1.25),
            moe_aux_weight=float(moe.get("aux_loss_weight", 0.01) or 0.0),
            router_z_weight=float(moe.get("router_z_weight", 0.0) or 0.0),
            moe_group_size=int(moe.get("group_size", 256) or 256),
            moe_impl=str(moe.get("impl", "grouped") or "grouped"),
            moe_ep_capacity_factor=float(moe.get("ep_capacity_factor", 0.0) or 0.0),
            matmul_precision=getattr(model_cfg, "matmul_precision", None),
        )
        return args


# -- init ---------------------------------------------------------------------
def init_params(args: LlamaArgs, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Params:
    """normal(0.02) embeddings/projections, residual output projections
    scaled by 1/sqrt(2 * num_layers), ones for norms. Values are drawn on the
    CPU from ``generator`` (a CPU ``torch.Generator``) and then moved, so one
    seed gives the same weights on every device."""
    std = 0.02
    res_std = std / (2 * args.num_layers) ** 0.5
    D, Dh = args.hidden_size, args.head_dim
    Hq, Hkv, I = args.num_heads, args.num_kv_heads, args.intermediate_size

    def dense(shape, s):
        return (torch.randn(shape, generator=generator) * s).to(device, dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    layers = []
    for _ in range(args.num_layers):
        layer = {
            "attention_norm": {"weight": ones(D)},
            "attention": {
                "wq": {"weight": dense((D, Hq * Dh), std)},
                "wk": {"weight": dense((D, Hkv * Dh), std)},
                "wv": {"weight": dense((D, Hkv * Dh), std)},
                "wo": {"weight": dense((Hq * Dh, D), res_std)},
            },
            "ffn_norm": {"weight": ones(D)},
        }
        if args.is_moe:
            from .moe import init_moe_params

            layer["feed_forward"] = init_moe_params(args, generator, device, dtype)
        else:
            layer["feed_forward"] = {
                "w_gate": {"weight": dense((D, I), std)},
                "w_up": {"weight": dense((D, I), std)},
                "w_down": {"weight": dense((I, D), res_std)},
            }
        if args.attention_bias:
            for name, fan_out in (("wq", Hq * Dh), ("wk", Hkv * Dh),
                                  ("wv", Hkv * Dh), ("wo", D)):
                layer["attention"][name]["bias"] = zeros(fan_out)
        if args.mlp_bias:
            if args.is_moe:
                raise ValueError("mlp_bias is not supported with MoE")
            for name, fan_out in (("w_gate", I), ("w_up", I), ("w_down", D)):
                layer["feed_forward"][name]["bias"] = zeros(fan_out)
        layers.append(layer)

    params: Params = {
        "tok_embeddings": {"weight": dense((args.vocab_size, D), std)},
        "layers": layers,
        "norm": {"weight": ones(D)},
    }
    if not args.tie_word_embeddings:
        params["output"] = {"weight": dense((D, args.vocab_size), std)}
    return params


def num_params(params: Params) -> int:
    return sum(t.numel() for t in flatten_dict(params).values())


# -- building blocks -----------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32-internal RMSNorm."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``x @ W (+ b)`` with W ``[in, out]``. A quantized leaf
    (``models/quantize.py``: ``weight_q`` int8, or ``weight_q4`` two int4
    values a byte along ``in``) is cast to x's dtype whole and its
    per-output-channel scale ``weight_s`` multiplies the result, as in JAX,
    where XLA fuses the cast into the matmul; eager PyTorch materializes it."""
    if "weight_q4" in p:
        from .quantize import unpack_int4

        y = (x @ unpack_int4(p["weight_q4"]).to(x.dtype)) * p["weight_s"].to(x.dtype)
    elif "weight_q" in p:
        y = (x @ p["weight_q"].to(x.dtype)) * p["weight_s"].to(x.dtype)
    else:
        y = x @ p["weight"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _out_dim(p: Params) -> int:
    """The output width of a linear leaf (fp, int8 or packed int4)."""
    for name in ("weight", "weight_q", "weight_q4"):
        if name in p:
            return p[name].shape[-1]
    raise KeyError(f"no weight in linear leaf {sorted(p)}")


def current_tp():
    """The tp axis of the current mesh (:class:`parallel.collectives.Tp`),
    or None."""
    return tp_of(current_mesh())


def _col_linear(x: torch.Tensor, p: Params, tp) -> torch.Tensor:
    """A column-parallel ``x @ W (+ b)``: W holds this rank's output
    columns; a replicated bias is cut to them (through ``tp.copy``, so its
    gradient is the sum of the ranks' blocks)."""
    bias = p.get("bias")
    y = _linear(x, {k: v for k, v in p.items() if k != "bias"})
    if bias is not None:
        if bias.shape[-1] != y.shape[-1]:
            lo = tp.coord * y.shape[-1]
            bias = tp.copy(bias).narrow(-1, lo, y.shape[-1])
        y = y + bias
    return y


def _row_linear(x: torch.Tensor, p: Params, tp) -> torch.Tensor:
    """A row-parallel ``x @ W``: this rank's rows of W on its columns of
    x, summed over tp, then the (replicated) bias once."""
    y = tp.reduce(_linear(x, {k: v for k, v in p.items() if k != "bias"}))
    return y + p["bias"] if "bias" in p else y


def quantize_params_int8(params: Params) -> Params:
    """Weight-only int8 for inference: per-output-channel symmetric scales
    on every layer linear (wq/wk/wv/wo, the dense MLP and the MoE expert
    banks); embeddings, the output head, norms, biases and routers stay
    full precision. ``models/quantize.py`` also has int4."""
    from .quantize import quantize_weights

    return quantize_weights(params, "int8")


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling_factor: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions ``[...]`` -> ``[..., head_dim // 2]``,
    fp32 (``[S]`` for one shared position vector, ``[B, S]`` per row)."""
    pos = positions.float()
    if scaling_factor:
        pos = pos / scaling_factor
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=pos.device,
                                             dtype=torch.float32) / head_dim))
    angles = pos[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               traditional: bool = False) -> torch.Tensor:
    """Rotate ``x [B, S, H, D]`` by tables ``[S, D//2]`` (or any shape that
    broadcasts as ``[B, S, 1, D//2]`` once the head axis is inserted).
    ``traditional`` = interleaved pairs; default = half-split (llama)."""
    xf = x.float()
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    if traditional:
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x1 = xf[..., :half]
        x2 = xf[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def mlp_block(p: Params, x: torch.Tensor, intermediate: Optional[int] = None
              ) -> torch.Tensor:
    """Canonical SwiGLU: ``down(silu(gate(x)) * up(x))``. Under tp, with
    gate/up holding this rank's columns (narrower than ``intermediate``),
    gate/up are column-parallel and down row-parallel."""
    tp = current_tp()
    if tp is None or intermediate is None or _out_dim(p["w_gate"]) == intermediate:
        return _linear(F.silu(_linear(x, p["w_gate"])) * _linear(x, p["w_up"]),
                       p["w_down"])
    xc = tp.copy(x)
    h = F.silu(_col_linear(xc, p["w_gate"], tp)) * _col_linear(xc, p["w_up"], tp)
    return _row_linear(h, p["w_down"], tp)


def init_paged_cache(args: LlamaArgs, num_blocks: int, block_size: int,
                     device="cuda", dtype=torch.float32,
                     quantize: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Paged KV arena: per layer ``{"k", "v"}`` of ``[num_blocks,
    block_size, Hkv, Dh]``, or with ``quantize`` the int8 quartet ``{"k_q",
    "k_s", "v_q", "v_s"}`` (int8 values, fp32 scales ``[num_blocks,
    block_size, Hkv, 1]``), addressed through per-sequence block tables.
    The serving steps write it in place."""
    shape = (num_blocks, block_size, args.num_kv_heads, args.head_dim)
    if quantize:
        scale = shape[:3] + (1,)
        return [{"k_q": torch.zeros(shape, device=device, dtype=torch.int8),
                 "k_s": torch.zeros(scale, device=device),
                 "v_q": torch.zeros(shape, device=device, dtype=torch.int8),
                 "v_s": torch.zeros(scale, device=device)}
                for _ in range(args.num_layers)]
    return [{"k": torch.zeros(shape, device=device, dtype=dtype),
             "v": torch.zeros(shape, device=device, dtype=dtype)}
            for _ in range(args.num_layers)]


def init_cache(args: LlamaArgs, batch_size: int, max_len: Optional[int] = None,
               dtype=torch.float32, quantize: bool = False,
               device="cuda") -> List[Dict[str, Any]]:
    """Static KV cache of the locked generation path: per layer ``{"k",
    "v"}`` of ``[B, T, Hkv, Dh]`` in ``dtype``, or with ``quantize`` the
    int8 quartet ``{"k_q", "k_s", "v_q", "v_s"}`` (int8 values, fp32 scales
    ``[B, T, Hkv, 1]`` per position and head), plus ``"pos"``: the next
    position to write, a host int. T defaults to
    ``max_position_embeddings``. :func:`forward` writes it in place."""
    T = max_len or args.max_position_embeddings
    shape = (batch_size, T, args.num_kv_heads, args.head_dim)
    scale = (batch_size, T, args.num_kv_heads, 1)
    if quantize:
        return [{"k_q": torch.zeros(shape, device=device, dtype=torch.int8),
                 "k_s": torch.zeros(scale, device=device),
                 "v_q": torch.zeros(shape, device=device, dtype=torch.int8),
                 "v_s": torch.zeros(scale, device=device),
                 "pos": 0}
                for _ in range(args.num_layers)]
    return [{"k": torch.zeros(shape, device=device, dtype=dtype),
             "v": torch.zeros(shape, device=device, dtype=dtype),
             "pos": 0}
            for _ in range(args.num_layers)]


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(batch, position, head) quantization of ``[B, S,
    H, D]`` -> (int8 values, fp32 scales ``[B, S, H, 1]``). ``torch.round``
    rounds half to even, as ``jnp.round`` does, so both packages store the
    same values."""
    xf = x.float()
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can land one ulp off the CPU's (and JAX's) quotient
    scale = (xf.abs().amax(dim=-1, keepdim=True)
             / torch.full((), 127.0, device=x.device)).clamp_min(1e-8)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, pos: int, S: int) -> torch.Tensor:
    """Attention over a prefix of the static cache under the positional
    validity mask: keys at or before each query, and already written. The
    config's mask type and score mod are not applied here, as in JAX."""
    from ..ops.attention import reference_attention

    k_idx = torch.arange(k.shape[1], device=q.device)
    explicit = (k_idx[None, :] <= positions[:, None]) & (k_idx[None, :] < pos + S)
    return reference_attention(q, k, v, explicit_mask=explicit)


def _cache_write(cache: Dict[str, Any], name: str, value: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """Write ``value [B, S, ...]`` into ``cache[name]`` at ``pos`` in place
    and return the buffer. A write past the end raises (JAX's
    ``dynamic_update_slice`` would move it back to fit)."""
    buf = cache[name]
    S = value.shape[1]
    if pos + S > buf.shape[1]:
        raise ValueError(f"cache write at {pos} of {S} positions overruns "
                         f"the cache's {buf.shape[1]}")
    buf[:, pos:pos + S] = value.to(buf.dtype)
    return buf


def _attend_cache(cache: Dict[str, Any], q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, positions: torch.Tensor,
                  attend_len: Optional[int]) -> torch.Tensor:
    """Write this call's K/V at ``cache["pos"]``, advance it, and attend
    over the first ``attend_len`` slots (all of them when None); an int8
    cache stores ``_quantize_kv``'s values and attends over their fp32
    dequantization."""
    pos, S = cache["pos"], q.shape[1]
    if "k_q" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        ck_q = _cache_write(cache, "k_q", kq, pos)
        ck_s = _cache_write(cache, "k_s", ks, pos)
        cv_q = _cache_write(cache, "v_q", vq, pos)
        cv_s = _cache_write(cache, "v_s", vs, pos)
        L = attend_len or ck_q.shape[1]
        keys = ck_q[:, :L].float() * ck_s[:, :L]
        values = cv_q[:, :L].float() * cv_s[:, :L]
    else:
        ck = _cache_write(cache, "k", k, pos)
        cv = _cache_write(cache, "v", v, pos)
        L = attend_len or ck.shape[1]
        keys, values = ck[:, :L], cv[:, :L]
    cache["pos"] = pos + S
    return _cached_attention(q, keys, values, positions, pos, S)


# -- the cache-free training path -------------------------------------------------
def build_mask_mod(args: LlamaArgs):
    from ..ops import masks

    if args.mask_type == "sliding_window":
        return masks.sliding_window(args.window_size)
    if args.mask_type == "prefix_lm":
        return masks.prefix_lm(args.prefix_len)
    return masks.causal()


def build_score_mod(args: LlamaArgs):
    """Score mod of the ``simple`` attention path over
    ``[B, Hkv, G, Sq, Skv]`` scores (alibi per head, or tanh soft-capping)."""
    if args.score_mod_type == "alibi":
        base = 2.0 ** (-8.0 / args.num_heads)
        slopes = torch.tensor([base ** i for i in range(1, args.num_heads + 1)],
                              dtype=torch.float32)

        def mod(scores, q_idx, k_idx):
            Hkv, G = scores.shape[1], scores.shape[2]
            slope = slopes.to(scores.device).reshape(Hkv, G)[None, :, :, None, None]
            return scores - slope * (q_idx - k_idx).abs()[None, None, None]

        return mod
    if args.score_mod_type == "soft_cap":
        return lambda s, q, k: args.soft_cap * torch.tanh(s / args.soft_cap)
    return None


def attention_block(p: Params, x: torch.Tensor, args: LlamaArgs,
                    positions: torch.Tensor, attn_impl: Optional[str] = None,
                    cache: Optional[Dict[str, Any]] = None,
                    attend_len: Optional[int] = None) -> torch.Tensor:
    """Self-attention with RoPE and GQA. With a static ``cache``
    (:func:`init_cache`) it writes this call's K/V there in place and
    attends over the cache (:func:`_attend_cache`). Cache-free: ``flash``
    runs the flash kernels (``ops/flash_attention.py``; with a score mod,
    the reference attention, as in JAX), ``flex`` the flash kernels under
    the config's mask plan and score-mod code (``ops/flex_attention.py``),
    ``simple`` the reference attention with the mask and score mods."""
    B, S, _ = x.shape
    tp = current_tp()
    if tp is not None and tp_split(p, args):
        q, k, v, pick = tp_qkv(p, x, args, tp)
        k, v = pick(k, v)
        out = _attend(q, k, v, args, positions, attn_impl, cache, attend_len)
        out = checkpoint_name(out.reshape(B, S, -1).to(x.dtype), "attn_out")
        return _row_linear(out, p["wo"], tp)
    Hq, Hkv, Dh = args.num_heads, args.num_kv_heads, args.head_dim
    q = checkpoint_name(_linear(x, p["wq"]), "qkv").reshape(B, S, Hq, Dh)
    k = checkpoint_name(_linear(x, p["wk"]), "qkv").reshape(B, S, Hkv, Dh)
    v = checkpoint_name(_linear(x, p["wv"]), "qkv").reshape(B, S, Hkv, Dh)
    out = _attend(q, k, v, args, positions, attn_impl, cache, attend_len)
    # matmul_precision "bf16" hands back bf16 under fp32 compute: promote as
    # JAX's bf16 @ fp32 does.
    out = checkpoint_name(out.reshape(B, S, Hq * Dh).to(x.dtype), "attn_out")
    return _linear(out, p["wo"])


def tp_split(p: Params, args: LlamaArgs) -> bool:
    """Whether an attention block's q/k/v hold tp blocks of their columns."""
    return any(_out_dim(p[w]) != h * args.head_dim for w, h in (
        ("wq", args.num_heads), ("wk", args.num_kv_heads), ("wv", args.num_kv_heads)))


def tp_kv_heads(args: LlamaArgs, tp_size: int) -> int:
    """The K/V heads a tp rank projects and caches: its block where the
    heads split whole, else all of them (:func:`tp_qkv`)."""
    whole = (tp_size > 1 and args.num_heads % tp_size == 0
             and args.num_kv_heads % tp_size == 0)
    return args.num_kv_heads // tp_size if whole else args.num_kv_heads


def tp_qkv(p: Params, x: torch.Tensor, args: LlamaArgs, tp):
    """``(q, k, v, pick)``: this tp rank's block of query heads (Hq/tp)
    and its K/V heads (:func:`tp_kv_heads`), from column-parallel
    projections; ``pick(k, v)``: the K/V heads its queries read.

    Where the K/V heads split whole over tp (Hkv % tp == 0), each rank
    keeps its block of them, the GQA groups intact. Where they do not
    (200m's 12/6 heads at tp 4: the rules still split the K/V columns,
    mid-head), the projection is gathered over tp (``gather_sum``: the
    backward sums the ranks' gradients) and each rank takes the K/V heads
    its queries read, as GQA groups when its queries start and end on a
    group, else one K/V head a query. A K/V projection the rules leave
    whole (its width does not divide) is computed whole, its weight
    through ``tp.copy`` (each rank uses part of it). Query heads that do
    not split over tp are refused: no config has them."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = args.num_heads, args.num_kv_heads, args.head_dim
    G = Hq // Hkv
    if args.score_mod_type == "alibi":
        raise NotImplementedError("alibi over tp-split heads: its slopes follow the "
                                  "global head index; train it without a tp axis")
    xc = tp.copy(x)

    def project(leaf, heads, gather):
        if _out_dim(leaf) == heads * Dh:  # left whole by the rules
            y = _linear(xc, {k: tp.copy(v) if v.is_floating_point() else v
                             for k, v in leaf.items()})
        else:
            y = _col_linear(xc, leaf, tp)
            if gather:
                y = tp.gather_sum(y, -1)
        y = checkpoint_name(y, "qkv")
        return y.reshape(B, S, -1, Dh)

    if Hq % tp.n or _out_dim(p["wq"]) == Hq * Dh:
        raise NotImplementedError(f"{Hq} query heads of {Dh} do not split over tp {tp.n}")
    kv_whole = tp_kv_heads(args, tp.n) != Hkv
    q = project(p["wq"], Hq, False)
    k = project(p["wk"], Hkv, not kv_whole)
    v = project(p["wv"], Hkv, not kv_whole)
    h0, hl = tp.coord * q.shape[2], q.shape[2]

    def pick(k, v):
        if kv_whole:
            return k, v
        if h0 % G == 0 and hl % G == 0:
            return k[:, :, h0 // G:(h0 + hl) // G], v[:, :, h0 // G:(h0 + hl) // G]
        idx = torch.arange(h0, h0 + hl, device=k.device) // G
        return k.index_select(2, idx), v.index_select(2, idx)

    return q, k, v, pick


def _attend(q, k, v, args: LlamaArgs, positions, attn_impl, cache, attend_len):
    """RoPE on q/k ``[B, S, H, D]``, then the attention of ``attn_impl``
    (or the config's) -> ``[B, S, Hq, D]``."""
    from ..ops.attention import reference_attention

    Dh = args.head_dim
    cos, sin = rope_cos_sin(positions, Dh, args.rope_theta,
                            args.rope_scaling_factor)
    q = apply_rope(q, cos, sin, args.rope_traditional)
    k = apply_rope(k, cos, sin, args.rope_traditional)
    impl = attn_impl or args.attention_type
    if cache is not None:
        out = _attend_cache(cache, q, k, v, positions, attend_len)
    elif impl == "flash" and args.score_mod_type is None:
        from ..ops.flash_attention import flash_attention

        out = flash_attention(q, k, v, mask_type=args.mask_type,
                              window_size=args.window_size,
                              prefix_len=args.prefix_len,
                              precision=args.matmul_precision)
    elif impl == "flex":
        from ..ops.flex_attention import flex_attention, kernel_score_mod

        out = flex_attention(q, k, v, mask_mod=build_mask_mod(args),
                             score_mod=kernel_score_mod(args.score_mod_type,
                                                        args.num_heads, args.soft_cap))
    elif impl == "ring":
        # No sp mesh axis on one device: JAX falls back to the reference
        # attention under the config's mask (ring over NCCL: item 10c).
        out = reference_attention(q, k, v, mask_mod=build_mask_mod(args))
    else:
        out = reference_attention(q, k, v, mask_mod=build_mask_mod(args),
                                  score_mod=build_score_mod(args))
    return out


def transformer_block(p: Params, x: torch.Tensor, args: LlamaArgs,
                      positions: torch.Tensor, attn_impl: Optional[str] = None,
                      stats: Optional[list] = None,
                      cache: Optional[Dict[str, Any]] = None,
                      attend_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block -> ``(x, aux)``: aux is the MoE layer's
    pre-scaled router loss (0 for a dense layer). An MoE layer appends its
    routing stats to ``stats`` when that is a list. ``cache`` is this
    layer's static KV cache, written in place."""
    x = x + attention_block(
        p["attention"], rms_norm(x, p["attention_norm"]["weight"], args.rms_norm_eps),
        args, positions, attn_impl, cache, attend_len)
    normed = rms_norm(x, p["ffn_norm"]["weight"], args.rms_norm_eps)
    if args.is_moe:
        from .moe import moe_block

        ff, aux = moe_block(p["feed_forward"], normed, args, stats)
    else:
        ff = mlp_block(p["feed_forward"], normed, args.intermediate_size)
        aux = torch.zeros((), device=x.device)
    return x + ff, aux


def _cast(tree, dtype):
    """The compute-dtype cast; int8 (quantized) leaves stay int8, as in JAX."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.int8 else tree.to(dtype)


def _layer(layer: Params, x: torch.Tensor, args: LlamaArgs, positions: torch.Tensor,
           compute_dtype: torch.dtype, stats: Optional[list],
           cache: Optional[Dict[str, Any]] = None, attend_len: Optional[int] = None):
    """One layer from its fp32 master weights: the cast to the compute dtype
    is inside, so a remat'd layer keeps no cast copy for the backward."""
    return transformer_block(_cast(layer, compute_dtype), x, args, positions,
                             stats=stats, cache=cache, attend_len=attend_len)


def forward(params: Params, tokens: torch.Tensor, args: LlamaArgs,
            compute_dtype: torch.dtype = torch.float32,
            remat: Optional[str] = None, remat_ratio: float = 1.0,
            scan_layers: bool = False, overlap: bool = False,
            return_aux: bool = False, return_hidden: bool = False,
            stats: Optional[list] = None, cache: Optional[list] = None,
            start_pos: int = 0, attend_len: Optional[int] = None):
    """tokens ``[B, S]`` -> ``(logits [B, S, V] fp32, cache)``, or
    ``(logits, cache, aux)`` with ``return_aux``: the MoE layers'
    pre-scaled router losses summed (fp32). ``cache`` (:func:`init_cache`,
    None in training) is written in place at positions ``start_pos +
    arange(S)`` and returned, where JAX returns a new one; cached attention
    reads the first ``attend_len`` slots (all when None) and ignores
    ``remat``.
    ``return_hidden`` returns the final normed hidden states ``[B, S, D]``
    in the compute dtype instead of logits (the fused CE folds the
    projection into the loss). MoE layers append their routing stats to
    ``stats`` when it is a list. The fp32 master weights are cast to
    ``compute_dtype`` layer by layer; the output projection accumulates in
    fp32: both bf16 operands are cast to fp32 (their products are exact
    there) and multiplied with TF32 off, as JAX's
    ``preferred_element_type=float32`` does.

    ``remat`` (a name of :data:`REMAT_POLICIES`) checkpoints the first
    ``round(num_layers * remat_ratio)`` layers; the rest run plain, as in
    JAX. ``scan_layers`` is accepted and runs the same per-layer loop in
    the same two remat segments: the JAX scan stacks the layers' params
    inside jit so XLA compiles one layer instead of ``num_layers``; it
    changes no number and no file layout, and eager PyTorch compiles
    nothing, so there is nothing for it to do here.

    Under an fsdp mesh the train step's plan (``parallel/overlap.py``) is
    active: ``params["layers"]`` then holds this rank's blocks, and each
    layer is gathered just before it runs. ``overlap``
    (``system.overlap_gather``) prefetches layer i+1's gather while layer i
    computes where JAX's ``can_overlap`` allows it; without the plan (one
    device, or no fsdp axis > 1) the plain loop runs, as in JAX."""
    del scan_layers  # the same loop either way (see the docstring)
    wrap = remat_wrap(remat) if cache is None else None
    n_remat = int(round(args.num_layers * remat_ratio)) if wrap is not None else 0
    B, S = tokens.shape
    x = embed(params, tokens, args, compute_dtype)
    positions = torch.arange(S, device=tokens.device) + start_pos

    plan = active_plan() if cache is None else None
    if plan is not None:
        x, aux_total = plan.run_layers(
            params["layers"], x,
            lambda layer, h: _layer(layer, h, args, positions, compute_dtype, stats),
            wrap, n_remat, prefetch=overlap and plan.can_overlap(B))
    else:
        aux_total = torch.zeros((), device=tokens.device)
        for i, layer in enumerate(params["layers"]):
            if i < n_remat:
                x, aux = wrap(_layer, layer, x, args, positions, compute_dtype, stats)
            else:
                x, aux = _layer(layer, x, args, positions, compute_dtype, stats,
                                None if cache is None else cache[i], attend_len)
            aux_total = aux_total + aux
    x = rms_norm(x, params["norm"]["weight"], args.rms_norm_eps)
    if return_hidden:
        return (x, cache, aux_total) if return_aux else (x, cache)
    logits = project_logits(params, x, args, compute_dtype)
    if return_aux:
        return logits, cache, aux_total
    return logits, cache


def embed(params: Params, tokens: torch.Tensor, args: LlamaArgs,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings ``[B, S, D]`` in ``compute_dtype``; a vocab-parallel
    lookup where the table holds this tp rank's rows. The rows are taken
    from the table in its own dtype and then cast (the values JAX's cast
    table gives), so the backward sums the gradients of a token's rows in
    the table's dtype: summed in bf16, a frequent token's thousands of rows
    lost a fifth of the table's gradient norm (moe-1b, 16,384 tokens of a
    259-token vocabulary)."""
    w = params["tok_embeddings"]["weight"]
    if w.shape[0] != args.vocab_size:
        return current_tp().embed(w, tokens, compute_dtype)
    return w[tokens.long()].to(compute_dtype)


def output_projection(params: Params, args: LlamaArgs, compute_dtype: torch.dtype):
    """``(w [V, D] in compute_dtype, bias [V] or None)`` of the logits: the
    tied embedding table or the untied output head (under tp, this rank's
    vocab rows; the bias stays whole)."""
    if not args.tie_word_embeddings and "output" in params:
        return (params["output"]["weight"].to(compute_dtype).t(),
                params["output"].get("bias"))
    return params["tok_embeddings"]["weight"].to(compute_dtype), None


def project_logits(params: Params, x: torch.Tensor, args: LlamaArgs,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """fp32 logits ``[..., V]`` of hidden states ``x``: both operands cast
    to fp32 (bf16 products are exact there). Under tp each rank projects
    onto its vocab columns, and the logits are gathered over tp."""
    w_vd, bias = output_projection(params, args, compute_dtype)
    tp = current_tp() if w_vd.shape[0] != args.vocab_size else None
    if tp is not None:  # this rank's vocab columns, then all of them
        x = tp.copy(x)
        if bias is not None:
            bias = tp.copy(bias).narrow(-1, tp.coord * w_vd.shape[0], w_vd.shape[0])
    logits = x.float() @ w_vd.float().t()
    if bias is not None:
        logits = logits + bias.float()
    if tp is not None:
        logits = tp.gather(logits, -1)
    if args.logit_scale:
        logits = logits * args.logit_scale
    return logits


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], args: LlamaArgs,
            compute_dtype: torch.dtype = torch.float32,
            remat: Optional[str] = None, remat_ratio: float = 1.0,
            ce_chunk: int = -1, scan_layers: bool = False,
            z_loss_weight: float = 0.0, overlap: bool = False,
            include_aux: bool = True, with_moe_stats: bool = False):
    """Masked mean cross-entropy in fp32, plus the z-loss
    ``z_loss_weight * mean(logsumexp^2)`` when set, plus an MoE model's
    pre-scaled router losses when ``include_aux`` (training; evaluation
    passes False so the validation loss stays pure cross-entropy). Returns
    ``(loss, mask.sum())``, or with ``with_moe_stats`` on an MoE model
    ``(loss, (mask.sum(), stats))``, the routing stats summed over the
    layers (device tensors, no sync).

    ``ce_chunk``: rows per fused-CE chunk (``ops/fused_ce.py``: the output
    projection folded into a chunked loss, no ``[B, S, V]`` logits); 0 is
    the plain path, -1 chooses as JAX does (``fused_ce.auto_chunk``). Both
    accumulate the projection in fp32 and reduce in fp32."""
    stats = [] if with_moe_stats and args.is_moe else None
    targets = batch["targets"]
    mask = batch["mask"].float()
    # a mesh train step passes the global batch's count: the ranks' losses
    # then sum to the global mean
    count = batch.get("global_count")
    if count is None:
        count = mask.sum().clamp_min(1.0)
    B, S = batch["inputs"].shape
    if ce_chunk < 0:
        ce_chunk = fused_ce.auto_chunk(B, S, args.vocab_size)
    kw = dict(compute_dtype=compute_dtype, remat=remat, remat_ratio=remat_ratio,
              scan_layers=scan_layers, overlap=overlap, return_aux=True, stats=stats)
    if ce_chunk > 0:
        hidden, _, aux = forward(params, batch["inputs"], args, return_hidden=True, **kw)
        w_vd, bias = output_projection(params, args, compute_dtype)
        nll_sum, z_sum = fused_ce.fused_cross_entropy(
            hidden, w_vd, targets, mask, bias_v=bias, logit_scale=args.logit_scale,
            chunk=ce_chunk, with_z=True,
            tp=current_tp() if w_vd.shape[0] != args.vocab_size else None)
        loss = nll_sum / count
        if z_loss_weight > 0.0:
            loss = loss + z_loss_weight * z_sum / count
    else:
        logits, _, aux = forward(params, batch["inputs"], args, **kw)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None].long())[..., 0]
        loss = ((logz - gold) * mask).sum() / count
        if z_loss_weight > 0.0:
            loss = loss + z_loss_weight * (logz.square() * mask).sum() / count
    if args.is_moe and include_aux:
        loss = loss + aux  # pre-scaled inside moe_block
    if stats is not None:
        from .moe import merge_stats

        return loss, (mask.sum(), merge_stats(stats, args.num_local_experts,
                                              targets.device))
    return loss, mask.sum()
