"""Llama decoder building blocks used by the serving steps.

Parameters are the JAX package's nested dict with torch tensors as leaves and
the same layout: every linear weight is ``[in, out]`` (``y = x @ W``), expert
banks are ``[E, in, out]``, and ``layers`` is a list. So a checkpoint written
by either package maps name for name (``layers.3.attention.wq.weight``) with
no transposes. RMSNorm and RoPE compute in fp32 whatever the input dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.tree import flatten_dict

Params = Dict[str, Any]


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
    num_local_experts: int = 0
    num_experts_per_tok: int = 0
    moe_impl: str = "grouped"

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0 and self.num_experts_per_tok > 0

    @classmethod
    def from_config(cls, model_cfg: Any, vocab_size: int) -> "LlamaArgs":
        """Same field mapping as the JAX ``LlamaArgs.from_config``, for the
        fields serving reads."""
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
            num_local_experts=int(moe.get("num_local_experts", 0) or 0),
            num_experts_per_tok=int(moe.get("num_experts_per_tok", 0) or 0),
            moe_impl=str(moe.get("impl", "grouped") or "grouped"),
        )
        if args.is_moe and args.moe_impl != "grouped":
            raise NotImplementedError(
                f"moe impl {args.moe_impl!r}: the torch port serves the "
                "grouped (dropless) dispatch only")
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
    """``x @ W (+ b)`` with W ``[in, out]`` (fp weights only)."""
    y = x @ p["weight"]
    if "bias" in p:
        y = y + p["bias"]
    return y


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


def mlp_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Canonical SwiGLU: ``down(silu(gate(x)) * up(x))``."""
    return _linear(F.silu(_linear(x, p["w_gate"])) * _linear(x, p["w_up"]),
                   p["w_down"])


def init_paged_cache(args: LlamaArgs, num_blocks: int, block_size: int,
                     device="cuda", dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """Paged KV arena: per layer ``{"k", "v"}`` of ``[num_blocks,
    block_size, Hkv, Dh]``, addressed through per-sequence block tables.
    The serving steps write it in place."""
    shape = (num_blocks, block_size, args.num_kv_heads, args.head_dim)
    return [{"k": torch.zeros(shape, device=device, dtype=dtype),
             "v": torch.zeros(shape, device=device, dtype=dtype)}
            for _ in range(args.num_layers)]
