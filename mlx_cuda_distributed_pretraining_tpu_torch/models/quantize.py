"""Weight-only quantization: per-channel int8 and packed int4 (the JAX
package's ``models/quantize.py``).

Decode re-reads every weight for each generated token, so serving moves
fewer bytes the fewer bits a weight has. ``quantize_weights(params,
"int8"|"int4")`` walks a param tree and gives the leaves the forward paths
take (``models/llama.py`` ``_linear``, ``models/moe.py`` ``_expert_bank``):

  =========  ================================  =====================
  dtype      quantized leaf                    scale leaf
  =========  ================================  =====================
  int8       ``weight_q``  int8 [in, out]      ``weight_s`` f32 [out]
  int4       ``weight_q4`` int8 [in//2, out]   ``weight_s`` f32 [out]
  =========  ================================  =====================

MoE expert banks carry a leading ``E`` on both. Scales are symmetric per
output channel, so they factor out of the contraction and multiply the
matmul's result. int4 packs two neighbouring contraction rows a byte: the
even row in the low nibble, the odd one in the high nibble, the JAX
package's order bit for bit, so a quantized tree or checkpoint converts
across the two packages leaf for leaf under the same key names.

Embeddings, the output head, norms, biases and MoE routers stay full
precision. Each function takes torch tensors or numpy arrays and returns
the same kind; the ``*_np`` names are the checkpoint-load path's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import flatten_dict

Params = Dict[str, Any]

WEIGHT_DTYPES = ("fp", "int8", "int4")

# Flat checkpoint keys of the linear weights quantize-on-load transforms.
QUANT_LEAF_RE = re.compile(
    r"(attention\.w[qkvo]|feed_forward\.w_(gate|up|down)|"
    r"experts\.w_(gate|up|down))\.weight$")

_INT8_MAX = 127.0
_INT4_MAX = 7.0  # symmetric: [-7, 7]; -8 stays unused


def check_weight_dtype(weight_dtype: Optional[str]) -> str:
    wd = str(weight_dtype or "fp").lower()
    if wd in ("fp32", "bf16", "none", ""):
        wd = "fp"
    if wd not in WEIGHT_DTYPES:
        raise ValueError(f"unknown weight_dtype {weight_dtype!r} "
                         f"(expected one of {WEIGHT_DTYPES})")
    return wd


def quantizable_path(path: str) -> bool:
    """Whether a flat checkpoint key names a quantizable linear weight."""
    return QUANT_LEAF_RE.search(path) is not None


# -- per-channel scales ------------------------------------------------------
def channel_scales(w, bits: int = 8):
    """Symmetric per-output-channel scales over the contraction dim: ``w``
    ``[in, out]`` or ``[E, in, out]`` -> fp32 ``[out]`` / ``[E, out]``
    (an all-zero channel gets scale 1)."""
    qmax = _INT8_MAX if bits == 8 else _INT4_MAX
    axis = 0 if w.ndim == 2 else 1
    if isinstance(w, np.ndarray):
        s = np.max(np.abs(w.astype(np.float32)), axis=axis) / np.float32(qmax)
        return np.where(s == 0, np.float32(1.0), s).astype(np.float32)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can land one ulp off the CPU's (and JAX's) quotient
    s = w.float().abs().amax(dim=axis) / torch.full((), qmax, device=w.device)
    return torch.where(s == 0, torch.ones_like(s), s)


def _quantize_values(w, s, bits: int):
    """int8-stored values of ``w`` on the grid of scales ``s``: ``round(w /
    s)`` (half to even in both packages) clipped to the symmetric range."""
    qmax = _INT8_MAX if bits == 8 else _INT4_MAX
    if isinstance(w, np.ndarray):
        se = s[None] if w.ndim == 2 else s[:, None, :]
        q = np.clip(np.round(w.astype(np.float32) / se), -qmax, qmax)
        return q.astype(np.int8)
    se = s[None] if w.ndim == 2 else s[:, None, :]
    return torch.clamp(torch.round(w.float() / se), -qmax, qmax).to(torch.int8)


# -- int4 packing ------------------------------------------------------------
def pack_int4(q):
    """Pack int8-stored int4 values ([-7, 7]) two a byte along the
    contraction dim: row 2i -> low nibble, row 2i+1 -> high nibble. ``[in,
    out]`` -> ``[in//2, out]`` (``[E, in, out]`` -> ``[E, in//2, out]``)."""
    axis = q.ndim - 2
    if q.shape[axis] % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got shape {tuple(q.shape)}")
    even, odd = (q[0::2], q[1::2]) if axis == 0 else (q[:, 0::2], q[:, 1::2])
    if isinstance(q, np.ndarray):
        return ((odd.astype(np.int8) << 4) | (even.astype(np.int8) & 0x0F)) \
            .astype(np.int8)
    # the high nibble's shift wraps mod 256; both exact for [-8, 7]
    return ((odd.to(torch.int8) << 4) | (even.to(torch.int8) & 0x0F)).to(torch.int8)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: ``[in//2, out]`` -> int8 ``[in, out]``.
    Arithmetic shifts on int8 sign-extend: the low nibble is ``(p << 4) >>
    4``, the high one ``p >> 4``."""
    shape = list(packed.shape)
    shape[-2] *= 2
    axis = packed.ndim - 1  # stack position after the contraction dim
    if isinstance(packed, np.ndarray):
        p = packed.astype(np.int8)
        return np.stack([(p << 4) >> 4, p >> 4], axis=axis).reshape(shape)
    p = packed.to(torch.int8)
    return torch.stack([(p << 4) >> 4, p >> 4], dim=axis).reshape(shape)


# -- leaf + tree transforms --------------------------------------------------
def quantize_leaf(w, weight_dtype: str) -> Dict[str, Any]:
    """One linear weight -> its quantized leaf dict (see the module doc)."""
    wd = check_weight_dtype(weight_dtype)
    if wd == "fp":
        return {"weight": w}
    bits = 8 if wd == "int8" else 4
    s = channel_scales(w, bits)
    q = _quantize_values(w, s, bits)
    if wd == "int8":
        return {"weight_q": q, "weight_s": s}
    return {"weight_q4": pack_int4(q), "weight_s": s}


def dequantize_leaf(p: Dict[str, Any], dtype=torch.float32):
    """fp weight of a quantized leaf dict (tests and the parity oracle; the
    forward paths scale the matmul's result instead)."""
    if "weight_q4" in p:
        q = unpack_int4(p["weight_q4"])
    elif "weight_q" in p:
        q = p["weight_q"]
    else:
        return p["weight"]
    s = p["weight_s"]
    se = s[None] if q.ndim == 2 else s[:, None, :]
    if isinstance(q, np.ndarray):
        return q.astype(np.float32) * se
    return (q.float() * se).to(dtype)


def _walk_linear(p: Params, weight_dtype: str) -> Params:
    if "weight" not in p or p["weight"].ndim not in (2, 3):
        return dict(p)
    out = {k: v for k, v in p.items() if k != "weight"}
    out.update(quantize_leaf(p["weight"], weight_dtype))
    return out


def _walk(sub: Params, weight_dtype: str) -> Params:
    return {k: _walk_linear(v, weight_dtype) if isinstance(v, dict) else v
            for k, v in sub.items()}


def quantize_weights(params: Params, weight_dtype: str) -> Params:
    """Weight-only quantization of a whole param tree: attention wq/wk/wv/wo,
    the dense SwiGLU and the MoE expert banks (per (expert, out-channel)
    scales). Embeddings, the head, norms, biases and routers stay fp;
    ``"fp"`` is the identity."""
    wd = check_weight_dtype(weight_dtype)
    if wd == "fp":
        return params
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = []
    for layer in params["layers"]:
        nl = dict(layer)
        nl["attention"] = _walk(layer["attention"], wd)
        ff = layer["feed_forward"]
        if "experts" in ff:  # MoE: the banks, the router stays fp
            nl["feed_forward"] = {**ff, "experts": _walk(ff["experts"], wd)}
        elif "w_gate" in ff:
            nl["feed_forward"] = _walk(ff, wd)
        layers.append(nl)
    out["layers"] = layers
    return out


def weight_dtype_of(params: Params) -> str:
    """"fp", "int8" or "int4", from the tree's leaf names."""
    found = "fp"
    for key in flatten_dict(params):
        if "weight_q4" in key:
            return "int4"
        if "weight_q" in key:
            found = "int8"
    return found


# -- the checkpoint-load path ------------------------------------------------
def quantized_key_shapes(path: str, shape: Tuple[int, ...],
                         weight_dtype: str
                         ) -> Optional[Dict[str, Tuple[int, ...]]]:
    """For a flat checkpoint key: the quantized keys and shapes it loads as
    under ``weight_dtype``, or None when it stays fp (an odd contraction
    dim stays fp under int4 rather than being padded)."""
    wd = check_weight_dtype(weight_dtype)
    if wd == "fp" or not quantizable_path(path) or len(shape) not in (2, 3):
        return None
    base = path[: -len(".weight")]
    contraction = shape[-2]
    s_shape = tuple(shape[:-2]) + (shape[-1],)
    if wd == "int8":
        return {base + ".weight_q": tuple(shape), base + ".weight_s": s_shape}
    if contraction % 2:
        return None
    q4 = tuple(shape[:-2]) + (contraction // 2, shape[-1])
    return {base + ".weight_q4": q4, base + ".weight_s": s_shape}


def quantize_slice_np(arr: np.ndarray, scales: np.ndarray,
                      idx, weight_dtype: str) -> np.ndarray:
    """Quantize one slice of a host fp array. ``idx`` indexes the QUANTIZED
    shape (under int4 the contraction dim is packed, so the fp rows are
    ``2*start : 2*stop``); ``scales`` are the whole array's per-channel
    scales."""
    wd = check_weight_dtype(weight_dtype)
    bits = 8 if wd == "int8" else 4
    idx = tuple(idx) if isinstance(idx, tuple) else (idx,)
    full = [slice(None)] * arr.ndim
    for i, sl in enumerate(idx):
        full[i] = sl
    caxis = arr.ndim - 2
    if wd == "int4":
        sl = full[caxis]
        start = 0 if sl.start is None else sl.start
        stop = arr.shape[caxis] // 2 if sl.stop is None else sl.stop
        fp_idx = list(full)
        fp_idx[caxis] = slice(2 * start, 2 * stop)
        w = arr[tuple(fp_idx)]
    else:
        w = arr[tuple(full)]
    s = scales[tuple(full[:caxis]) + (full[-1],)]
    q = _quantize_values(w, s, bits)
    return pack_int4(q) if wd == "int4" else q


def dequantize_np(q: np.ndarray, s: np.ndarray, packed: bool) -> np.ndarray:
    """Host-side dequantization (tests)."""
    if packed:
        q = unpack_int4(q)
    se = s[None] if q.ndim == 2 else s[:, None, :]
    return q.astype(np.float32) * se


def weight_plane_bytes(params: Params) -> int:
    """Bytes of every param leaf as stored (a quantized tree counts its int
    and scale bytes)."""
    total = 0
    for leaf in flatten_dict(params).values():
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.asarray(leaf).nbytes)
    return total
