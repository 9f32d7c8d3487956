"""Flash attention: forward, dQ and dK/dV kernels with a recomputing backward.

Two versions of each of the three functions:

- the kernels, ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``),
  replacing the JAX package's Pallas TPU kernels ``flash_fwd``,
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` (``ops/flash_attention.py``). The
  library is compiled with ``nvcc`` at first use into ``build/kernels/`` at
  the repository root (``utils/cuda_build.py``) and bound through ``ctypes``;
- ``*_plain``, the same arithmetic in plain PyTorch with the score matrix
  materialized: the CPU path, and what the kernels are held against.

The raw entry points take the JAX kernels' ``[B, H, S, D]`` layout as any
strided view with a contiguous head dim: :func:`flash_attention` hands them
``transpose(1, 2)`` views of the model's ``[B, S, H, D]`` activations, and
the kernels read those strides in place (no transpose copies). Their
outputs are allocated ``[B, S, H, D]`` in memory and returned as the same
kind of view. ``lse`` and ``delta`` are ``[B, Hq, S]`` fp32.

CPU tensors go to the plain versions; CUDA tensors launch the kernels, and
a dtype, head dim, layout or mask the kernels do not take raises. No build
or launch error falls back. Each function has several kernels
("variants"); :func:`flash_variant` picks one before launch: "wgmma" (TMA
ring feeding wgmma, scores, P and dS in registers) for bf16, "f32" (SIMT)
for fp32. Each wrapper counts
its launches in ``<fn>.launches`` and per variant in
``<fn>.launches_by_variant`` (:func:`reset_launches` zeroes both).

Block sparsity follows the JAX planners (:func:`_kv_range`, :func:`_q_range`,
:func:`_full_tile_fn`, ported over Python ints) at each kernel's own tile
sizes (:func:`kernel_tiles`). The host turns them into per-tile live ranges
and a "needs no mask" flag per tile, cached per shape on the device.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..utils import cuda_build
from . import masks as M
from .masks import NEG_INF

__all__ = [
    "MATMUL_PRECISIONS",
    "check_matmul_precision",
    "fit_block",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "flash_variant",
    "kernel_tiles",
    "reset_launches",
]

MATMUL_PRECISIONS = (None, "fp32", "bf16", "int8")
KERNEL_MASKS = ("full", "causal", "sliding_window", "prefix_lm")
_MASK_CODES = {name: i for i, name in enumerate(KERNEL_MASKS)}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_VARIANTS = ("wgmma", "f32")
_VARIANT_CODES = {"f32": 0, "wgmma": 2}  # csrc/flash_attention.cu's Variant
_HEAD_DIMS = (64, 128)
_DKV_BQ = {64: 128, 128: 64}  # DKV_BQ_D64 / _D128 in csrc/flash_attention.cu
_DQ_BKV = {64: 128, 128: 64}  # DQ_BKV_D64 / _D128 in csrc/flash_attention.cu
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "flash_attention.cu"


def check_matmul_precision(precision: Optional[str]) -> Optional[str]:
    p = str(precision).lower() if precision is not None else None
    if p in ("", "none", "fp32", "fp"):
        p = None
    if p not in MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul_precision {precision!r} "
                         f"(expected one of {MATMUL_PRECISIONS})")
    return p


def flash_variant(fn: str, dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of ``fn`` ("flash_fwd", "flash_bwd_dq" or
    "flash_bwd_dkv") launches: "wgmma" for bf16, "f32" for fp32. The head
    dim and TMA's 16-byte alignment need no check here: :func:`_check`
    refuses operands the kernels do not take before any launch."""
    if fn not in FLASH_KERNELS:
        raise ValueError(f"unknown flash kernel {fn!r} (expected one of "
                         f"{FLASH_KERNELS})")
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"{fn} kernel takes fp32 or bf16, got {dtype}")
    return "wgmma"


def kernel_tiles(fn: str, variant: str, head_dim: int = 64) -> Tuple[int, int]:
    """``(block_q, block_kv)``: the tile sizes a variant's kernel plans at
    (the tile constants in ``csrc/flash_attention.cu``, which the wgmma
    launchers check against the plan). The wgmma forward takes 128 query
    rows per CTA against 128-row KV tiles; the wgmma dQ 128 query rows per
    CTA against ``_DQ_BKV[head_dim]``-row KV tiles (128 at D 64, 64 at D
    128, where dQ alone holds 64 registers a thread); the wgmma dK/dV 128 KV
    rows per CTA against ``_DKV_BQ[head_dim]``-row Q tiles (128 at D 64, 64
    at D 128, where dK and dV alone hold 128 registers a thread); SIMT 32
    square."""
    if variant == "wgmma":
        if fn == "flash_fwd":
            return (128, 128)
        if fn == "flash_bwd_dq":
            return (128, _DQ_BKV[head_dim])
        return (_DKV_BQ[head_dim], 128)
    return (32, 32)


# -- tile planners (the JAX package's, over Python ints) -----------------------
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fit_block(block: int, dim: int) -> int:
    """Largest power-of-two block <= requested that divides ``dim`` (stops
    at 128), capped at ``dim``."""
    while block > 128 and dim % block:
        block //= 2
    return min(block, dim)


def _kv_range(mask_type: str, window: int, prefix_len: int, block_q: int,
              block_kv: int, num_kv_blocks: int):
    """(qi -> lo, qi -> hi): the live KV tiles of query tile ``qi``."""

    def lo(qi):
        if mask_type in ("sliding_window", "band"):
            return max((qi * block_q - window + 1) // block_kv, 0)
        return 0

    def hi(qi):
        if mask_type in ("causal", "sliding_window"):
            return min(_cdiv(qi * block_q + block_q, block_kv), num_kv_blocks)
        if mask_type == "prefix_lm":
            causal_hi = _cdiv(qi * block_q + block_q, block_kv)
            return min(max(causal_hi, _cdiv(prefix_len, block_kv)), num_kv_blocks)
        return num_kv_blocks  # full / band

    return lo, hi


def _q_range(mask_type: str, window: int, prefix_len: int, block_q: int,
             block_kv: int, num_q_blocks: int):
    """(ki -> lo, ki -> hi): the live query tiles of KV tile ``ki``."""

    def lo(ki):
        if mask_type in ("causal", "sliding_window"):
            return (ki * block_kv) // block_q
        return 0

    def hi(ki):
        if mask_type in ("sliding_window", "band"):
            return max(min(_cdiv(ki * block_kv + block_kv - 1 + window, block_q) + 1,
                           num_q_blocks), 0)
        return num_q_blocks

    return lo, hi


def _full_tile_fn(mask_type: str, window: int, prefix_len: int, block_q: int,
                  block_kv: int):
    """(qi, j) -> is the whole tile valid under the mask (None: no fast
    path for this mask type)."""
    if mask_type not in ("causal", "sliding_window", "prefix_lm", "band"):
        return None

    def full(qi, j):
        min_row = qi * block_q
        max_row = qi * block_q + block_q - 1
        max_col = j * block_kv + block_kv - 1
        causal_ok = max_col <= min_row
        if mask_type == "causal":
            return causal_ok
        if mask_type == "sliding_window":
            return causal_ok and (max_row - j * block_kv <= window - 1)
        if mask_type == "band":
            return max_row - j * block_kv <= window - 1
        return causal_ok or (max_col < prefix_len)

    return full


_plans: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_plans_lock = threading.Lock()


def _plan(mask_type: str, window: int, prefix_len: int, S: int, block: int,
          device: torch.device, block_kv: Optional[int] = None):
    """Device tensors ``(kv_ranges [nq, 2], q_ranges [nk, 2], full [nq, nk])``
    for one shape at ``block`` query rows per Q tile and ``block_kv`` (by
    default ``block``) rows per KV tile: live [lo, hi) tile ranges and the
    per-tile no-mask flag (a tile qualifies when the mask holds everywhere
    on it and it lies inside S)."""
    bq, bkv = block, block if block_kv is None else block_kv
    key = (mask_type, window, prefix_len, S, bq, bkv, str(device))
    with _plans_lock:
        got = _plans.get(key)
        if got is not None:
            return got
        nq, nk = _cdiv(S, bq), _cdiv(S, bkv)
        kv_lo, kv_hi = _kv_range(mask_type, window, prefix_len, bq, bkv, nk)
        q_lo, q_hi = _q_range(mask_type, window, prefix_len, bq, bkv, nq)
        tile = _full_tile_fn(mask_type, window, prefix_len, bq, bkv)
        full = [[int((tile is None or bool(tile(i, j)))
                     and (i + 1) * bq <= S and (j + 1) * bkv <= S)
                 for j in range(nk)] for i in range(nq)]
        got = (torch.tensor([[kv_lo(i), kv_hi(i)] for i in range(nq)],
                            dtype=torch.int32, device=device),
               torch.tensor([[q_lo(j), q_hi(j)] for j in range(nk)],
                            dtype=torch.int32, device=device),
               torch.tensor(full, dtype=torch.uint8, device=device))
        _plans[key] = got
        return got


# -- plain versions ----------------------------------------------------------------
def _mask_mod(mask_type: str, window: int, prefix_len: int):
    if mask_type == "causal":
        return M.causal()
    if mask_type == "sliding_window":
        return M.sliding_window(window)
    if mask_type == "prefix_lm":
        return M.prefix_lm(prefix_len)
    if mask_type == "full":
        return None
    if mask_type == "band":
        raise NotImplementedError(
            "mask 'band' is ring attention's off-diagonal chunk: not ported "
            "(ROADMAP queue 1: flex, ring and band over the flash kernels)")
    raise ValueError(f"unknown mask_type {mask_type!r} (expected one of "
                     f"{KERNEL_MASKS})")


def _probs(q, k, mask_type, window, prefix_len, scale, lse=None):
    """fp32 scores ``(q . k^T) * scale`` masked to NEG_INF (GQA: query head
    h reads KV head h // G), and either ``exp(s - lse)`` or the running max
    path's pieces."""
    G = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(G, dim=1)
    s = torch.matmul(q.float(), kf.float().transpose(-1, -2)) * scale
    mod = _mask_mod(mask_type, window, prefix_len)
    if mod is not None:
        valid = M.materialize_mask(mod, q.shape[2], k.shape[2], device=q.device)
        s = s.masked_fill(~valid, NEG_INF)
    if lse is None:
        return s, kf
    return torch.exp(s - lse[..., None]), kf


def flash_fwd_plain(q, k, v, mask_type: str = "causal", window: int = 512,
                    prefix_len: int = 0, scale: float = 1.0):
    """``(o, lse)``: softmax of the masked fp32 scores, p cast to v's type
    before ``p . v``, normalized after, as the kernel does."""
    s, _ = _probs(q, k, mask_type, window, prefix_len, scale)
    G = q.shape[1] // k.shape[1]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vf = v.repeat_interleave(G, dim=1)
    o = torch.matmul(p.to(v.dtype).float(), vf.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_dq_plain(q, k, v, do, lse, delta, mask_type: str = "causal",
                       window: int = 512, prefix_len: int = 0,
                       scale: float = 1.0):
    p, kf = _probs(q, k, mask_type, window, prefix_len, scale, lse)
    G = q.shape[1] // k.shape[1]
    dp = torch.matmul(do.float(), v.repeat_interleave(G, dim=1).float()
                      .transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return torch.matmul(ds.to(k.dtype).float(), kf.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, mask_type: str = "causal",
                        window: int = 512, prefix_len: int = 0,
                        scale: float = 1.0):
    """Per-query-head ``(dk_h, dv_h)``, each ``[B, Hq, S, D]``."""
    p, _ = _probs(q, k, mask_type, window, prefix_len, scale, lse)
    G = q.shape[1] // k.shape[1]
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.repeat_interleave(G, dim=1).float()
                      .transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels ------------------------------------------------------------
class _FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in csrc/flash_attention.cu (every
    field 8 bytes wide)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "dout", "lse_in", "delta", "out0", "out1",
            "lse_out", "ranges", "full")]
        + [(n, ctypes.c_int64) for n in ("B", "Hq", "Hkv", "S", "nq", "nk")]
        + [(n, ctypes.c_int64 * 3) for n in (
            "sq", "sk", "sv", "so", "sdo", "s0", "s1")]
        + [(n, ctypes.c_int64) for n in ("mask_type", "window", "prefix")]
        + [("scale", ctypes.c_double)])


_lib = None
_lib_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/flash_attention.cu`` for sm_90a (once per source hash)
    and return the shared library's path."""
    return cuda_build.build_library(_SRC)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch,
                       lib.flash_bwd_dkv_launch):
                fn.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, tensors: Dict[str, torch.Tensor], mask_type: str) -> None:
    q = tensors["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel takes CUDA tensors, got {q.device} "
                         "(CPU tensors go to the plain version)")
    if mask_type not in _MASK_CODES:
        raise ValueError(f"{name} kernel takes masks {KERNEL_MASKS}, got "
                         f"{mask_type!r}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes fp32 or bf16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel takes [B, H, S, D] with D in "
                         f"{_HEAD_DIMS}, got {tuple(q.shape)}")
    B, Hq, S, D = q.shape
    Hkv = tensors["k"].shape[1]
    for key, t in tensors.items():
        want_dtype = torch.float32 if key in ("lse", "delta") else q.dtype
        if t.device != q.device or t.dtype != want_dtype:
            raise TypeError(f"{name}: {key} is {t.dtype} on {t.device}, "
                            f"want {want_dtype} on {q.device}")
        if key in ("lse", "delta"):
            if t.shape != (B, Hq, S) or not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous "
                                 f"[{B}, {Hq}, {S}] fp32, got {tuple(t.shape)}")
            continue
        heads = Hkv if key in ("k", "v") else Hq
        if t.shape != (B, heads, S, D):
            raise ValueError(f"{name}: {key} {tuple(t.shape)} != "
                             f"{(B, heads, S, D)} (the kernels take Sq == Skv)")
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} needs a contiguous head dim, "
                             f"16-byte aligned rows and strides, got strides "
                             f"{t.stride()}")
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")


def _bhs(t: Optional[torch.Tensor]):
    return (ctypes.c_int64 * 3)(*(t.stride()[:3] if t is not None else (0, 0, 0)))


def _launch(fn_name: str, variant: str, q, k, v, *, ranges, full, mask_type,
            window, prefix_len, scale, o=None, dout=None, lse_in=None,
            delta=None, out0=None, out1=None, lse_out=None) -> None:
    """One launch of ``variant``'s kernel through the library's C entry
    ``fn_name`` (``flash_fwd_launch``, ...) on the plan ``ranges`` /
    ``full``, which must be at that kernel's tile sizes."""
    def ptr(t):
        return t.data_ptr() if t is not None else None

    B, Hq, S, D = q.shape
    a = _FlashArgs(
        q=ptr(q), k=ptr(k), v=ptr(v), o=ptr(o), dout=ptr(dout),
        lse_in=ptr(lse_in), delta=ptr(delta), out0=ptr(out0), out1=ptr(out1),
        lse_out=ptr(lse_out), ranges=ptr(ranges), full=ptr(full),
        B=B, Hq=Hq, Hkv=k.shape[1], S=S, nq=full.shape[0], nk=full.shape[1],
        sq=_bhs(q), sk=_bhs(k), sv=_bhs(v), so=_bhs(o if o is not None else out0),
        sdo=_bhs(dout), s0=_bhs(out0), s1=_bhs(out1),
        mask_type=_MASK_CODES[mask_type], window=window, prefix=prefix_len,
        scale=float(scale))
    err = getattr(_library(), fn_name)(
        ctypes.byref(a), _VARIANT_CODES[variant], D,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} ({variant}) failed with CUDA error {err}")


def _bshd_like(q: torch.Tensor) -> torch.Tensor:
    """An output shaped like ``q`` ([B, H, S, D]) laid out [B, S, H, D]."""
    B, H, S, D = q.shape
    return torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_fwd(q, k, v, mask_type: str = "causal", window: int = 512,
              prefix_len: int = 0, scale: float = 1.0):
    """``(o [B, Hq, S, D], lse [B, Hq, S] fp32)`` for q ``[B, Hq, S, D]``,
    k/v ``[B, Hkv, S, D]``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask_type, window, prefix_len, scale)
    _check("flash_fwd", {"q": q, "k": k, "v": v}, mask_type)
    B, Hq, S, D = q.shape
    kind = flash_variant("flash_fwd", q.dtype, D)
    bq, bkv = kernel_tiles("flash_fwd", kind)
    kv_ranges, _, full = _plan(mask_type, window, prefix_len, S, bq, q.device, bkv)
    o = _bshd_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", kind, q, k, v, ranges=kv_ranges, full=full,
            mask_type=mask_type, window=window, prefix_len=prefix_len,
            scale=scale, out0=o, lse_out=lse)
    flash_fwd.launches += 1
    flash_fwd.launches_by_variant[kind] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, mask_type: str = "causal",
                 window: int = 512, prefix_len: int = 0, scale: float = 1.0):
    """dQ ``[B, Hq, S, D]`` by recomputation from ``lse`` and ``delta``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, mask_type, window,
                                  prefix_len, scale)
    _check("flash_bwd_dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                            "delta": delta}, mask_type)
    kind = flash_variant("flash_bwd_dq", q.dtype, q.shape[3])
    bq, bkv = kernel_tiles("flash_bwd_dq", kind, q.shape[3])
    kv_ranges, _, full = _plan(mask_type, window, prefix_len, q.shape[2], bq,
                               q.device, bkv)
    dq = _bshd_like(q)
    _launch("flash_bwd_dq_launch", kind, q, k, v, ranges=kv_ranges, full=full,
            mask_type=mask_type, window=window, prefix_len=prefix_len,
            scale=scale, dout=do, lse_in=lse, delta=delta, out0=dq)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_by_variant[kind] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, mask_type: str = "causal",
                  window: int = 512, prefix_len: int = 0, scale: float = 1.0):
    """Per-query-head ``(dk_h, dv_h)``, each ``[B, Hq, S, D]`` (the caller
    sums GQA groups)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, mask_type, window,
                                   prefix_len, scale)
    _check("flash_bwd_dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                             "delta": delta}, mask_type)
    dk, dv = _bshd_like(q), _bshd_like(q)
    kind = flash_variant("flash_bwd_dkv", q.dtype, q.shape[3])
    bq, bkv = kernel_tiles("flash_bwd_dkv", kind, q.shape[3])
    _, q_ranges, full = _plan(mask_type, window, prefix_len, q.shape[2], bq,
                              q.device, bkv)
    _launch("flash_bwd_dkv_launch", kind, q, k, v, ranges=q_ranges, full=full,
            mask_type=mask_type, window=window, prefix_len=prefix_len,
            scale=scale, dout=do, lse_in=lse, delta=delta, out0=dk, out1=dv)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.launches_by_variant[kind] += 1
    return dk, dv


def reset_launches() -> None:
    """Set the three flash kernels' launch counts, totals and per variant,
    to 0."""
    for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = 0
        fn.launches_by_variant = dict.fromkeys(FLASH_VARIANTS, 0)


reset_launches()


# -- autograd and the model-facing wrapper ------------------------------------------
class _FlashCore(torch.autograd.Function):
    """Flash attention on ``[B, H, S, D]`` views: forward saves q, k, v, o and
    lse (never the probabilities); backward computes ``delta`` in plain
    torch, then dQ and per-query-head dK/dV, and sums the GQA groups."""

    @staticmethod
    def forward(ctx, q, k, v, mask_type, window, prefix_len, scale):
        o, lse = flash_fwd(q, k, v, mask_type, window, prefix_len, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plan = (mask_type, window, prefix_len, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ctx.plan)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.plan)
        G = q.shape[1] // k.shape[1]
        if G > 1:
            dk = dk.unflatten(1, (k.shape[1], G)).sum(dim=2).to(k.dtype)
            dv = dv.unflatten(1, (k.shape[1], G)).sum(dim=2).to(v.dtype)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_type: str = "causal",
    window_size: int = 512,
    prefix_len: int = 0,
    scale: Optional[float] = None,
    mask_fn=None,
    score_fn=None,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Flash attention on the ``[B, S, H, D]`` layout, differentiable.

    ``mask_type``: causal / sliding_window / prefix_lm / full. ``precision``
    (model.matmul_precision): "bf16" casts q/k/v. Custom ``mask_fn`` /
    ``score_fn`` (the flex path), the ``band`` mask and int8 precision are
    not ported and raise."""
    precision = check_matmul_precision(precision)
    if precision == "int8":
        raise NotImplementedError(
            "matmul_precision int8 over the flash kernels is not ported "
            "(ROADMAP queue 1: flex, ring and band over the flash kernels)")
    if mask_fn is not None or score_fn is not None:
        raise NotImplementedError(
            "custom mask_fn / score_fn (the flex path) are not ported "
            "(ROADMAP queue 1: flex, ring and band over the flash kernels)")
    _mask_mod(mask_type, window_size, prefix_len)  # raises on band / unknown
    if precision == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv "
                         f"heads {k.shape[2]}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    o = _FlashCore.apply(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), mask_type, int(window_size),
                         int(prefix_len), float(scale))
    return o.transpose(1, 2)
