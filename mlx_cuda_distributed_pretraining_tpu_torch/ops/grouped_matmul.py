"""Grouped expert matmuls (``gmm``, and its backward's ``tgmm``) for dropless
MoE dispatch.

``x [T, K]`` is a token-sorted, block-aligned activation buffer and
``w [E, K, N]`` the stacked expert weights: rows ``[offset_e, offset_{e+1})``
of ``x`` multiply ``w[e]`` (MegaBlocks formulation, Gale et al., 2022). Every
group size is a multiple of ``block_t`` (the dispatcher in ``models/moe.py``
pads for this), so a ``block_t`` row tile never straddles two experts. Rows
past ``sum(group_sizes)`` come out as zeros.

:func:`gmm` is differentiable (``_GroupedMatmul``, the JAX package's
``_gmm_pallas_diff``): dX = ``gmm(dy, w^T)`` on the forward kernel, which
reads ``w`` transposed in place, and dW = :func:`tgmm`, the per-expert sum
of ``x_tile^T @ dy_tile``. Two versions of each function:

- the kernels, ``csrc/grouped_matmul.cu`` (CUDA C++ for ``sm_90a``),
  replacing the JAX package's Pallas TPU kernels
  ``ops/grouped_matmul.py::_gmm_pallas`` and ``::_tgmm_pallas``. The source
  is compiled with ``nvcc`` at first use into ``build/kernels/`` at the
  repository root (``utils/cuda_build.py``) and bound through ``ctypes``.
  Each function has several kernels ("variants"); :func:`gmm_variant` and
  :func:`tgmm_variant` pick one from the operands before launch (bf16 at
  block_t % 64 == 0 takes the TMA/wgmma kernel, other bf16 shapes the WMMA
  one, fp32 "f32" (3xTF32 on the tensor cores) or, at block_t 8,
  "f32_decode" (a weight stream)), and ``gmm.launches_by_variant`` /
  ``tgmm.launches_by_variant`` count the launches of each
  (``gmm.launches_by_shape`` and ``tgmm.launches_by_shape`` by ``(variant,
  T, K, N, block_t)``);
- :func:`gmm_plain`, the JAX package's "blocked" formulation in plain
  PyTorch (one weight gather per row tile and one batched matmul, fp32
  accumulation), and :func:`tgmm_plain`, the Pallas kernel's rounding points
  in plain PyTorch.

``precision="int8"`` (``model.matmul_precision``) runs :func:`gmm_int8`, the
JAX package's ``_gmm_int8``: rows of x and columns of each expert's w are
quantized to int8 with amax scales, the ``gmm_int8`` kernels of the same
source (int32 sums: an s8 ``wgmma`` fed by TMA, or ``mma.sync`` s8 where
block_t has no 64-row tile, :func:`gmm_int8_variant`;
:func:`gmm_int8_plain` on the CPU) contract them, and the scales multiply
the result. Its backward is straight-through and full precision: dX on the
gmm kernels, dW on the fp32 tgmm (3xTF32 on ``wgmma``; see
:class:`_GroupedMatmulInt8`).

CPU tensors go to the plain versions and CUDA tensors to the kernels;
anything else raises. No build or launch error falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from .flash_attention import check_matmul_precision

__all__ = [
    "DEFAULT_BLOCK_T",
    "GMM_VARIANTS",
    "TGMM_VARIANTS",
    "build_library",
    "decode_plan",
    "gmm",
    "GMM_INT8_VARIANTS",
    "gmm_int8",
    "gmm_int8_plain",
    "gmm_int8_variant",
    "gmm_plain",
    "gmm_variant",
    "pick_block_t",
    "round_up",
    "tgmm",
    "tgmm_plain",
    "tgmm_variant",
    "tile_experts",
]

# Largest row tile the dispatcher picks (the TPU's 128-row matrix unit set the
# JAX default; kept so both packages pad identically).
DEFAULT_BLOCK_T = 128

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "grouped_matmul.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_ROWS = 32  # largest CTA row tile of the fp32 and WMMA kernels (8, 16 or 32)
# gmm_f32_decode_kernel's work items (csrc/grouped_matmul.cu): DEC_ROWS rows x
# DEC_COLS columns x a K chunk of at most DEC_KC_MAX rows (staged in shared memory).
_DEC_ROWS, _DEC_COLS, _DEC_KC_MAX = 8, 128, 256
_DEC_CTAS = 4 * 132  # work items a decode call aims for: ~4 per SM of an H100
GMM_VARIANTS = ("wgmma", "wmma", "f32", "f32_decode")
TGMM_VARIANTS = ("wgmma", "wmma", "f32")
GMM_INT8_VARIANTS = ("wgmma", "mma_sync")
_GMM_INT8_CODES = {"mma_sync": 0, "wgmma": 1}  # gmm_int8's variant argument
_TGMM_CODES = {"f32": 0, "wmma": 1, "wgmma": 2}  # tgmm_backward's kernel argument


def round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def pick_block_t(rows: int, num_experts: int = 0) -> int:
    """Largest power-of-two tile <= DEFAULT_BLOCK_T that does not dwarf the
    row count; with ``num_experts`` it also shrinks while the worst-case
    per-expert alignment padding ``E * (bt - 1)`` exceeds half the rows
    (decode dispatches route a handful of tokens)."""
    bt = 8
    while bt < DEFAULT_BLOCK_T and bt < rows:
        bt *= 2
    if num_experts > 0:
        while bt > 8 and num_experts * (bt - 1) > rows // 2:
            bt //= 2
    return bt


def tile_experts(group_sizes: torch.Tensor, n_tiles: int,
                 block_t: int) -> torch.Tensor:
    """int64 ``[n_tiles]`` owning expert of each row tile: the first expert
    whose cumulative end exceeds the tile's start. Tiles past the last group
    clamp to the final expert."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = torch.arange(n_tiles, device=group_sizes.device) * block_t
    te = torch.searchsorted(ends, starts, right=True)
    return te.clamp_max(group_sizes.shape[0] - 1)


def gmm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
              block_t: int) -> torch.Tensor:
    """The blocked formulation: ``[n_tiles, block_t, K] @ w[tile_expert]``
    with fp32 accumulation, tail tiles (past ``sum(group_sizes)``) zeroed."""
    T, K = x.shape
    if T % block_t:
        raise ValueError(f"gmm needs T ({T}) % block_t ({block_t}) == 0; "
                         "the moe dispatcher pads for this")
    n_t = T // block_t
    te = tile_experts(group_sizes, n_t, block_t)
    live = (torch.arange(n_t, device=x.device) * block_t
            < group_sizes.sum().to(x.device))
    yt = torch.bmm(x.reshape(n_t, block_t, K).float(), w[te].float())
    yt = torch.where(live[:, None, None], yt, torch.zeros((), device=x.device))
    return yt.reshape(T, w.shape[2]).to(x.dtype)


def tgmm_plain(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
               num_experts: int, block_t: int) -> torch.Tensor:
    """``dW [E, K, N]``: for each expert, its ``block_t`` row tiles' fp32
    partials ``x_tile^T @ dy_tile``, each rounded to x's dtype, summed in
    that dtype in tile order (the Pallas kernel's output-block revisits).
    Experts with no rows are exact zeros; tail tiles are never visited.
    Reads the group sizes on the host."""
    T, K = x.shape
    N = dy.shape[1]
    if T % block_t or dy.shape[0] != T:
        raise ValueError(f"tgmm needs x [{T}, K] and dy [{dy.shape[0]}, N] with "
                         f"T % block_t ({block_t}) == 0")
    sizes = group_sizes.tolist()
    if any(n % block_t for n in sizes) or sum(sizes) > T:
        raise ValueError(f"tgmm group sizes {sizes} must be multiples of "
                         f"block_t ({block_t}) within T ({T})")
    n_t = sum(sizes) // block_t
    parts = torch.bmm(x[:n_t * block_t].reshape(n_t, block_t, K).transpose(1, 2).float(),
                      dy[:n_t * block_t].reshape(n_t, block_t, N).float()).to(x.dtype)
    dw = x.new_zeros((num_experts, K, N))
    t = 0
    for e, n in enumerate(sizes):
        for i in range(t, t + n // block_t):
            dw[e] = parts[i] if i == t else dw[e] + parts[i]
        t += n // block_t
    return dw


# -- the CUDA kernels ----------------------------------------------------------
def _takes_wgmma(dtype: torch.dtype, block_t: int, K: int, N: int,
                 aligned: bool) -> bool:
    """The TMA/wgmma kernels' preconditions: bf16, 64-row multiples of
    block_t (a CTA's 64- or 128-row tile stays inside one expert's group),
    K and N multiples of 8 (TMA's 16-byte row strides) and 16-byte aligned
    operands (TMA's base addresses)."""
    return (dtype == torch.bfloat16 and block_t % 64 == 0 and K % 8 == 0
            and N % 8 == 0 and aligned)


def _dtype_checked(dtype: torch.dtype) -> torch.dtype:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the grouped GEMM kernels take fp32 or bf16, got {dtype}")
    return dtype


def gmm_variant(dtype: torch.dtype, block_t: int, K: int, N: int,
                aligned: bool = True) -> str:
    """The kernel a CUDA :func:`gmm` call (forward or dX) launches, from its
    operands alone: "wgmma" where :func:`_takes_wgmma` holds, "wmma" for
    other bf16 calls, "f32_decode" for fp32 at block_t 8 and "f32" for other
    fp32 calls. ``K`` is the contraction width, ``N`` the output's;
    ``aligned``: every operand's ``data_ptr()`` is a multiple of 16."""
    if _dtype_checked(dtype) == torch.float32:
        return "f32_decode" if block_t == 8 else "f32"
    return "wgmma" if _takes_wgmma(dtype, block_t, K, N, aligned) else "wmma"


def tgmm_variant(dtype: torch.dtype, block_t: int, K: int, N: int,
                 aligned: bool = True) -> str:
    """The kernel a CUDA :func:`tgmm` call launches: "wgmma" where
    :func:`_takes_wgmma` holds, "wmma" for other bf16 calls, "f32" (3xTF32
    on ``wgmma``, any block_t % 8 == 0) for fp32 (``x [T, K]``,
    ``dy [T, N]``)."""
    if _dtype_checked(dtype) == torch.float32:
        return "f32"
    return "wgmma" if _takes_wgmma(dtype, block_t, K, N, aligned) else "wmma"


def decode_plan(T: int, K: int, N: int) -> Tuple[int, int]:
    """``(kc, chunks)`` for the "f32_decode" kernel on ``x [T, K]``, output
    width ``N``: each work item multiplies one 8-row tile by ``kc`` rows of
    K of one 128-column strip of its expert's weights. ``kc`` is the
    smallest multiple of 64 for which the row tiles' items, K divided
    evenly, number at most ``4 x 132`` (~4 per SM of an H100, so every SM
    streams a like share even when a few tiles are tails), capped at 256
    (the chunk's weights sit in shared memory) and at what K needs; ``chunks`` =
    ``ceil(K / kc)``. moe-8x40m's decode (T 72): (128, 4) at gate/up and
    (128, 12) at down, 432 items each."""
    tiles, strips = T // _DEC_ROWS, -(-N // _DEC_COLS)
    kc = round_up(max(1, -(-K * strips * tiles // _DEC_CTAS)), 64)
    kc = min(kc, _DEC_KC_MAX, round_up(K, 64))
    return kc, -(-K // kc)


_counters = {}


def _decode_counters(x: torch.Tensor, slots: int) -> torch.Tensor:
    """Zeroed int32 arrival counters for the decode kernel's last-CTA sums,
    one buffer per device and stream (kernels on one stream run in order;
    each leaves its counters at zero). Grown, never shrunk."""
    key = (x.device, _stream(x))
    buf = _counters.get(key)
    if buf is None or buf.numel() < slots:
        buf = _counters[key] = torch.zeros(max(slots, 1024), dtype=torch.int32,
                                           device=x.device)
    return buf


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_lib = None
_lib_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/grouped_matmul.cu`` for sm_90a (once per source hash;
    ``utils/cuda_build.py``) and return the shared library's path."""
    return cuda_build.build_library(_SRC)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.gmm_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.gmm_forward.restype = ctypes.c_int
            lib.gmm_f32_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.gmm_f32_decode.restype = ctypes.c_int
            lib.tgmm_backward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.tgmm_backward.restype = ctypes.c_int
            lib.gmm_int8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.gmm_int8.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
           block_t: int, w_trans: bool = False, name: str = "gmm") -> None:
    """The kernels' input contract; ``w`` is ``[E, K, N]``, or ``[E, N, K]``
    read transposed with ``w_trans`` (for tgmm: ``dy [T, N]``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel takes CUDA tensors, got {x.device} "
                         "(CPU tensors go to the plain version)")
    if w.device != x.device or group_sizes.device != x.device:
        raise ValueError(f"{name} operands on different devices: {x.device}, "
                         f"{w.device}, group_sizes {group_sizes.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes fp32 or bf16 operands of one "
                        f"type, got {x.dtype} and {w.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if name == "tgmm":
        shapes_ok = x.dim() == 2 and w.dim() == 2 and w.shape[0] == x.shape[0] \
            and group_sizes.dim() == 1
        want = "x [T, K], dy [T, N], group_sizes [E]"
    else:
        shapes_ok = x.dim() == 2 and w.dim() == 3 \
            and w.shape[2 if w_trans else 1] == x.shape[1] \
            and group_sizes.shape == (w.shape[0],)
        want = ("x [T, K], w [E, N, K] (read transposed), group_sizes [E]"
                if w_trans else "x [T, K], w [E, K, N], group_sizes [E]")
    if not shapes_ok:
        raise ValueError(f"{name} shapes {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_sizes.shape)}: want {want}")
    if not (x.is_contiguous() and w.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous operands")
    if block_t <= 0 or block_t % 8 or x.shape[0] % block_t:
        raise ValueError(f"{name} kernel needs block_t ({block_t}) a multiple "
                         f"of 8 dividing T ({x.shape[0]})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _gmm_forward(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                 block_t: int, w_trans: bool = False) -> torch.Tensor:
    """``x @ w[e]`` per row group, or ``x @ w[e]^T`` with ``w_trans`` (``w``
    then ``[E, N, K]``, read in place). CPU: :func:`gmm_plain`; CUDA: one
    launch of the :func:`gmm_variant` kernel, counted in ``gmm.launches``,
    ``gmm.launches_by_variant`` and ``gmm.launches_by_shape``."""
    if x.device.type == "cpu":
        return gmm_plain(x, w.transpose(1, 2) if w_trans else w, group_sizes,
                         block_t)
    _check(x, w, group_sizes, block_t, w_trans)
    T, K = x.shape
    E, N = w.shape[0], w.shape[1 if w_trans else 2]
    kind = gmm_variant(x.dtype, block_t, K, N, _aligned(x, w))
    lib = _library()
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if kind == "f32_decode":
        kc, chunks = decode_plan(T, K, N)
        partial = torch.empty((chunks, T, N), dtype=torch.float32, device=x.device) \
            if chunks > 1 else out
        counters = _decode_counters(x, (T // _DEC_ROWS) * -(-N // _DEC_COLS))
        err = lib.gmm_f32_decode(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            partial.data_ptr(), counters.data_ptr(), T, K, N, E, kc, int(w_trans),
            _stream(x))
    else:
        bm = (128 if block_t % 128 == 0 else 64) if kind == "wgmma" \
            else min(block_t, _KERNEL_ROWS)
        err = lib.gmm_forward(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            T, K, N, E, bm, _DTYPE_CODES[x.dtype], int(w_trans), _stream(x))
    if err != 0:
        raise RuntimeError(f"gmm kernel ({kind}) launch failed with CUDA error {err}")
    gmm.launches += 1
    gmm.launches_by_variant[kind] += 1
    shape = (kind, T, K, N, block_t)
    gmm.launches_by_shape[shape] = gmm.launches_by_shape.get(shape, 0) + 1
    return out


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
         num_experts: int, block_t: int) -> torch.Tensor:
    """``dW [E, K, N]`` = per expert, the sum over its row tiles of
    ``x_tile^T @ dy_tile`` with :func:`tgmm_plain`'s rounding points.

    CPU tensors run :func:`tgmm_plain`; CUDA tensors launch the
    :func:`tgmm_variant` kernel on the current stream (``tgmm.launches``,
    ``tgmm.launches_by_variant`` and ``tgmm.launches_by_shape`` count the
    launches)."""
    if x.device.type == "cpu":
        return tgmm_plain(x, dy, group_sizes, num_experts, block_t)
    _check(x, dy, group_sizes, block_t, name="tgmm")
    if group_sizes.shape[0] != num_experts:
        raise ValueError(f"tgmm: {group_sizes.shape[0]} group sizes for "
                         f"{num_experts} experts")
    T, K = x.shape
    N = dy.shape[1]
    kind = tgmm_variant(x.dtype, block_t, K, N, _aligned(x, dy))
    lib = _library()
    dw = torch.empty((num_experts, K, N), dtype=x.dtype, device=x.device)
    err = lib.tgmm_backward(
        x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(), dw.data_ptr(),
        T, K, N, num_experts, block_t, _TGMM_CODES[kind], _stream(x))
    if err != 0:
        raise RuntimeError(f"tgmm kernel ({kind}) launch failed with CUDA error {err}")
    tgmm.launches += 1
    tgmm.launches_by_variant[kind] += 1
    shape = (kind, T, K, N, block_t)
    tgmm.launches_by_shape[shape] = tgmm.launches_by_shape.get(shape, 0) + 1
    return dw


# -- matmul_precision "int8" ---------------------------------------------------
def _quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the contraction dim: ``[T, K]`` -> (int8
    ``[T, K]``, fp32 scales ``[T, 1]``); JAX's ``_quantize_rows_int8`` op for
    op (``round`` half to even, dividing by the scale)."""
    xf = x.float()
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can land one ulp off the CPU's (and JAX's) quotient
    s = (xf.abs().amax(dim=-1, keepdim=True)
         / torch.full((), 127.0, device=x.device)).clamp_min(1e-8)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _quantize_cols_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(expert, output column) symmetric int8 over the contraction dim:
    ``[E, K, N]`` -> (int8 ``[E, K, N]``, fp32 scales ``[E, 1, N]``)."""
    wf = w.float()
    s = (wf.abs().amax(dim=1, keepdim=True)
         / torch.full((), 127.0, device=w.device)).clamp_min(1e-8)  # as above
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), s


def gmm_int8_products(xq: torch.Tensor, wq: torch.Tensor, group_sizes: torch.Tensor,
                      block_t: int) -> torch.Tensor:
    """The exact int32 sums ``xq[r] @ wq[e(r)]`` ``[T, N]`` of the blocked
    formulation (tail tiles zero): in int64 on the CPU, in float64 on CUDA
    (cuBLAS has no integer batched product; every partial sum is an integer
    below 127^2 K < 2^53, so float64 is exact)."""
    T, K = xq.shape
    n_t = T // block_t
    te = tile_experts(group_sizes, n_t, block_t)
    live = (torch.arange(n_t, device=xq.device) * block_t
            < group_sizes.sum().to(xq.device))
    wide = torch.int64 if xq.device.type == "cpu" else torch.float64
    yt = torch.bmm(xq.reshape(n_t, block_t, K).to(wide), wq[te].to(wide))
    yt = torch.where(live[:, None, None], yt, torch.zeros((), dtype=wide, device=xq.device))
    return yt.reshape(T, wq.shape[2]).to(torch.int32)


def _int8_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                   group_sizes: torch.Tensor, block_t: int, dtype: torch.dtype):
    """``(float(acc) * sx) * sw[e(r)]`` in fp32, then one cast to ``dtype``."""
    T = acc.shape[0]
    te = tile_experts(group_sizes, T // block_t, block_t)
    sw_rows = sw[:, 0, :][te].repeat_interleave(block_t, dim=0)  # [T, N]
    return ((acc.float() * sx) * sw_rows).to(dtype)


def gmm_int8_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   block_t: int) -> torch.Tensor:
    """JAX's ``_gmm_int8_impl`` in plain PyTorch: quantize, contract exactly,
    scale back, cast to x's dtype; tail tiles zero."""
    T = x.shape[0]
    if T % block_t:
        raise ValueError(f"gmm int8 path needs T ({T}) % block_t ({block_t}) "
                         "== 0; the moe dispatcher pads for this")
    xq, sx = _quantize_rows_int8(x)
    wq, sw = _quantize_cols_int8(w)
    acc = gmm_int8_products(xq, wq, group_sizes, block_t)
    return _int8_epilogue(acc, sx, sw, group_sizes, block_t, x.dtype)


def gmm_int8_variant(block_t: int, N: int, aligned: bool = True) -> str:
    """The ``gmm_int8`` kernel a CUDA call launches, from its shapes alone:
    "wgmma" (an s8 wgmma fed by TMA, 64- or 128-row CTA tiles) where
    block_t % 64 == 0, the output width ``N`` is a multiple of 8 (its
    16-byte stores) and every operand's ``data_ptr()`` is a multiple of 16;
    else "mma_sync" (``mma.sync`` s8, 16- to 64-row tiles), which needs
    block_t % 16 == 0 (a CTA's m16 tiles stay inside one expert)."""
    if block_t % 64 == 0 and N % 8 == 0 and aligned:
        return "wgmma"
    if block_t % 16:
        raise ValueError(f"the gmm_int8 kernel needs block_t % 16 == 0, got {block_t}")
    return "mma_sync"


def gmm_int8_bm(block_t: int, variant: str = "mma_sync") -> int:
    """The ``gmm_int8`` kernel's CTA row tile, dividing block_t: "wgmma" 128
    where block_t allows, else 64; "mma_sync" ``min(block_t, 64)``, block_t
    a multiple of 16."""
    if variant == "wgmma":
        return 128 if block_t % 128 == 0 else 64
    if block_t % 16:
        raise ValueError(f"the gmm_int8 kernel needs block_t % 16 == 0, got {block_t}")
    return min(block_t, 64)


def gmm_int8_kernel(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor, group_sizes: torch.Tensor, block_t: int,
                    dtype: torch.dtype, with_products: bool = False):
    """One launch of the :func:`gmm_int8_variant` kernel on quantized
    operands (``xq`` int8 ``[T, K]``, ``sx`` fp32 ``[T, 1]``, ``wq`` int8
    ``[E, K, N]``, ``sw`` fp32 ``[E, 1, N]``): the output ``[T, N]`` in
    ``dtype`` (fp32 or bf16), and with ``with_products`` also the kernel's
    int32 sums. Counts the launch in ``gmm_int8.launches`` and
    ``gmm_int8.launches_by_variant``."""
    if xq.device.type != "cuda":
        raise ValueError(f"the gmm_int8 kernel takes CUDA tensors, got {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or group_sizes.dtype != torch.int32:
        raise TypeError("gmm_int8 takes int8 xq and wq and int32 group_sizes")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"gmm_int8 writes fp32 or bf16, not {dtype}")
    T, K = xq.shape
    E, _, N = wq.shape
    if T % block_t or group_sizes.shape != (E,):
        raise ValueError(f"gmm_int8 shapes {tuple(xq.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(group_sizes.shape)}: T must be a multiple of block_t "
                         f"({block_t}; the moe dispatcher pads for this)")
    pad = -K % 64  # the kernels take K in 64-byte slices; zeros add nothing
    wqt = wq.transpose(1, 2)
    if pad:
        xq, wqt = F.pad(xq, (0, pad)), F.pad(wqt, (0, pad))
    xq, wqt = xq.contiguous(), wqt.contiguous()
    sx = sx.reshape(T).float().contiguous()
    sw = sw.reshape(E, N).float().contiguous()
    out = torch.empty((T, N), dtype=dtype, device=xq.device)
    acc = torch.empty((T, N), dtype=torch.int32, device=xq.device) if with_products else None
    kind = gmm_int8_variant(block_t, N, _aligned(*(t for t in (xq, wqt, out, acc)
                                                   if t is not None)))
    err = _library().gmm_int8(
        xq.data_ptr(), wqt.data_ptr(), group_sizes.data_ptr(), sx.data_ptr(),
        sw.data_ptr(), out.data_ptr(), None if acc is None else acc.data_ptr(),
        T, K + pad, N, E, gmm_int8_bm(block_t, kind), _GMM_INT8_CODES[kind],
        _DTYPE_CODES[dtype], _stream(xq))
    if err != 0:
        raise RuntimeError(f"gmm_int8 kernel ({kind}) launch failed with CUDA error {err}")
    gmm_int8.launches += 1
    gmm_int8.launches_by_variant[kind] += 1
    return (out, acc) if with_products else out


class _GroupedMatmulInt8(torch.autograd.Function):
    """JAX's ``_gmm_int8`` custom VJP. Forward: ``_gmm_int8_impl`` (the
    ``gmm_int8`` kernel on CUDA, :func:`gmm_int8_plain` on the CPU).
    Backward, straight through in full precision: dX = ``gmm(dy, w^T)`` on
    the gmm kernels in dy's dtype; dW = each row tile's ``x^T dy`` summed in
    fp32 over the expert's tiles, zero for an empty expert, then cast to
    w's dtype, as JAX's ``_gmm_int8_bwd`` does with its "blocked" backend.
    The bf16 tgmm rounds every tile's partial to bf16 (as the Pallas
    kernel does), so dW runs the fp32 tgmm ("f32") on fp32 copies of x and
    dy: a bf16 value is exact in fp32, so are the products of two, and the
    sums are fp32 sums in tile order."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, block_t):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.block_t = block_t
        if x.device.type == "cpu":
            return gmm_int8_plain(x, w, group_sizes, block_t)
        xq, sx = _quantize_rows_int8(x)
        wq, sw = _quantize_cols_int8(w)
        return gmm_int8_kernel(xq, sx, wq, sw, group_sizes, block_t, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_forward(dy, w.contiguous(), group_sizes, ctx.block_t,
                              w_trans=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x.float().contiguous(), dy.float(), group_sizes, w.shape[0],
                      ctx.block_t).to(w.dtype)
        return dx, dw, None, None


def gmm_int8(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
             block_t: int) -> torch.Tensor:
    """``gmm`` under ``matmul_precision: int8``, differentiable
    (:class:`_GroupedMatmulInt8`). ``gmm_int8.launches`` counts the kernel's
    launches, ``gmm_int8.launches_by_variant`` each variant's."""
    return _GroupedMatmulInt8.apply(x, w, group_sizes, block_t)


class _GroupedMatmul(torch.autograd.Function):
    """``gmm`` with the JAX package's custom VJP (``_gmm_fwd`` /
    ``_gmm_bwd``): dX = ``gmm(dy, w^T)``, dW = :func:`tgmm`, each cast
    back to its input's dtype; ``group_sizes`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, block_t):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.block_t = block_t
        return _gmm_forward(x, w, group_sizes, block_t)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_forward(dy, w, group_sizes, ctx.block_t,
                              w_trans=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, group_sizes, w.shape[0], ctx.block_t).to(w.dtype)
        return dx, dw, None, None


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        block_t: int, precision: Optional[str] = None) -> torch.Tensor:
    """``x [T, K]`` x ``w [E, K, N]`` -> ``[T, N]``, row group ``e`` (per
    ``group_sizes``, block_t-aligned) against ``w[e]``; differentiable in
    ``x`` and ``w``.

    ``precision`` (model.matmul_precision): "bf16" casts both operands (the
    result is bf16); "int8" runs :func:`gmm_int8`. CPU tensors run the
    plain versions; CUDA tensors launch the kernels on the current stream
    (``gmm.launches`` counts forward and dX launches, ``tgmm.launches``
    the dW ones, ``gmm_int8.launches`` the int8 forwards)."""
    precision = check_matmul_precision(precision)
    if precision == "int8":
        return gmm_int8(x, w, group_sizes, block_t)
    if precision == "bf16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    return _GroupedMatmul.apply(x, w, group_sizes, block_t)


def reset_launches() -> None:
    """Set the gmm, tgmm and gmm_int8 launch counts (totals, per variant, and
    the gmm's per shape) to 0."""
    gmm.launches = tgmm.launches = gmm_int8.launches = 0
    gmm.launches_by_variant = dict.fromkeys(GMM_VARIANTS, 0)
    gmm.launches_by_shape = {}
    tgmm.launches_by_variant = dict.fromkeys(TGMM_VARIANTS, 0)
    tgmm.launches_by_shape = {}
    gmm_int8.launches_by_variant = dict.fromkeys(GMM_INT8_VARIANTS, 0)


reset_launches()
