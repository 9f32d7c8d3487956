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
  ``tgmm.launches_by_variant`` count the launches of each;
- :func:`gmm_plain`, the JAX package's "blocked" formulation in plain
  PyTorch (one weight gather per row tile and one batched matmul, fp32
  accumulation), and :func:`tgmm_plain`, the Pallas kernel's rounding points
  in plain PyTorch.

CPU tensors go to the plain versions and CUDA tensors to the kernels;
anything else raises. No build or launch error falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from .flash_attention import check_matmul_precision

__all__ = [
    "DEFAULT_BLOCK_T",
    "GMM_VARIANTS",
    "TGMM_VARIANTS",
    "build_library",
    "decode_plan",
    "gmm",
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
    :func:`_takes_wgmma` holds, "wmma" for other bf16 calls, "f32" for
    fp32 (``x [T, K]``, ``dy [T, N]``)."""
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
    launch of the :func:`gmm_variant` kernel, counted in ``gmm.launches``
    and ``gmm.launches_by_variant``."""
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
    return out


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
         num_experts: int, block_t: int) -> torch.Tensor:
    """``dW [E, K, N]`` = per expert, the sum over its row tiles of
    ``x_tile^T @ dy_tile`` with :func:`tgmm_plain`'s rounding points.

    CPU tensors run :func:`tgmm_plain`; CUDA tensors launch the
    :func:`tgmm_variant` kernel on the current stream (``tgmm.launches``
    and ``tgmm.launches_by_variant`` count the launches)."""
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
    return dw


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
    result is bf16); "int8" is not ported and raises. CPU tensors run the
    plain versions; CUDA tensors launch the kernels on the current stream
    (``gmm.launches`` counts forward and dX launches, ``tgmm.launches``
    the dW ones)."""
    precision = check_matmul_precision(precision)
    if precision == "int8":
        raise NotImplementedError(
            "matmul_precision int8 in the grouped GEMM is not ported (ROADMAP "
            "queue 1 item 8: speculation and quantization)")
    if precision == "bf16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    return _GroupedMatmul.apply(x, w, group_sizes, block_t)


def reset_launches() -> None:
    """Set the gmm and tgmm launch counts, totals and per variant, to 0."""
    gmm.launches = tgmm.launches = 0
    gmm.launches_by_variant = dict.fromkeys(GMM_VARIANTS, 0)
    tgmm.launches_by_variant = dict.fromkeys(TGMM_VARIANTS, 0)


reset_launches()
