"""Grouped expert matmul (``gmm``) for dropless MoE dispatch.

``x [T, K]`` is a token-sorted, block-aligned activation buffer and
``w [E, K, N]`` the stacked expert weights: rows ``[offset_e, offset_{e+1})``
of ``x`` multiply ``w[e]`` (MegaBlocks formulation, Gale et al., 2022). Every
group size is a multiple of ``block_t`` (the dispatcher in ``models/moe.py``
pads for this), so a ``block_t`` row tile never straddles two experts. Rows
past ``sum(group_sizes)`` come out as zeros.

Two versions of one function:

- the kernel, ``csrc/grouped_matmul.cu`` (CUDA C++ for ``sm_90a``), replacing
  the JAX package's Pallas TPU kernel ``ops/grouped_matmul.py::_gmm_pallas``.
  It is compiled with ``nvcc`` at first use into ``build/kernels/`` at the
  repository root (``utils/cuda_build.py``) and bound through ``ctypes``;
- :func:`gmm_plain`, the JAX package's "blocked" formulation in plain PyTorch:
  one weight gather per row tile and one batched matmul, fp32 accumulation.

:func:`gmm` sends CPU tensors to the plain version and CUDA tensors to the
kernel; anything else raises. No build or launch error falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..utils import cuda_build

__all__ = [
    "DEFAULT_BLOCK_T",
    "build_library",
    "gmm",
    "gmm_plain",
    "pick_block_t",
    "round_up",
    "tile_experts",
]

# Largest row tile the dispatcher picks (the TPU's 128-row matrix unit set the
# JAX default; kept so both packages pad identically).
DEFAULT_BLOCK_T = 128

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "grouped_matmul.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_ROWS = 32  # largest CTA row tile the kernel has (8, 16 or 32)


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


# -- the CUDA kernel -----------------------------------------------------------
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
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.gmm_forward.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
           block_t: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"gmm kernel takes CUDA tensors, got {x.device} "
                         "(CPU tensors go to the plain version)")
    if w.device != x.device or group_sizes.device != x.device:
        raise ValueError(f"gmm operands on different devices: x {x.device}, "
                         f"w {w.device}, group_sizes {group_sizes.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"gmm kernel takes fp32 or bf16 x and w of one type, "
                        f"got {x.dtype} and {w.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] \
            or group_sizes.shape != (w.shape[0],):
        raise ValueError(f"gmm shapes: x {tuple(x.shape)} [T, K], w "
                         f"{tuple(w.shape)} [E, K, N], group_sizes "
                         f"{tuple(group_sizes.shape)} [E]")
    if not (x.is_contiguous() and w.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError("gmm kernel needs contiguous x, w and group_sizes")
    if block_t <= 0 or block_t % 8 or x.shape[0] % block_t:
        raise ValueError(f"gmm kernel needs block_t ({block_t}) a multiple "
                         f"of 8 dividing T ({x.shape[0]})")


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        block_t: int) -> torch.Tensor:
    """``x [T, K]`` x ``w [E, K, N]`` -> ``[T, N]`` in x's dtype, row group
    ``e`` (per ``group_sizes``, block_t-aligned) against ``w[e]``.

    CPU tensors run :func:`gmm_plain`; CUDA tensors launch the kernel on the
    current stream (``gmm.launches`` counts those launches)."""
    if x.device.type == "cpu":
        return gmm_plain(x, w, group_sizes, block_t)
    _check(x, w, group_sizes, block_t)
    lib = _library()
    T, K = x.shape
    E, _, N = w.shape
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    err = lib.gmm_forward(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        T, K, N, E, min(block_t, _KERNEL_ROWS), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed with CUDA error {err}")
    gmm.launches += 1
    return out


gmm.launches = 0
