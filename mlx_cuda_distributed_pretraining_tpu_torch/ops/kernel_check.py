"""How the port's kernels are held against their plain versions on the card,
and planted faults that the check must catch.

``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` both use
:func:`compare` for every kernel (gmm and the three flash kernels; tgmm
through :func:`compare_experts`, expert by expert; ``gmm_int8`` through
:func:`compare_int8`, its int32 sums bitwise), so the gates cannot drift
apart; each must reject its planted fault (:func:`planted_fault`,
:func:`gmm_skipping_a_tile`, :func:`tgmm_skipping_a_tile`,
:func:`gmm_int8_skipping_a_tile`).

The limits scale with the typical value of the output (its RMS), not its
largest: in a causal row the flash output shrinks as ``sqrt(e / n)`` over
``n`` live keys, so a limit taken from the first rows (where ``o ~ v``)
would be as large as the late rows' values, and a kernel that dropped part
of a late row's softmax mass would pass. Two checks, both must hold:

- per element, ``|got - ref| <= atol + rtol * |ref|``;
- over the whole tensor, ``||got - ref|| / ||ref|| <= norm``.

fp32: atol 1e-5 x RMS, rtol 1e-4, norm 1e-5. The flash kernels are held
to their plain version evaluated in float64 (:func:`reference`): in fp32
the plain version carries its own rounding, and where the flash backward
cancels (dQ's rows with one live key, where dS = P (dP - delta) is
rounding noise) that alone can miss the exact result by more than the
per-element limit (``chip_smoke.py`` prints the fp32 plain version's own
ratio in each fp32 case). Against the fp32 plain version only a kernel
that sums in cuBLAS's order (a sequential FMA loop) passes there; the
3xTF32 kernels sum in another. gmm and tgmm keep the fp32 plain version.

bf16: flash rounds p and dS to bf16 at the same points in both versions
(the kernel's p against its running max, the plain one's against the row
max: an error of at most 2**-9 of each term) and rounds the output once;
gmm rounds one fp32 sum; tgmm rounds each tile's fp32 partial and the
running sum at the same points in both versions, so only the partials' fp32
summation order differs (a partial that lands on the other side of a bf16
rounding boundary sets the two running sums on rounding paths that drift
apart by about sqrt(tiles left) half-ulps of the sum). A correct kernel is at most about one bf16 ulp
(2**-8 to 2**-7 relative) from the plain version: atol 2**-5 x RMS (four
ulps of a typical value), rtol 2e-2, norm 1e-2 (an ulp on every element
would read 4e-3).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from . import flash_attention as fa
from . import grouped_matmul as gm

_LIMITS = {  # dtype: (atol as a fraction of the RMS, rtol, normwise)
    torch.float32: (1e-5, 1e-4, 1e-5),
    torch.bfloat16: (2 ** -5, 2e-2, 1e-2),
}


def reference(plain, *args, **kw):
    """``plain(*args, **kw)`` for fp32 operands (``args[0]``, q, is fp32)
    with every fp32 tensor of ``args`` upcast to float64 and each output
    cast back to fp32: the exact reference the fp32 flash kernels are held
    to. For bf16 operands the call runs as given (a bf16 kernel is held to
    the plain version's own rounding points; its fp32 lse and delta stay
    fp32)."""
    if args[0].dtype != torch.float32:
        return plain(*args, **kw)
    out = plain(*(a.double() if isinstance(a, torch.Tensor) and a.dtype == torch.float32
                  else a for a in args), **kw)
    return tuple(o.float() for o in out) if isinstance(out, tuple) else out.float()


def compare(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``got`` (a kernel's output) against ``ref`` (its plain version's):
    the largest error, the largest error as a share of its per-element
    limit (``limit_ratio``, at most 1 to pass), the normwise error and
    ``ok``."""
    atol_rms, rtol, norm_limit = _LIMITS[ref.dtype]
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return {"max_abs_err": float("inf"), "limit_ratio": float("inf"),
                "norm_err": float("inf"), "ok": False}
    diff = (got - ref).abs()
    ref_norm = ref.norm().item()
    atol = max(atol_rms * ref_norm / ref.numel() ** 0.5, 1e-30)
    ratio = (diff / (atol + rtol * ref.abs())).max().item()
    norm_err = diff.norm().item() / max(ref_norm, 1e-30)
    return {"max_abs_err": diff.max().item(), "limit_ratio": ratio,
            "norm_err": norm_err, "ok": ratio <= 1.0 and norm_err <= norm_limit}


def compare_experts(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """:func:`compare` applied to each expert's block ``[e]`` of a tgmm
    output on its own, and the worst of them (``ok`` only if every expert
    passes). An expert's dW scales with its row count, so a hot expert's
    bf16 running sum carries ulps larger than the other experts' typical
    value; each expert is held to its own RMS."""
    if got.shape != ref.shape:
        return compare(got, ref)
    checks = [compare(g, r) for g, r in zip(got, ref)]
    return {"max_abs_err": max(c["max_abs_err"] for c in checks),
            "limit_ratio": max(c["limit_ratio"] for c in checks),
            "norm_err": max(c["norm_err"] for c in checks),
            "ok": all(c["ok"] for c in checks)}


def kernel_outputs(q, k, v, do, lse, delta, **kw) -> Dict[str, torch.Tensor]:
    """The three kernels' outputs ``o``, ``dq``, ``dk``, ``dv`` on one set of
    inputs. Both backward kernels take the given (plain) ``lse`` and
    ``delta``, so each kernel is held against its own plain version
    alone."""
    o, _ = fa.flash_fwd(q, k, v, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return {"o": o, "dq": dq, "dk": dk, "dv": dv}


@contextlib.contextmanager
def planted_fault():
    """Launch the kernels with one live tile left out of their plans: the
    forward and dQ skip the last live KV tile of the last Q tile (the
    diagonal tile under a causal or sliding-window mask), dK/dV skip the
    last Q tile of the first KV tile that holds a pair the mask allows (the
    Q-tile planner may keep a tile past a sliding window, which holds none;
    the fault ends the range before the last tile that does). The kernels
    themselves run unchanged; what they return is what a kernel with that
    bug would return, and :func:`compare` must reject it."""
    plan = fa._plan

    def faulty(mask_type, window, prefix_len, S, block, device, block_kv=None):
        kv_ranges, q_ranges, full = plan(mask_type, window, prefix_len, S, block, device,
                                         block_kv)
        kv_ranges, q_ranges = kv_ranges.clone(), q_ranges.clone()
        kv_ranges[-1, 1] -= 1
        bq, bkv = block, block if block_kv is None else block_kv
        mod = fa._mask_mod(mask_type, window, prefix_len)
        allowed = (fa.M.materialize_mask(mod, S, min(bkv, S)) if mod is not None
                   else torch.ones(S, min(bkv, S), dtype=torch.bool))
        lo, hi = (int(x) for x in q_ranges[0])
        while hi - 1 > lo and not bool(allowed[(hi - 1) * bq:hi * bq].any()):
            hi -= 1
        q_ranges[0, 1] = hi - 1
        return kv_ranges, q_ranges, full

    fa._plan = faulty
    try:
        yield
    finally:
        fa._plan = plan


def gmm_skipping_a_tile(x, w, group_sizes, block_t: int, w_trans: bool = False):
    """:func:`grouped_matmul.gmm`'s forward (or dX, with ``w_trans``) with
    the last live row tile left out: the kernel (or, on the CPU, the plain
    version) runs unchanged on the last non-empty group shortened by one
    block_t, which turns that tile into a tail tile and zeroes its rows, as
    a kernel that skipped the tile would leave them (no other row moves).
    :func:`compare` must reject it."""
    sizes = group_sizes.clone()
    e = int(torch.nonzero(sizes).max())
    sizes[e] -= block_t
    return gm._gmm_forward(x, w, sizes, block_t, w_trans)


def tgmm_skipping_a_tile(x, dy, group_sizes, num_experts: int, block_t: int):
    """:func:`grouped_matmul.tgmm` with the last non-empty expert's last row
    tile left out of its walk: the kernel (or, on the CPU, the plain
    version) runs unchanged on that expert's group shortened by one tile,
    which is what a kernel that skipped the tile would return (no other
    expert's rows move). :func:`compare_experts` must reject it."""
    sizes = group_sizes.clone()
    e = int(torch.nonzero(sizes).max())
    sizes[e] -= block_t
    return gm.tgmm(x, dy, sizes, num_experts, block_t)


def int8_operands(x, w):
    """``gmm_int8``'s quantized operands of ``x [T, K]`` and ``w [E, K, N]``:
    ``(xq, sx, wq, sw)``."""
    xq, sx = gm._quantize_rows_int8(x)
    wq, sw = gm._quantize_cols_int8(w)
    return xq, sx, wq, sw


def gmm_int8_plain_outputs(xq, sx, wq, sw, group_sizes, block_t: int, dtype):
    """The plain version's int32 sums and output for quantized operands."""
    acc = gm.gmm_int8_products(xq, wq, group_sizes, block_t)
    return acc, gm._int8_epilogue(acc, sx, sw, group_sizes, block_t, dtype)


def compare_int8(acc, out, ref_acc, ref_out) -> Dict[str, float]:
    """``gmm_int8``'s gate: its int32 sums equal the plain version's bit for
    bit (integer sums are exact), and its output passes :func:`compare`
    against the plain epilogue (the same fp32 products and one rounding, so
    a correct kernel matches it exactly)."""
    check = compare(out, ref_out)
    exact = bool(torch.equal(acc, ref_acc))
    check.update(int32_equal=exact, ok=check["ok"] and exact)
    return check


def gmm_int8_skipping_a_tile(xq, sx, wq, sw, group_sizes, block_t: int, dtype):
    """The ``gmm_int8`` kernel with the last live row tile left out (its
    rows zeroed, as a kernel that skipped the tile would leave them): the
    kernel runs unchanged on the last non-empty group shortened by one
    block_t. Returns ``(int32 sums, output)``; :func:`compare_int8` must
    reject them."""
    sizes = group_sizes.clone()
    e = int(torch.nonzero(sizes).max())
    sizes[e] -= block_t
    out, acc = gm.gmm_int8_kernel(xq, sx, wq, sw, sizes, block_t, dtype,
                                  with_products=True)
    return acc, out
