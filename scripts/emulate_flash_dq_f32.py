#!/usr/bin/env python3
"""Emulate the fp32 flash dQ kernel's arithmetic in numpy, on the CPU, for
the first 64 query rows of every (batch, head) (causal: the rows whose
first key holds the softmax, where dS = P (dP - delta) cancels), and hold
each way of computing dP against the plain version evaluated in float64
with ``kernel_check``'s fp32 limits.

    python3 scripts/emulate_flash_dq_f32.py [--batch 32] [--head-dim 64]

The inputs are ``chip_smoke.py``'s flash case inputs (seed 0, H 8, S
1024, causal). The model of the tensor cores: tf32 operands rounded to
nearest (ties away), exact products, each ``mma.sync`` summing its
products and accumulator exactly and truncating the sum to fp32; fp32
adds round to nearest. S, P, dS and dQ += dS K run as the kernel runs
them (3xTF32, ``mma3``); dP runs as each variant says. Prints one line a
variant: its largest per-element limit ratio (at most 1 passes) and
where. A CPU model only: no device time comes from it.
"""

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, F64 = np.float32, np.float64
ROWS, BKV, HEADS, S = 64, 32, 8, 1024


def rna(x):
    """fp32 -> tf32, to nearest, ties away (cvt.rna.tf32.f32)."""
    u = x.astype(F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x, pieces=2):
    """x as ``pieces`` tf32 terms, largest first."""
    out, rest = [], x.astype(F32)
    for _ in range(pieces):
        out.append(rna(rest))
        rest = (rest - out[-1]).astype(F32)
    return out


def mma(a, b, c):
    """One mma.sync: c + a @ b summed exactly, truncated to fp32."""
    v = c.astype(F64) + np.matmul(a.astype(F64), b.astype(F64))
    f = v.astype(F32)
    over = np.abs(f.astype(F64)) > np.abs(v)
    f[over] = np.nextafter(f[over], F32(0))
    return f


# dP variants: (terms of a k-step as (A piece, B piece) index pairs, small
# first; pieces per operand; k-step sums added in fp64)
VARIANTS = {
    "3xTF32, fp32 sums (the kernel before)": ([(1, 0), (0, 1), (0, 0)], 2, False),
    "3xTF32, fp64 sums": ([(1, 0), (0, 1), (0, 0)], 2, True),
    "4xTF32, fp32 sums": ([(1, 1), (1, 0), (0, 1), (0, 0)], 2, False),
    "4xTF32, fp64 sums": ([(1, 1), (1, 0), (0, 1), (0, 0)], 2, True),
    "three pieces, six products, fp64 sums":
        ([(1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)], 3, True),
    "fp64 products and sums (mma.m16n8k4.f64, the kernel now)": (None, 0, True),
}


def kstep(acc, a, b, terms=((1, 0), (0, 1), (0, 0)), pieces=2, wide=False):
    """acc += a @ b for one k-step: the terms summed from zero in the
    tensor cores, then added into acc (fp32, or fp64 if ``wide``)."""
    if terms is None:
        d = np.matmul(a.astype(F64), b.astype(F64))
    else:
        pa, pb = split(a, pieces), split(b, pieces)
        d = np.zeros(acc.shape, F32)
        for i, j in terms:
            d = mma(pa[i], pb[j], d)
    return acc + d.astype(F64) if wide else (acc + d).astype(F32)


def emulate(q, k, v, do, lse, delta, scale, terms, pieces, wide):
    B, D = q.shape[0], q.shape[-1]
    rows = np.arange(ROWS)[:, None]
    dq = np.zeros((B, HEADS, ROWS, D), F32)
    for j in range(ROWS // BKV):
        kt, vt = k[..., j * BKV:(j + 1) * BKV, :], v[..., j * BKV:(j + 1) * BKV, :]
        s = np.zeros((B, HEADS, ROWS, BKV), F32)
        dp = np.zeros(s.shape, F64 if wide else F32)
        for kk in range(D // 8):
            c = slice(8 * kk, 8 * kk + 8)
            s = kstep(s, q[..., c], np.swapaxes(kt[..., c], -1, -2))
            dp = kstep(dp, do[..., c], np.swapaxes(vt[..., c], -1, -2), terms, pieces, wide)
        cols = j * BKV + np.arange(BKV)[None, :]
        p = np.where(cols <= rows, np.exp((s * F32(scale) - lse).astype(F32)), F32(0))
        diff = (dp - delta.astype(dp.dtype)).astype(F32)
        ds = ((p * diff).astype(F32) * F32(scale)).astype(F32)
        for kk in range(BKV // 8):
            dq = kstep(dq, ds[..., 8 * kk:8 * kk + 8], kt[..., 8 * kk:8 * kk + 8, :])
    return dq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=64)
    opts = ap.parse_args()
    import torch

    sys.path.insert(0, HERE)
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check

    B, D = opts.batch, opts.head_dim
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, S, HEADS, D, generator=g).transpose(1, 2) for _ in range(4))
    kw = dict(mask_type="causal", window=256, prefix_len=384, scale=D ** -0.5)
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do * o).sum(-1).contiguous()
    exact = torch.cat([kernel_check.reference(
        fa.flash_bwd_dq_plain, *(t[b:b + 1] for t in (q, k, v, do, lse, delta)), **kw)
        for b in range(B)])
    plain = torch.cat([fa.flash_bwd_dq_plain(*(t[b:b + 1] for t in (q, k, v, do, lse, delta)),
                                             **kw) for b in range(B)])
    atol_rms, rtol, _ = kernel_check._LIMITS[torch.float32]
    atol = atol_rms * exact.norm().item() / exact.numel() ** 0.5

    def ratio(got, ref):
        r = (got.double() - ref.double()).abs() / (atol + rtol * ref.double().abs())
        return r.max().item(), tuple(int(i) for i in np.unravel_index(r.argmax().item(), r.shape))

    print(f"B {B}, H {HEADS}, S {S}, D {D}, causal: the fp32 plain version (CPU) "
          f"{ratio(plain, exact)[0]:.3f}")
    args = [t[..., :ROWS, :].numpy() for t in (q, k, v, do)]
    args += [t[..., :ROWS].numpy()[..., None] for t in (lse, delta)]
    ref = exact[..., :ROWS, :]
    for name, (terms, pieces, wide) in VARIANTS.items():
        got = emulate(*args, D ** -0.5, terms, pieces, wide)
        worst, at = ratio(torch.from_numpy(got), ref)
        print(f"  dP {name}: limit ratio {worst:.3f} at (b, h, row, col) {at}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
