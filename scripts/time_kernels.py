#!/usr/bin/env python3
"""Device times of the port's fp32 serving gmm kernels, tgmm and the flash
backward kernels at their paths' shapes, from one checkout: to compare two
trees on one card.

    python3 scripts/time_kernels.py [--root DIR] [--reps 20]
                                    [--shapes all|serve|train] [--out f.json]

Imports the port from ``--root`` (default: the checkout holding this
script), so its kernels are built from that tree's ``csrc/`` into that
tree's ``build/kernels/``. The shapes:

- fp32 gmm at the serving path's (moe-8x40m, 8 experts top-2, the routing
  draws of ``chip_smoke.py``'s kernel phase): decode gate/up (x [72, 512],
  w [8, 512, 1536]) and down (x [72, 1536]) at block_t 8 ("f32_decode");
  a 256-token prefill chunk's gate/up and down (x [768, ...]) at block_t
  32 and a 160-token chunk's down at block_t 16 ("f32"). Each launch reads
  the next of several weight copies that together exceed twice the 50 MB
  L2, so the weights come from HBM as on the serving path. Beside them,
  yardsticks of the card's read rate in the same harness: ``torch.sum``
  over 25.2 MB (a decode call's weight bytes) cold and hot in L2, and
  over 1 GB;
- at the MoE training path's (65,536 selections routed over 8 experts,
  block_t 128; the routing draw of ``chip_smoke.py``): tgmm gate/up
  (x [T, 512], dy [T, 1536]), down (x [T, 1536], dy [T, 512]) and gate/up
  with one expert holding half the selections;
- flash dQ and dK/dV at B 32, H 8, S 1024, D 64, bf16, causal.

Each time is the mean over ``--reps`` back-to-back launches between CUDA
events, after warm-up. To compare a change with its parent, unpack the
parent into a git-ignored directory (``git archive``) and time parent,
change, change, parent in one call, on one card. Prints one JSON object
with the card's name and power limit; needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, SELECTIONS, BLOCK_T, EXPERTS = 0, 32 * 1024 * 2, 128, 8


def device_ms(torch, fn, reps: int, copies: int = 1) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` launches, ``i`` cycling
    over ``copies`` operand copies."""
    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host enqueues every launch before start fires
    start.record()
    for i in range(reps):
        fn(i % copies)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def routed(torch, rng, selections: int, block_t: int):
    """One routing draw's group sizes (rounded up to block_t) and buffer
    rows, as ``chip_smoke.py::routed_sizes`` draws them."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops.grouped_matmul import round_up

    ids = torch.randint(0, EXPERTS, (selections,), generator=rng)
    counts = torch.bincount(ids, minlength=EXPERTS)
    sizes = ((counts + block_t - 1) // block_t * block_t).to(torch.int32)
    return sizes, round_up(selections + EXPERTS * (block_t - 1), block_t)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", choices=("all", "serve", "train"), default="all",
                    help="the serving path's fp32 gmm, the training path's kernels, or both")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(opts.root))
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm
    from mlx_cuda_distributed_pretraining_tpu_torch.ops.grouped_matmul import round_up

    assert gm.__file__.startswith(os.path.abspath(opts.root)), gm.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    # chip_smoke.py's training-path routing draw (its seed + 1)
    rng = torch.Generator().manual_seed(SEED + 1)
    ids = torch.randint(0, EXPERTS, (SELECTIONS,), generator=rng)
    counts = torch.bincount(ids, minlength=EXPERTS)
    sizes = ((counts + BLOCK_T - 1) // BLOCK_T * BLOCK_T).to(torch.int32)
    rows = round_up(SELECTIONS + EXPERTS * (BLOCK_T - 1), BLOCK_T)
    hot = torch.full((EXPERTS,), SELECTIONS // (2 * (EXPERTS - 1)), dtype=torch.int64)
    hot[0] = SELECTIONS - int(hot[1:].sum())
    hot = ((hot + BLOCK_T - 1) // BLOCK_T * BLOCK_T).to(torch.int32)

    out = {"root": os.path.abspath(opts.root), "card": card, "ms": {}}
    g = torch.Generator().manual_seed(SEED)
    # the serving path's fp32 gmm: chip_smoke.py's kernel-phase draws, in its order
    srng = torch.Generator().manual_seed(SEED)
    dec, pre, short = (routed(torch, srng, n, bt) for n, bt in ((16, 8), (512, 32), (320, 16)))
    serve_shapes = [
        ("f32_decode_gate_up", dec, 8, 512, 1536), ("f32_decode_down", dec, 8, 1536, 512),
        ("f32_prefill_gate_up", pre, 32, 512, 1536), ("f32_prefill_down", pre, 32, 1536, 512),
        ("f32_prefill_short_down", short, 16, 1536, 512)]
    for name, (gs, n_rows), bt, K, N in serve_shapes if opts.shapes != "train" else []:
        x = torch.randn(n_rows, K, generator=g)
        x[int(gs.sum()):] = 0
        x = x.cuda()
        copies = max(2, int(2 * 50e6 // (EXPERTS * K * N * 4)) + 2)
        ws = [(torch.randn(EXPERTS, K, N, generator=g) / K ** 0.5).cuda()
              for _ in range(copies)]
        gsd = gs.to("cuda")
        out["ms"][name] = device_ms(torch, lambda i: gm.gmm(x, ws[i], gsd, bt),
                                    2 * opts.reps, copies)
        del x, ws
    if opts.shapes != "train":
        bufs = [torch.randn(EXPERTS * 512 * 1536, generator=g).cuda() for _ in range(6)]
        out["ms"]["yardstick_sum_25mb_cold"] = device_ms(
            torch, lambda i: bufs[i].sum(), 2 * opts.reps, len(bufs))
        out["ms"]["yardstick_sum_25mb_hot"] = device_ms(
            torch, lambda _: bufs[0].sum(), 2 * opts.reps)
        del bufs
        big = torch.empty(2 ** 28, device="cuda").uniform_()
        out["ms"]["yardstick_sum_1gb"] = device_ms(torch, lambda _: big.sum(), 5)
        del big
    if opts.shapes == "serve":
        return report(out, gm, fa, opts)
    for name, K, N, gs in (("tgmm_gate_up", 512, 1536, sizes), ("tgmm_down", 1536, 512, sizes),
                           ("tgmm_imbalanced_gate_up", 512, 1536, hot)):
        x = torch.randn(rows, K, generator=g).to("cuda", torch.bfloat16)
        x[int(gs.sum()):] = 0
        dy = torch.randn(rows, N, generator=g).to("cuda", torch.bfloat16)
        gsd = gs.to("cuda")
        out["ms"][name] = device_ms(torch, lambda _: gm.tgmm(x, dy, gsd, EXPERTS, BLOCK_T),
                                    opts.reps)
        del x, dy
    B, H, S, D = 32, 8, 1024, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=g).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    kw = dict(mask_type="causal", scale=D ** -0.5)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    out["ms"]["flash_bwd_dq"] = device_ms(
        torch, lambda _: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), opts.reps)
    out["ms"]["flash_bwd_dkv"] = device_ms(
        torch, lambda _: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw), opts.reps)
    return report(out, gm, fa, opts)


def report(out, gm, fa, opts) -> int:
    out["variants"] = {"gmm": dict(gm.gmm.launches_by_variant),
                       "tgmm": dict(gm.tgmm.launches_by_variant),
                       **{n: dict(getattr(fa, n).launches_by_variant)
                          for n in ("flash_bwd_dq", "flash_bwd_dkv")}}
    line = json.dumps(out)
    print(line, flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
