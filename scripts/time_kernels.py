#!/usr/bin/env python3
"""Device times of the port's tgmm and flash backward kernels at the
training path's shapes, from one checkout: to compare two trees on one card.

    python3 scripts/time_kernels.py [--root DIR] [--reps 20] [--out f.json]

Imports the port from ``--root`` (default: the checkout holding this
script), so its kernels are built from that tree's ``csrc/`` into that
tree's ``build/kernels/``. The shapes are the MoE training path's
(moe-8x40m: 65,536 selections routed over 8 experts, block_t 128; the
routing draw of ``chip_smoke.py``):

- tgmm gate/up (x [T, 512], dy [T, 1536]), down (x [T, 1536], dy [T, 512])
  and gate/up with one expert holding half the selections;
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


def device_ms(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host enqueues every launch before start fires
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
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
    for name, K, N, gs in (("tgmm_gate_up", 512, 1536, sizes), ("tgmm_down", 1536, 512, sizes),
                           ("tgmm_imbalanced_gate_up", 512, 1536, hot)):
        x = torch.randn(rows, K, generator=g).to("cuda", torch.bfloat16)
        x[int(gs.sum()):] = 0
        dy = torch.randn(rows, N, generator=g).to("cuda", torch.bfloat16)
        gsd = gs.to("cuda")
        out["ms"][name] = device_ms(torch, lambda: gm.tgmm(x, dy, gsd, EXPERTS, BLOCK_T),
                                    opts.reps)
        del x, dy
    B, H, S, D = 32, 8, 1024, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=g).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    kw = dict(mask_type="causal", scale=D ** -0.5)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    out["ms"]["flash_bwd_dq"] = device_ms(
        torch, lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), opts.reps)
    out["ms"]["flash_bwd_dkv"] = device_ms(
        torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw), opts.reps)
    out["variants"] = {"tgmm": dict(gm.tgmm.launches_by_variant),
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
