#!/usr/bin/env python3
"""The fp32 flash kernels and their fp32 plain versions, each held to the
plain version evaluated in float64 (``kernel_check.reference``, the fp32
gate's reference), and the kernels held to the fp32 plain version: the
``kernel_check.compare`` readings of every output.

    python3 scripts/flash_f32_reference.py [--out f.json]

The cases are the fp32 dQ cases of ``tests/test_torch_kernels_cuda.py``'s
redesigned-kernel test where the 3xTF32 dQ missed the fp32 plain version's
per-element limit, with that test's inputs (``_flash_inputs`` seeded with
S + D: [B, S, H, D] tensors seen as [B, H, S, D], or made contiguous for
the "bhsd" layout). Prints one JSON object with the card's name and power
limit; needs CUDA; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, Hq, Hkv, S, mask, window, prefix, mod, arg, layout, D)
CASES = [
    (2, 4, 4, 512, "causal", 0, 0, "none", 0.0, "bshd", 64),
    (2, 4, 4, 1000, "causal", 0, 0, "none", 0.0, "bshd", 128),
    (2, 4, 4, 1000, "sliding_window", 300, 0, "none", 0.0, "bhsd", 128),
    (2, 4, 4, 1000, "causal", 0, 0, "soft_cap", 50.0, "bshd", 128),
    (1, 8, 2, 1000, "causal", 0, 0, "none", 0.0, "bshd", 128),
]


def inputs(torch, B, Hq, Hkv, S, D, layout):
    """q, k, v, dO as the CUDA test makes them (fp32, seed S + D)."""
    g = torch.Generator().manual_seed(S + D)
    out = [torch.randn(B, S, h, D, generator=g).to("cuda", torch.float32).transpose(1, 2)
           for h in (Hq, Hkv, Hkv, Hq)]
    return [t.contiguous() for t in out] if layout == "bhsd" else out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_reference: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rows = []
    for B, Hq, Hkv, S, mask, window, prefix, mod, arg, layout, D in CASES:
        q, k, v, do = inputs(torch, B, Hq, Hkv, S, D, layout)
        kw = dict(mask_type=mask, window=window, prefix_len=prefix, scale=D ** -0.5,
                  score_mod=mod, score_arg=arg)
        ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
        delta = (do * ro).sum(-1).contiguous()
        plain = {"o": ro, "dq": fa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)}
        plain.update(zip(("dk", "dv"), fa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)))
        exact = {"o": kernel_check.reference(fa.flash_fwd_plain, q, k, v, **kw)[0],
                 "dq": kernel_check.reference(fa.flash_bwd_dq_plain, q, k, v, do, rlse,
                                              delta, **kw)}
        exact.update(zip(("dk", "dv"), kernel_check.reference(
            fa.flash_bwd_dkv_plain, q, k, v, do, rlse, delta, **kw)))
        got = {"o": fa.flash_fwd(q, k, v, **kw)[0],
               "dq": fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)}
        got.update(zip(("dk", "dv"), fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)))
        readings = {out: {"kernel_vs_float64": kernel_check.compare(got[out], exact[out]),
                          "plain_vs_float64": kernel_check.compare(plain[out], exact[out]),
                          "kernel_vs_plain": kernel_check.compare(got[out], plain[out])}
                    for out in exact}
        rows.append({"case": [B, Hq, Hkv, S, mask, window, prefix, mod, arg, layout, D],
                     "readings": readings})
        print(f"B {B} H {Hq}/{Hkv} S {S} D {D} {mask} {window} {mod} {layout}: " + " | ".join(
            f"{out} limit_ratio kernel/f64 {r['kernel_vs_float64']['limit_ratio']:.3g} "
            f"plain/f64 {r['plain_vs_float64']['limit_ratio']:.3g} "
            f"kernel/plain {r['kernel_vs_plain']['limit_ratio']:.3g}"
            for out, r in readings.items()), file=sys.stderr)
    report = json.dumps({"card": card, "cases": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
