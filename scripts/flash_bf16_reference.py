"""The bf16 flash dQ kernel and its bf16 plain version, each against the
plain version evaluated in float64, at the 1B shapes (H 16, S 2048, D 128,
causal): where the kernel misses the bf16 plain version, which of the two
is nearer the exact result. Needs the card.

    python3 scripts/flash_bf16_reference.py [--batches 8 32]

Prints, a batch size a line: the kernel against the bf16 plain version
(the largest per-element ratio to ``ops/kernel_check.py``'s bf16 limit,
where it falls, and the three values there), the bf16 plain version's own
distance from float64, and the kernel's excess over it
(``kernel_check.no_worse_than_plain``).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    import torch

    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check
    from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[8, 32])
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bf16_reference: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    cuda_build.build_libraries((fa._SRC,))
    print(f"card: {chip_smoke.card_line()}")
    H, S, D = 16, 2048, 128
    kw = dict(mask_type="causal", window=256, prefix_len=384, scale=D ** -0.5,
              score_mod="none", score_arg=0.0)
    for B in a.batches:
        g = torch.Generator().manual_seed(chip_smoke.SEED)
        q, k, v, do = (torch.randn(B, S, H, D, generator=g).to("cuda", torch.bfloat16)
                       .transpose(1, 2) for _ in range(4))
        ro, lse = fa.flash_fwd_plain(q, k, v, **kw)
        delta = (do.float() * ro.float()).sum(-1).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        plain = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        exact = chip_smoke.flash_f64(torch, fa, "dq", q, k, v, do, lse, delta, kw)
        atol_rms, rtol, _ = kernel_check._LIMITS[torch.bfloat16]
        atol = atol_rms * plain.float().norm().item() / plain.numel() ** 0.5
        ratio = (dq.float() - plain.float()).abs() / (atol + rtol * plain.float().abs())
        i = int(ratio.argmax())
        at = tuple(int(t) for t in torch.unravel_index(torch.tensor(i), dq.shape))
        arb = kernel_check.no_worse_than_plain(dq, plain, exact)
        print(f"B {B}: kernel vs bf16 plain {ratio.max().item():.3f}x the limit at (b, h, s, "
              f"d) {at}: kernel {dq.flatten()[i].item():.6f}, plain "
              f"{plain.flatten()[i].item():.6f}, float64 {exact.flatten()[i].item():.6f}; "
              f"against float64: the bf16 plain version {arb['plain_limit_ratio']:.3f}x the "
              f"limit, the kernel's excess over it {arb['limit_ratio']:.3f}x (normwise "
              f"{arb['norm_err']:.3g}); no_worse_than_plain ok: {arb['ok']}", flush=True)
        del q, k, v, do, ro, dq, plain, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
