#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result on stdout):

1. device  — needs CUDA (there is no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — compiles the grouped-GEMM kernel (csrc/grouped_matmul.cu) and the
   flash-attention kernels (csrc/flash_attention.cu) with nvcc into
   build/kernels/, one nvcc per source, both at once; prints each kernel's
   registers and spills, and fails if a wgmma kernel spills or ptxas
   reports that it serialized a kernel's wgmmas (advisories C7513, C7518,
   C7520).
3. kernels — holds ``gmm`` against its plain PyTorch version at the serving
   path's shapes (moe-8x40m: decode with 8 slots, a 256-token prefill chunk
   and a 160-token one at block_t 16), fp32 and bf16, plus an
   empty-group/tail-tile case; each must run the ``gmm_variant`` kernel
   (fp32: "f32_decode" at block_t 8, "f32" above), and at the fp32 prefill
   shape the kernel is launched once more with its last live row tile left
   out, which the same check must reject. Times the kernel, the plain
   version and ``torch._grouped_mm`` (where it takes the dtype) as a
   yardstick, each launch reading weights from HBM. At the MoE training
   path's shapes (block_t 128) gmm's forward and dX and tgmm must run
   their TMA/wgmma kernels (the
   per-variant launch counts say so), are held against their plain
   versions, and are compared element by element with, and timed in turns
   with, the WMMA kernels that served those shapes before (called through
   the library's C entries with the arguments the wrapper passed then;
   WMMA, wgmma, wgmma, WMMA); at the path shape each
   is launched once more with its last live row tile left out
   (``kernel_check.gmm_skipping_a_tile``, ``tgmm_skipping_a_tile``), and
   the same check must reject it. Then holds ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` against their plain versions: the training path's
   shape (B 32, H 8, S 1024, D 64, bf16, causal), fp32, GQA 8/2, S 1000
   (tail tiles), sliding_window, prefix_lm, full and D 128, timing each
   beside ``F.scaled_dot_product_attention`` (forward; forward + backward
   for the backward kernels) as a yardstick, with its TFLOP/s. Each call
   must run the variant ``flash_variant`` names (bf16: the wgmma kernels).
   Each output must pass ``ops/kernel_check.compare`` (per-element limits
   scaled to the output's RMS, and a normwise limit). At the path shape
   the kernels are launched once more with one live tile left out of their
   plans, and the same check must reject every output.
4. serve   — serves moe-8x40m at full width (12 layers, seeded random fp32
   weights) through the port's HTTP server and batch engine: 8 slots,
   max_len 1024, paged KV in 32-token blocks, prefix cache, 256-token prefill
   chunks. Checks the responses, the gmm launch count (3 per layer per
   prefill chunk and per decode step: every prefill launch on "f32", every
   decode launch on "f32_decode") and the first token's logits against the
   port's plain path on the CPU.
5. train   — trains configs/model-config-40m-adamw.yaml at full width
   (hidden 512, 12 layers, S 1024, batch 32, bf16 over fp32 masters, AdamW)
   through ``Trainer(...).train()`` on a seeded synthetic byte corpus: 30
   steps (``iters`` and ``warmup_steps`` cut to fit a smoke), a log line
   every 5, one validation and the final checkpoint. Checks the loss falls,
   the flash launch counts (12 per step and per validation batch for the
   forward, 12 per step for each backward; every flash launch on the wgmma
   kernels), step 1's loss and gradients
   against the plain attention path on the card at batch 8, and serves the
   final checkpoint through the port's server.
6. moe     — trains configs/model-config-moe-8x40m.yaml at full width (hidden
   512, intermediate 1536, 12 layers, 8 experts top-2, dropless grouped
   dispatch, router aux and z losses, S 1024, batch 32, bf16 over fp32
   masters, AdamW) the same way: 30 steps, a log line every 5 with routing
   stats, one validation, the final checkpoint. Checks the loss falls, the
   routing stats on every line (no drops), the exact launch counts (per
   step 72 gmm, 36 tgmm and 12 of each flash kernel; per validation batch
   36 gmm and 12 flash_fwd; every gmm, tgmm and flash launch a wgmma
   one), step
   1's loss and gradients with the gmm and
   tgmm kernels against their plain versions (flash kernels in both) at
   batch 8, and serves the final checkpoint.
7. report  — a ``{"kernels": [...]}`` line (each kernel with the earlier
   kernel's ms where this run timed one, each flash kernel with its
   launches by variant; the serving path's fp32 gmm kernels, "gmm_f32" and
   "gmm_f32_decode", as entries of their own with their serving launches
   and every fp32 row), the card line, and as the last line
   ``{"ok": true, "device": {...}}``. fp32 operation bounds are reckoned at
   495 / 3 TFLOP/s (3xTF32), the card's fastest fp32-accurate rate.

Every path runs with all launch counts set to 0 just before it and read
just after. fp32 matmuls run in full fp32: TF32 is switched off for matmuls
and cuDNN. Imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
# configs/model-config-moe-8x40m.yaml, written out so no YAML is read here.
MOE_8X40M = dict(vocab_size=259, hidden_size=512, intermediate_size=1536,
                 num_layers=12, num_heads=8, num_kv_heads=8, head_dim=64,
                 max_position_embeddings=1024, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=True,
                 num_local_experts=8, num_experts_per_tok=2, moe_impl="grouped")
# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by operand type.
# fp32: the card's fastest route to fp32-accurate products is three TF32
# tensor-core passes (3xTF32, as the "f32" gmm kernel runs them): 495 / 3
# TFLOP/s, above the FMA units' 67.
HBM_BYTES_S = 3.35e12
FP32_3XTF32_FLOPS = 495e12 / 3
PEAK_FLOPS = {"float32": FP32_3XTF32_FLOPS, "bfloat16": 989e12}
REPLACES = "mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py:137"
TGMM_REPLACES = "mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py:188"
SOURCE = "mlx_cuda_distributed_pretraining_tpu_torch/csrc/grouped_matmul.cu"
FLASH_SOURCE = "mlx_cuda_distributed_pretraining_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:404",
    "flash_bwd_dq": "mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:466",
    "flash_bwd_dkv": "mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:509",
}
FLASH_KERNELS = tuple(FLASH_REPLACES)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def reset_launches(gm, fa) -> None:
    gm.reset_launches()
    fa.reset_launches()


def read_launches(gm, fa) -> dict:
    return {"gmm": gm.gmm.launches, "tgmm": gm.tgmm.launches,
            **{name: getattr(fa, name).launches for name in FLASH_KERNELS}}


def read_variants(gm, fa=None) -> dict:
    """Launches of each gmm and tgmm kernel ("wgmma", "wmma", "f32", ...),
    and with ``fa`` of each flash kernel's variants."""
    out = {"gmm": dict(gm.gmm.launches_by_variant),
           "tgmm": dict(gm.tgmm.launches_by_variant)}
    if fa is not None:
        out.update({n: dict(getattr(fa, n).launches_by_variant) for n in FLASH_KERNELS})
    return out


def flash_variants_want(fa, fwd: int, bwd: int) -> dict:
    """The bf16 training path's flash launches by variant: every one on
    the wgmma kernels."""
    zero = dict.fromkeys(fa.FLASH_VARIANTS, 0)
    return {"flash_fwd": {**zero, "wgmma": fwd}, "flash_bwd_dq": {**zero, "wgmma": bwd},
            "flash_bwd_dkv": {**zero, "wgmma": bwd}}


def launched_since(before: dict, counts: dict) -> dict:
    """The variants launched since ``before`` (a copy of ``counts``), with
    their launch counts."""
    return {k: n - before[k] for k, n in counts.items() if n != before[k]}


# -- phase 3: kernel vs plain -----------------------------------------------------
def routed_sizes(torch, rng, selections: int, experts: int, block_t: int):
    """Group sizes of one routing draw, each rounded up to block_t (the
    dispatcher's padding), and the buffer rows the dispatcher allocates."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops.grouped_matmul import round_up

    ids = torch.randint(0, experts, (selections,), generator=rng)
    counts = torch.bincount(ids, minlength=experts)
    sizes = (counts + block_t - 1) // block_t * block_t
    rows = round_up(selections + experts * (block_t - 1), block_t)
    return sizes.to(torch.int32), rows


def device_ms(torch, fn, copies: int, reps: int = 40) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` back-to-back launches,
    cycling over ``copies`` weight copies (> 2x the 50 MB L2, so every
    launch reads its weights from HBM as the serving path does). A GPU
    sleep queued first lets the host enqueue every launch before the start
    event fires, so host launch overhead is not in the number."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(reps):
        fn(i % copies)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(torch, gm, kernel_check, name, dtype, T, K, N, sizes, block_t,
                fault=False):
    """gmm at one serving shape against its plain version; it must run the
    ``gmm_variant`` kernel. With ``fault`` the kernel is also launched with
    the last live row tile left out, which the same check must reject."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(SEED)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(T, K, generator=g)
    x[live:] = 0.0  # the dispatcher's tail rows are zero
    x = x.to("cuda", dt)
    w_bytes = E * K * N * x.element_size()
    copies = max(2, int(2 * 50e6 // w_bytes) + 2)
    ws = [(torch.randn(E, K, N, generator=g) / K ** 0.5).to("cuda", dt)
          for _ in range(copies)]
    gs = sizes.to("cuda")

    before = dict(gm.gmm.launches_by_variant)
    out = gm.gmm(x, ws[0], gs, block_t)
    ran = launched_since(before, gm.gmm.launches_by_variant)
    ref = gm.gmm_plain(x, ws[0], gs, block_t)
    torch.cuda.synchronize()
    # kernel_check.compare: the order of the fp32 sums only (bf16: one
    # rounding of it); tail rows exactly zero.
    check = kernel_check.compare(out, ref)
    err = check["max_abs_err"]
    ok = check["ok"] and not out[live:].any().item()
    want = gm.gmm_variant(dt, block_t, K, N)
    if ran != {want: 1}:
        ok = False
        log(f"gmm {name}: ran {ran}, not the {want} kernel")
    bad = None
    if fault:
        bad = kernel_check.compare(
            kernel_check.gmm_skipping_a_tile(x, ws[0], gs, block_t), ref)
        log(f"gmm {name} planted fault (last live row tile skipped): "
            f"limit_ratio={bad['limit_ratio']:.3g} norm={bad['norm_err']:.3g} "
            f"rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log(f"gmm {name}: the check passed a planted fault")

    ms = device_ms(torch, lambda i: gm.gmm(x, ws[i], gs, block_t), copies)
    plain_ms = device_ms(torch, lambda i: gm.gmm_plain(x, ws[i], gs, block_t),
                         copies, reps=10)
    library_ms, library_note = None, "torch._grouped_mm not in this torch"
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is not None:
        offs = torch.cumsum(gs, 0).to(torch.int32)
        try:
            grouped_mm(x, ws[0], offs=offs)
            library_ms = device_ms(
                torch, lambda i: grouped_mm(x, ws[i], offs=offs), copies)
            library_note = "torch._grouped_mm"
        except RuntimeError as e:  # a yardstick only; the port never calls it
            library_note = f"torch._grouped_mm refused {dtype}: {str(e)[:100]}"
    used = int((sizes > 0).sum())
    nbytes = (live * K + used * K * N + T * N) * x.element_size() + 4 * E
    flops = 2.0 * live * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    case = {"case": name, "dtype": dtype, "shape": [T, K, N, E],
            "block_t": block_t, "group_sizes": sizes.tolist(), "variants": ran,
            "max_abs_err": err, "check": check, "planted_fault": bad,
            "ok": bool(ok), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": library_note,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"gmm {name} {dtype} x[{T},{K}] w[{E},{K},{N}] block_t={block_t}: "
        f"variant={ran} max_abs_err={err:.3g} limit_ratio={check['limit_ratio']:.3g} "
        f"norm={check['norm_err']:.3g} ok={ok} kernel={ms:.4f} ms plain="
        f"{plain_ms:.4f} ms library={library_ms} ms ({library_note}) "
        f"bound={case['bound_ms']:.4f} ms ({case['bound_by']})")
    del ws
    torch.cuda.empty_cache()
    return case


def kernel_phase(torch, gm, kernel_check):
    rng = torch.Generator().manual_seed(SEED)
    E, D, I = 8, 512, 1536
    dec_sizes, dec_rows = routed_sizes(torch, rng, 16, E, 8)      # 8 slots x top-2
    pre_sizes, pre_rows = routed_sizes(torch, rng, 512, E, 32)    # 256 tokens x top-2
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases.append(kernel_case(torch, gm, kernel_check, "decode_gate_up", dtype,
                                 dec_rows, D, I, dec_sizes, 8))
        cases.append(kernel_case(torch, gm, kernel_check, "prefill_gate_up", dtype,
                                 pre_rows, D, I, pre_sizes, 32))
    cases.append(kernel_case(torch, gm, kernel_check, "decode_down", "float32",
                             dec_rows, I, D, dec_sizes, 8))
    cases.append(kernel_case(torch, gm, kernel_check, "prefill_down", "float32",
                             pre_rows, I, D, pre_sizes, 32, fault=True))
    # a short last prefill chunk: 160 tokens x top-2 pick block_t 16
    short_sizes, short_rows = routed_sizes(torch, rng, 320, E, 16)
    cases.append(kernel_case(torch, gm, kernel_check, "prefill_short_down", "float32",
                             short_rows, I, D, short_sizes, 16))
    edge = torch.tensor([16, 0, 8, 0, 0, 24, 8, 0], dtype=torch.int32)
    cases.append(kernel_case(torch, gm, kernel_check, "empty_groups_tail",
                             "float32", 72, D, I, edge, 8))
    return cases


# -- phase 3: the MoE training path's grouped GEMMs (gmm fwd / dX, tgmm) ---------
TRAIN_SELECTIONS, TRAIN_BLOCK_T = 32 * 1024 * 2, 128  # B 32 x S 1024 x top-2


def library_call(torch, fn):
    """``fn()`` once to see whether this torch takes it; (fn, note) or
    (None, why not). A yardstick only; the port never calls it."""
    try:
        fn()
        return fn, "ok"
    except (RuntimeError, TypeError, ValueError) as e:
        return None, str(e)[:120]


def earlier_gmm(torch, gm, x, w, gs, block_t, w_trans):
    """The bf16 gmm (forward, or dX with ``w_trans``) on the WMMA kernel that
    served the training path's shapes before the wgmma one: the library's
    ``gmm_forward`` with a CTA row tile of min(block_t, 32), as the wrapper
    called it then. Measurement only; the port never launches it there."""
    T, K = x.shape
    E, N = w.shape[0], w.shape[1 if w_trans else 2]
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    err = gm._library().gmm_forward(
        x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(), T, K, N, E,
        min(block_t, 32), 1, int(w_trans), gm._stream(x))
    if err != 0:
        raise RuntimeError(f"WMMA gmm launch failed with CUDA error {err}")
    return out


def earlier_tgmm(torch, gm, x, dy, gs, E, block_t):
    """bf16 tgmm on its WMMA kernel (``tgmm_backward``'s kernel code 1), as
    :func:`earlier_gmm`."""
    T, K = x.shape
    N = dy.shape[1]
    dw = torch.empty((E, K, N), dtype=x.dtype, device=x.device)
    err = gm._library().tgmm_backward(
        x.data_ptr(), dy.data_ptr(), gs.data_ptr(), dw.data_ptr(), T, K, N, E,
        block_t, 1, gm._stream(x))
    if err != 0:
        raise RuntimeError(f"WMMA tgmm launch failed with CUDA error {err}")
    return dw


def against_earlier(torch, new, old) -> dict:
    """Whether the wgmma kernel's output equals the WMMA kernel's, element
    by element, on the same inputs."""
    return {"bitwise_equal": bool(torch.equal(new, old)),
            "max_abs_diff": (new.float() - old.float()).abs().max().item()}


def gemm_row(torch, kernel, plain, library, nbytes, flops, dtype, earlier=None):
    """ms of kernel, plain version and library call (device time, inputs
    larger than L2 so no copies are cycled), and the bound. ``earlier``: the
    WMMA kernel that served these shapes before the wgmma one, timed in
    turns with it (earlier, kernel, kernel, earlier); ``ms`` and
    ``earlier_ms`` are the means of each pair."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    turns = {}
    if earlier is not None:
        turns["earlier"] = [device_ms(torch, lambda _: earlier(), 1, reps=5)]
        turns["kernel"] = [device_ms(torch, lambda _: kernel(), 1, reps=20)
                           for _ in range(2)]
        turns["earlier"].append(device_ms(torch, lambda _: earlier(), 1, reps=5))
    else:
        turns["kernel"] = [device_ms(torch, lambda _: kernel(), 1, reps=20)]
    row = {"ms": sum(turns["kernel"]) / len(turns["kernel"]),
           "earlier_ms": (sum(turns["earlier"]) / 2 if earlier is not None else None),
           "turns_ms": turns,
           "plain_ms": device_ms(torch, lambda _: plain(), 1, reps=3),
           "library_ms": (device_ms(torch, lambda _: library(), 1, reps=20)
                          if library is not None else None),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    torch.cuda.empty_cache()
    return row


def fmt_earlier(row) -> str:
    if row["earlier_ms"] is None:
        return ""
    return (f" (earlier WMMA kernel {row['earlier_ms']:.4f} ms, "
            f"{row['earlier_ms'] / row['ms']:.1f}x; turns {row['turns_ms']})")


def train_gmm_case(torch, gm, kernel_check, name, K, N, sizes, rows, w_trans,
                   fault=False):
    """One bf16 gmm product of the training path: the forward ``x [rows, K]
    @ w[e] [K, N]``, or with ``w_trans`` the backward's dX ``dy [rows, K] @
    w[e]^T`` with w stored ``[E, N, K]`` (the forward's weights, read in
    place). It must run the wgmma kernel; with ``fault`` the kernel is also
    launched with the last live row tile left out, which the same check must
    reject."""
    g = torch.Generator().manual_seed(SEED)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(rows, K, generator=g)
    x[live:] = 0.0
    x = x.to("cuda", torch.bfloat16)
    shape = (E, N, K) if w_trans else (E, K, N)
    w = (torch.randn(*shape, generator=g) / K ** 0.5).to("cuda", torch.bfloat16)
    w_kn = w.transpose(1, 2) if w_trans else w
    gs = sizes.to("cuda")
    before = dict(gm.gmm.launches_by_variant)
    out = gm._gmm_forward(x, w, gs, TRAIN_BLOCK_T, w_trans)
    ran = launched_since(before, gm.gmm.launches_by_variant)
    ref = gm.gmm_plain(x, w_kn, gs, TRAIN_BLOCK_T)
    torch.cuda.synchronize()
    check = kernel_check.compare(out, ref)
    ok = check["ok"] and not out[live:].any().item()
    if ran != {"wgmma": 1}:
        ok = False
        log(f"gmm {name}: ran {ran}, not the wgmma kernel")
    vs_wmma = against_earlier(
        torch, out, earlier_gmm(torch, gm, x, w, gs, TRAIN_BLOCK_T, w_trans))
    log(f"gmm {name}: wgmma vs WMMA output {vs_wmma}")
    del out
    bad = None
    if fault:
        bad = kernel_check.compare(
            kernel_check.gmm_skipping_a_tile(x, w, gs, TRAIN_BLOCK_T, w_trans), ref)
        log(f"gmm {name} planted fault (last live row tile skipped): "
            f"limit_ratio={bad['limit_ratio']:.3g} norm={bad['norm_err']:.3g} "
            f"rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log("gmm: the check passed a planted fault")
    del ref
    offs = torch.cumsum(gs, 0).to(torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    library, note = (None, "torch._grouped_mm not in this torch") \
        if grouped_mm is None else library_call(
            torch, lambda: grouped_mm(x, w_kn, offs=offs))
    used = int((sizes > 0).sum())
    row = gemm_row(
        torch, lambda: gm._gmm_forward(x, w, gs, TRAIN_BLOCK_T, w_trans),
        lambda: gm.gmm_plain(x, w_kn, gs, TRAIN_BLOCK_T), library,
        (live * K + used * K * N + rows * N) * 2 + 4 * E, 2.0 * live * K * N,
        "bfloat16",
        earlier=lambda: earlier_gmm(torch, gm, x, w, gs, TRAIN_BLOCK_T, w_trans))
    case = {"case": name, "dtype": "bfloat16", "shape": [rows, K, N, E],
            "block_t": TRAIN_BLOCK_T, "w_trans": w_trans, "variants": ran,
            "vs_wmma": vs_wmma, "max_abs_err": check["max_abs_err"], "check": check,
            "planted_fault": bad, "ok": bool(ok),
            "library": "torch._grouped_mm" if library else note, **row}
    log(f"gmm {name} bf16 x[{rows},{K}] w[{E},{K},{N}]{' (w^T)' if w_trans else ''}: "
        f"ok={ok} variant={ran} err={check['max_abs_err']:.3g} limit_ratio="
        f"{check['limit_ratio']:.3g} norm={check['norm_err']:.3g} kernel="
        f"{row['ms']:.4f} ms{fmt_earlier(row)} plain={row['plain_ms']:.4f} ms "
        f"library={row['library_ms']} ms ({case['library']}) bound="
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return case


def tgmm_case(torch, gm, kernel_check, name, dtype, K, N, sizes, rows, block_t,
              want, fault=False):
    """``dW = tgmm(x, dy)`` against ``tgmm_plain``; it must run the ``want``
    variant. With ``fault`` also the kernel with the last expert's last tile
    left out of its walk, which the same check must reject. A "wgmma" case
    is also held bitwise against the WMMA kernel that served it before, and
    timed in turns with it."""
    g = torch.Generator().manual_seed(SEED)
    dt = getattr(torch, dtype)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(rows, K, generator=g)
    x[live:] = 0.0
    x = x.to("cuda", dt)
    dy = torch.randn(rows, N, generator=g).to("cuda", dt)
    gs = sizes.to("cuda")
    before = dict(gm.tgmm.launches_by_variant)
    dw = gm.tgmm(x, dy, gs, E, block_t)
    ran = launched_since(before, gm.tgmm.launches_by_variant)
    ref = gm.tgmm_plain(x, dy, gs, E, block_t)
    torch.cuda.synchronize()
    check = kernel_check.compare_experts(dw, ref)
    empty_ok = all(not dw[e].any().item() for e in range(E) if int(sizes[e]) == 0)
    ok = check["ok"] and empty_ok
    wgmma = want == "wgmma"
    if ran != {want: 1}:
        ok = False
        log(f"tgmm {name}: ran {ran}, not the {want} kernel")
    vs_wmma = None
    if wgmma:
        vs_wmma = against_earlier(torch, dw, earlier_tgmm(torch, gm, x, dy, gs, E, block_t))
        log(f"tgmm {name}: wgmma vs WMMA output {vs_wmma}")
        if not vs_wmma["bitwise_equal"]:  # the same rounding points: the same bits
            ok = False
            log(f"tgmm {name}: the wgmma output differs from the WMMA kernel's")
    bad = None
    if fault:
        bad = kernel_check.compare_experts(
            kernel_check.tgmm_skipping_a_tile(x, dy, gs, E, block_t), ref)
        log(f"tgmm {name} planted fault (last expert's last tile skipped): "
            f"limit_ratio={bad['limit_ratio']:.3g} norm={bad['norm_err']:.3g} "
            f"rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log("tgmm: the check passed a planted fault")
    del ref
    offs = torch.cumsum(gs, 0).to(torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    library, note = None, "torch._grouped_mm not in this torch"
    if grouped_mm is not None:  # dW over the contraction: x^T [K, T] . dy [T, N]
        library, note = library_call(torch, lambda: grouped_mm(x.t(), dy, offs=offs))
        if library is None:
            xt = x.t().contiguous().t()
            library, note2 = library_call(
                torch, lambda: grouped_mm(xt.t(), dy, offs=offs))
            note = "x^T as a row-major copy" if library else f"{note}; {note2}"
    es = x.element_size()
    row = gemm_row(torch, lambda: gm.tgmm(x, dy, gs, E, block_t),
                   lambda: gm.tgmm_plain(x, dy, gs, E, block_t), library,
                   live * (K + N) * es + E * K * N * es + 4 * E,
                   2.0 * live * K * N, dtype,
                   earlier=(lambda: earlier_tgmm(torch, gm, x, dy, gs, E, block_t))
                   if wgmma else None)
    case = {"case": name, "dtype": dtype, "shape": [rows, K, N, E],
            "block_t": block_t, "group_sizes": sizes.tolist(), "variants": ran,
            "vs_wmma": vs_wmma, "max_abs_err": check["max_abs_err"], "check": check,
            "planted_fault": bad, "ok": bool(ok),
            "library": "torch._grouped_mm" + ("" if note == "ok" else f" ({note})")
            if library else note, **row}
    log(f"tgmm {name} {dtype} x[{rows},{K}] dy[{rows},{N}] E={E} block_t="
        f"{block_t}: ok={ok} variant={ran} err={check['max_abs_err']:.3g} limit_ratio="
        f"{check['limit_ratio']:.3g} norm={check['norm_err']:.3g} kernel="
        f"{row['ms']:.4f} ms{fmt_earlier(row)} plain={row['plain_ms']:.4f} ms library="
        f"{row['library_ms']} ms ({case['library']}) bound={row['bound_ms']:.4f} "
        f"ms ({row['bound_by']})")
    return case


def train_kernel_phase(torch, gm, kernel_check):
    """(gmm cases, tgmm cases) at the MoE training path's shapes."""
    rng = torch.Generator().manual_seed(SEED + 1)
    E, D, I = 8, 512, 1536
    sizes, rows = routed_sizes(torch, rng, TRAIN_SELECTIONS, E, TRAIN_BLOCK_T)
    gmm_cases = [
        train_gmm_case(torch, gm, kernel_check, "train_gate_up", D, I, sizes, rows, False,
                       fault=True),
        train_gmm_case(torch, gm, kernel_check, "train_down", I, D, sizes, rows, False),
        train_gmm_case(torch, gm, kernel_check, "train_dx_gate_up", I, D, sizes, rows, True),
        train_gmm_case(torch, gm, kernel_check, "train_dx_down", D, I, sizes, rows, True),
    ]
    # one expert takes half of the selections, the rest share the other half
    hot = torch.full((E,), TRAIN_SELECTIONS // (2 * (E - 1)), dtype=torch.int64)
    hot[0] = TRAIN_SELECTIONS - int(hot[1:].sum())
    hot = ((hot + TRAIN_BLOCK_T - 1) // TRAIN_BLOCK_T * TRAIN_BLOCK_T).to(torch.int32)
    edge = torch.tensor([256, 0, 128, 0, 384, 128, 128, 0], dtype=torch.int32)
    small, small_rows = routed_sizes(torch, rng, 4096, E, 32)
    tgmm_cases = [
        tgmm_case(torch, gm, kernel_check, "path_gate_up", "bfloat16", D, I, sizes,
                  rows, TRAIN_BLOCK_T, "wgmma", fault=True),
        tgmm_case(torch, gm, kernel_check, "path_down", "bfloat16", I, D, sizes,
                  rows, TRAIN_BLOCK_T, "wgmma"),
        tgmm_case(torch, gm, kernel_check, "imbalanced_gate_up", "bfloat16", D, I,
                  hot, rows, TRAIN_BLOCK_T, "wgmma"),
        tgmm_case(torch, gm, kernel_check, "fp32_gate_up", "float32", D, I, small,
                  small_rows, 32, "f32"),
        tgmm_case(torch, gm, kernel_check, "empty_groups_tail", "bfloat16", D, I,
                  edge, 1280, TRAIN_BLOCK_T, "wgmma"),
    ]
    return gmm_cases, tgmm_cases


# -- phase 3: the flash kernels vs plain -------------------------------------------
# (name, dtype, B, Hq, Hkv, S, D, mask): the training path's shape first.
FLASH_CASES = [
    ("path", "bfloat16", 32, 8, 8, 1024, 64, "causal"),
    ("fp32", "float32", 4, 8, 8, 1024, 64, "causal"),
    ("gqa", "bfloat16", 8, 8, 2, 1024, 64, "causal"),
    ("tail", "bfloat16", 8, 8, 8, 1000, 64, "causal"),
    ("tail_fp32", "float32", 2, 8, 2, 1000, 64, "causal"),
    ("sliding_window", "bfloat16", 8, 8, 8, 1024, 64, "sliding_window"),
    ("prefix_lm", "bfloat16", 8, 8, 8, 1024, 64, "prefix_lm"),
    ("full", "bfloat16", 8, 8, 8, 1024, 64, "full"),
    ("d128", "bfloat16", 8, 8, 8, 1024, 128, "causal"),
    ("d128_fp32", "float32", 2, 8, 8, 1024, 128, "causal"),
]
WINDOW, PREFIX = 256, 384


def flash_work(fa, dtype, B, Hq, Hkv, S, D, mask):
    """(bytes, operations) each kernel needs for these inputs: every input
    read once and every output written once; the products over the pairs
    (row, col) the mask lets through (2 per multiply-add): fwd q.k^T and
    p.v, dQ q.k^T, dO.v^T and dS.k, dK/dV q.k^T, dO.v^T, p^T.dO and dS^T.q."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks

    mod = fa._mask_mod(mask, WINDOW, PREFIX)
    pairs = S * S if mod is None else int(
        masks.materialize_mask(mod, S, S, device="cuda").sum().item())
    es = 2 if dtype == "bfloat16" else 4
    q_el, kv_el, stat = B * Hq * S * D, B * Hkv * S * D, B * Hq * S * 4
    per_product = 2.0 * B * Hq * D * pairs
    return {"flash_fwd": ((2 * q_el + 2 * kv_el) * es + stat, 2 * per_product),
            "flash_bwd_dq": ((3 * q_el + 2 * kv_el) * es + 2 * stat, 3 * per_product),
            "flash_bwd_dkv": ((4 * q_el + 2 * kv_el) * es + 2 * stat, 4 * per_product)}


def sdpa_calls(torch, q, k, v, do, mask, scale):
    """``F.scaled_dot_product_attention`` forward, and forward + backward,
    on the same inputs: a yardstick only, the port never calls it."""
    import torch.nn.functional as F

    from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks

    G = q.shape[1] // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    kw = {"scale": scale}
    if mask == "causal":
        kw["is_causal"] = True
    elif mask != "full":
        mod = masks.sliding_window(WINDOW) if mask == "sliding_window" \
            else masks.prefix_lm(PREFIX)
        kw["attn_mask"] = masks.materialize_mask(mod, q.shape[2], k.shape[2],
                                                 device="cuda")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd(_):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **kw)

    def fwd_bwd(_):
        F.scaled_dot_product_attention(qg, kg, vg, **kw).backward(do)

    return fwd, fwd_bwd


def fmt_checks(checks: dict) -> str:
    return " ".join(f"{o}:err={c['max_abs_err']:.3g},limit_ratio="
                    f"{c['limit_ratio']:.3g},norm_err={c['norm_err']:.3g}"
                    for o, c in checks.items())


def flash_case(torch, gm, fa, name, dtype, B, Hq, Hkv, S, D, mask):
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check

    g = torch.Generator().manual_seed(SEED)
    dt = getattr(torch, dtype)
    # [B, H, S, D] views of [B, S, H, D] tensors: the model's layout.
    q, k, v, do = (torch.randn(B, S, h, D, generator=g).to("cuda", dt)
                   .transpose(1, 2) for h in (Hq, Hkv, Hkv, Hq))
    kw = dict(mask_type=mask, window=WINDOW, prefix_len=PREFIX, scale=D ** -0.5)
    before = read_variants(gm, fa)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    after = read_variants(gm, fa)
    ran = {n: launched_since(before[n], after[n]) for n in FLASH_KERNELS}
    bf16 = dtype == "bfloat16"
    want_ran = {n: {"wgmma" if bf16 else "f32": 1} for n in FLASH_KERNELS}
    rdq = fa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    refs = {"o": ro, "dq": rdq, "dk": rdk, "dv": rdv}
    # kernel_check.compare: per element atol 2**-5 x RMS / rtol 2e-2 and
    # normwise 1e-2 for bf16; 1e-5 x RMS / 1e-4 and 1e-5 for fp32. lse is
    # fp32 in both versions: 1e-5.
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    checks = {out: kernel_check.compare(got[out], refs[out]) for out in refs}
    errs = {out: c["max_abs_err"] for out, c in checks.items()}
    errs["lse"] = (lse - rlse).abs().max().item()
    ok = all(c["ok"] for c in checks.values()) and bool(torch.isfinite(lse).all()) \
        and torch.allclose(lse, rlse, atol=1e-5, rtol=1e-5)
    if ran != want_ran:
        ok = False
        log(f"flash {name}: ran {ran}, not {want_ran}")
    fault = None
    if name == "path":
        # The same check on a planted fault: one live tile left out of each
        # kernel's plan. Every output must fail it.
        with kernel_check.planted_fault():
            bad = kernel_check.kernel_outputs(q, k, v, do, rlse, delta, **kw)
        fault = {out: kernel_check.compare(bad[out], refs[out]) for out in refs}
        del bad
        log(f"flash {name} planted fault (one live tile skipped): "
            + fmt_checks(fault))
        if any(c["ok"] for c in fault.values()):
            ok = False
            log("flash path: the check passed a planted fault")
    del ro, rdq, rdk, rdv, o, dq, dk, dv, refs, got
    torch.cuda.empty_cache()

    work = flash_work(fa, dtype, B, Hq, Hkv, S, D, mask)
    lib_fwd, lib_fwd_bwd = sdpa_calls(torch, q, k, v, do, mask, D ** -0.5)
    try:
        library = {"fwd": device_ms(torch, lib_fwd, 1, reps=10),
                   "fwd_bwd": device_ms(torch, lib_fwd_bwd, 1, reps=10)}
        library_note = "F.scaled_dot_product_attention"
    except RuntimeError as e:  # a yardstick only; the port never calls it
        library, library_note = {}, f"sdpa refused: {str(e)[:100]}"
    torch.cuda.empty_cache()
    calls = {
        "flash_fwd": (lambda _: fa.flash_fwd(q, k, v, **kw),
                      lambda _: fa.flash_fwd_plain(q, k, v, **kw), "fwd"),
        "flash_bwd_dq": (lambda _: fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw),
                         lambda _: fa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw),
                         "fwd_bwd"),
        "flash_bwd_dkv": (lambda _: fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw),
                          lambda _: fa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw),
                          "fwd_bwd"),
    }
    rows = {}
    for kname, (kernel, plain, lib) in calls.items():
        nbytes, flops = work[kname]
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        row = {"ms": device_ms(torch, kernel, 1, reps=20)}
        row.update(plain_ms=device_ms(torch, plain, 1, reps=5),
                   library_ms=library.get(lib), library=library_note,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   tflops=flops / row["ms"] * 1e-9)
        rows[kname] = row
        torch.cuda.empty_cache()
    case = {"case": name, "dtype": dtype, "shape": [B, Hq, Hkv, S, D],
            "mask": mask, "max_abs_err": errs, "checks": checks, "variants": ran,
            "planted_fault": fault, "ok": bool(ok),
            "kernels": rows}
    log(f"flash {name} {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {mask}: "
        f"ok={ok} variants={ran} lse:err={errs['lse']:.3g} " + fmt_checks(checks))
    for kname, r in rows.items():
        log(f"  {kname}: kernel={r['ms']:.4f} ms {r['tflops']:.1f} TFLOP/s "
            f"plain={r['plain_ms']:.4f} ms library={r['library_ms']} ms "
            f"({library_note}) bound={r['bound_ms']:.4f} ms ({r['bound_by']})")
    if library.get("fwd_bwd") is not None:
        both = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
        log(f"  dQ + dK/dV {both:.4f} ms vs {library_note} forward + backward "
            f"{library['fwd_bwd']:.4f} ms ({both / library['fwd_bwd']:.2f}x)")
    return case


def flash_kernel_phase(torch, gm, fa):
    return [flash_case(torch, gm, fa, *c) for c in FLASH_CASES]


# -- phase 4: the serving path ----------------------------------------------------
def post(url: str, body: dict, timeout: float = 600.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode(errors="replace")}


def cpu_first_logits(torch, args, params_cpu, prompt_ids):
    """The port's plain path on the CPU: chunked paged prefill of one prompt
    (same chunking as the engine), returning the last token's logits."""
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import batch_step

    C, bs = 256, 32
    P = len(prompt_ids)
    nblk = -(-P // bs)
    cache = llama.init_paged_cache(args, nblk + 1, bs, device="cpu")
    table = torch.zeros(1024 // bs, dtype=torch.long)
    table[:nblk] = torch.arange(1, nblk + 1)
    logits = None
    for start in range(0, P, C):
        n = min(C, P - start)
        toks = torch.zeros(C, dtype=torch.long)
        toks[:n] = torch.tensor(prompt_ids[start:start + n])
        attend = min(batch_step.round_up(
            batch_step.attend_bucket(start + C, 1024), bs), 1024)
        logits = batch_step.paged_prefill_step(
            params_cpu, cache, toks, table, start, n - 1, args, attend, bs,
            with_logits=start + n >= P)
    return logits[0]


def path_phase(torch, gm, fa, card):
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
        InferenceService,
        serve,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig
    from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

    failures = []
    args = llama.LlamaArgs(**MOE_8X40M)
    tok = TokenizerManager()
    t0 = time.perf_counter()
    params = llama.init_params(args, torch.Generator().manual_seed(SEED),
                               device="cuda")
    torch.cuda.synchronize()
    n_params = llama.num_params(params)
    log(f"path: moe-8x40m {n_params / 1e6:.1f}M params fp32 on cuda "
        f"({time.perf_counter() - t0:.1f}s to draw)")
    service = InferenceService(params, args, tok, run_name="moe-8x40m-random")
    engine = service.attach_engine(EngineConfig(
        num_slots=8, max_len=1024, block_size=32, prefix_cache=True,
        prefill_chunk=256))
    httpd = serve(service, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    prefix = ("In the port of a serving system, every request shares this "
              "system prompt: answer briefly, cite the layer you measured, "
              "and name the card and its power limit beside every number. ")
    prefix = (prefix * 3)[:300]
    bodies = [
        {"prompt": prefix + " First question: what bounds decode?",
         "max_tokens": 32},
        {"prompt": prefix + " Second question: what bounds prefill?",
         "max_tokens": 32},
        {"prompt": prefix + " First question: what bounds decode?",
         "max_tokens": 32},
        {"prompt": "Sample me something short.", "max_tokens": 32,
         "temperature": 0.8, "seed": 7},
        {"prompt": "An unrelated greedy prompt about grouped GEMMs.",
         "max_tokens": 32},
    ]
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the path's run only
        c0, d0 = engine.prefill_chunks, engine.decode_steps
        warm = post(url, {"prompt": "warm up", "max_tokens": 2})
        if warm[0] != 200:
            failures.append(f"warm-up request: HTTP {warm[0]} {warm[1]}")
        t_single = time.perf_counter()
        results = [post(url, bodies[0])]
        t_single = time.perf_counter() - t_single
        box = {}

        def run(i):
            box[i] = post(url, bodies[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(1, len(bodies))]
        t_conc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_conc = time.perf_counter() - t_conc
        results += [box.get(i, (0, {"error": "no response"}))
                    for i in range(1, len(bodies))]
        all_launches = read_launches(gm, fa)
        launches = all_launches["gmm"]
        variants = read_variants(gm)["gmm"]
        chunks = engine.prefill_chunks - c0
        steps = engine.decode_steps - d0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        metrics = engine.metrics()
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()

    for i, (code, out) in enumerate(results):
        if code != 200:
            failures.append(f"request {i}: HTTP {code} {out}")
            continue
        n = out["tokens"]
        if not (n == 32 or (n < 32 and out["finish_reason"] == "stop")) \
                or len(out["token_ids"]) != n \
                or not all(0 <= t < args.vocab_size for t in out["token_ids"]):
            failures.append(f"request {i}: bad token count/ids {out}")
        log(f"request {i}: HTTP {code} tokens={n} finish={out['finish_reason']}"
            f" ttft_ms={out.get('ttft_ms')} prefix_cached="
            f"{out['prefix_cached_tokens']} text={out['text'][:40]!r}")
    if failures:
        return failures, {}
    r1, r2, r3 = results[0][1], results[1][1], results[2][1]
    if r3["token_ids"] != r1["token_ids"]:
        failures.append("the same greedy prompt gave different tokens")
    if r2["prefix_cached_tokens"] <= 0 or r3["prefix_cached_tokens"] <= 0:
        failures.append("prefix cache did not hit on the shared 300-byte prefix")
    per = 3 * args.num_layers
    if chunks <= 0 or steps <= 0 or launches != per * (chunks + steps):
        failures.append(f"gmm launches {launches} != {per} x ({chunks} prefill "
                        f"chunks + {steps} decode steps)")
    log(f"path: gmm launches={launches} = {per} x ({chunks} prefill chunks + "
        f"{steps} decode steps); by variant {variants}")
    # fp32: every prefill chunk (256 tokens, block_t 32) on "f32", every
    # decode step (8 slots, block_t 8) on "f32_decode"
    want_variants = {**dict.fromkeys(gm.GMM_VARIANTS, 0), "f32": per * chunks,
                     "f32_decode": per * steps}
    if variants != want_variants:
        failures.append(f"gmm launches by variant {variants} != {want_variants}")
    if any(all_launches[n] for n in FLASH_KERNELS):
        failures.append(f"serving launched flash kernels: {all_launches}")

    # The first greedy token's logprob from the server vs the plain path on
    # the CPU with the same weights. fp32 on both; 12 layers of different
    # summation orders and atomic scatter-adds: |d logprob| <= 1e-3.
    prompt_ids = [tok.bos_id] + tok.tokenize(bodies[0]["prompt"])
    # init_params draws on the CPU, so the same seed gives the same weights.
    params_cpu = llama.init_params(args, torch.Generator().manual_seed(SEED),
                                   device="cpu")
    ref = cpu_first_logits(torch, args, params_cpu, prompt_ids)
    ref_lp = torch.log_softmax(ref, dim=-1)
    first = r1["token_ids"][0] if r1["token_ids"] else None
    if first is not None:
        d_lp = abs(ref_lp[first].item() - r1["logprobs"][0])
        gap = (ref.max() - ref[first]).item()
        log(f"path: first token {first} cpu_argmax={int(ref.argmax())} "
            f"|d logprob|={d_lp:.3g} cpu top-logit gap={gap:.3g}")
        if d_lp > 1e-3 or gap > 1e-3:
            failures.append(f"first-token logits disagree with the CPU plain "
                            f"path (|d logprob| {d_lp}, gap {gap})")
    dec_s = r1.get("decode_ms", 0.0) / 1e3
    conc_tokens = sum(out["tokens"] for _, out in results[1:])
    perf = {
        "ttft_ms_single": r1.get("ttft_ms"),
        "decode_tok_s_single": (r1["tokens"] - 1) / dec_s if dec_s else None,
        "request_s_single": t_single,
        "tok_s_concurrent_4": conc_tokens / t_conc,
        "peak_mem_gb": peak_gb,
        "prefill_chunks": chunks, "decode_steps": steps,
        "gmm_launches": launches, "gmm_launches_by_variant": variants,
        "prefix_cache_hit_rate": metrics.get("prefix_cache_hit_rate"),
    }
    for k, v in perf.items():
        log(f"path: {k}={v} [{card}]")
    return failures, perf


# -- phase 5: the training path ---------------------------------------------------
def config_40m(tmp: str, steps: int, warmup: int) -> dict:
    """configs/model-config-40m-adamw.yaml written out as a dict, with the
    smoke's cuts: ``iters``, ``warmup_steps``, the log, validation and
    checkpoint intervals, and the corpus paths. Every width is the
    config's. The file's ``system.device: "tpu"`` is left out: the port
    keeps that key only for the round trip, and the Trainer's ``device``
    argument decides."""
    return {
        "name": "Llama (40M)", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "validation_file": os.path.join(tmp, "val.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 1024, "chunk_overlap": 0},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 512, "intermediate_size": 1536,
                                 "num_layers": 12},
                  "attention": {"num_heads": 8, "num_kv_heads": 8, "head_dim": 64,
                                "max_position_embeddings": 1024,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 6.0e-4,
                                         "weight_decay": 0.05, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup",
                                   "warmup_steps": warmup, "min_lr_ratio": 0.1},
                     "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 5, "checkpoint_interval": 1000,
                              "validation_interval": 0},
                    "metrics": {"log_loss": True, "log_perplexity": True,
                                "log_tokens_per_second": True}},
        "system": {"seed": 42, "mixed_precision": True,
                   "precision": "bfloat16"},
    }


def write_corpus(tmp: str, train_bytes: int, val_bytes: int) -> None:
    """A seeded synthetic byte corpus: documents of sentences drawn from a
    small Zipf-weighted vocabulary, so a few steps can learn something."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    syll = ["ka", "lo", "mi", "ne", "su", "ta", "ri", "po", "an", "el", "or", "ve"]
    words = ["".join(rng.choice(syll, size=int(rng.integers(1, 4))))
             for _ in range(96)]
    weights = 1.0 / np.arange(1, len(words) + 1)
    weights /= weights.sum()

    def docs(n_bytes):
        out, total = [], 0
        while total < n_bytes:
            sentences = []
            for _ in range(int(rng.integers(4, 40))):
                ids = rng.choice(len(words), size=int(rng.integers(4, 16)), p=weights)
                sentences.append(" ".join(words[i] for i in ids).capitalize() + ".")
            text = " ".join(sentences)
            out.append(json.dumps({"text": text}))
            total += len(text)
        return "\n".join(out) + "\n"

    with open(os.path.join(tmp, "train.jsonl"), "w") as f:
        f.write(docs(train_bytes))
    with open(os.path.join(tmp, "val.jsonl"), "w") as f:
        f.write(docs(val_bytes))


def first_step_parity(torch, trainer, rows: int, swaps):
    """Step 1's loss and gradients on ``rows`` rows of the first batch: the
    kernels against their plain versions, the same model code with
    ``swaps`` (``(module, name, plain function)``) set for the second run
    only. The loss is the training loss (an MoE model's router losses in)."""
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.optim.base import global_norm
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import leaves_with_path

    batch = {k: torch.from_numpy(v[:rows]).to(trainer.device)
             for k, v in trainer.data.generate_batch(0).items()}
    params = trainer.state["params"]

    def loss_and_grads():
        for _, p in leaves_with_path(params):
            p.grad = None
        loss, _ = llama.loss_fn(params, batch, trainer.model_args,
                                compute_dtype=trainer.compute_dtype)
        loss.backward()
        grads = {"/".join(path): p.grad.float().clone()
                 for path, p in leaves_with_path(params)}
        for _, p in leaves_with_path(params):
            p.grad = None
        return loss.item(), grads

    kernel_loss, kernel_grads = loss_and_grads()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        plain_loss, plain_grads = loss_and_grads()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    norm_k, norm_p = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
    leaf_rel = {n: ((kernel_grads[n] - plain_grads[n]).norm()
                    / plain_grads[n].norm().clamp_min(1e-30)).item()
                for n in plain_grads}
    worst = max(leaf_rel, key=leaf_rel.get)
    return {"kernel_loss": kernel_loss, "plain_loss": plain_loss,
            "kernel_grad_norm": norm_k, "plain_grad_norm": norm_p,
            "max_leaf_rel_grad_diff": leaf_rel[worst], "worst_leaf": worst}


def parity_ok(par) -> bool:
    """The step-1 limits (bf16): loss 2e-3, gradient norm 2e-2 and every
    leaf's gradient 5e-2, each relative to the plain run."""
    return (abs(par["kernel_loss"] - par["plain_loss"]) <= 2e-3 * abs(par["plain_loss"])
            and abs(par["kernel_grad_norm"] - par["plain_grad_norm"])
            <= 2e-2 * par["plain_grad_norm"]
            and par["max_leaf_rel_grad_diff"] <= 5e-2)


def serve_run(torch, run_dir: str, device, run_name: str):
    """One greedy request through the port's server on a finished run."""
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
        InferenceService,
        serve,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import load_trained

    params, args, tok, _ = load_trained(run_dir, device=device)
    service = InferenceService(params, args, tok, run_name=run_name)
    service.attach_engine(EngineConfig(num_slots=2, max_len=1024, block_size=32,
                                       prefill_chunk=256))
    httpd = serve(service, port=0)
    try:
        return post(f"http://127.0.0.1:{httpd.server_address[1]}",
                    {"prompt": "Kalo mine su", "max_tokens": 16})
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()


def train_phase(torch, gm, fa, card, steps: int = 30, warmup: int = 10):
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        trainer = Trainer(Config.from_dict(config_40m(tmp, steps, warmup)),
                          runs_root=os.path.join(tmp, "runs"), quiet=True,
                          device="cuda")
        log(f"train: 40m-adamw {trainer.n_params / 1e6:.2f}M params, "
            f"{len(trainer.data.train_rows)} train rows, "
            f"{len(trainer.data.val_rows)} val rows of "
            f"{trainer.data.seq_len + 1} tokens, "
            f"{time.perf_counter() - t0:.1f}s to set up")

        # bf16 on both sides with the same rounding points outside the
        # attention; inside it the kernels sum in another order and round p
        # against a running max: bf16-ulp noise (2**-8) that twelve layers
        # carry to the loss at ~1e-4 and to each gradient at ~1e-2. At
        # initialisation the loss is ~ln(259) whatever the attention
        # computes, so the per-leaf gradient limit is the one that gates an
        # attention fault here; the kernel checks above gate each kernel.
        par = first_step_parity(
            torch, trainer, 8,
            [(fa, n, getattr(fa, n + "_plain")) for n in FLASH_KERNELS])
        log(f"train: step-1 parity at batch 8, kernels vs plain on the card: {par}")
        if not parity_ok(par):
            failures.append(f"step-1 loss/gradients disagree with the plain "
                            f"path: {par}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the training run only
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gm, fa)
        variants = read_variants(gm, fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = trainer.windows
        losses = [w["loss"] for w in windows]
        layers = trainer.model_args.num_layers
        want = {"flash_fwd": layers * (steps + trainer.eval_batches),
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
                "gmm": 0, "tgmm": 0}
        want_variants = flash_variants_want(fa, want["flash_fwd"], want["flash_bwd_dq"])
        flash_variants = {n: variants[n] for n in FLASH_KERNELS}
        log(f"train: flash launches by variant {flash_variants}")
        if flash_variants != want_variants:
            failures.append(f"train: flash launches by variant {flash_variants} != "
                            f"{want_variants}")
        log(f"train: {steps} steps + {trainer.eval_batches} validation batches "
            f"in {wall:.1f}s; losses every 5 steps {losses}; final val_loss="
            f"{result['final_val_loss']}; launches {launches}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != steps // 5:
            failures.append(f"train: bad loss log {losses}")
        elif not losses[-1] < 0.9 * losses[0]:
            failures.append(f"train: loss did not fall below 0.9x the first "
                            f"logged ({losses[0]} -> {losses[-1]})")
        if result["final_val_loss"] is None or trainer.eval_batches <= 0:
            failures.append("train: no validation ran")
        if launches != want:
            failures.append(f"train: launches {launches} != {want}")
        code, out = serve_run(torch, trainer.run_dir, trainer.device,
                              "40m-adamw-smoke")
        log(f"train: final checkpoint served: HTTP {code} "
            f"tokens={out.get('tokens')} text={out.get('text', '')[:40]!r}")
        if code != 200 or not out.get("tokens"):
            failures.append(f"serving the final checkpoint: HTTP {code} {out}")

    steady = windows[1:]  # the first window holds the first step's warm-up
    secs = sum(w["seconds"] for w in steady)
    toks = sum(w["toks"] for w in steady)
    tok_s = toks / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady),
            "tok_s": tok_s,
            "mfu_vs_989tflops": tok_s * trainer.flops_per_token / PEAK_FLOPS["bfloat16"],
            "flops_per_token": trainer.flops_per_token,
            "peak_mem_gb": peak_gb, "first_window_s": windows[0]["seconds"],
            "losses": losses, "launches": launches,
            "launches_by_variant": flash_variants, "first_step_parity": par}
    for k in ("step_ms", "tok_s", "mfu_vs_989tflops", "peak_mem_gb"):
        log(f"train: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 6: MoE training ------------------------------------------------------------
def config_moe(tmp: str, steps: int, warmup: int) -> dict:
    """configs/model-config-moe-8x40m.yaml written out as a dict, with the
    smoke's cuts: ``iters``, ``warmup_steps``, the log, validation and
    checkpoint intervals, and the corpus paths. ``system.mesh`` ({dp: -1,
    ep: 4}: expert parallelism over four devices) is dropped, since the
    port trains on one GPU and refuses a mesh that needs more; so is
    ``system.device``. Every width is the config's."""
    cfg = config_40m(tmp, steps, warmup)
    cfg["name"] = "Llama-MoE (8x40M)"
    cfg["model"]["moe"] = {"num_local_experts": 8, "num_experts_per_tok": 2,
                           "impl": "grouped", "capacity_factor": 1.25,
                           "aux_loss_weight": 0.01, "router_z_weight": 0.001,
                           "group_size": 256}
    return cfg


def moe_parity(torch, gm, moe, trainer):
    """Step-1 parity with the gmm and tgmm kernels against their plain
    versions (the flash kernels run in both), and how many of the routing
    selections changed expert between the two runs."""
    chosen = []
    grouped_ffn = moe._grouped_ffn

    def recording(experts, x_flat, gate_idx, *a, **kw):
        chosen.append(gate_idx.sort(dim=-1).values)
        return grouped_ffn(experts, x_flat, gate_idx, *a, **kw)

    def gmm_forward_plain(x, w, gs, block_t, w_trans=False):
        return gm.gmm_plain(x, w.transpose(1, 2) if w_trans else w, gs, block_t)

    moe._grouped_ffn = recording
    try:
        par = first_step_parity(torch, trainer, 8, [
            (gm, "_gmm_forward", gmm_forward_plain), (gm, "tgmm", gm.tgmm_plain)])
    finally:
        moe._grouped_ffn = grouped_ffn
    half = len(chosen) // 2
    par["selections_changed"] = int(sum(
        (a != b).sum().item() for a, b in zip(chosen[:half], chosen[half:])))
    par["selections"] = int(sum(a.numel() for a in chosen[:half]))
    return par


def moe_train_phase(torch, gm, fa, card, steps: int = 30, warmup: int = 10):
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.models import moe
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        trainer = Trainer(Config.from_dict(config_moe(tmp, steps, warmup)),
                          runs_root=os.path.join(tmp, "runs"), quiet=True,
                          device="cuda")
        log(f"moe: moe-8x40m {trainer.n_params / 1e6:.2f}M params, "
            f"{trainer.flops_per_token / 1e6:.1f} MFLOP per token (active), "
            f"{len(trainer.data.train_rows)} train rows, "
            f"{time.perf_counter() - t0:.1f}s to set up")

        # bf16 on both sides; the gmm kernels and their plain versions sum
        # each fp32 product in another order before one bf16 rounding (tgmm:
        # each tile's partial and the running sum), the combine and the
        # gather's backward scatter-add with atomics (an ulp per add, run to
        # run), and a token whose top-2 router probabilities nearly tie can
        # route differently in the two runs. The same limits as the dense
        # phase; the selections that changed expert are reported.
        par = moe_parity(torch, gm, moe, trainer)
        log(f"moe: step-1 parity at batch 8, gmm/tgmm kernels vs plain: {par}")
        if not parity_ok(par):
            failures.append(f"moe: step-1 loss/gradients disagree with the plain "
                            f"gmm/tgmm: {par}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the MoE training run only
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gm, fa)
        variants = read_variants(gm, fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = trainer.windows
        losses = [w["loss"] for w in windows]
        layers, vb = trainer.model_args.num_layers, trainer.eval_batches
        want = {"gmm": 6 * layers * steps + 3 * layers * vb,
                "tgmm": 3 * layers * steps,
                "flash_fwd": layers * (steps + vb),
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
        log(f"moe: {steps} steps + {vb} validation batches in {wall:.1f}s; losses "
            f"every 5 steps {losses}; final val_loss={result['final_val_loss']}; "
            f"launches {launches}")
        for w in windows:
            log(f"moe: step {w['step']} moe_entropy={w.get('moe_entropy')} "
                f"moe_drop={w.get('moe_drop')} moe_load_max={w.get('moe_load_max')}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != steps // 5:
            failures.append(f"moe: bad loss log {losses}")
        elif not losses[-1] < 0.9 * losses[0]:
            failures.append(f"moe: loss did not fall below 0.9x the first "
                            f"logged ({losses[0]} -> {losses[-1]})")
        if not all(0.0 < w.get("moe_entropy", -1) <= 1.0 and w.get("moe_drop") == 0
                   and 1 / 8 <= w.get("moe_load_max", -1) <= 1.0 for w in windows):
            failures.append("moe: a log line lacks sane routing stats")
        if result["final_val_loss"] is None or vb <= 0:
            failures.append("moe: no validation ran")
        if launches != want:
            failures.append(f"moe: launches {launches} != {want}")
        # bf16 at block_t 128: the TMA/wgmma kernels and no other; the
        # flash kernels on wgmma
        want_variants = {"gmm": {**dict.fromkeys(gm.GMM_VARIANTS, 0), "wgmma": want["gmm"]},
                         "tgmm": {**dict.fromkeys(gm.TGMM_VARIANTS, 0),
                                  "wgmma": want["tgmm"]},
                         **flash_variants_want(fa, want["flash_fwd"], want["flash_bwd_dq"])}
        log(f"moe: launches by variant {variants}")
        if variants != want_variants:
            failures.append(f"moe: launches by variant {variants} != {want_variants}")
        code, out = serve_run(torch, trainer.run_dir, trainer.device,
                              "moe-8x40m-smoke")
        log(f"moe: final checkpoint served: HTTP {code} "
            f"tokens={out.get('tokens')} text={out.get('text', '')[:40]!r}")
        if code != 200 or not out.get("tokens"):
            failures.append(f"moe: serving the final checkpoint: HTTP {code} {out}")
        flops_per_token = trainer.flops_per_token
        del trainer
    torch.cuda.empty_cache()

    steady = windows[1:]  # the first window holds the first step's warm-up
    secs = sum(w["seconds"] for w in steady)
    tok_s = sum(w["toks"] for w in steady) / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady),
            "tok_s": tok_s,
            "mfu_active_vs_989tflops": tok_s * flops_per_token / PEAK_FLOPS["bfloat16"],
            "flops_per_token": flops_per_token,
            "peak_mem_gb": peak_gb, "first_window_s": windows[0]["seconds"],
            "losses": losses, "launches": launches, "launches_by_variant": variants,
            "first_step_parity": par,
            "routing": [{k: w.get(k) for k in ("step", "moe_entropy", "moe_drop",
                                                "moe_load_max")} for w in windows]}
    for k in ("step_ms", "tok_s", "mfu_active_vs_989tflops", "peak_mem_gb"):
        log(f"moe: {k}={perf[k]} [{card}]")
    return failures, perf


def kernel_entry(name, source, replaces, launches, row, max_abs_err):
    """One kernel of the report line; ``earlier_ms`` is the kernel that
    served the path before it, where this run timed one in turns with it."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "earlier_ms": row.get("earlier_ms")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check
    from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = cuda_build.build_libraries([gm._SRC, fa._SRC])
    log(f"build: both sources in {time.perf_counter() - t0:.1f}s")
    failures = []
    for lib, src in zip(libs, (gm._SRC, fa._SRC)):
        secs = cuda_build.BUILD_SECONDS.get(src.name)
        log(f"build: {lib.name} in "
            + (f"{secs:.1f}s" if secs is not None else "0s (already built)"))
        kernel = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"build: {(kernel or '')[-60:]}: {line.strip()}")
                if "wgmma" in (kernel or "") and " 0 bytes spill stores" not in line \
                        and "spill stores" in line:
                    failures.append(f"build: {kernel[-60:]} spills: {line.strip()}")
            if any(c in line for c in ("C7513", "C7518", "C7520")):  # ptxas serialized every wgmma
                log(f"build: {line.strip()}")
                failures.append(f"build: {line.strip()[:200]}")

    cases = kernel_phase(torch, gm, kernel_check)
    train_cases, tgmm_cases = train_kernel_phase(torch, gm, kernel_check)
    failures += [f"{k} {c['case']} {c['dtype']}: kernel disagrees with plain "
                 f"(max_abs_err {c['max_abs_err']})"
                 for k, group in (("gmm", cases + train_cases), ("tgmm", tgmm_cases))
                 for c in group if not c["ok"]]
    flash_cases = flash_kernel_phase(torch, gm, fa)
    failures += [f"flash {c['case']} {c['dtype']}: kernels disagree with plain "
                 f"(max_abs_err {c['max_abs_err']})" for c in flash_cases
                 if not c["ok"]]
    path_failures, perf = path_phase(torch, gm, fa, card)
    failures += path_failures
    train_failures, train_perf = train_phase(torch, gm, fa, card)
    failures += train_failures
    torch.cuda.empty_cache()
    moe_failures, moe_perf = moe_train_phase(torch, gm, fa, card)
    failures += moe_failures

    # Launches: the MoE training run, which drives all five kernels. Times:
    # the training path's bf16 gate/up shapes (gmm forward, tgmm) and the
    # flash path shape (B 32, H 8, S 1024, D 64, bf16, causal).
    moe_launches = moe_perf.get("launches", {})
    gmm_case = train_cases[0]
    gmm_entry = kernel_entry(
        "gmm", SOURCE, REPLACES, moe_launches.get("gmm", 0), gmm_case,
        max(c["max_abs_err"] for c in train_cases))
    gmm_entry.update(cases=cases + train_cases, serve_path=perf,
                     serve_launches=perf.get("gmm_launches", 0), card=card)
    tgmm_entry = kernel_entry(
        "tgmm", SOURCE, TGMM_REPLACES, moe_launches.get("tgmm", 0), tgmm_cases[0],
        max(c["max_abs_err"] for c in tgmm_cases if c["dtype"] == "bfloat16"))
    tgmm_entry.update(cases=tgmm_cases, moe_train=moe_perf, card=card)
    # The serving path's two fp32 kernels, each at its K 1536 shape (down),
    # with its launches in the serving run and every fp32 row it served.
    serve_variants = perf.get("gmm_launches_by_variant", {})
    by_case = {c["case"]: c for c in cases if c["dtype"] == "float32"}
    fp32_entries = []
    for kname, variant, row in (("gmm_f32", "f32", "prefill_down"),
                                ("gmm_f32_decode", "f32_decode", "decode_down")):
        rows = [c for c in by_case.values() if c["variants"] == {variant: 1}]
        entry = kernel_entry(kname, SOURCE, REPLACES, serve_variants.get(variant, 0),
                             by_case[row], max(c["max_abs_err"] for c in rows))
        entry.update(variant=variant, cases=rows, card=card)
        fp32_entries.append(entry)
    path_case = flash_cases[0]  # B 32, H 8, S 1024, D 64, bf16, causal
    out_of = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
              "flash_bwd_dkv": ("dk", "dv")}
    flash_entries = [kernel_entry(
        name, FLASH_SOURCE, FLASH_REPLACES[name], moe_launches.get(name, 0),
        path_case["kernels"][name],
        max(path_case["max_abs_err"][o] for o in out_of[name]))
        for name in FLASH_KERNELS]
    moe_variants = moe_perf.get("launches_by_variant", {})
    for entry in flash_entries:
        row = path_case["kernels"][entry["name"]]
        entry.update(launches_by_variant=moe_variants.get(entry["name"]),
                     tflops=row["tflops"])
    flash_entries[0].update(cases=flash_cases, dense_train=train_perf, card=card)
    report = json.dumps({"kernels": [gmm_entry, tgmm_entry] + fp32_entries + flash_entries})
    if failures:  # no result on stdout; the measurements go to stderr
        print(report, file=sys.stderr)
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(report, flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
