#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result on stdout):

1. device  — needs CUDA (there is no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — compiles the grouped-GEMM kernel (csrc/grouped_matmul.cu) with
   nvcc into build/kernels/.
3. kernels — holds ``gmm`` against its plain PyTorch version at the serving
   path's shapes (moe-8x40m: decode with 8 slots, a 256-token prefill chunk),
   fp32 and bf16, plus an empty-group/tail-tile case, and times the kernel,
   the plain version and ``torch._grouped_mm`` (where it takes the dtype)
   as a yardstick.
4. path    — serves moe-8x40m at full width (12 layers, seeded random fp32
   weights) through the port's HTTP server and batch engine: 8 slots,
   max_len 1024, paged KV in 32-token blocks, prefix cache, 256-token prefill
   chunks. Checks the responses, the gmm launch count (3 per layer per
   prefill chunk and per decode step) and the first token's logits against
   the port's plain path on the CPU.
5. report  — a ``{"kernels": [...]}`` line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

fp32 matmuls run in full fp32: TF32 is switched off for matmuls and cuDNN.
Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import threading
import time

SEED = 0
# configs/model-config-moe-8x40m.yaml, written out so no YAML is read here.
MOE_8X40M = dict(vocab_size=259, hidden_size=512, intermediate_size=1536,
                 num_layers=12, num_heads=8, num_kv_heads=8, head_dim=64,
                 max_position_embeddings=1024, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=True,
                 num_local_experts=8, num_experts_per_tok=2, moe_impl="grouped")
# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by operand type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
REPLACES = "mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py:137"
SOURCE = "mlx_cuda_distributed_pretraining_tpu_torch/csrc/grouped_matmul.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


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


def kernel_case(torch, gm, name, dtype, T, K, N, sizes, block_t):
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

    out = gm.gmm(x, ws[0], gs, block_t)
    ref = gm.gmm_plain(x, ws[0], gs, block_t)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    # fp32: both sum fp32 products, in different orders (rtol/atol 1e-4).
    # bf16: exact bf16 products summed in fp32, rounded once to bf16; the
    # order can move that rounding by one bf16 ulp (2e-2 relative).
    tol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    ok = torch.allclose(out.float(), ref.float(), rtol=tol[0], atol=tol[1]) \
        and not out[live:].any().item()

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
            "block_t": block_t, "group_sizes": sizes.tolist(),
            "max_abs_err": err, "ok": bool(ok), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": library_note,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"gmm {name} {dtype} x[{T},{K}] w[{E},{K},{N}] block_t={block_t}: "
        f"max_abs_err={err:.3g} ok={ok} kernel={ms:.4f} ms plain="
        f"{plain_ms:.4f} ms library={library_ms} ms ({library_note}) "
        f"bound={case['bound_ms']:.4f} ms ({case['bound_by']})")
    del ws
    torch.cuda.empty_cache()
    return case


def kernel_phase(torch, gm):
    rng = torch.Generator().manual_seed(SEED)
    E, D, I = 8, 512, 1536
    dec_sizes, dec_rows = routed_sizes(torch, rng, 16, E, 8)      # 8 slots x top-2
    pre_sizes, pre_rows = routed_sizes(torch, rng, 512, E, 32)    # 256 tokens x top-2
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases.append(kernel_case(torch, gm, "decode_gate_up", dtype, dec_rows,
                                 D, I, dec_sizes, 8))
        cases.append(kernel_case(torch, gm, "prefill_gate_up", dtype, pre_rows,
                                 D, I, pre_sizes, 32))
    cases.append(kernel_case(torch, gm, "decode_down", "float32", dec_rows, I,
                             D, dec_sizes, 8))
    cases.append(kernel_case(torch, gm, "prefill_down", "float32", pre_rows, I,
                             D, pre_sizes, 32))
    edge = torch.tensor([16, 0, 8, 0, 0, 24, 8, 0], dtype=torch.int32)
    cases.append(kernel_case(torch, gm, "empty_groups_tail", "float32", 72, D,
                             I, edge, 8))
    return cases


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


def path_phase(torch, gm, card):
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
        gm.gmm.launches = 0  # count from here: the path's run only
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
        launches = gm.gmm.launches
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
        f"{steps} decode steps)")

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
        "gmm_launches": launches,
        "prefix_cache_hit_rate": metrics.get("prefix_cache_hit_rate"),
    }
    for k, v in perf.items():
        log(f"path: {k}={v} [{card}]")
    return failures, perf


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = gm.build_library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f}s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    failures = []
    cases = kernel_phase(torch, gm)
    failures += [f"gmm {c['case']} {c['dtype']}: kernel disagrees with plain "
                 f"(max_abs_err {c['max_abs_err']})" for c in cases if not c["ok"]]
    path_failures, perf = path_phase(torch, gm, card)
    failures += path_failures

    main_case = cases[0]  # fp32 decode gate/up: the shape the path runs most
    report = json.dumps({"kernels": [{
        "name": "gmm", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": perf.get("gmm_launches", 0),
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["dtype"] == main_case["dtype"]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "cases": cases, "path": perf, "card": card}]})
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
