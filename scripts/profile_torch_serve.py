#!/usr/bin/env python3
"""Where a serving step's time goes in the torch port, on one NVIDIA GPU.

    python3 scripts/profile_torch_serve.py [--steps 20] [--root DIR] [--out profile.json]

Builds moe-8x40m at full width (seeded random fp32 weights, the numbers of
configs/model-config-moe-8x40m.yaml written out), fills all 8 rows of a
batch engine with ~300-token prompts, then drives the engine's iterations on
this thread:

- decode: wall time per batched decode step (host clock around steps that
  end in a synchronise), and a torch.profiler window over the same steps:
  device time per step by kernel, and the device's idle share of the wall
  time;
- prefill: wall time of one 256-token prefill chunk (paged_prefill_step),
  and a torch.profiler window over the same chunks: device time per chunk
  by kernel and the device's idle share;
- the engine's own thread, as the HTTP server drives it: ms per decode step
  of one request served alone, and of one request decoding beside 7 others
  (from the requests' ``decode_ms``).

Both windows also report the grouped GEMM's share (kernels named
``gmm*``). ``--root`` imports the port from another checkout (its kernels
built there), so one call can profile a change and its parent in turns.
Prints one JSON object (also written to ``--out`` when given) with the
card's name and power limit beside the numbers. Needs CUDA; imports nothing
of JAX.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MOE_8X40M = dict(vocab_size=259, hidden_size=512, intermediate_size=1536,
                 num_layers=12, num_heads=8, num_kv_heads=8, head_dim=64,
                 max_position_embeddings=1024, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=True,
                 num_local_experts=8, num_experts_per_tok=2, moe_impl="grouped")


def device_kernels(torch, prof) -> dict:
    """{kernel name: [device ms, launches]} over a profiler window."""
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time / 1e3  # us -> ms
            k[1] += 1
    return kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--root", default=HERE, help="checkout whose port to profile")
    p.add_argument("--out", help="also write the JSON object here")
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import (
        BatchEngine,
        EngineConfig,
        batch_step,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

    assert llama.__file__.startswith(os.path.abspath(a.root)), llama.__file__
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    args = llama.LlamaArgs(**MOE_8X40M)
    params = llama.init_params(args, torch.Generator().manual_seed(0),
                               device="cuda")
    tok = TokenizerManager()
    engine = BatchEngine(params, args, tok, EngineConfig(
        num_slots=8, max_len=1024, block_size=32, prefill_chunk=256))
    base = "Profile prompt number {i}: a request of about three hundred bytes. "
    for i in range(8):
        engine.submit((base.format(i=i) * 5)[:300], max_tokens=10 ** 6)
    while len(engine.scheduler.decoding()) < 8:  # prefill every row
        engine._iteration()
    for _ in range(5):  # warm decode
        engine._iteration()
    torch.cuda.synchronize()

    launches0, steps0 = gm.gmm.launches, engine.decode_steps
    t0 = time.perf_counter()
    for _ in range(a.steps):
        engine._iteration()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / a.steps
    gmm_per_step = (gm.gmm.launches - launches0) / (engine.decode_steps - steps0)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(a.steps):
            engine._iteration()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    kernels = device_kernels(torch, prof)
    device_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]

    # one 256-token prefill chunk through row 0's table (it overwrites that
    # row's KV; the decode measurements above are done)
    toks = torch.randint(0, 256, (256,), device="cuda")
    table = torch.from_numpy(engine.pool.tables[0].astype("int64")).cuda()
    for _ in range(2):
        batch_step.paged_prefill_step(params, engine.pool.cache, toks, table, 0,
                                      255, args, 256, 32, with_logits=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(5):
        batch_step.paged_prefill_step(params, engine.pool.cache, toks, table, 0,
                                      255, args, 256, 32, with_logits=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t2) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        for _ in range(5):
            batch_step.paged_prefill_step(params, engine.pool.cache, toks, table, 0,
                                          255, args, 256, 32, with_logits=True)
        torch.cuda.synchronize()
        prefill_prof_wall_ms = (time.perf_counter() - t3) * 1e3
    pre_kernels = device_kernels(torch, prof)
    pre_device_ms = sum(v[0] for v in pre_kernels.values())

    def gmm_ms(ks, n):  # demangled names read "(anonymous namespace)::gmm_..."
        return sum(v[0] for name, v in ks.items() if re.search(r"\bgmm_", name)) / n

    def thread_step_ms(n_rows: int) -> float:
        """ms per decode step of the last request; the others get more
        tokens, so all ``n_rows`` rows decode for the whole of its window."""
        eng = BatchEngine(params, args, tok, EngineConfig(
            num_slots=8, max_len=1024, block_size=32, prefill_chunk=256,
            prefix_cache=False)).start()
        try:
            reqs = [eng.submit((base.format(i=i) * 5)[:300],
                               max_tokens=64 if i < n_rows - 1 else 32)
                    for i in range(n_rows)]
            for r in reqs:
                r.wait(600)
            res = reqs[-1].result
            return res["decode_ms"] / max(res["tokens"] - 1, 1)
        finally:
            eng.stop()

    thread_ms = {n: thread_step_ms(n) for n in (1, 8)}

    out = {
        "card": card,
        "decode_rows": 8,
        "decode_step_ms": step_ms,
        "decode_tok_s": 8 * 1e3 / step_ms,
        "profiled_step_wall_ms": prof_wall_ms / a.steps,
        "profiled_step_device_ms": device_ms / a.steps,
        "device_idle_share": 1.0 - device_ms / prof_wall_ms,
        "gmm_launches_per_decode_step": gmm_per_step,
        "kernels_per_decode_step": sum(v[1] for v in kernels.values()) / a.steps,
        "top_kernels_ms_per_step": [
            {"name": n[:90], "ms": v[0] / a.steps, "launches": v[1] / a.steps}
            for n, v in top],
        "decode_step_gmm_device_ms": gmm_ms(kernels, a.steps),
        "prefill_chunk_256_ms": prefill_ms,
        "profiled_prefill_chunk_wall_ms": prefill_prof_wall_ms / 5,
        "profiled_prefill_chunk_device_ms": pre_device_ms / 5,
        "prefill_device_idle_share": 1.0 - pre_device_ms / prefill_prof_wall_ms,
        "prefill_chunk_gmm_device_ms": gmm_ms(pre_kernels, 5),
        "engine_thread_decode_step_ms_1_row": thread_ms[1],
        "engine_thread_decode_step_ms_8_rows": thread_ms[8],
    }
    text = json.dumps(out, indent=1)
    print(text)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
