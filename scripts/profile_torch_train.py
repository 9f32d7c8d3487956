#!/usr/bin/env python3
"""Where a training step's time goes in the torch port, on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py
        [--config 40m-adamw|40m-adamw-fp32|moe-8x40m|moe-8x40m-int8|1b-singlechip|1b-fsdp|
                  100m-muon|1m-adamw|1m-flex|80m-fineweb]
        [--steps 10] [--per-leaf-ns] [--root DIR] [--out profile.json]
    python -m mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch \\
        --nproc-per-node 1 --script scripts/profile_torch_train.py -- --config 1b-fsdp

Builds configs/model-config-40m-adamw.yaml (the default),
configs/model-config-moe-8x40m.yaml, configs/model-config-1b-singlechip.yaml,
configs/model-config-100m-muon.yaml, configs/models/model-config-1m-adamw.yaml,
configs/model-config-1m-flex.yaml or configs/model-config-80m-fineweb.yaml at full width (their numbers written out. 40m: hidden 512, 12 layers, 8
heads of 64, 1024 positions, batch 32, bf16 compute over fp32 masters,
flash attention, AdamW with clip 1.0; 40m-adamw-fp32 the same with
``system.mixed_precision`` false (fp32 compute, the fp32 flash kernels); the MoE config's 8 experts top-2
with its router losses, on one GPU, without its expert-parallel mesh
(moe-8x40m-int8: the same with ``model.matmul_precision: int8``). 1B:
hidden 2048, intermediate 5632, 16 layers, 16 heads of 128, 2048
positions, batch 8, flash attention, remat "full" on the first half of the
layers (the default ``gradient_checkpointing_ratio`` 0.5), Adafactor with
update clipping 1.0 and gradient clip 1.0. 1b-fsdp
(configs/model-config-1b-fsdp.yaml): the same widths at batch 32, remat
"save_attn" on the first half of the layers, AdamW (betas 0.9/0.95, weight
decay 0.1, clip 1.0), ZeRO-1 and ``overlap_gather`` over its ``{fsdp: -1}``
mesh: started through ``parallel.launch`` (as above) the step is the
mesh train step over the launcher's ranks, and the profile splits out the
collectives (NCCL's all-gathers, reduce-scatters and all-reduces); with
one rank every axis is 1 and nothing is communicated. 100m-muon: hidden 768,
intermediate 2048, 12 layers, 12 heads of 64, 1024 positions, batch 32,
flash attention, Muon with Nesterov, 5 Newton-Schulz steps and AdamW at
0.015 x the LR for the vectors; ``--per-leaf-ns`` orthogonalizes each
matrix alone, as the JAX update does, instead of in same-shape batches.
1m-adamw: hidden 128, intermediate 512, 6 layers, 4 heads of 32 over 2 KV
heads, 512 positions, batch 16, flash attention, AdamW. 1m-flex: hidden 96,
intermediate 256, 4 layers, 6 heads of 16, 512 positions, batch 16, flex
attention with a 128-token sliding window and ALiBi, Muon at 0.03 x the LR
for the vectors. 80m-fineweb: hidden 1024, intermediate 2816, 12 layers,
16 query heads over 8 KV heads of 64, 2048 positions, batch 32, flash
attention, Muon at 0.02 x the LR for the vectors; the batch is a fixed
device tensor, so its streaming loader and prefetcher are not in the
step) with seeded random weights and seeded random byte tokens,
then:

- step: wall time per train step (``make_train_step``; host clock around
  steps that end in a synchronise);
- phases: wall time of the forward + loss, the backward and the fused
  AdamW, each ended by a synchronise;
- a torch.profiler window over the same steps: device time per step by
  kernel and by family (flash kernels, matrix products, the rest), kernels
  launched per step, and the device's idle share of the wall time. An MoE
  step's kernels split into gmm, tgmm, the dispatch's gathers, scatters and
  sort, and the rest; at ``matmul_precision: int8`` also gmm_int8 and the
  copies that write int8 (the quantizers' casts, gmm_int8's transposed
  weights).

``--root`` imports the port from another checkout (its kernels built
there), to compare two trees in turns on one card. Prints one JSON object
(also written to ``--out`` when given) with the card's name and power
limit beside the numbers. Needs CUDA; imports nothing
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

# configs/model-config-40m-adamw.yaml, the sections the step reads.
CONFIG_40M = {
    "name": "40m-adamw",
    "model": {"dimensions": {"hidden_size": 512, "intermediate_size": 1536,
                             "num_layers": 12},
              "attention": {"num_heads": 8, "num_kv_heads": 8, "head_dim": 64,
                            "max_position_embeddings": 1024,
                            "use_flash_attention": True},
              "normalization": {"rms_norm_eps": 1.0e-5},
              "rope": {"theta": 10000, "traditional": False},
              "misc": {"tie_word_embeddings": True}},
    "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 6.0e-4,
                                     "weight_decay": 0.05, "gradient_clip": 1.0,
                                     "iters": 10000},
                 "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 500,
                               "min_lr_ratio": 0.1},
                 "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
    "data": {"preprocessing": {"max_context_size": 1024}},
    "system": {"seed": 42, "mixed_precision": True},
}
# configs/model-config-moe-8x40m.yaml: the same trunk with its moe section.
CONFIG_MOE = {**CONFIG_40M, "name": "moe-8x40m", "model": {
    **CONFIG_40M["model"],
    "moe": {"num_local_experts": 8, "num_experts_per_tok": 2, "impl": "grouped",
            "capacity_factor": 1.25, "aux_loss_weight": 0.01,
            "router_z_weight": 0.001, "group_size": 256}}}
# configs/model-config-1b-singlechip.yaml, the sections the step reads.
CONFIG_1B = {
    "name": "1b-singlechip",
    "data": {"preprocessing": {"max_context_size": 2048}},
    "model": {"dimensions": {"hidden_size": 2048, "intermediate_size": 5632,
                             "num_layers": 16},
              "attention": {"num_heads": 16, "num_kv_heads": 16, "head_dim": 128,
                            "max_position_embeddings": 2048,
                            "attention_type": "flash"},
              "normalization": {"rms_norm_eps": 1.0e-5},
              "rope": {"theta": 10000},
              "misc": {"tie_word_embeddings": True}},
    "training": {"hyperparameters": {"batch_size": 8, "learning_rate": 1.0e-2,
                                     "weight_decay": 0.0, "gradient_clip": 1.0,
                                     "iters": 20000},
                 "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 2000,
                               "min_lr_ratio": 0.1},
                 "optimization": {"optimizer": "adafactor", "clipping_threshold": 1.0}},
    "system": {"seed": 42, "compute_dtype": "bfloat16", "remat": "full",
               "scan_layers": True},
}
# configs/model-config-100m-muon.yaml, the sections the step reads.
CONFIG_100M_MUON = {
    "name": "100m-muon",
    "data": {"preprocessing": {"max_context_size": 1024}},
    "model": {"dimensions": {"hidden_size": 768, "intermediate_size": 2048,
                             "num_layers": 12},
              "attention": {"num_heads": 12, "num_kv_heads": 12, "head_dim": 64,
                            "max_position_embeddings": 1024,
                            "use_flash_attention": True},
              "normalization": {"rms_norm_eps": 1.0e-5},
              "rope": {"theta": 10000, "traditional": False},
              "misc": {"tie_word_embeddings": True}},
    "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 2.0e-2,
                                     "weight_decay": 0.01, "gradient_clip": 1.0,
                                     "iters": 10000},
                 "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 300,
                               "min_lr_ratio": 0.05},
                 "optimization": {"optimizer": "muon", "momentum": 0.95, "nesterov": True,
                                  "ns_steps": 5, "adamw_lr_ratio": 0.015}},
    "system": {"seed": 42, "mixed_precision": True},
}
# configs/models/model-config-1m-adamw.yaml, the sections the step reads.
CONFIG_1M_ADAMW = {
    "name": "1m-adamw",
    "data": {"preprocessing": {"max_context_size": 512}},
    "model": {"dimensions": {"hidden_size": 128, "intermediate_size": 512, "num_layers": 6},
              "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
                            "max_position_embeddings": 512, "attention_type": "flash"},
              "normalization": {"rms_norm_eps": 1.0e-5},
              "rope": {"theta": 10000, "traditional": False},
              "misc": {"tie_word_embeddings": True}},
    "training": {"hyperparameters": {"batch_size": 16, "learning_rate": 3.0e-3,
                                     "weight_decay": 0.01, "gradient_clip": 1.0,
                                     "iters": 2000},
                 "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 100,
                               "min_lr_ratio": 0.05},
                 "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
    "system": {"seed": 42, "mixed_precision": True},
}
# configs/model-config-1m-flex.yaml, the sections the step reads.
CONFIG_1M_FLEX = {
    "name": "1m-flex",
    "data": {"preprocessing": {"max_context_size": 512}},
    "model": {"dimensions": {"hidden_size": 96, "intermediate_size": 256, "num_layers": 4},
              "attention": {"num_heads": 6, "num_kv_heads": 6, "head_dim": 16,
                            "max_position_embeddings": 512, "use_flex_attention": True,
                            "mask_type": "sliding_window", "window_size": 128,
                            "score_mod": "alibi"},
              "normalization": {"rms_norm_eps": 1.0e-5},
              "rope": {"theta": 10000, "traditional": False},
              "misc": {"tie_word_embeddings": True}},
    "training": {"hyperparameters": {"batch_size": 16, "learning_rate": 1.0e-2,
                                     "weight_decay": 0.01, "gradient_clip": 1.0,
                                     "iters": 5000},
                 "scheduler": {"type": "cosine", "min_lr_ratio": 0.05},
                 "optimization": {"optimizer": "muon", "adamw_lr_ratio": 0.03}},
    "system": {"seed": 42, "mixed_precision": True},
}
# configs/model-config-80m-fineweb.yaml, the sections the step reads.
CONFIG_80M_FINEWEB = {
    "name": "80m-fineweb",
    "data": {"preprocessing": {"max_context_size": 2048}},
    "model": {"dimensions": {"hidden_size": 1024, "intermediate_size": 2816,
                             "num_layers": 12},
              "attention": {"num_heads": 16, "num_kv_heads": 8, "head_dim": 64,
                            "max_position_embeddings": 2048,
                            "use_flash_attention": True},
              "normalization": {"rms_norm_eps": 1.0e-5},
              "rope": {"theta": 10000, "traditional": False},
              "misc": {"tie_word_embeddings": True}},
    "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 1.5e-2,
                                     "weight_decay": 0.01, "gradient_clip": 1.0,
                                     "iters": 20000},
                 "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 500,
                               "min_lr_ratio": 0.05},
                 "optimization": {"optimizer": "muon", "adamw_lr_ratio": 0.02}},
    "system": {"seed": 42, "mixed_precision": True},
}
# configs/model-config-1b-fsdp.yaml, the sections the step reads.
CONFIG_1B_FSDP = {
    "name": "1b-fsdp",
    "data": {"preprocessing": {"max_context_size": 2048}},
    "model": {**CONFIG_1B["model"], "remat_policy": "save_attn"},
    "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 3.0e-4,
                                     "weight_decay": 0.1, "gradient_clip": 1.0,
                                     "iters": 20000},
                 "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 2000,
                               "min_lr_ratio": 0.1},
                 "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
    "system": {"seed": 42, "mixed_precision": True, "gradient_checkpointing": True,
               "remat": "dots", "zero_optimization_level": 1, "mesh": {"fsdp": -1},
               "scan_layers": True, "overlap_gather": True},
}
CONFIGS = {"40m-adamw": CONFIG_40M, "moe-8x40m": CONFIG_MOE, "1b-singlechip": CONFIG_1B,
           "1b-fsdp": CONFIG_1B_FSDP,
           "moe-8x40m-int8": {**CONFIG_MOE, "name": "moe-8x40m-int8", "model": {
               **CONFIG_MOE["model"], "matmul_precision": "int8"}},
           "40m-adamw-fp32": {**CONFIG_40M, "name": "40m-adamw-fp32",
                              "system": {"seed": 42, "mixed_precision": False}},
           "100m-muon": CONFIG_100M_MUON, "1m-adamw": CONFIG_1M_ADAMW,
           "1m-flex": CONFIG_1M_FLEX, "80m-fineweb": CONFIG_80M_FINEWEB}
VOCAB = 259


def family(name: str) -> str:
    kernel = re.search(r"(flash_\w+_kernel|tgmm_\w+_kernel|gmm_\w+_kernel)", name)
    if kernel:
        return kernel.group(0)
    n = name.lower()
    if "nccl" in n:  # the mesh's collectives, by kind
        kind = next((k for k in ("AllGather", "ReduceScatter", "AllReduce") if k in name),
                    "other")
        return f"collectives: {kind}"
    if "copy" in n and "signed char" in n:  # the int8 path's casts to int8 and weight transposes
        return "int8 casts and copies (quantizers, gmm_int8's transposed weights)"
    if any(k in n for k in ("gemm", "nvjet", "sm90", "cutlass", "xmma")):
        return "matrix products (cuBLAS)"
    if any(k in n for k in ("index", "scatter", "gather", "sort", "radix")):
        return "dispatch: gathers, scatters, sort"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="40m-adamw")
    p.add_argument("--steps", type=int, default=10,
                   help="timed and profiled steps; 0: step 1 alone (its loss and "
                        "gradient norm, to hold one mesh against another)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the config's depth to this many layers")
    p.add_argument("--per-leaf-ns", action="store_true",
                   help="Muon: orthogonalize each matrix alone (the JAX order)")
    p.add_argument("--root", default=HERE,
                   help="the checkout whose port (and kernels) to profile")
    p.add_argument("--out", help="also write the JSON object here")
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm
    from mlx_cuda_distributed_pretraining_tpu_torch.optim.factory import build_optimizer
    from mlx_cuda_distributed_pretraining_tpu_torch.optim.sharded import make_sharded_apply
    from mlx_cuda_distributed_pretraining_tpu_torch.parallel.mesh import build_mesh, world_size
    from mlx_cuda_distributed_pretraining_tpu_torch.parallel.overlap import use_plan
    from mlx_cuda_distributed_pretraining_tpu_torch.train.train_step import (
        init_train_state,
        local_rows,
        make_loss_fn,
        make_train_step,
        shard_state,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import (
        leaves_with_path,
        tree_map,
    )

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    if a.per_leaf_ns:
        import importlib

        muon = importlib.import_module("mlx_cuda_distributed_pretraining_tpu_torch.optim.muon")
        batched = muon.orthogonalize
        muon.orthogonalize = lambda tree, steps=5: tree_map(
            lambda m: None if m is None else batched({"m": m}, steps)["m"], tree)
    cfg_dict = CONFIGS[a.config]
    if a.layers:
        model = dict(cfg_dict["model"])
        model["dimensions"] = dict(model["dimensions"], num_layers=a.layers)
        cfg_dict = dict(cfg_dict, model=model)
    cfg = Config.from_dict(cfg_dict)
    args = llama.LlamaArgs.from_config(cfg.model, VOCAB)
    params = llama.init_params(args, torch.Generator().manual_seed(42), device="cuda")
    optimizer = build_optimizer(cfg.training, cfg.training.iters)
    dtype = torch.bfloat16 if cfg.system.compute_dtype == "bfloat16" else torch.float32

    experts = args.num_local_experts if args.is_moe else 0
    seq = cfg.data.max_context_size
    remat = cfg.model.remat_policy or cfg.system.remat or (
        "full" if cfg.system.gradient_checkpointing else None)
    loss_fn = make_loss_fn(args, dtype, remat=remat,
                           remat_ratio=cfg.system.gradient_checkpointing_ratio,
                           ce_chunk=cfg.system.fused_ce_chunk,
                           overlap=bool(cfg.system.overlap_gather),
                           with_moe_stats=bool(experts))

    # a config with a mesh runs the mesh train step over the launcher's ranks
    mesh = build_mesh(cfg.system) if cfg.system.mesh else None
    zero = int(cfg.system.zero_optimization_level or 0)
    like = tree_map(lambda q: torch.empty(q.shape, device="meta"), params)
    step_fn = make_train_step(loss_fn, optimizer, moe_stats_experts=experts, mesh=mesh,
                              zero_level=zero, params_like=like, log_grad_norm=True)
    state = init_train_state(params, optimizer)
    apply = optimizer.fused_apply
    if mesh is not None:
        state = shard_state(state, step_fn.shardings, mesh)
        apply = make_sharded_apply(optimizer, mesh, step_fn.shardings, like, zero)
        del params
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 256, (cfg.training.batch_size, seq + 1), generator=g)
    batch = {"inputs": rows[:, :-1].cuda(), "targets": rows[:, 1:].cuda(),
             "mask": torch.ones(rows.shape[0], seq, device="cuda")}
    if mesh is not None:  # this rank's rows of the global batch
        batch = {k: v.contiguous() for k, v in local_rows(batch, mesh).items()}
    first = None
    for _ in range(3 if a.steps else 1):  # warm: cuBLAS handles, the kernels' library
        state, metrics = step_fn(state, batch)
        if first is None:  # step 1 from the seeded weights, for parity across meshes
            first = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    torch.cuda.synchronize()
    if not a.steps:
        out = {"card": card, "config": a.config, "layers": args.num_layers,
               "mesh": None if mesh is None else dict(mesh.shape), "ranks": world_size(),
               "first_step": first}
        if mesh is None or mesh.rank == 0:
            print(json.dumps(out))
            if a.out:
                with open(a.out, "w") as f:
                    json.dump(out, f)
        return 0

    t0 = time.perf_counter()
    for _ in range(a.steps):
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / a.steps

    # The same step cut into phases, each ended by a synchronise (one rank:
    # over several, the gradients' reduction sits between the backward and
    # the update, and the phases are not split).
    phases = {"forward_and_loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    leaves = [q for _, q in leaves_with_path(state["params"])]
    for _ in range(a.steps if world_size() == 1 else 0):
        for q in leaves:
            q.grad = None
        t = time.perf_counter()
        with use_plan(getattr(step_fn, "plan", None)):
            loss = loss_fn(state["params"], batch)[0]
        torch.cuda.synchronize()
        phases["forward_and_loss"] += time.perf_counter() - t
        t = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        phases["backward"] += time.perf_counter() - t
        t = time.perf_counter()
        state["params"], state["opt_state"] = apply(
            tree_map(lambda q: q.grad, state["params"]), state["opt_state"],
            state["params"])
        torch.cuda.synchronize()
        phases["optimizer"] += time.perf_counter() - t
    for q in leaves:
        q.grad = None

    from torch.profiler import ProfilerActivity, profile

    fa.reset_launches()
    gm.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(a.steps):
            state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    kernels, families = {}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time / 1e3  # us -> ms
            k[1] += 1
            f = families.setdefault(family(ev.name), [0.0, 0])
            f[0] += ev.device_time / 1e3
            f[1] += 1
    device_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    tokens = cfg.training.batch_size * seq

    out = {
        "card": card,
        "root": os.path.dirname(os.path.dirname(os.path.dirname(llama.__file__))),
        "config": f"{a.config}, B {cfg.training.batch_size}, S {seq}, "
                  f"{'bf16 over fp32' if dtype == torch.bfloat16 else 'fp32'}, "
                  f"{args.attention_type} attention, remat {remat}, "
                  f"{cfg.training.optimizer_name}"
                  + (" (NS per leaf)" if a.per_leaf_ns else ""),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "params": llama.num_params(like),
        "mesh": None if mesh is None else dict(mesh.shape),
        "ranks": world_size(),
        "zero_optimization_level": zero,
        "step_ms": step_ms,
        "tok_s": tokens * 1e3 / step_ms,
        "phase_ms": ({k: v * 1e3 / a.steps for k, v in phases.items()}
                     if world_size() == 1 else None),
        "first_step": first,
        "profiled_step_wall_ms": prof_wall_ms / a.steps,
        "profiled_step_device_ms": device_ms / a.steps,
        "device_idle_share": 1.0 - device_ms / prof_wall_ms,
        "kernels_per_step": sum(v[1] for v in kernels.values()) / a.steps,
        "flash_fwd_launches_per_step": fa.flash_fwd.launches / a.steps,
        "flash_launches_by_variant": {
            n: getattr(fa, n).launches_by_variant for n in fa.FLASH_KERNELS},
        "gmm_launches_per_step": gm.gmm.launches / a.steps,
        "tgmm_launches_per_step": gm.tgmm.launches / a.steps,
        "gmm_int8_launches_per_step": gm.gmm_int8.launches / a.steps,
        "gmm_launches_by_variant": gm.gmm.launches_by_variant,
        "tgmm_launches_by_variant": gm.tgmm.launches_by_variant,
        "gmm_int8_launches_by_variant": getattr(gm.gmm_int8, "launches_by_variant", None),
        "families_ms_per_step": {
            n: {"ms": v[0] / a.steps, "launches": v[1] / a.steps}
            for n, v in sorted(families.items(), key=lambda kv: -kv[1][0])},
        "top_kernels_ms_per_step": [
            {"name": n[:90], "ms": v[0] / a.steps, "launches": v[1] / a.steps}
            for n, v in top],
        "last_loss": float(metrics["loss"]),
    }
    # 6N FLOPs a token (attention's share and the remat recompute left out)
    out["mfu_6n_vs_989tflops"] = (out["tok_s"] * 6 * out["params"] / 989e12
                                  if dtype == torch.bfloat16 else None)
    text = json.dumps(out, indent=1)
    if mesh is not None and mesh.rank != 0:
        return 0  # the chief reports
    print(text)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
