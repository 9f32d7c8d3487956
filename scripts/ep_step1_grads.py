"""Step 1's gradients leaf by leaf: one rank without a mesh against the ep
ranks of ``chip_smoke.py`` phases 7d (moe-1b, 8 gloo ranks) and 6c
(moe-8x40m, 4), at the phases' cuts, on the same global batch.

For each case it prints the gradient norm each side logs, the global norms
summed from the leaves, and the leaves whose gradients differ most (the
norm of each side and of the difference). Run on a machine with a card,
from the repository root:

    python3 scripts/ep_step1_grads.py [--cases ep8_bf16,ep8_fp32,ep4_bf16,ep8_bf16_castfirst]

A case ending in ``_castfirst`` looks the tokens up in the embedding table
cast to the compute dtype first, as JAX writes it (and the port once did),
so the backward sums a token's rows in that dtype.

Each rank is this file again (``--worker CONFIG OUT`` under
``parallel.launch --script``): the trainer's first step, its gradients
gathered over the mesh before the update, rank 0 writing them to
``OUT.npz``. The summary goes to ``build/ep_step1_grads/summary.json``.
"""

import argparse
import gc
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def cast_first() -> None:
    """``models/llama.py`` ``embed`` as JAX writes it: the table cast to the
    compute dtype, then the lookup."""
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama

    def embed(params, tokens, args, compute_dtype):
        return params["tok_embeddings"]["weight"].to(compute_dtype)[tokens.long()]

    llama.embed = embed


def worker(cfg_path: str, out: str) -> None:
    import torch.distributed as dist

    import mlx_cuda_distributed_pretraining_tpu_torch.train.train_step as ts
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.parallel.collectives import gather_full
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict, tree_map

    captured = {}
    make_apply = ts.make_sharded_apply

    def capturing(optimizer, mesh, shardings, params_like, zero_level=0):
        apply = make_apply(optimizer, mesh, shardings, params_like, zero_level)

        def step(grads, state, params):
            if not captured:
                full = tree_map(lambda g, s: gather_full(g, s, mesh), grads,
                                shardings["params"])
                captured.update({k: v.float().cpu().numpy()
                                 for k, v in flatten_dict(full).items()})
            return apply(grads, state, params)
        return step

    ts.make_sharded_apply = capturing
    with open(cfg_path) as f:
        cfg = json.load(f)
    if cfg["name"].endswith("_castfirst"):
        cast_first()
    Trainer(Config.from_dict(cfg), runs_root=out + "_runs", quiet=True, device="cuda").train()
    if dist.get_rank() == 0:
        np.savez(out + ".npz", **captured)


def one_rank(torch, cs, cfg: dict, spec: dict, tmp: str):
    """(the logged gradient norm, {leaf: gradient}) of the cut config's
    step 1 on one rank, on the ranks' global batch."""
    import mlx_cuda_distributed_pretraining_tpu_torch.train.train_step as ts
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.data.streaming import build_data_manager
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict

    single = json.loads(json.dumps(cfg))
    single["system"].pop("mesh")
    single["training"]["hyperparameters"]["batch_size"] = spec["rows"] * spec["ranks"]
    t = Trainer(Config.from_dict(single), runs_root=os.path.join(tmp, "single"), quiet=True,
                device="cuda")
    ccfg = Config.from_dict(cfg)
    parts = [build_data_manager(ccfg, t.tokenizer, spec["rows"],
                                seq_len=ccfg.data.max_context_size, seed=ccfg.system.seed,
                                process_index=i, process_count=spec["ranks"]).generate_batch(0)
             for i in range(spec["ranks"])]
    batch = t._device_batch({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    got = {}
    global_norm = ts.global_norm

    def capturing(grads):  # the one-device step logs the norm of its gradients
        got.update({k: v.float().cpu().numpy() for k, v in flatten_dict(grads).items()})
        return global_norm(grads)

    ts.global_norm = capturing
    try:
        t.state, m = t.train_step(t.state, batch)
    finally:
        ts.global_norm = global_norm
    norm = float(m["grad_norm"])
    t.events.close()
    t.logger.close()
    t.state = None
    del t, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return norm, got


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--worker", nargs=2, metavar=("CONFIG", "OUT"))
    p.add_argument("--cases", default="ep8_bf16,ep8_fp32,ep4_bf16")
    args = p.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    import torch

    import chip_smoke as cs
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm
    from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_libraries((gm._SRC, fa._SRC))
    card = cs.card_line()
    tmp = os.path.join(REPO, "build", "ep_step1_grads")
    os.makedirs(tmp, exist_ok=True)
    cs.write_corpus(tmp, train_bytes=300_000, val_bytes=70_000)
    report = {"card": card}
    table_first = llama.embed
    for case in args.cases.split(","):
        label, precision = case.split("_")[:2]
        spec = {"ep8": cs.EP8, "ep4": cs.EP4}[label]
        llama.embed = table_first
        if case.endswith("_castfirst"):
            cast_first()
        cfg = spec["config"](tmp)
        cfg["name"] = case
        cfg["training"]["hyperparameters"]["iters"] = 1
        cfg["system"]["mixed_precision"] = precision == "bf16"
        cfg["logging"]["steps"]["checkpoint_interval"] = 0
        ref_norm, ref = one_rank(torch, cs, cfg, spec, tmp)
        path = os.path.join(tmp, case + ".json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        rc = cs.child_run(cs.launch_cmd(spec["ranks"], "--device", "cuda", "--backend", "gloo",
                                        "--script", os.path.abspath(__file__), "--",
                                        "--worker", path, os.path.join(tmp, case)),
                          os.path.join(tmp, case + ".out"), 600)
        if rc != 0:
            print(case, "ranks exit", rc, cs.tail_of(os.path.join(tmp, case + ".out")))
            return 1
        mesh = dict(np.load(os.path.join(tmp, case + ".npz")))

        def norm(x):
            return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))

        leaves = sorted(([k, norm(v), norm(mesh[k]), norm(mesh[k] - v)] for k, v in ref.items()),
                        key=lambda r: -r[3])
        report[case] = {
            "one_rank_logged_norm": ref_norm,
            "one_rank_norm": sum(norm(v) ** 2 for v in ref.values()) ** 0.5,
            "ranks_norm": sum(norm(mesh[k]) ** 2 for k in ref) ** 0.5,
            "leaves_one_rank_ranks_difference": leaves[:6]}
        print(case, json.dumps(report[case]), f"[{card}]", flush=True)
    with open(os.path.join(tmp, "summary.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
