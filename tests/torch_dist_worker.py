"""One rank of the port's multi-rank CPU tests, started through the port's
own launcher (``parallel.launch --nproc-per-node N --device cpu --script
tests/torch_dist_worker.py -- TASK DIR``). It imports the port only; the
test writes its inputs into ``DIR`` and rank 0 writes the results there.

Tasks:

- ``train``: the mesh train step, 5 steps from ``init.npz`` on the global
  batches of ``batches.npz``, for every case of ``spec.json``'s ``train``
  (mesh, ZeRO level, overlap_gather).
- ``ckpt``: {fsdp: 4} with ZeRO-1: steps 1-3, a save through the
  checkpoint manager with a sidecar a rank, steps 4-5; and steps 4-5
  resumed from the JAX package's step-3 files in ``ckpt_jax/``.
- ``resume``: steps 4-5 from the port's step-3 files on this world size.
- ``opt``: every optimizer of ``spec.json``'s ``opt``, 5 updates of
  ``opt_init.npz`` by ``opt_grads.npz`` on sharded state.
- ``trainers``: the trainer at ``spec.json``'s ``trainers`` configs, in
  order (cross-mesh resumes on one world).
- ``moe``: the MoE model of ``spec.json``'s ``moe`` (router losses, routing
  stats) 3 steps from ``moe_init.npz`` at each of its meshes.

- ``tp``: every case of ``spec.json``'s ``tp`` (a model of ``tp_models``,
  a mesh with a tp axis, ZeRO level, CE chunk, z-loss, remat, training),
  5 steps from ``tp_<model>.npz``.
- ``tpckpt``: {tp: 4} ZeRO-1 on ``tp_ckpt_model``: steps 1-3, a save,
  steps 4-5; and steps 4-5 from the JAX package's step-3 files in
  ``tp_ckpt_jax/``.
- ``tpresume``: steps 4-5 from the port's tp step-3 files on
  ``spec.json``'s ``tp_resume_mesh`` (``{}`` on one rank).
- ``tpgrad``: one backward on {tp: 4} (and {dp: 2, tp: 2}); every rank's
  gradient of each tp-replicated leaf, gathered to rank 0.

TASK may name several, comma-separated, run in order in one world.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    _atomic_json,
    shard_arrays,
)
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_flat
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.optim.factory import build_optimizer
from mlx_cuda_distributed_pretraining_tpu_torch.optim.sharded import make_sharded_apply
from mlx_cuda_distributed_pretraining_tpu_torch.parallel.elastic import process_barrier
from mlx_cuda_distributed_pretraining_tpu_torch.parallel.mesh import build_mesh
from mlx_cuda_distributed_pretraining_tpu_torch.train import train_step as ts
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict, tree_map

TASKS, OUT = sys.argv[1].split(","), sys.argv[2]
SPEC = json.load(open(os.path.join(OUT, "spec.json")))
RANK = dist.get_rank() if dist.is_initialized() else 0
torch.manual_seed(0)


def mesh_of(sizes):
    return build_mesh(SimpleNamespace(mesh=dict(sizes)))


def load_flat(name):
    with np.load(os.path.join(OUT, name)) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def training_cfg(d):
    return Config.from_dict({"name": "w", "training": d}).training


def flat_numpy(tree):
    return {k: v.detach().float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in flatten_dict(tree).items() if isinstance(v, torch.Tensor)}


def save(name, **arrays):
    if RANK == 0:
        np.savez(os.path.join(OUT, name), **arrays)


def batches():
    with np.load(os.path.join(OUT, "batches.npz")) as z:
        n = len([k for k in z.files if k.startswith("inputs_")])
        return [{k: torch.from_numpy(z[f"{k}_{i}"].copy()).to(torch.float32 if k == "mask"
                                                                  else torch.int64)
                 for k in ("inputs", "targets", "mask")} for i in range(n)]


ARGS = tl.LlamaArgs(**SPEC["model"])
LOSS = ts.make_loss_fn(ARGS, torch.float32, ce_chunk=0)
LOSS_OVERLAP = ts.make_loss_fn(ARGS, torch.float32, ce_chunk=0, overlap=True)


def step_fn(sizes, zero, overlap, init="init.npz", loss=None, experts=0, training=None,
            accum=1):
    mesh = mesh_of(sizes)
    opt = build_optimizer(training_cfg(training or SPEC["training"]), SPEC["total_steps"])
    like = tree_map(lambda p: torch.empty(p.shape, device="meta"),
                    params_from_flat(load_flat(init), "cpu"))
    step = ts.make_train_step(loss or (LOSS_OVERLAP if overlap else LOSS), opt,
                              accum_steps=accum, log_grad_norm=True, mesh=mesh,
                              zero_level=zero, params_like=like, moe_stats_experts=experts)
    return mesh, opt, step


def run_steps(mesh, step, state, steps):
    out = []
    for b in [batches()[i] for i in steps]:
        local = {k: v.contiguous() for k, v in ts.local_rows(b, mesh).items()}
        state, m = step(state, local)
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m["toks"])))
    return state, out


def fresh_state(mesh, opt, step, init="init.npz"):
    params = params_from_flat(load_flat(init), "cpu")
    return ts.shard_state(ts.init_train_state(params, opt), step.shardings, mesh)


def write_result(name, state, step, mesh, metrics):
    full = ts.gather_state(state, step.shardings, mesh)
    save(name, metrics=np.array(metrics, np.float64),
         **{"p." + k: v for k, v in flat_numpy(full["params"]).items()},
         **{"o." + k: v for k, v in flat_numpy(full["opt_state"]).items()})


def save_checkpoint(ckpt_dir, step_no, state, step, mesh):
    """The trainer's save: every rank gathers and writes its sidecar, the
    chief writes the step once the sidecars are down."""
    full = ts.gather_state(state, step.shardings, mesh)
    mgr = CheckpointManager(ckpt_dir)
    os.makedirs(mgr.checkpoint_dir, exist_ok=True)
    _atomic_json(os.path.join(mgr.checkpoint_dir, f"step_{step_no}_data_p{RANK}.json"),
                 {"rank": RANK, "process_count": mesh.size, "process_index": RANK})
    process_barrier(f"save_{ckpt_dir}_{step_no}")
    if RANK == 0:
        mgr.save(step_no, full["params"], full["opt_state"], {"step": step_no})


def load_checkpoint(ckpt_dir, step_no, state, step, mesh, opt, init="init.npz"):
    like_p = tree_map(lambda p: torch.empty(p.shape, device="meta"),
                      params_from_flat(load_flat(init), "cpu"))
    params, opt_state, _ = CheckpointManager(ckpt_dir).load(
        step_no, like_params=like_p, like_opt_state=opt.init(like_p), strict=True)
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import load_into

    load_into(state["params"], shard_arrays(params, step.shardings["params"], mesh))
    state["opt_state"] = load_into(state["opt_state"],
                                   shard_arrays(opt_state, step.shardings["opt_state"], mesh))
    state["step"] = step_no
    return state


def moe_task():
    margs = tl.LlamaArgs(**SPEC["moe"]["model"])
    loss = ts.make_loss_fn(margs, torch.float32, ce_chunk=0, with_moe_stats=True)
    for case in SPEC["moe"]["cases"]:
        mesh, opt, step = step_fn(case["mesh"], case["zero"], False, "moe_init.npz", loss,
                                  margs.num_local_experts, SPEC["moe"]["training"])
        state = fresh_state(mesh, opt, step, "moe_init.npz")
        metrics, loads = [], []
        for b in batches()[:3]:
            local = {k: v.contiguous() for k, v in ts.local_rows(b, mesh).items()}
            state, m = step(state, local)
            metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["toks"])))
            loads.append(m["moe_load"].numpy().copy())
        full = ts.gather_state(state, step.shardings, mesh)
        save(f"moe_{case['name']}.npz", metrics=np.array(metrics, np.float64),
             loads=np.array(loads), **{"p." + k: v for k, v in flat_numpy(full["params"]).items()})


def tp_loss(model, case):
    margs = tl.LlamaArgs(**SPEC["tp_models"][model])
    return margs, ts.make_loss_fn(margs, torch.float32, ce_chunk=case.get("ce", 0),
                                  z_loss_weight=case.get("z", 0.0), remat=case.get("remat"),
                                  with_moe_stats=margs.is_moe)


def tp_step(case, model):
    margs, loss = tp_loss(model, case)
    init = f"tp_{model}.npz"
    mesh, opt, step = step_fn(case["mesh"], case["zero"], False, init, loss,
                              margs.num_local_experts, case.get("training"))
    return mesh, opt, step, init


def tp_ckpt_task():
    case = SPEC["tp_ckpt"]
    mesh, opt, step, init = tp_step(case, case["model"])
    state, first = run_steps(mesh, step, fresh_state(mesh, opt, step, init), range(3))
    save_checkpoint(os.path.join(OUT, "tp_ckpt_port"), 3, state, step, mesh)
    state, rest = run_steps(mesh, step, state, range(3, 5))
    write_result("tp_ckpt_uninterrupted.npz", state, step, mesh, first + rest)
    ready = os.path.join(OUT, "tp_ckpt_jax", ".ready")  # the test writes JAX's files
    deadline = time.monotonic() + 300
    while not os.path.exists(ready) and time.monotonic() < deadline:
        time.sleep(0.2)
    state = load_checkpoint(os.path.join(OUT, "tp_ckpt_jax"), 3,
                            fresh_state(mesh, opt, step, init), step, mesh, opt, init)
    state, rest = run_steps(mesh, step, state, range(3, 5))
    write_result("tp_from_jax.npz", state, step, mesh, rest)


def tp_resume_task():
    case = dict(SPEC["tp_ckpt"], mesh=SPEC["tp_resume_mesh"], zero=1)
    mesh, opt, step, init = tp_step(case, case["model"])
    state = load_checkpoint(os.path.join(OUT, "tp_ckpt_port"), 3,
                            fresh_state(mesh, opt, step, init), step, mesh, opt, init)
    state, rest = run_steps(mesh, step, state, range(3, 5))
    name = "_".join(f"{k}{v}" for k, v in SPEC["tp_resume_mesh"].items()) or "one"
    write_result(f"tp_resume_{name}.npz", state, step, mesh, rest)


def tp_grad_task():
    """The gradients of the tp-replicated leaves (norms, router) on every
    rank after one backward, for each model and mesh of ``tp_grad``."""
    from mlx_cuda_distributed_pretraining_tpu_torch.parallel.collectives import spec_axes
    from mlx_cuda_distributed_pretraining_tpu_torch.parallel.context import use_mesh
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import leaves_with_path

    for case in SPEC["tp_grad"]:
        mesh, opt, step, init = tp_step(dict(case, zero=0), case["model"])
        state = fresh_state(mesh, opt, step, init)
        b = {k: v.contiguous() for k, v in ts.local_rows(batches()[0], mesh).items()}
        count = b["mask"].sum().clamp_min(1.0) * mesh.size  # any common count
        _, loss = tp_loss(case["model"], case)
        with use_mesh(mesh):
            l, _ = loss(state["params"], dict(b, global_count=count))
            l.backward()
        specs = dict(zip([k for k, _ in leaves_with_path(state["params"])],
                         [s for _, s in ts.spec_items(step.shardings["params"])]))
        out = {}
        for k, p in leaves_with_path(state["params"]):
            if spec_axes(specs[k]):
                continue
            got = [torch.empty_like(p.grad) for _ in range(mesh.size)]
            dist.all_gather(got, p.grad.contiguous())
            out[".".join(k)] = torch.stack(got).numpy()
        save(f"tp_grad_{case['name']}.npz", **out)


for TASK in TASKS:
    if TASK == "tp":
        for case in SPEC["tp"]:
            mesh, opt, step, init = tp_step(case, case["model"])
            state, metrics = run_steps(mesh, step, fresh_state(mesh, opt, step, init), range(5))
            write_result(f"tp_{case['name']}.npz", state, step, mesh, metrics)
    elif TASK == "tpckpt":
        tp_ckpt_task()
    elif TASK == "tpresume":
        tp_resume_task()
    elif TASK == "tpgrad":
        tp_grad_task()
    elif TASK == "moe":
        moe_task()
    elif TASK == "train":
        for case in SPEC["train"]:
            mesh, opt, step = step_fn(case["mesh"], case["zero"], case["overlap"],
                                      accum=case.get("accum", 1))
            state, metrics = run_steps(mesh, step, fresh_state(mesh, opt, step), range(5))
            write_result(f"train_{case['name']}.npz", state, step, mesh, metrics)
    elif TASK == "ckpt":  # {fsdp: 4}, ZeRO-1, a save at step 3
        mesh, opt, step = step_fn({"fsdp": 4}, 1, False)
        state, first = run_steps(mesh, step, fresh_state(mesh, opt, step), range(3))
        save_checkpoint(os.path.join(OUT, "ckpt_port"), 3, state, step, mesh)
        state, rest = run_steps(mesh, step, state, range(3, 5))
        write_result("ckpt_uninterrupted.npz", state, step, mesh, first + rest)
        state = load_checkpoint(os.path.join(OUT, "ckpt_jax"), 3,
                                fresh_state(mesh, opt, step), step, mesh, opt)
        state, rest = run_steps(mesh, step, state, range(3, 5))
        write_result("from_jax.npz", state, step, mesh, rest)
    elif TASK == "resume":
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh, opt, step = step_fn({"fsdp": -1}, 1, False)
        state = load_checkpoint(os.path.join(OUT, "ckpt_port"), 3,
                                fresh_state(mesh, opt, step), step, mesh, opt)
        state, rest = run_steps(mesh, step, state, range(3, 5))
        write_result(f"resume_{world}.npz", state, step, mesh, rest)
    elif TASK == "opt":
        init = params_from_flat(load_flat("opt_init.npz"), "cpu")
        grads_flat = load_flat("opt_grads.npz")
        for case in SPEC["opt"]:
            mesh = mesh_of(case["mesh"])
            opt = build_optimizer(training_cfg(case["training"]), 20)
            like = tree_map(lambda p: torch.empty(p.shape, device="meta"), init)
            shardings = ts.mesh_shardings(opt, like, mesh, case["zero"])
            state = ts.shard_state(ts.init_train_state(tree_map(torch.clone, init), opt),
                                   shardings, mesh)
            apply = make_sharded_apply(opt, mesh, shardings, like, case["zero"])
            for i in range(5):
                g = params_from_flat({k[len(f"{i}."):]: v for k, v in grads_flat.items()
                                      if k.startswith(f"{i}.")}, "cpu")
                g = shard_arrays(g, shardings["params"], mesh)
                with torch.no_grad():
                    params, opt_state = apply(g, state["opt_state"], state["params"])
                state.update(params=params, opt_state=opt_state)
            full = ts.gather_state(state, shardings, mesh)
            save(f"opt_{case['name']}.npz",
                 **{"p." + k: v for k, v in flat_numpy(full["params"]).items()},
                 **{"o." + k: v for k, v in flat_numpy(full["opt_state"]).items()})
    elif TASK == "trainers":
        from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

        for run in SPEC["trainers"]:
            tr = Trainer(Config.from_dict(run), runs_root=os.path.join(OUT, "runs"),
                         quiet=True, device="cpu")
            tr.train()
        if RANK == 0:
            open(os.path.join(OUT, "trainers.done"), "w").close()
    else:
        raise SystemExit(f"unknown task {TASK!r}")
