"""One rank of the port's tensor-parallel serving tests, started through the
port's launcher (``parallel.launch --nproc-per-node 2 --device cpu --script
tests/torch_tp_serve_worker.py -- DIR``). It imports the port only; the test
writes the models, weights and cases into ``DIR`` (``spec.json``,
``<model>.npz``, ``model.safetensors``) and rank 0 writes the results
there as JSON.

Every engine of a case is built on both ranks in the same order; rank 0
leads it (``BatchEngine``'s loop), rank 1 follows its steps until rank 0
stops it.
"""

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import CheckpointManager
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_flat
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.parallel.mesh import build_serve_mesh
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.serve.kv_transfer import KVTransferPayload
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict

OUT = sys.argv[1]
SPEC = json.load(open(os.path.join(OUT, "spec.json")))
RANK = dist.get_rank()
TOK = TokenizerManager()
RESULTS = {}


def params_of(name):
    with np.load(os.path.join(OUT, f"{name}.npz")) as z:
        return params_from_flat({k: torch.from_numpy(z[k].copy()) for k in z.files}, "cpu")


def args_of(name):
    return tl.LlamaArgs(**SPEC["models"][name])


def session(model, lead, held=None, **cfg):
    """A tp=2 engine on every rank: rank 0 runs ``lead(engine)`` and stops
    it; rank 1 follows until then. ``held(engine)`` runs on every rank
    before the engine starts. Returns ``lead``'s result on rank 0."""
    eng = BatchEngine(params_of(model), args_of(model), TOK,
                      EngineConfig(**{**SPEC["engine"], **cfg, "mesh": {"tp": 2}}))
    if held is not None:
        held(eng)
    eng.start()
    if RANK:
        eng.follow()
        return None
    try:
        return lead(eng)
    finally:
        eng.stop()


def schedule(eng, prompts=None):
    """The first prompt alone (its blocks enter the prefix cache), then the
    rest concurrently: tokens, cached prompt tokens, first logprobs."""
    prompts = prompts or SPEC["prompts"]
    first = eng.submit(prompts[0], max_tokens=SPEC["max_tokens"])
    assert first.wait(120) and first.error is None, first.error
    rest = [eng.submit(p, max_tokens=SPEC["max_tokens"]) for p in prompts[1:]]
    for r in rest:
        assert r.wait(120) and r.error is None, r.error
    reqs = [first] + rest
    return {"tokens": [list(r.tokens) for r in reqs],
            "cached": [r.cached_tokens for r in reqs],
            "lp0": [r.logprobs[0] for r in reqs]}


def arms():
    for model, arm_name, arm in SPEC["arms"]:
        def lead(eng):
            out = schedule(eng)
            m = eng.metrics()
            out.update(mesh=m["mesh"], hits=m.get("prefix_cache_hits"),
                       devices=eng._mg_mesh_devices.value(),
                       axis_tp=eng._mg_mesh_axis.value(axis="tp"),
                       spec=[m.get("spec_proposed"), m.get("spec_accepted")])
            return out

        RESULTS[f"{model}_{arm_name}"] = session(model, lead, **arm)


def mesh_shapes():
    mesh = build_serve_mesh("tp=2")
    RESULTS["mesh"] = {"shape": mesh.shape, "size": mesh.size,
                       "one": build_serve_mesh("tp=1,dp=1") is None}


def reshard():
    """The fsdp2 run's file loaded on the tp=2 mesh, fp and int4: each rank
    keeps its blocks (quantizing only its slice), and they are the blocks a
    tp=2 engine serves from the full weights."""
    path = os.path.join(OUT, "model.safetensors")
    for wd in ("fp", "int4"):
        probe = build_serve_mesh("tp=2")
        flat = flatten_dict(CheckpointManager.load_params(path, mesh=probe,
                                                          weight_dtype=wd))
        nbytes = {k: v.numel() * v.element_size() for k, v in flat.items()}
        every = [None, None]
        dist.all_gather_object(every, {k: (v.numpy().tobytes().hex() if k.endswith(
            ("weight_q4", "weight_s")) else None, tuple(v.shape)) for k, v in flat.items()})
        sizes = [None, None]
        dist.all_gather_object(sizes, nbytes)
        held = [None, None]

        def same_blocks(eng):
            mine = flatten_dict(eng.params)
            dist.all_gather_object(held, sorted(mine) == sorted(flat) and all(
                torch.equal(mine[k].cpu(), v) for k, v in flat.items()))

        out = session("moe", lambda eng: schedule(eng, SPEC["prompts"][:2]),
                      held=same_blocks, weight_dtype=wd)
        if RANK == 0:
            RESULTS[f"reshard_{wd}"] = {"bytes": sizes, "blocks": every, "held": held,
                                        **out}


def swap():
    """A live decode engine on model A swaps to B's full tree mid-request."""
    new = params_of("moe_b")

    def lead(eng):
        prompt = SPEC["prompts"][0]
        base = eng.submit(prompt, max_tokens=SPEC["max_tokens"])
        assert base.wait(120)
        req = eng.submit(prompt + " again", max_tokens=SPEC["max_tokens"])
        deadline = time.monotonic() + 120.0
        while not req.tokens and time.monotonic() < deadline:
            time.sleep(0.005)
        version = eng.swap_params(new)
        assert req.wait(120) and req.error is None, req.error
        post = eng.submit(prompt, max_tokens=SPEC["max_tokens"])
        assert post.wait(120)
        return {"version": version, "base": list(base.tokens), "post": list(post.tokens),
                "straddled": len(req.tokens),
                "params_version": eng.metrics()["params_version"]}

    RESULTS["swap"] = session("moe", lead, role="decode")


def gkv1():
    """GKV1 both ways between a one-device engine (rank 0 alone) and the tp=2
    engine: a payload adopted and exported again is the same bytes."""
    prompt = SPEC["prompts"][0]
    one = None
    if RANK == 0:
        one = BatchEngine(params_of("moe"), args_of("moe"), TOK,
                          EngineConfig(**SPEC["engine"])).start()
        r = one.submit(prompt, max_tokens=4)
        assert r.wait(120)
        ids = r.prompt_ids
        p1 = one.export_kv(ids).to_bytes()
    out = {}

    def into_tp(eng):
        stats = eng.adopt_kv(KVTransferPayload.from_bytes(p1))
        out["adopt_tp"] = stats
        out["tp_again"] = eng.export_kv(ids).to_bytes() == p1
        out["n_blocks"] = KVTransferPayload.from_bytes(p1).num_blocks
        # the tp engine's own KV of another prompt, for the reverse way
        q = SPEC["prompts"][1]
        r = eng.submit(q, max_tokens=4)
        assert r.wait(120)
        out["q_ids"] = r.prompt_ids
        return eng.export_kv(r.prompt_ids).to_bytes()

    p3 = session("moe", into_tp)
    if RANK == 0:
        one.stop()
        fresh = BatchEngine(params_of("moe"), args_of("moe"), TOK,
                            EngineConfig(**SPEC["engine"])).start()
        try:
            out["adopt_one"] = fresh.adopt_kv(KVTransferPayload.from_bytes(p3))
            out["one_again"] = fresh.export_kv(out["q_ids"]).to_bytes() == p3
            out["p3_blocks"] = KVTransferPayload.from_bytes(p3).num_blocks
        finally:
            fresh.stop()
        RESULTS["gkv1"] = out


for task in (arms, mesh_shapes, reshard, swap, gkv1):
    task()
    dist.barrier()
if RANK == 0:
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(RESULTS, f)
