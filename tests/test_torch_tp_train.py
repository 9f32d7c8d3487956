"""The port's tensor-parallel training over torch.distributed against the
JAX package's GSPMD training on the same mesh, on the CPU.

The port side runs 4 gloo ranks started through the port's launcher
(``tests/torch_dist_worker.py``, tasks ``tp``, ``tpckpt``, ``tpgrad``,
``tpresume``); the JAX side runs in the test process on the first 4 of the
8 virtual CPU devices with the same mesh. Weights are JAX's, inputs numpy
from a seed, tokens under a vocabulary of 256 so the tables split over tp.

- Meshes {tp: 4}, {dp: 2, tp: 2} and {fsdp: 2, tp: 2}, each with ZeRO 0 and
  1, over the models: dense with whole K/V heads a rank (4/4 heads), GQA
  whose 6 K/V heads split mid-head at tp 4 (12/6 heads of 4), tied and
  untied embeddings, fused CE on and off with a z-loss, remat ``dots``,
  and an MoE whose experts split over tp; AdamW, or momentum SGD where
  AdamW's normalization magnifies the reordered sums past the leaf limit
  (the MoE, as in ``tests/test_torch_dist_train.py``, and three more
  cases, where JAX against itself on one device breaks the same limit:
  ``tests/tp_adamw_drift.py``). 5 steps: losses and
  ``grad_norm`` within 1e-5 relative, every param and optimizer leaf
  within 1e-5 of its largest entry.
- A {tp: 4} ZeRO-1 checkpoint at step 3 resumes at one rank and at
  {fsdp: 2, tp: 2}, and JAX's step-3 files resume on {tp: 4}: steps 4-5
  against the uninterrupted run and JAX's.
- The gradient of every tp-replicated leaf (norms, the router) is the same
  on every rank of a tp group.
- The trainer through ``parallel.launch`` on 4 ranks with ``mesh: {dp: -1,
  tp: 2}``: the ranks of a tp group read the same rows, so its losses are
  the JAX trainer's at 2 processes.
"""

import fcntl
import json
import os
import pickle

import jax
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.checkpoint.manager import CheckpointManager as JManager
from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.train import train_step as jts
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from test_torch_dist_train import (
    MOE_TRAINING,
    TRAINING,
    assert_leaves_close,
    e2e_jax,
    e2e_setup,
    jax_mesh,
    jax_params,
    launch,
    launch_worker,
    wait_ok,
    write_inputs,
)

VOCAB = 256
BASE = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_layers=2,
            max_position_embeddings=64)
MODELS = {
    "dense": dict(BASE, num_heads=4, num_kv_heads=4, head_dim=8, tie_word_embeddings=True),
    "gqa": dict(BASE, hidden_size=48, num_heads=12, num_kv_heads=6, head_dim=4,
                tie_word_embeddings=False),
    "moe": dict(BASE, num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=False,
                num_local_experts=4, num_experts_per_tok=2, router_z_weight=1e-3),
}
Z = 1e-3
TP4, DP2TP2, FSDP2TP2 = {"tp": 4}, {"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2}
CASES = [
    dict(name="tp4_z0_dense", mesh=TP4, zero=0, model="dense", ce=0),
    dict(name="tp4_z1_gqa_fused_z", mesh=TP4, zero=1, model="gqa", ce=16, z=Z),
    dict(name="dp2tp2_z0_gqa_fused_dots", mesh=DP2TP2, zero=0, model="gqa", ce=16, z=Z,
         remat="dots"),
    # momentum SGD: under AdamW these three leave one to nine elements of a
    # leaf up to 8.8x past the leaf limit, and JAX on one device against
    # JAX on the same mesh breaks it at the same leaves (up to 4.6x):
    # Adam's normalized update magnifies the reordered sums
    # (tests/tp_adamw_drift.py). ZeRO-1 cuts the momentum as it cuts
    # Adam's moments, so these cases still hold its cut on tp blocks.
    dict(name="dp2tp2_z1_dense_fused_z_dots", mesh=DP2TP2, zero=1, model="dense", ce=16,
         z=Z, remat="dots", training=MOE_TRAINING),
    dict(name="fsdp2tp2_z0_dense_z", mesh=FSDP2TP2, zero=0, model="dense", ce=0, z=Z,
         training=MOE_TRAINING),
    dict(name="fsdp2tp2_z1_gqa_fused_dots", mesh=FSDP2TP2, zero=1, model="gqa", ce=16,
         remat="dots", training=MOE_TRAINING),
    dict(name="tp4_moe", mesh=TP4, zero=0, model="moe", ce=0, training=MOE_TRAINING),
    dict(name="fsdp2tp2_z1_moe", mesh=FSDP2TP2, zero=1, model="moe", ce=0,
         training=MOE_TRAINING),
]
CKPT = dict(mesh=TP4, zero=1, model="gqa", ce=16, z=Z)
GRAD_CASES = [dict(name="tp4_moe", mesh=TP4, model="moe"),
              dict(name="dp2tp2_gqa", mesh=DP2TP2, model="gqa", ce=16, z=Z, remat="dots")]


def batches(n=5, b=8, s=16):
    """Global batches whose padding differs between the data ranks' rows."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(200 + i)
        rows = rng.integers(0, VOCAB, size=(b, s + 1)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        mask[0, s // 2:] = 0.0
        mask[5, 3:] = 0.0
        out.append({"inputs": rows[:, :-1], "targets": rows[:, 1:], "mask": mask})
    return out


def jax_step(case):
    args = jl.LlamaArgs(**MODELS[case["model"]])
    training = case.get("training", TRAINING)
    opt = jfactory.build_optimizer(JConfig.from_dict({"name": "j", "training": training})
                                   .training, 5)
    params = jax_params(1, MODELS[case["model"]])
    step, shardings = jts.make_train_step(
        lambda p, b: jl.loss_fn(p, b, args, ce_chunk=case.get("ce", 0),
                                z_loss_weight=case.get("z", 0.0), remat=case.get("remat"),
                                with_moe_stats=args.is_moe),
        opt, mesh=jax_mesh(case["mesh"]), zero_level=case["zero"], log_grad_norm=True,
        params_like=params, moe_stats_experts=args.num_local_experts if args.is_moe else 0)
    return step, jax.device_put(jts.init_train_state(params, opt), shardings)


def jax_run(case, steps=range(5), state=None, save_at=None):
    step, fresh = jax_step(case)
    state = fresh if state is None else state
    data = batches()
    metrics = []
    for i in steps:
        state, m = step(state, data[i])
        metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["toks"])))
        if save_at is not None and i + 1 == save_at[0]:
            JManager(save_at[1]).save(i + 1, state["params"], state["opt_state"],
                                      {"step": i + 1})
    return state, np.array(metrics)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def e2e_tp(out):
    """The launcher's trainer at {dp: -1, tp: 2} on 4 ranks (2 data ranks)."""
    e2e = e2e_setup(out)
    with open(e2e["cfg"]) as f:
        cfg = json.load(f)
    cfg["system"].update(mesh={"dp": -1, "tp": 2}, overlap_gather=False)
    with open(e2e["cfg"], "w") as f:
        json.dump(cfg, f)
    return e2e


def shared_once(tmp_path_factory, name, compute):
    """``compute(out_dir)`` once for the whole test session: every xdist
    worker that runs a test of the module takes the same lock in the
    session's shared temp root, the first computes (its ranks and JAX's
    steps) and pickles the result, the others read it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = root / name
    out.mkdir(exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out / "result.pkl"
        if done.exists():
            return pickle.loads(done.read_bytes())
        result = compute(str(out))
        done.write_bytes(pickle.dumps(result))
        return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "tp_train", _runs)


def _runs(out):
    write_inputs(out, {"tp_models": MODELS, "tp": CASES, "tp_ckpt": CKPT,
                       "tp_grad": GRAD_CASES, "tp_resume_mesh": FSDP2TP2})
    np.savez(os.path.join(out, "batches.npz"),
             **{f"{k}_{i}": v for i, b in enumerate(batches()) for k, v in b.items()})
    for name, model in MODELS.items():
        np.savez(os.path.join(out, f"tp_{name}.npz"), **jflatten(jax_params(1, model)))
    e2e = e2e_tp(out)
    procs = {"train": launch_worker(4, "tp,tpckpt,tpgrad,tpresume", out),
             "e2e": launch(4, ["--config", e2e["cfg"], "--runs-root", e2e["runs"]],
                           os.path.join(out, "e2e.log"))}
    # JAX: its step-3 files first (the port's tpckpt task reads them)
    ckpt_jax = os.path.join(out, "tp_ckpt_jax")
    ref = {"ckpt": numpy_tree(jax_run(CKPT, save_at=(3, ckpt_jax)))}
    with open(os.path.join(ckpt_jax, ".ready"), "w"):
        pass
    ref["train"] = {c["name"]: numpy_tree(jax_run(c)) for c in CASES}
    ref["e2e"] = e2e_jax(e2e["dict"])
    wait_ok(procs["train"], os.path.join(out, "tp,tpckpt,tpgrad,tpresume_4.log"))
    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    spec["tp_resume_mesh"] = {}
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    one = launch_worker(1, "tpresume", out)
    wait_ok(procs["e2e"], os.path.join(out, "e2e.log"))
    wait_ok(one, os.path.join(out, "tpresume_1.log"))
    return out, ref, e2e


def _check(got, jstate, jmetrics, opt=True):
    tm = got["metrics"]
    np.testing.assert_allclose(tm[:, 0], jmetrics[:, 0], rtol=1e-5)  # loss
    np.testing.assert_allclose(tm[:, 1], jmetrics[:, 1], rtol=1e-5)  # grad_norm
    np.testing.assert_array_equal(tm[:, 2], jmetrics[:, 2])  # global real tokens
    assert_leaves_close(jstate["params"], got, "p.")
    if opt:
        assert_leaves_close(jstate["opt_state"], got, "o.")


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_tp_train_step_matches_jax_on_four_ranks(runs, case):
    out, ref, _ = runs
    jstate, jmetrics = ref["train"][case]
    _check(np.load(os.path.join(out, f"tp_{case}.npz")), jstate, jmetrics)


@pytest.mark.parametrize("where", ["uninterrupted", "resume_one", "resume_fsdp2_tp2",
                                   "from_jax"])
def test_tp_checkpoint_resumes_across_meshes(runs, where):
    out, ref, _ = runs
    jstate, jmetrics = ref["ckpt"]
    got = np.load(os.path.join(out, f"tp_{'ckpt_' if where == 'uninterrupted' else ''}"
                                    f"{where}.npz"))
    if where == "uninterrupted":
        _check(got, jstate, jmetrics)
        return
    _check(got, jstate, jmetrics[3:])
    base = np.load(os.path.join(out, "tp_ckpt_uninterrupted.npz"))
    np.testing.assert_allclose(got["metrics"][:, 0], base["metrics"][3:, 0], rtol=1e-5)


@pytest.mark.parametrize("case", [c["name"] for c in GRAD_CASES])
def test_tp_replicated_leaf_gradient_is_equal_on_every_tp_rank(runs, case):
    out, _, _ = runs
    mesh = next(c["mesh"] for c in GRAD_CASES if c["name"] == case)
    tp = mesh["tp"]
    got = np.load(os.path.join(out, f"tp_grad_{case}.npz"))
    keys = set(got.files)
    assert any(k.endswith("norm.weight") for k in keys)
    if case.endswith("moe"):
        assert any("router" in k for k in keys)
    for k in keys:
        g = got[k]  # [ranks, ...]
        assert np.abs(g).max() > 0, k
        for group in range(g.shape[0] // tp):
            for r in range(1, tp):
                np.testing.assert_array_equal(g[group * tp + r], g[group * tp], err_msg=k)


def test_launcher_trains_tp2_as_jax_at_two_processes(runs):
    out, ref, e2e = runs
    run_dir = os.path.join(e2e["runs"], "e2e")
    losses = {}
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("type") == "step_window":
                losses[int(ev["step"])] = float(ev["loss"])
    assert sorted(losses) == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([losses[s] for s in range(1, 6)], ref["e2e"], rtol=1e-5)
    with open(os.path.join(run_dir, "log.txt")) as f:
        assert "mesh {'dp': 2, 'tp': 2} over 4 rank(s)" in f.read()
    # one data position a data rank: the tp ranks of a group share theirs
    ckpts = set(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert {"step_final_data_p0.json", "step_final_data_p1.json"} <= ckpts
    assert "step_final_data_p2.json" not in ckpts
