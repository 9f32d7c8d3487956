"""The port's data and fully-sharded training over torch.distributed against
the JAX package's mesh training, on the CPU.

The port side runs as gloo ranks in subprocesses started through the
port's own launcher (``parallel.launch --nproc-per-node N --device cpu``,
``tests/torch_dist_worker.py``), each child with one thread; the JAX side
runs in the test process on the first 4 (or 2) of the 8 virtual CPU
devices. Weights are JAX's, inputs numpy from a seed.

- The train step: 4 ranks against ``make_train_step`` on a 4-device mesh,
  at {dp: 4}, {fsdp: 4} and {dp: 2, fsdp: 2}, each with ZeRO 0 and 1 (and
  {dp: 2, fsdp: 2} with 2 accumulated micro-batches): 5
  steps with the gradient clip acting, on a batch whose padding differs
  between the ranks (a row half padded, one nearly all, one all). Losses
  and ``grad_norm`` within 1e-5 relative, every param and optimizer leaf
  after step 5 within 1e-5 of its largest entry; ``overlap_gather`` on and
  off bitwise equal at {fsdp: 4}.
- Every optimizer of the factory at {dp: 2} with ZeRO-1 and at {fsdp: 2}
  (2 ranks), 5 updates on sharded state against the JAX factory's update
  on the full tensors (what JAX computes on any mesh), at the tolerances
  ``tests/test_torch_optimizers.py`` states for one device.
- The MoE model (``ep`` absent: 4 experts top-2, its router and z losses
  and routing stats) at {dp: 2} and {fsdp: 2}, 2 ranks against JAX's
  2-device train step for 3 momentum-SGD steps: the router losses are
  means over the GLOBAL batch, so the port sums the expert counts over
  the ranks.
- The trainer end to end: ``parallel.launch`` with 2 ranks on a config
  with ``mesh: {fsdp: -1}`` (ZeRO-1, overlap_gather) trains 5 steps; its
  losses equal the JAX trainer's at 2 processes: each JAX process's
  in-memory loader at ``(index i, count 2)``, their batches in process
  order, through JAX's train step on a 2-device mesh.

One launch a world serves every case of the module, once a session
(``shared_once``: the xdist workers that run the module's tests read one
result); the launches run while the JAX side computes.
"""

import fcntl
import functools
import json
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.data.memory import DataManager as JData
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.optim import base as jbase
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.parallel.mesh import build_mesh as jbuild_mesh
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu.train import train_step as jts
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import CheckpointManager
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from test_torch_optimizers import CASES, Cfg, ill_conditioned, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")

MODEL = dict(vocab_size=259, hidden_size=32, intermediate_size=64, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=64,
             tie_word_embeddings=False)
TRAINING = {"hyperparameters": {"batch_size": 8, "learning_rate": 1e-3, "iters": 5,
                                "weight_decay": 0.05, "gradient_clip": 0.25},
            "scheduler": {"type": "cosine", "min_lr_ratio": 0.1},
            "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}}
TRAIN_CASES = [dict(name=f"{'_'.join(f'{k}{v}' for k, v in m.items())}_z{z}", mesh=m, zero=z,
                    overlap=False)
               for m in ({"dp": 4}, {"fsdp": 4}, {"dp": 2, "fsdp": 2}) for z in (0, 1)]
TRAIN_CASES.append(dict(name="fsdp4_z0_overlap", mesh={"fsdp": 4}, zero=0, overlap=True))
# gradient accumulation: each micro-batch is a slice of the GLOBAL batch
TRAIN_CASES.append(dict(name="dp2_fsdp2_z1_accum2", mesh={"dp": 2, "fsdp": 2}, zero=1,
                        overlap=False, accum=2))
OPT_NAMES = {"adamw": "adamw_fused", "adamw_enhanced": "adamw_enhanced", "lion": "lion",
             "muon": "muon", "shampoo": "shampoo", "hybrid": "hybrid_matrix"}
ADAFACTOR = ({"optimizer": "adafactor", "momentum": 0.9}, 1e-5)
OPT_MESHES = {"dp2_z1": ({"dp": 2}, 1), "fsdp2": ({"fsdp": 2}, 0)}
MOE_MODEL = dict(MODEL, num_local_experts=4, num_experts_per_tok=2, router_z_weight=1e-3)
# momentum SGD: the cases hold the router losses and stats over the ranks;
# an update without Adam's normalization keeps the leaves' differences at
# the gradients' (tests/test_torch_moe_train.py holds the MoE gradients)
MOE_TRAINING = dict(TRAINING, hyperparameters=dict(TRAINING["hyperparameters"],
                                                   learning_rate=1e-2),
                    optimization={"optimizer": "sgd", "momentum": 0.9})
MOE_CASES = [{"name": "dp2_z1", "mesh": {"dp": 2}, "zero": 1},
             {"name": "fsdp2", "mesh": {"fsdp": 2}, "zero": 0}]


# -- shared with tests/test_torch_dist_ckpt.py ------------------------------------------
def child_env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def launch(n, args, log_path, cwd=REPO):
    """``parallel.launch --nproc-per-node n --device cpu ARGS`` in the
    background, its output into ``log_path``."""
    log = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch",
         "--nproc-per-node", str(n), "--device", "cpu", "--timeout-s", "300", *args],
        env=child_env(), cwd=cwd, stdout=log, stderr=subprocess.STDOUT)


def launch_worker(n, task, out):
    return launch(n, ["--script", WORKER, "--", task, str(out)],
                  os.path.join(out, f"{task}_{n}.log"))


def wait_ok(proc, log_path):
    rc = proc.wait(timeout=360)
    with open(log_path) as f:
        log = f.read()
    assert rc == 0, f"launch failed ({rc}):\n{log[-6000:]}"
    return log


def jax_mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jbuild_mesh(SimpleNamespace(mesh=dict(sizes)), jax.devices()[:n])


def jax_params(seed=0, model=MODEL):
    """numpy weights at the JAX shapes, from a seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if x.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        s = 0.05 if "tok_embeddings" in jax.tree_util.keystr(path) else x.shape[-2] ** -0.5
        return (s * rng.standard_normal(x.shape)).astype(np.float32)

    shapes = jl.init_params(jax.random.PRNGKey(0), jl.LlamaArgs(**model))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def global_batches(n=5, b=8, s=16):
    """Global batches whose padding differs between the ranks' rows."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        rows = rng.integers(0, MODEL["vocab_size"], size=(b, s + 1)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        mask[0, s // 2:] = 0.0
        mask[3, 2:] = 0.0
        mask[6, :] = 0.0
        out.append({"inputs": rows[:, :-1], "targets": rows[:, 1:], "mask": mask})
    return out


def write_inputs(out, extra=None):
    params = jax_params()
    np.savez(os.path.join(out, "init.npz"), **jflatten(params))
    np.savez(os.path.join(out, "batches.npz"),
             **{f"{k}_{i}": v for i, b in enumerate(global_batches()) for k, v in b.items()})
    spec = {"model": MODEL, "training": TRAINING, "total_steps": 5, **(extra or {})}
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    return params


def jax_step(sizes, zero, accum=1):
    args = jl.LlamaArgs(**MODEL)
    opt = jfactory.build_optimizer(JConfig.from_dict({"name": "j", "training": TRAINING})
                                   .training, 5)
    params = jax_params()
    mesh = jax_mesh(sizes)
    step, shardings = jts.make_train_step(
        lambda p, b: jl.loss_fn(p, b, args, ce_chunk=0), opt, accum_steps=accum, mesh=mesh,
        zero_level=zero, log_grad_norm=True, params_like=params)
    return step, jax.device_put(jts.init_train_state(params, opt), shardings)


def jax_run(sizes, zero, steps=range(5), state=None, accum=1):
    step, fresh = jax_step(sizes, zero, accum)
    state = fresh if state is None else state
    batches = global_batches()
    metrics = []
    for i in steps:
        state, m = step(state, batches[i])
        metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["toks"])))
    return state, np.array(metrics)


def jax_moe_run(sizes, zero, steps=3):
    args = jl.LlamaArgs(**MOE_MODEL)
    opt = jfactory.build_optimizer(JConfig.from_dict({"name": "j", "training": MOE_TRAINING})
                                   .training, 5)
    params = jax_params(1, MOE_MODEL)
    step, shardings = jts.make_train_step(
        lambda p, b: jl.loss_fn(p, b, args, ce_chunk=0, with_moe_stats=True), opt,
        mesh=jax_mesh(sizes), zero_level=zero, log_grad_norm=True, params_like=params,
        moe_stats_experts=args.num_local_experts)
    state = jax.device_put(jts.init_train_state(params, opt), shardings)
    metrics, loads = [], []
    for b in global_batches()[:steps]:
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["toks"])))
        loads.append(np.asarray(m["moe_load"]))
    return state, np.array(metrics), np.array(loads)


def assert_leaves_close(jtree, got, prefix, tol=1e-5):
    """Every tensor leaf within ``tol`` of the JAX leaf's largest entry."""
    jflat = jflatten(jax.tree_util.tree_map(np.asarray, jtree))
    keys = {k[len(prefix):] for k in got.files if k.startswith(prefix)}
    want = {k for k, v in jflat.items() if isinstance(v, np.ndarray) and v.dtype.kind == "f"}
    assert want <= keys, sorted(want - keys)[:5]
    for k in want:
        j = np.asarray(jflat[k], np.float32)
        np.testing.assert_allclose(got[prefix + k], j, rtol=0,
                                   atol=tol * max(float(np.abs(j).max()), 1e-30), err_msg=k)


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


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the module's launches --------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "dist_train", _runs)


def _runs(out):
    opt_cases = []
    for label, (mesh, zero) in OPT_MESHES.items():
        for name, case in {**{n: CASES[c] for n, c in OPT_NAMES.items()},
                           "adafactor": ADAFACTOR}.items():
            opt_cases.append({"name": f"{name}_{label}", "mesh": mesh, "zero": zero,
                              "training": {"hyperparameters": {
                                  "learning_rate": 1e-2, "weight_decay": 0.01,
                                  "gradient_clip": 1.0},
                                  "scheduler": {"type": "cosine_with_warmup",
                                                "warmup_steps": 2, "min_lr_ratio": 0.1},
                                  "optimization": case[0]}})
    write_inputs(out, {"train": TRAIN_CASES, "opt": opt_cases,
                       "moe": {"model": MOE_MODEL, "cases": MOE_CASES,
                               "training": MOE_TRAINING}})
    np.savez(os.path.join(out, "moe_init.npz"), **jflatten(jax_params(1, MOE_MODEL)))
    np.savez(os.path.join(out, "opt_init.npz"), **jflatten(tree(0)))
    np.savez(os.path.join(out, "opt_grads.npz"),
             **{f"{i}.{k}": v for i in range(5)
                for k, v in jflatten(tree(100 + i, scale=1.0)).items()})
    e2e = e2e_setup(out)
    procs = {"train": launch_worker(4, "train", out), "opt": launch_worker(2, "opt,moe", out),
             "e2e": launch(2, ["--config", e2e["cfg"], "--runs-root", e2e["runs"]],
                           os.path.join(out, "e2e.log"))}
    ref = {"train": {c["name"]: numpy_tree(jax_run(c["mesh"], c["zero"],
                                                   accum=c.get("accum", 1)))
                     for c in TRAIN_CASES if not c["overlap"]},
           "moe": {c["name"]: numpy_tree(jax_moe_run(c["mesh"], c["zero"]))
                   for c in MOE_CASES},
           "e2e": e2e_jax(e2e["dict"])}
    for name, proc in procs.items():
        wait_ok(proc, os.path.join(out, {"train": "train_4.log", "opt": "opt,moe_2.log",
                                         "e2e": "e2e.log"}[name]))
    return out, ref, e2e


# -- the train step -----------------------------------------------------------------------
@pytest.mark.parametrize("case", [c["name"] for c in TRAIN_CASES if not c["overlap"]])
def test_train_step_matches_jax_on_four_ranks(runs, case):
    out, ref, _ = runs
    jstate, jmetrics = ref["train"][case]
    got = np.load(os.path.join(out, f"train_{case}.npz"))
    tm = got["metrics"]
    np.testing.assert_allclose(tm[:, 0], jmetrics[:, 0], rtol=1e-5)  # loss
    np.testing.assert_allclose(tm[:, 1], jmetrics[:, 1], rtol=1e-5)  # grad_norm
    np.testing.assert_array_equal(tm[:, 2], jmetrics[:, 2])  # global real tokens
    assert (jmetrics[:, 1] > TRAINING["hyperparameters"]["gradient_clip"]).all()  # clipped
    assert_leaves_close(jstate["params"], got, "p.")
    assert_leaves_close(jstate["opt_state"], got, "o.")


def test_overlap_gather_is_bitwise_neutral_at_fsdp4(runs):
    out, _, _ = runs
    on = np.load(os.path.join(out, "train_fsdp4_z0_overlap.npz"))
    off = np.load(os.path.join(out, "train_fsdp4_z0.npz"))
    assert sorted(on.files) == sorted(off.files)
    for k in on.files:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


@pytest.mark.parametrize("case", [c["name"] for c in MOE_CASES])
def test_moe_train_step_matches_jax_on_two_ranks(runs, case):
    out, ref, _ = runs
    jstate, jmetrics, jloads = ref["moe"][case]
    got = np.load(os.path.join(out, f"moe_{case}.npz"))
    np.testing.assert_allclose(got["metrics"][:, 0], jmetrics[:, 0], rtol=1e-5)  # with aux
    np.testing.assert_allclose(got["metrics"][:, 1], jmetrics[:, 1], rtol=1e-5)
    np.testing.assert_array_equal(got["loads"], jloads)  # global expert selections
    assert_leaves_close(jstate["params"], got, "p.")


# -- optimizers on sharded state ----------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_optimizer(name):
    """JAX's 5 updates of optimizer ``name`` (one reference for both meshes)."""
    optimization, tol = CASES[OPT_NAMES[name]] if name in OPT_NAMES else ADAFACTOR
    cfg = Cfg(optimization)
    jopt = jfactory.build_optimizer(cfg, 20)
    jp = jax.tree_util.tree_map(jnp.asarray, tree(0))
    js = jopt.init(jp)
    flagged = set()
    for step in range(5):
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, tree(100 + step, scale=1.0)),
                            js, jp)
        jp = jbase.apply_updates(jp, u)
        if step + 1 in (2, 4):
            flagged |= ill_conditioned(js)
    return jp, js, tol, flagged


@pytest.mark.parametrize("mesh", list(OPT_MESHES))
@pytest.mark.parametrize("name", [*OPT_NAMES, "adafactor"])
def test_optimizer_on_sharded_state_matches_jax(runs, name, mesh):
    out, _, _ = runs
    jp, js, tol, flagged = _jax_optimizer(name)
    got = np.load(os.path.join(out, f"opt_{name}_{mesh}.npz"))
    for jtree, prefix in ((jp, "p."), (js, "o.")):
        for k, j in jflatten(jax.tree_util.tree_map(np.asarray, jtree)).items():
            if not (isinstance(j, np.ndarray) and j.dtype.kind == "f"):
                continue
            t = 5e-3 if any(f in k for f in flagged) else tol
            np.testing.assert_allclose(got[prefix + k], j.astype(np.float32), rtol=t,
                                       atol=t * max(float(np.abs(j).max()), 1e-30),
                                       err_msg=f"{name} {mesh} {k}")


# -- the trainer through the launcher -----------------------------------------------------
def e2e_setup(out):
    """A 2-rank run of the trainer from the JAX trainer's initial weights
    (written as a step-0 checkpoint the run resumes from, optimizer and
    training state reset)."""
    corpus = [f"doc {i} " + "the quick brown fox jumps over the lazy dog " * (2 + i % 3)
              for i in range(48)]
    data = os.path.join(out, "train.jsonl")
    with open(data, "w") as f:
        for t in corpus:
            f.write(json.dumps({"text": t}) + "\n")
    d = {"name": "e2e", "overwrite": False,
         "data": {"input_file": data, "preprocessing": {"max_context_size": 32},
                  "tokenizer": {"normal_vocab_size": 256}},
         "model": {"architecture": "llama",
                   "dimensions": {"hidden_size": 32, "intermediate_size": 64, "num_layers": 2},
                   "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
         "training": {"hyperparameters": {"batch_size": 2, "learning_rate": 1e-2, "iters": 5,
                                          "weight_decay": 0.05, "gradient_clip": 1.0},
                      "scheduler": {"type": "cosine", "min_lr_ratio": 0.1},
                      "optimization": {"optimizer": "adamw"}},
         "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 0,
                               "validation_interval": 0}},
         "system": {"seed": 3, "mesh": {"fsdp": -1}, "zero_optimization_level": 1,
                    "overlap_gather": True}}
    jcfg = JConfig.from_dict(d)
    args = jl.LlamaArgs.from_config(jcfg.model, JTok(jcfg.data).vocab_size)
    init = jax.tree_util.tree_map(np.asarray,
                                  jl.init_params(jax.random.PRNGKey(3), args))
    runs_root = os.path.join(out, "e2e_runs")
    CheckpointManager(os.path.join(runs_root, "e2e")).save(
        0, params_from_jax(init, "cpu"), None, {"step": 0})
    run = dict(d, resume={"checkpoint": "0", "reset_optimizer": True,
                          "reset_training_state": True})
    cfg_path = os.path.join(out, "e2e.json")
    with open(cfg_path, "w") as f:
        json.dump(run, f)
    return {"dict": d, "init": init, "cfg": cfg_path, "runs": runs_root}


def e2e_jax(d):
    """The JAX trainer at 2 processes, step by step: each process's loader
    at (index i, count 2), the global batch theirs in order, JAX's train
    step on a 2-device {fsdp: 2} mesh with ZeRO-1."""
    jcfg = JConfig.from_dict(d)
    tok = JTok(jcfg.data)
    loaders = [JData(jcfg.data, tok, 2, seq_len=32, seed=3, process_index=i,
                     process_count=2) for i in range(2)]
    args = jl.LlamaArgs.from_config(jcfg.model, tok.vocab_size)
    init = jl.init_params(jax.random.PRNGKey(3), args)
    opt = jfactory.build_optimizer(jcfg.training, 5)
    step, shardings = jts.make_train_step(
        lambda p, b: jl.loss_fn(p, b, args, ce_chunk=0), opt, mesh=jax_mesh({"fsdp": 2}),
        zero_level=1, params_like=init)
    state = jax.device_put(jts.init_train_state(init, opt), shardings)
    losses = []
    for s in range(1, 6):
        parts = [dm.generate_batch(s - 1) for dm in loaders]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_launcher_trains_two_ranks_as_jax_at_two_processes(runs):
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
        log = f.read()
    assert "mesh {'fsdp': 2} over 2 rank(s)" in log
    assert "Resumed from checkpoint 0 at step 0" in log
    # every rank beats its own heartbeat; the chief alone writes the log
    assert os.path.isfile(os.path.join(run_dir, "heartbeat_p1.json"))
    ckpts = os.listdir(os.path.join(run_dir, "checkpoints"))
    assert {"step_final_data_p0.json", "step_final_data_p1.json"} <= set(ckpts)
