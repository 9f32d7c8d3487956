"""Sharded checkpoints of the port's mesh training, resumed across world
sizes, meshes and packages, on the CPU (gloo ranks through the port's
launcher; JAX on the first 4 virtual CPU devices).

- A run at {fsdp: 4} with ZeRO-1 saves at step 3 (the chief writes the
  gathered state in the one-device layout, every rank its data sidecar,
  folded into the manifest). Resumed at 2 ranks and at 1 rank, steps 4-5
  equal the uninterrupted run's within 1e-5 relative.
- The files of a port save at 4 ranks resume in JAX at 4 virtual devices,
  and JAX's save at 4 devices resumes in the port at 4 ranks: steps 4-5
  equal the other package's uninterrupted run.
- The trainer's sidecars cross world sizes: a 2-rank run on a seekable
  streaming source checkpoints at step 3; resumed at 1 rank, the port and
  the JAX trainer remap the two positions alike and train steps 4-5 to the
  same losses.
- ``tests/test_cross_mesh_resume.py``'s case on the port: a checkpoint of
  one mesh resumes on another over the same ranks ({fsdp: 4} -> {dp: 2,
  fsdp: 2} and back), and the resumed losses track the uninterrupted ones.
"""

import json
import os
import pathlib
import shutil

import jax
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.checkpoint.manager import (
    CheckpointManager as JManager,
)
from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer
from test_torch_dist_train import (
    global_batches,
    jax_run,
    jax_step,
    launch,
    launch_worker,
    shared_once,
    wait_ok,
    write_inputs,
)
from test_torch_streaming import source_data

FSDP4 = {"fsdp": 4}


def _step_losses(run_dir, last=True):
    """step -> loss from ``events.jsonl`` (a resumed run appends: the first
    entry of a step is the first leg's, the last the resumed one's)."""
    out = {}
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("type") == "step_window":
                if last or int(ev["step"]) not in out:
                    out[int(ev["step"])] = float(ev["loss"])
    return out


def _cross_mesh_runs(out):
    """The trainer configs of the cross-mesh case, run in order on 4 ranks."""
    data = os.path.join(out, "cm.jsonl")
    with open(data, "w") as f:
        for i in range(64):
            f.write(json.dumps({"text": "hello world " * (3 + i % 5)}) + "\n")

    def cfg(name, mesh, resume=None):
        d = {"name": name, "overwrite": resume is None,
             "data": {"input_file": data, "preprocessing": {"max_context_size": 32},
                      "tokenizer": {"normal_vocab_size": 256}},
             "model": {"architecture": "llama",
                       "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                      "num_layers": 2},
                       "attention": {"num_heads": 2, "num_kv_heads": 2, "head_dim": 16}},
             "training": {"hyperparameters": {"batch_size": 2, "learning_rate": 1e-3,
                                              "iters": 6},
                          "scheduler": {"type": "cosine"},
                          "optimization": {"optimizer": "adamw"}},
             "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 3,
                                   "validation_interval": 0}},
             "system": {"seed": 0, "mesh": mesh, "zero_optimization_level": 1}}
        if resume:
            d["resume"] = {"checkpoint": resume}
        return d

    two = {"dp": 2, "fsdp": 2}
    return [cfg("down", FSDP4), cfg("down", two, "3"), cfg("up", two), cfg("up", FSDP4, "3")]


def _sidecar_config(out):
    data = source_data(pathlib.Path(out), "jsonl")
    return {"name": "sc", "overwrite": True, "data": data,
            "model": {"architecture": "llama",
                      "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                     "num_layers": 2},
                      "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
            "training": {"hyperparameters": {"batch_size": 2, "learning_rate": 1e-2,
                                             "iters": 5},
                         "optimization": {"optimizer": "adamw"},
                         "scheduler": {"type": "cosine", "min_lr_ratio": 0.1}},
            "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 3,
                                  "validation_interval": 0}},
            "system": {"seed": 0, "mesh": {"dp": -1}}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "dist_ckpt", _runs)


def _runs(out):
    write_inputs(out, {"trainers": _cross_mesh_runs(out)})
    sc = _sidecar_config(out)
    with open(os.path.join(out, "sc.json"), "w") as f:
        json.dump(sc, f)
    procs = [(launch_worker(4, "trainers", out), os.path.join(out, "trainers_4.log")),
             (launch(2, ["--config", os.path.join(out, "sc.json"), "--runs-root",
                         os.path.join(out, "sc_runs")], os.path.join(out, "sc.log")),
              os.path.join(out, "sc.log"))]
    # JAX at 4 devices: 5 uninterrupted steps, its state saved at step 3
    step, state = jax_step(FSDP4, 1)
    batches = global_batches()
    jax_losses = []
    for i in range(5):
        state, m = step(state, batches[i])
        jax_losses.append(float(m["loss"]))
        if i == 2:
            JManager(os.path.join(out, "ckpt_jax")).save(3, state["params"],
                                                           state["opt_state"], {"step": 3})
    procs.append((launch_worker(4, "ckpt", out), os.path.join(out, "ckpt_4.log")))
    wait_ok(*procs.pop())  # the port's step-3 files, for the resumes below
    resumes = [(launch_worker(n, "resume", out), os.path.join(out, f"resume_{n}.log"))
               for n in (2, 1)]
    # JAX resumes the port's files at 4 devices
    _, fresh = jax_step(FSDP4, 1)
    like = jax.tree_util.tree_map(np.asarray, fresh)
    params, opt_state, _ = JManager(os.path.join(out, "ckpt_port")).load(
        3, like_params=like["params"], like_opt_state=like["opt_state"], strict=True)
    resumed = dict(fresh, params=jax.device_put(params, jax.tree_util.tree_map(
        lambda x: x.sharding, fresh["params"])), opt_state=jax.device_put(
        opt_state, jax.tree_util.tree_map(lambda x: x.sharding, fresh["opt_state"])))
    _, jax_from_port = jax_run(FSDP4, 1, steps=range(3, 5), state=resumed)
    for proc, log in procs + resumes:
        wait_ok(proc, log)
    return {"out": out, "jax_losses": np.array(jax_losses),
            "jax_from_port": jax_from_port[:, 0], "sidecar": sc}


def _metrics(out, name):
    return np.load(os.path.join(out, name))["metrics"]


@pytest.mark.parametrize("world", [2, 1])
def test_a_four_rank_checkpoint_resumes_on_fewer_ranks(runs, world):
    out = runs["out"]
    base = _metrics(out, "ckpt_uninterrupted.npz")
    np.testing.assert_allclose(base[:, 0], runs["jax_losses"], rtol=1e-5)
    got = _metrics(out, f"resume_{world}.npz")
    np.testing.assert_allclose(got[:, 0], base[3:, 0], rtol=1e-5)
    np.testing.assert_allclose(got[:, 1], base[3:, 1], rtol=1e-5)


def test_checkpoints_cross_packages_both_ways(runs):
    out = runs["out"]
    base = _metrics(out, "ckpt_uninterrupted.npz")
    # the port's 4-rank files in JAX at 4 devices
    np.testing.assert_allclose(runs["jax_from_port"], base[3:, 0], rtol=1e-5)
    # JAX's 4-device files in the port at 4 ranks
    np.testing.assert_allclose(_metrics(out, "from_jax.npz")[:, 0], runs["jax_losses"][3:],
                               rtol=1e-5)


def test_every_rank_writes_its_sidecar_into_the_manifest(runs):
    out = runs["out"]
    ckpt = os.path.join(out, "ckpt_port", "checkpoints")
    with open(os.path.join(ckpt, "step_3.manifest.json")) as f:
        artifacts = json.load(f)["artifacts"]
    for i in range(4):
        name = f"step_3_data_p{i}.json"
        assert name in artifacts
        with open(os.path.join(ckpt, name)) as f:
            assert json.load(f) == {"rank": i, "process_count": 4, "process_index": i}
    assert {"step_3_model.safetensors", "step_3_optimizer.safetensors"} <= set(artifacts)
    # no rank wrote another's file, and none but the chief wrote the step
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("step_3")) == sorted(
        [f"step_3_data_p{i}.json" for i in range(4)] + [
            "step_3.manifest.json", "step_3_model.safetensors",
            "step_3_optimizer.safetensors", "step_3_state.json"])


def test_sidecars_are_read_across_world_sizes_as_jax_reads_them(runs, tmp_path):
    """A 2-rank streaming run's step-3 sidecars, resumed at 1 rank by the
    port and by the JAX trainer (each on its own copy of the run)."""
    src = os.path.join(runs["out"], "sc_runs", "sc")
    files = os.listdir(os.path.join(src, "checkpoints"))
    assert {"step_3_data_p0.json", "step_3_data_p1.json"} <= set(files)
    d = dict(runs["sidecar"], overwrite=False, resume={"checkpoint": "3"})
    losses = {}
    for pkg in ("port", "jax"):
        root = str(tmp_path / pkg)
        shutil.copytree(src, os.path.join(root, "sc"))
        if pkg == "port":
            tr = Trainer(TConfig.from_dict(d), runs_root=root, quiet=True, device="cpu")
        else:  # one process on one of the test process's devices, as the port's one rank
            one = dict(d, system=dict(d["system"], mesh={"dp": 1}))
            with pytest.warns(RuntimeWarning, match="STRANDED"):
                tr = JTrainer(JConfig.from_dict(one), runs_root=root, quiet=True)
        tr.train()
        with open(os.path.join(root, "sc", "log.txt")) as f:
            log = f.read()
        assert "remapped data position from a 2-host snapshot to 1 host(s)" in log, pkg
        losses[pkg] = _step_losses(os.path.join(root, "sc"))
    assert {4, 5} <= set(losses["port"])
    np.testing.assert_allclose([losses["port"][s] for s in (4, 5)],
                               [losses["jax"][s] for s in (4, 5)], rtol=1e-5)


def test_a_checkpoint_of_one_mesh_resumes_on_another(runs):
    out = runs["out"]
    assert os.path.isfile(os.path.join(out, "trainers.done"))
    for name in ("down", "up"):
        run_dir = os.path.join(out, "runs", name)
        first, resumed = _step_losses(run_dir, last=False), _step_losses(run_dir)
        assert sorted(first) == list(range(1, 7))
        np.testing.assert_allclose([resumed[s] for s in (4, 5, 6)],
                                   [first[s] for s in (4, 5, 6)], rtol=1e-5, err_msg=name)
        with open(os.path.join(run_dir, "log.txt")) as f:
            assert "Resumed from checkpoint 3 at step 3" in f.read()
    # the two meshes train the same run
    np.testing.assert_allclose(
        [_step_losses(os.path.join(out, "runs", "down"), last=False)[s] for s in range(1, 7)],
        [_step_losses(os.path.join(out, "runs", "up"), last=False)[s] for s in range(1, 7)],
        rtol=1e-5)
