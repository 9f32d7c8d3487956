"""Resume across the two packages, on the CPU, with Adafactor, Muon and a
hybrid partition.

JAX trains uninterrupted and saves at step 4; the port resumes its run
from step 4 and its steps 5-6 give JAX's losses (1e-5 relative). Then the
other way round. (Muon's and hybrid's states are partitions with ``None``
where the other label owns a parameter; those ride the optimizer file's
metadata as JSON nulls.) The early-stopping state and the data position ride the
checkpoint; a SIGTERM saves and ends the run, and a resume from it gives
the uninterrupted run's losses; a failed background write raises out of
``train()``; retention GC keeps what it is told to.
"""

import json
import os
import signal

import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint import faults
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.reset()


def _config(tmp_path, name, iters=6, **extra):
    """h 128 (so the [128, *] matrices are factored), 2 layers, S 64, vocab
    259, Adafactor, a log line every step, a checkpoint every 4 and a
    validation every 3 (moving the data position), early stopping on."""
    train, val = tmp_path / "train.jsonl", tmp_path / "val.jsonl"
    if not train.exists():
        rng = np.random.default_rng(0)
        words = ["ka", "lomi", "ne", "suta", "ripo", "an", "elor", "ve"]
        docs = [" ".join(rng.choice(words, size=60)) for _ in range(60)]
        train.write_text("".join(json.dumps({"text": d}) + "\n" for d in docs))
        val.write_text("".join(json.dumps({"text": d}) + "\n" for d in docs[:12]))
    d = {
        "name": name, "overwrite": True,
        "data": {"input_file": str(train), "validation_file": str(val),
                 "preprocessing": {"max_context_size": 64},
                 "tokenizer": {"normal_vocab_size": 256}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 128, "intermediate_size": 256,
                                 "num_layers": 2},
                  "attention": {"num_heads": 4, "num_kv_heads": 4, "head_dim": 32}},
        "training": {
            "hyperparameters": {"batch_size": 4, "learning_rate": 1e-2, "iters": iters,
                                "gradient_clip": 1.0},
            "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 2,
                          "min_lr_ratio": 0.1},
            "optimization": {"optimizer": "adafactor", "clipping_threshold": 1.0},
            "early_stopping": {"enabled": True, "patience": 5, "min_delta": 0.0},
        },
        "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 4,
                              "validation_interval": 3}},
        "system": {"seed": 0, "device": "cpu"},
    }
    for key, value in extra.items():
        node = d
        *parts, last = key.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = value
    return d


def _capture_losses(trainer):
    """Full-precision losses of each log line (log.txt rounds them)."""
    out = {}
    real = trainer.logger.log_metrics

    def log_metrics(step, line):
        out[step] = float(line["loss"])
        real(step, line)

    trainer.logger.log_metrics = log_metrics
    return out


def _assert_same_losses(got, want, steps):
    assert sorted(got) == list(steps)
    for s in steps:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5, err_msg=f"step {s}")


def _resume_cfg(d, tag):
    d = dict(d, overwrite=False, resume={"checkpoint": tag})
    return d


def test_port_resumes_a_jax_adafactor_run(tmp_path):
    runs = str(tmp_path / "runs")
    d = _config(tmp_path, "j2t")
    jtr = JTrainer(JConfig.from_dict(d), runs_root=runs, quiet=True)
    j_losses = _capture_losses(jtr)
    jtr.train()  # uninterrupted: checkpoints at 4 and final (6)
    with open(os.path.join(jtr.run_dir, "checkpoints", "step_4_state.json")) as f:
        j_state = json.load(f)

    ttr = Trainer(TConfig.from_dict(_resume_cfg(d, "4")), runs_root=runs, quiet=True,
                  device="cpu")
    assert ttr.start_step == 4
    assert ttr.total_tokens == j_state["total_tokens"]
    assert ttr.data.val_ptr == j_state["val_ptr"] > 0
    assert ttr.early_stopping.state_dict() == j_state["early_stopping"]
    assert ttr.early_stopping.best is not None
    t_losses = _capture_losses(ttr)
    ttr.train()
    _assert_same_losses(t_losses, j_losses, [5, 6])
    log = open(os.path.join(ttr.run_dir, "log.txt")).read()
    assert "Resumed from checkpoint 4 at step 4" in log


def test_jax_resumes_a_port_adafactor_run(tmp_path):
    runs = str(tmp_path / "runs")
    d = _config(tmp_path, "t2j")
    ttr = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    t_losses = _capture_losses(ttr)
    ttr.train()

    jtr = JTrainer(JConfig.from_dict(_resume_cfg(d, "4")), runs_root=runs, quiet=True)
    with open(os.path.join(ttr.run_dir, "checkpoints", "step_4_state.json")) as f:
        t_state = json.load(f)
    assert jtr.start_step == 4 and jtr.total_tokens == t_state["total_tokens"]
    assert jtr.early_stopping.state_dict() == t_state["early_stopping"]
    assert jtr.data.val_ptr == t_state["val_ptr"] > 0
    j_losses = _capture_losses(jtr)
    jtr.train()
    _assert_same_losses(j_losses, t_losses, [5, 6])


OPTIMIZERS = {
    "muon": {"optimizer": "muon", "adamw_lr_ratio": 0.04},
    "hybrid": {"optimizer": "hybrid", "matrix_optimizer": "muon",
               "non_matrix_optimizer": "lion", "hybrid_embeddings": "rest",
               "adamw_lr_ratio": 0.04},
}


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_muon_and_hybrid_resume_across_packages(tmp_path, opt, first):
    """One package trains uninterrupted (checkpoint at 4); the other resumes
    from step 4, and its steps 5-6 give the first one's losses."""
    runs = str(tmp_path / "runs")
    d = _config(tmp_path, f"{opt}-{first}", **{"training.optimization": OPTIMIZERS[opt]})
    make = {"jax": lambda c: JTrainer(JConfig.from_dict(c), runs_root=runs, quiet=True),
            "port": lambda c: Trainer(TConfig.from_dict(c), runs_root=runs, quiet=True,
                                      device="cpu")}
    second = "port" if first == "jax" else "jax"
    tr1 = make[first](d)
    want = _capture_losses(tr1)
    tr1.train()
    tr2 = make[second](_resume_cfg(d, "4"))
    assert tr2.start_step == 4
    got = _capture_losses(tr2)
    tr2.train()
    _assert_same_losses(got, want, [5, 6])


def test_early_stopping_and_data_position_ride_the_checkpoint(tmp_path):
    """Early stopping stops the port where it stops JAX; a resume from an
    interval checkpoint restores the monitor and the validation pointer
    as they were saved, and a resumed run stops where the whole run did."""
    es = {"enabled": True, "patience": 1, "min_delta": 100.0}  # never improves
    d = _config(tmp_path, "stop", iters=20, **{"training.early_stopping": es,
                                               "logging.steps.validation_interval": 2})
    runs = str(tmp_path / "runs")
    jtr = JTrainer(JConfig.from_dict(d), runs_root=str(tmp_path / "jruns"), quiet=True)
    j_result = jtr.train()
    ttr = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    result = ttr.train()
    assert result["steps"] == j_result["steps"] == 4  # validations at 2 and 4
    log = open(os.path.join(ttr.run_dir, "log.txt")).read()
    assert "Early stopping triggered at step 4" in log
    with open(os.path.join(ttr.run_dir, "checkpoints", "step_4_state.json")) as f:
        saved = json.load(f)
    assert saved["early_stopping"] == {"best": saved["validation"]["losses"][1],
                                       "bad_count": 1, "should_stop": True}

    d2 = _resume_cfg(dict(d, training=dict(d["training"], early_stopping=dict(
        es, patience=3))), "4")
    tr2 = Trainer(TConfig.from_dict(d2), runs_root=runs, quiet=True, device="cpu")
    assert tr2.data.val_ptr == saved["val_ptr"] > 0
    assert tr2.early_stopping.bad_count == 1 and tr2.early_stopping.should_stop
    assert tr2.val_history == saved["validation"]
    assert tr2.train()["steps"] == 6  # should_stop rides along: the next check stops


def test_sigterm_saves_exits_and_the_resume_gives_the_whole_run(tmp_path):
    """SIGTERM mid-run: a checkpoint at the next step boundary (after the
    async write in flight), a clean return, every manifest verifying; the
    resume from "latest" gives the uninterrupted run's losses."""
    d = _config(tmp_path, "whole", iters=8, **{"logging.steps.checkpoint_interval": 2})
    whole = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "w"), quiet=True,
                    device="cpu")
    w_losses = _capture_losses(whole)
    whole.train()

    runs = str(tmp_path / "runs")
    tr = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    real_step = tr.train_step

    def step_then_signal(state, batch):
        out = real_step(state, batch)
        if out[0]["step"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.train_step = step_then_signal
    handler = signal.getsignal(signal.SIGTERM)
    result = tr.train()
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert result["steps"] == 3
    log = open(os.path.join(tr.run_dir, "log.txt")).read()
    assert "Preemption signal received: saving checkpoint at step 3" in log
    for tag in tr.checkpoints.manifested_steps():
        assert tr.checkpoints.verify(tag) == (True, "ok"), tag
    assert {"2", "3", "final"} <= set(tr.checkpoints.manifested_steps())

    tr2 = Trainer(TConfig.from_dict(_resume_cfg(d, "latest")), runs_root=runs,
                  quiet=True, device="cpu")
    assert tr2.start_step == 3
    r_losses = _capture_losses(tr2)
    assert tr2.train()["steps"] == 8
    _assert_same_losses(r_losses, w_losses, range(4, 9))


def test_failed_background_write_raises_out_of_train(tmp_path):
    d = _config(tmp_path, "enospc", iters=6, **{"logging.steps.checkpoint_interval": 2})
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "runs"), quiet=True,
                 device="cpu")
    faults.inject("model", "enospc", match="step_2")
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        tr.train()
    assert tr.checkpoints.latest_complete_step() is None


def test_retention_gc_in_the_trainer(tmp_path):
    d = _config(tmp_path, "gc", iters=8, **{"logging.steps.checkpoint_interval": 2,
                                            "logging.retention": {"keep_last": 1,
                                                                  "keep_every": 4}})
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "runs"), quiet=True,
                 device="cpu")
    tr.train()
    assert set(tr.checkpoints.manifested_steps()) == {"final", "8", "4"}
    log = open(os.path.join(tr.run_dir, "log.txt")).read()
    assert "retention GC removed step(s) 2" in log


def _trained(tmp_path, name, iters=6):
    d = _config(tmp_path, name, iters=iters, **{"logging.steps.checkpoint_interval": 2,
                                                "logging.steps.validation_interval": 0})
    runs = str(tmp_path / "runs")
    tr = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    tr.train()  # checkpoints at 2, 4, 6 and final
    return d, runs, tr.checkpoints


def _log(tr):
    return open(os.path.join(tr.run_dir, "log.txt")).read()


def test_resume_latest_falls_back_over_torn_steps(tmp_path):
    d, runs, mgr = _trained(tmp_path, "fallback")
    for tag in ("final", "6"):
        with open(mgr.paths_for_step(tag)[0], "r+b") as f:
            f.truncate(32)
    tr = Trainer(TConfig.from_dict(_resume_cfg(d, "latest")), runs_root=runs, quiet=True,
                 device="cpu")
    assert tr.start_step == 4
    names = os.listdir(os.path.join(mgr.checkpoint_dir, "quarantine"))
    assert {"step_final_model.safetensors", "step_6_model.safetensors"} <= set(names)
    assert "quarantined checkpoint step final" in _log(tr)
    assert "Resumed from checkpoint 4 at step 4" in _log(tr)


@pytest.mark.parametrize("strict", [True, False])
def test_resume_without_a_verified_checkpoint(tmp_path, strict):
    import shutil

    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint import CheckpointIntegrityError

    d, runs, mgr = _trained(tmp_path, f"none{strict}", iters=2)
    shutil.rmtree(mgr.checkpoint_dir)
    os.makedirs(mgr.checkpoint_dir)
    cfg = TConfig.from_dict(dict(d, overwrite=False,
                                 resume={"checkpoint": "latest", "strict": strict}))
    if strict:
        with pytest.raises(CheckpointIntegrityError, match="no\\s+verified"):
            Trainer(cfg, runs_root=runs, quiet=True, device="cpu")
        return
    tr = Trainer(cfg, runs_root=runs, quiet=True, device="cpu")
    assert tr.start_step == 0
    assert "no resumable checkpoint found" in _log(tr)


def test_explicit_legacy_tag_loads_unverified_not_quarantined(tmp_path):
    d, runs, mgr = _trained(tmp_path, "legacytag")
    os.unlink(mgr.manifest_path(4))  # step 4 now predates manifests
    tr = Trainer(TConfig.from_dict(_resume_cfg(d, "4")), runs_root=runs, quiet=True,
                 device="cpu")
    assert tr.start_step == 4
    assert os.path.isfile(mgr.paths_for_step(4)[0])
    assert not os.path.isdir(os.path.join(mgr.checkpoint_dir, "quarantine"))
    assert "no integrity manifest" in _log(tr)


def test_reset_optimizer_and_training_state(tmp_path):
    d, runs, mgr = _trained(tmp_path, "reset")
    cfg = dict(d, overwrite=False, resume={"checkpoint": "4", "reset_optimizer": True,
                                           "reset_training_state": True})
    tr = Trainer(TConfig.from_dict(cfg), runs_root=runs, quiet=True, device="cpu")
    assert tr.start_step == 0 and tr.total_tokens == 0
    assert int(tr.state["opt_state"][1]["count"]) == 0  # a fresh Adafactor
    params, _, _ = mgr.load(4, like_params=tr.state["params"])
    w = params["layers"][0]["attention"]["wq"]["weight"]
    assert bool((tr.state["params"]["layers"][0]["attention"]["wq"]["weight"] == w).all())
