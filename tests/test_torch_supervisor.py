"""The torch port's single-host supervisor, on the CPU.

The JAX package's fast supervisor tests (``tests/test_supervisor.py``) and
its two watchdog tests (``tests/test_obs_metrics.py``), run against the
port's ``train/supervisor.py`` with the same stub children: a ``python -c``
script that acts out a plan ("crash", "ckpt+crash", "ok", "sleep"),
writing hand-rolled but manifest-valid checkpoints. Then a chaos drill:
the port's trainer under the port's supervisor, SIGKILLed after each of two
new checkpoints, finishes with the uninterrupted port run's losses and
weights, bit for bit, and within 1e-5 of the JAX trainer's uninterrupted
run.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer
from mlx_cuda_distributed_pretraining_tpu_torch.obs.events import (
    events_path,
    heartbeat_path,
    iter_events,
    replay_into,
    write_heartbeat,
)
from mlx_cuda_distributed_pretraining_tpu_torch.obs.metrics import MetricsRegistry
from mlx_cuda_distributed_pretraining_tpu_torch.train.supervisor import (
    CrashLoopError,
    Supervisor,
    _trainer_cmd_builder,
)
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import build_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Stub child: argv = [run_dir, plan]. Reads and bumps an attempt counter,
# then acts out plan[attempt]: "crash" exits 1; "ckpt+crash" first writes a
# checkpoint (a real manifest: bytes + crc32) for step attempt+1; "ok" exits
# 0; "sleep" hangs until signalled. Imports nothing heavy.
_STUB = r"""
import json, os, sys, time, zlib
run_dir, plan = sys.argv[1], sys.argv[2].split(",")
cnt = os.path.join(run_dir, "attempt")
n = int(open(cnt).read()) if os.path.exists(cnt) else 0
open(cnt, "w").write(str(n + 1))
action = plan[min(n, len(plan) - 1)]
if action == "sleep":
    time.sleep(120)
    sys.exit(1)
if action.startswith("ckpt"):
    ckdir = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckdir, exist_ok=True)
    step = n + 1
    data = ("model-bytes-%d" % step).encode()
    name = "step_%d_model.safetensors" % step
    open(os.path.join(ckdir, name), "wb").write(data)
    manifest = {"format_version": 1, "step": step, "written_at": float(step),
                "artifacts": {name: {"bytes": len(data),
                                     "crc32": zlib.crc32(data)}}}
    with open(os.path.join(ckdir, "step_%d.manifest.json" % step), "w") as f:
        json.dump(manifest, f)
sys.exit(0 if action.endswith("ok") else 1)
"""


def _stub_supervisor(tmp_path, plan, **kw):
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir, exist_ok=True)
    resume_tags = []

    def build_cmd(tag):
        resume_tags.append(tag)
        return [sys.executable, "-c", _STUB, run_dir, plan]

    sup = Supervisor(build_cmd, run_dir, backoff_base=0.01, backoff_max=0.05,
                     log=lambda m: None, **kw)
    return sup, resume_tags


def test_restarts_until_success_and_resumes_from_new_checkpoint(tmp_path):
    sup, tags = _stub_supervisor(tmp_path, "crash,ckpt+crash,ok")
    assert sup.run() == 0
    assert sup.restarts == 2
    # launch 1 fresh, launch 2 fresh (no checkpoint yet), launch 3 resumes
    # from the step-2 checkpoint launch 2 wrote before crashing
    assert tags == [None, None, "2"]
    kinds = [e["type"] for e in iter_events(events_path(sup.run_dir))]
    assert kinds == ["postmortem", "restart", "postmortem", "restart"]


def test_crash_loop_gives_up_after_max_crashes(tmp_path):
    sup, tags = _stub_supervisor(tmp_path, "crash", max_crashes_per_step=3)
    with pytest.raises(CrashLoopError, match="3 consecutive crashes"):
        sup.run()
    assert len(tags) == 3  # exactly max_crashes launches, then give up


def test_checkpoint_progress_resets_crash_counter(tmp_path):
    # two no-progress crashes (2/3), a crash WITH a new checkpoint (resets to
    # 1), another no-progress crash (2/3), then success
    sup, tags = _stub_supervisor(
        tmp_path, "crash,crash,ckpt+crash,crash,ok", max_crashes_per_step=3)
    assert sup.run() == 0
    assert sup.restarts == 4
    assert tags[-1] == "3"


def test_forwarded_sigterm_stops_without_restart(tmp_path):
    sup, tags = _stub_supervisor(tmp_path, "sleep")

    def on_spawn(child):
        # the handler is installed before the first launch: signal the
        # SUPERVISOR once the child runs
        threading.Timer(0.2, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()

    sup.on_spawn = on_spawn
    rc = sup.run()
    assert rc != 0  # the child was terminated by the forwarded signal
    assert sup.restarts == 0
    assert len(tags) == 1


def test_latest_resumable_skips_corrupt_newest(tmp_path):
    import zlib

    run_dir = str(tmp_path / "run")
    ckdir = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckdir)
    for step in (1, 2):
        data = f"model-bytes-{step}".encode()
        name = f"step_{step}_model.safetensors"
        with open(os.path.join(ckdir, name), "wb") as f:
            f.write(data)
        with open(os.path.join(ckdir, f"step_{step}.manifest.json"), "w") as f:
            json.dump({"format_version": 1, "step": step, "written_at": 0.0,
                       "artifacts": {name: {"bytes": len(data),
                                            "crc32": zlib.crc32(data)}}}, f)
    with open(os.path.join(ckdir, "step_2_model.safetensors"), "wb") as f:
        f.write(b"xx")  # torn, as a kill -9 mid-write leaves it
    sup = Supervisor(lambda tag: ["true"], run_dir, log=lambda m: None)
    assert sup.latest_resumable() == "1"
    assert os.path.isdir(os.path.join(ckdir, "quarantine"))


def test_scan_oserror_raises_instead_of_treating_as_fresh(tmp_path, monkeypatch):
    """A transient scan failure must never read as "no checkpoints": after
    its retries the error propagates."""
    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
        CheckpointManager,
    )

    calls = {"n": 0}

    def boom(self, quarantine=True):
        calls["n"] += 1
        raise OSError("stale NFS handle")

    monkeypatch.setattr(CheckpointManager, "latest_complete_step", boom)
    sup = Supervisor(lambda tag: ["true"], str(tmp_path / "run"),
                     backoff_base=0.001, backoff_max=0.002, log=lambda m: None)
    with pytest.raises(OSError, match="stale NFS handle"):
        sup.latest_resumable()
    assert calls["n"] == 3


def _builder_args(cfg_path, root, name, *extra):
    return build_parser().parse_args(
        ["--config", str(cfg_path), "--runs-root", str(root), "--run-name", name,
         *extra])


def test_fresh_restart_never_overwrites_dir_with_checkpoint_data(tmp_path):
    """A fresh launch (no verified tag) on a run dir whose checkpoints dir is
    not empty launches in resume mode: overwrite=true would delete it."""
    run_dir = tmp_path / "runs" / "r"
    qdir = run_dir / "checkpoints" / "quarantine"
    os.makedirs(qdir)
    (qdir / "step_7.reason.txt").write_text("crc32 mismatch")
    build = _trainer_cmd_builder(
        _builder_args(tmp_path / "c.json", tmp_path / "runs", "r"), str(run_dir))
    cmd = build(None)
    assert "overwrite=true" not in cmd
    assert "overwrite=false" in cmd
    assert "resume.checkpoint=latest" in cmd


def test_fresh_start_overwrites_only_without_checkpoint_data(tmp_path):
    run_dir = tmp_path / "runs" / "r"
    args = _builder_args(tmp_path / "c.json", tmp_path / "runs", "r", "--device", "cpu",
                         "--iters", "7", "--batch-size", "2", "--learning-rate", "0.5")
    build = _trainer_cmd_builder(args, str(run_dir))
    assert "overwrite=true" in build(None)  # no run dir at all
    os.makedirs(run_dir / "checkpoints")
    assert "overwrite=true" in build(None)  # a crash before the first checkpoint
    cmd = build("42")  # a verified tag always wins
    assert "resume.checkpoint=42" in cmd and "overwrite=false" in cmd
    # the port's trainer module, with the device and the overrides passed on
    i = cmd.index("-m")
    assert cmd[i + 1] == "mlx_cuda_distributed_pretraining_tpu_torch.train.trainer"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    for flag, value in (("--iters", "7"), ("--batch-size", "2"),
                        ("--learning-rate", "0.5"), ("--run-name", "r")):
        assert cmd[cmd.index(flag) + 1] == value
    assert "--auto-resume" not in cmd


def test_what_is_not_ported_raises_naming_its_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        Supervisor(lambda tag: ["true"], str(tmp_path), process_count=2)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"name": "r"}))
    from mlx_cuda_distributed_pretraining_tpu_torch.train.supervisor import (
        supervise_from_args,
    )

    # --scope is ported (tests/test_torch_scope.py runs the sidecar); a
    # supervisor over several processes still refuses, with --scope too
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        supervise_from_args(_builder_args(cfg, tmp_path, "r", "--auto-resume", "--scope",
                                          "--num-processes", "2"))


def test_watchdog_last_progress_floors_stale_heartbeat(tmp_path):
    """A heartbeat left behind by a PREVIOUS child must not count against a
    freshly spawned one."""
    run_dir = str(tmp_path)
    write_heartbeat(heartbeat_path(run_dir), step=3)
    sup = Supervisor(lambda tag: ["true"], run_dir, log=lambda m: None)
    spawn_after = time.time() + 100
    assert sup._last_progress(spawn_after) == spawn_after
    spawn_before = time.time() - 100
    assert sup._last_progress(spawn_before) > spawn_before  # the heartbeat is newer


def test_watchdog_restarts_hung_child_and_books_lost_time(tmp_path):
    """A synthetic hang: run 1 writes one heartbeat, then stalls, trapping
    SIGTERM into exit 0 (a hang must count as a crash even on a clean exit
    code); run 2 completes. The supervisor stops and restarts it, logs the
    fault/restart events, and the replayed registry carries the lost wall
    clock as restart_lost_s."""
    run_dir = tmp_path / "run"
    (run_dir / "checkpoints").mkdir(parents=True)
    marker = tmp_path / "attempts.txt"
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""
        import json, os, signal, sys, time
        marker = {str(marker)!r}
        n = int(open(marker).read()) if os.path.exists(marker) else 0
        open(marker, "w").write(str(n + 1))
        hb = {str(run_dir / "heartbeat.json")!r}
        tmp = hb + ".tmp"
        with open(tmp, "w") as f:
            json.dump({{"t": time.time(), "step": n, "pid": os.getpid()}}, f)
        os.replace(tmp, hb)
        if n == 0:
            signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
            time.sleep(300)  # hang: the heartbeat never advances again
        sys.exit(0)
    """))
    sup = Supervisor(lambda tag: [sys.executable, str(child)], str(run_dir),
                     backoff_base=0.05, backoff_max=0.05, hang_timeout_s=1.5,
                     hang_kill_grace_s=5.0, log=lambda m: None)
    assert sup.run() == 0
    assert sup.hangs == 1 and sup.restarts == 1
    assert int(marker.read_text()) == 2

    evs = list(iter_events(events_path(str(run_dir))))
    fault = next(e for e in evs if e["type"] == "fault")
    assert fault["kind"] == "hang" and fault["stalled_s"] > 1.5
    restart = next(e for e in evs if e["type"] == "restart")
    assert restart["lost_s"] > 0
    post = next(e for e in evs if e["type"] == "postmortem")
    assert post["hang"] is True and post["rc"] == 0  # a clean-exit hang

    reg = MetricsRegistry()
    replay_into(reg, events_path(str(run_dir)))
    assert reg.counter("faults_total").value(kind="hang") == 1.0
    assert reg.counter("restarts_total").value() == 1.0
    lost = reg.counter("goodput_seconds_total").value(component="restart_lost_s")
    assert lost == pytest.approx(restart["lost_s"])


def test_watchdog_kills_a_stopped_child(tmp_path):
    """A child that SIGSTOPs itself never runs a SIGTERM handler: the
    watchdog's SIGKILL after ``hang_kill_grace_s`` ends it."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    marker = tmp_path / "n"
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""
        import os, signal, sys
        marker = {str(marker)!r}
        n = int(open(marker).read()) if os.path.exists(marker) else 0
        open(marker, "w").write(str(n + 1))
        if n == 0:
            os.kill(os.getpid(), signal.SIGSTOP)
        sys.exit(0)
    """))
    t0 = time.time()
    sup = Supervisor(lambda tag: [sys.executable, str(child)], str(run_dir),
                     backoff_base=0.05, hang_timeout_s=1.0, hang_kill_grace_s=0.5,
                     log=lambda m: None)
    assert sup.run() == 0 and sup.hangs == 1 and sup.restarts == 1
    assert time.time() - t0 < 30
    post = next(e for e in iter_events(events_path(str(run_dir)))
                if e["type"] == "postmortem")
    assert post["rc"] == -signal.SIGKILL


# -- the chaos drill: the port's trainer, killed twice ---------------------------------
CHAOS_STEPS = 40


def _chaos_config(tmp_path):
    train = tmp_path / "train.jsonl"
    rng = np.random.default_rng(0)
    words = ["ka", "lomi", "ne", "suta", "ripo", "an", "elor", "ve"]
    train.write_text("".join(json.dumps({"text": " ".join(rng.choice(words, 60))}) + "\n"
                             for _ in range(40)))
    d = {"name": "placeholder", "overwrite": True,
         "data": {"input_file": str(train), "preprocessing": {"max_context_size": 64},
                  "tokenizer": {"normal_vocab_size": 256}},
         "model": {"architecture": "llama",
                   "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                  "num_layers": 2},
                   "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
         "training": {"hyperparameters": {"batch_size": 4, "learning_rate": 1e-2,
                                          "iters": CHAOS_STEPS},
                      "scheduler": {"type": "cosine", "min_lr_ratio": 0.1},
                      "optimization": {"optimizer": "adamw"}},
         "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 10,
                               "validation_interval": 0}},
         # blocking interval saves: the kill lands right after the save
         "system": {"seed": 0, "device": "cpu", "async_checkpointing": False}}
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps(d))
    return d, str(path)


def _event_losses(run_dir):
    """step -> loss of the step_window events (a restarted run logs some
    steps twice: both must agree)."""
    out = {}
    for e in iter_events(events_path(run_dir)):
        if e["type"] == "step_window":
            assert out.setdefault(e["step"], e["loss"]) == e["loss"], e["step"]
    return out


def _manifests(ckdir):
    try:
        return {n for n in os.listdir(ckdir) if n.endswith(".manifest.json")}
    except OSError:
        return set()


def test_chaos_kill9_twice_matches_the_uninterrupted_run(tmp_path):
    """Both port runs start from the JAX trainer's initial state (its step-0
    checkpoint, which the port resumes), so the JAX run is the reference for
    all three."""
    import shutil

    d, cfg_path = _chaos_config(tmp_path)
    root = str(tmp_path / "runs")
    jd = dict(d, name="jax")
    jtr = JTrainer(JConfig.from_dict(jd), runs_root=str(tmp_path / "jr"), quiet=True)
    jtr.save_checkpoint(0)
    for name in ("base", "chaos"):
        shutil.copytree(os.path.join(jtr.run_dir, "checkpoints"),
                        os.path.join(root, name, "checkpoints"))

    # one thread a child: a tiny model, and the suite runs beside it
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.train.trainer",
         "--config", cfg_path, "--runs-root", root, "--run-name", "base", "--device", "cpu",
         "--set", "resume.checkpoint=0", "--set", "overwrite=false"],
        env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    base = _event_losses(os.path.join(root, "base"))
    assert sorted(base) == list(range(1, CHAOS_STEPS + 1))

    args = build_parser().parse_args(
        ["--config", cfg_path, "--runs-root", root, "--run-name", "chaos",
         "--device", "cpu", "--auto-resume", "--max-crashes", "3",
         "--backoff-base", "0.05", "--backoff-max", "0.2"])
    run_dir = os.path.join(root, "chaos")
    ckdir = os.path.join(run_dir, "checkpoints")
    kills = []

    def on_spawn(child):
        if len(kills) >= 2:
            return  # the last incarnation runs to the end
        seen = _manifests(ckdir)

        def watch():
            # SIGKILL once the child has committed a NEW checkpoint
            deadline = time.time() + 40
            while child.poll() is None and time.time() < deadline:
                new = _manifests(ckdir) - seen
                if new and "step_final.manifest.json" not in new:
                    child.kill()
                    kills.append(sorted(new))
                    return
                time.sleep(0.002)

        threading.Thread(target=watch, daemon=True).start()

    sup = Supervisor(_trainer_cmd_builder(args, run_dir), run_dir, max_crashes_per_step=3,
                     backoff_base=0.05, backoff_max=0.2, env=env, on_spawn=on_spawn,
                     log=lambda m: None)
    t0 = time.time()
    assert sup.run() == 0
    assert time.time() - t0 < 60
    assert kills == [["step_10.manifest.json"], ["step_20.manifest.json"]]
    assert sup.restarts == 2
    chaos = _event_losses(run_dir)
    assert chaos == base  # every step, bit for bit (as the events round them)
    # ... and the two runs end on the same weight bytes
    with open(os.path.join(root, "base", "checkpoints", "step_final_model.safetensors"),
              "rb") as f:
        base_bytes = f.read()
    with open(os.path.join(ckdir, "step_final_model.safetensors"), "rb") as f:
        assert f.read() == base_bytes
    evs = list(iter_events(events_path(run_dir)))
    assert [e["step"] for e in evs if e["type"] == "resume"] == [0, 10, 20]
    assert sum(e["type"] == "restart" for e in evs) == 2
    assert evs[-1]["type"] == "run_end" and evs[-1]["step"] == CHAOS_STEPS

    # the JAX trainer's uninterrupted run from the same state: within 1e-5
    want = {}
    real = jtr.logger.log_metrics

    def log_metrics(step, line):
        want[step] = float(line["loss"])
        real(step, line)

    jtr.logger.log_metrics = log_metrics
    jtr.train()
    assert sorted(want) == sorted(chaos)
    np.testing.assert_allclose([chaos[s] for s in sorted(want)],
                               [want[s] for s in sorted(want)], rtol=1e-5)
