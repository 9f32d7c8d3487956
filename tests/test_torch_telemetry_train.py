"""The torch port's trainer telemetry against the JAX trainer's, on the CPU.

Both trainers train a tiny dense and a tiny MoE model (2 layers of hidden
32, 6 steps, a log line every 2, a checkpoint every 3, spans on) from
JAX's initial weights (carried across with ``convert.params_from_jax``).
The event streams, the log lines' keys, the registries rebuilt from the
event logs and the losses agree; each window's goodput components sum to
its wall time, and the spans in ``trace.json`` sum to its goodput fields.
Telemetry changes no number: the losses with it on and off are bitwise
equal. A ``torch.profiler`` window leaves ``prof_summary.json`` and
``prof_*`` fields in the later ``step_window`` events; SIGUSR2 writes
``trace_step<N>.json``. The configs that set the telemetry and supervisor
keys load into the port's ``Config`` as into JAX's.
"""

import json
import os
import signal
import socket
import urllib.request

import jax
import numpy as np
import pytest
import yaml

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.obs import events as jevents
from mlx_cuda_distributed_pretraining_tpu.obs.metrics import MetricsRegistry as JRegistry
from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.config import read_config_dict
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.obs import events as tevents
from mlx_cuda_distributed_pretraining_tpu_torch.obs.flops import GOODPUT_COMPONENTS
from mlx_cuda_distributed_pretraining_tpu_torch.obs.metrics import MetricsRegistry
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer, load_into

from test_torch_train import _config_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
WINDOW_KEYS = ("data_wait_s", "h2d_wait_s", "dispatch_s", "compile_s",
               "ckpt_save_s", "eval_s", "other_s")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _config(tmp_path, name, moe=False, **logging):
    d = _config_dict(tmp_path, name=name, iters=STEPS)
    d["logging"]["steps"] = {"logging_interval": 2, "checkpoint_interval": 3,
                             "validation_interval": 0}
    d["logging"]["trace"] = {"enabled": True}
    d["logging"].update(logging)
    if moe:
        d["model"]["moe"] = {"num_local_experts": 4, "num_experts_per_tok": 2,
                             "impl": "grouped", "aux_loss_weight": 0.01,
                             "router_z_weight": 0.001, "capacity_factor": 1.25,
                             "group_size": 16}
    return d


def _capture(trainer):
    """Full-precision log lines, as the logger gets them."""
    out = {}
    real = trainer.logger.log_metrics

    def log_metrics(step, line):
        out[step] = dict(line)
        real(step, line)

    trainer.logger.log_metrics = log_metrics
    return out


def _port_trainer(d, runs, start=None):
    tr = Trainer(TConfig.from_dict(d), runs_root=str(runs), quiet=True, device="cpu")
    if start is not None:
        load_into(tr.state["params"], params_from_jax(start, "cpu"))
    return tr


def _span_windows(trace_path):
    """Per closed window (in record order), the span seconds by goodput
    component; a ``goodput_flush`` marker discards what came before the
    first window, as the ledger does."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out, acc = {}, {}
    for e in events:
        if e.get("ph") == "X":
            comp = e["name"] + "_s"
            acc[comp] = acc.get(comp, 0.0) + e["args"]["seconds"]
        elif e.get("ph") == "i" and e["name"] in ("step_window", "goodput_flush"):
            if e["name"] == "step_window":
                out[e["args"]["step"]] = acc
            acc = {}
    return out


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_trainer_telemetry_matches_jax(tmp_path, moe):
    d = _config(tmp_path, "tele-moe" if moe else "tele", moe=moe)
    jtr = JTrainer(JConfig.from_dict(d), runs_root=str(tmp_path / "jr"), quiet=True)
    start = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    ttr = _port_trainer(d, tmp_path / "tr", start)
    want, got = _capture(jtr), _capture(ttr)
    jtr.train()
    ttr.train()

    # the log lines: JAX's keys, the same steps, losses within 1e-5
    assert sorted(got) == sorted(want) == [2, 4, 6]
    for s in got:
        assert set(got[s]) == set(want[s]), s
        np.testing.assert_allclose(got[s]["loss"], want[s]["loss"], rtol=1e-5)
        assert got[s]["toks"] == want[s]["toks"]
    for w in ttr.windows:  # the components sum to the window's wall time
        line = got[w["step"]]
        assert sum(line[k] for k in WINDOW_KEYS) == pytest.approx(w["seconds"], abs=1e-9)
    assert got[2]["compile_s"] > 0 and got[4]["compile_s"] == 0.0
    assert got[4]["ckpt_save_s"] > 0  # the step-3 save books into the next window

    # the event streams: types in the same order, step_window's keys
    jev = list(jevents.iter_events(jevents.events_path(jtr.run_dir)))
    tev = list(tevents.iter_events(tevents.events_path(ttr.run_dir)))
    assert [e["type"] for e in tev] == [e["type"] for e in jev]
    assert [e["type"] for e in tev] == [
        "run_start", "compile", "step_window", "checkpoint_save", "step_window",
        "step_window", "checkpoint_save", "eval", "checkpoint_save", "run_end"]
    tw = [e for e in tev if e["type"] == "step_window"]
    jw = [e for e in jev if e["type"] == "step_window"]
    for a, b in zip(tw, jw):
        assert set(a) == set(b) and set(a["goodput"]) == set(b["goodput"])
        assert (a["step"], a["steps"], a["toks"]) == (b["step"], b["steps"], b["toks"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    assert jevents.tally(tevents.events_path(ttr.run_dir))["steps"] == STEPS

    # the registries rebuilt from each event log: equal durable counters
    treg, jreg = MetricsRegistry(), JRegistry()
    tevents.replay_into(treg, tevents.events_path(ttr.run_dir))
    jevents.replay_into(jreg, jevents.events_path(jtr.run_dir))
    for name in ("train_steps_total", "train_tokens_total", "checkpoint_saves_total",
                 "eval_runs_total", "faults_total", "restarts_total"):
        assert treg.snapshot()[name] == jreg.snapshot()[name], name
    # the live registry holds the same counters and the MoE gauges
    live = ttr.metrics.snapshot()
    assert live["train_steps_total"] == treg.snapshot()["train_steps_total"]
    assert ("moe_balance_entropy" in live) == moe
    assert live["checkpoint_writes_total"]["series"]

    # the spans of each window sum to its goodput fields
    spans = _span_windows(os.path.join(ttr.run_dir, "trace.json"))
    assert sorted(spans) == [2, 4, 6]
    for ev in tw:
        for comp in GOODPUT_COMPONENTS:
            assert spans[ev["step"]].get(comp, 0.0) == pytest.approx(
                ev["goodput"][comp], abs=1e-6), (ev["step"], comp)
    hb = tevents.read_heartbeat(tevents.heartbeat_path(ttr.run_dir))
    assert jevents.read_heartbeat(jevents.heartbeat_path(ttr.run_dir)) == hb
    assert hb["step"] == STEPS


def test_telemetry_changes_no_loss(tmp_path):
    """Spans, a metrics port, a stats hub that is not there and a profile
    window against none of them: bitwise-equal losses. The exposition
    answers while the run lives and after it ends."""
    off = _port_trainer(_config(tmp_path, "off", trace={"enabled": False}), tmp_path / "a")
    port = _free_port()
    on = _port_trainer(_config(tmp_path, "on", metrics_port=port, profile_start=3,
                               profile_stop=5, tensorboard=True,
                               metrics={"stats_url": f"ws://127.0.0.1:{_free_port()}"}),
                       tmp_path / "b")
    load_into(on.state["params"], off.state["params"])
    a, b = _capture(off), _capture(on)
    off.train()
    on.train()
    assert [a[s]["loss"] for s in sorted(a)] == [b[s]["loss"] for s in sorted(b)]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    assert f"train_step {STEPS}" in text and "train_tokens_total" in text
    assert 'goodput_seconds_total{component="dispatch_s"}' in text
    assert "input_batches_total 6" in text and "input_data_wait_seconds_count 6" in text
    assert 'checkpoint_writes_total{mode="async"} 2' in text


def test_profile_window_leaves_summary_and_prof_fields(tmp_path):
    d = _config(tmp_path, "prof", profile_start=2, profile_stop=4,
                profile_report={"top_k": 50})
    tr = _port_trainer(d, tmp_path / "r")
    tr.train()
    summary = json.load(open(os.path.join(tr.run_dir, "prof_summary.json")))
    assert [s["step"] for s in summary["steps"]] == [2, 3]
    agg = summary["aggregate"]
    assert abs(agg["compute_frac"] + agg["comm_frac"] + agg["host_frac"]
               + agg["idle_frac"] - 1.0) < 1e-9
    assert summary["ops"] and all(o["count"] > 0 for o in summary["ops"])
    traces = [f for _, _, fs in os.walk(os.path.join(tr.run_dir, "profile"))
              for f in fs if f.endswith(".trace.json")]
    assert len(traces) == 1
    ev = list(tevents.iter_events(tevents.events_path(tr.run_dir)))
    assert [(e["action"], e["step"]) for e in ev if e["type"] == "profiler"] == [
        ("start", 2), ("stop", 4)]
    assert any(e["type"] == "profile_report" for e in ev)
    windows = {e["step"]: e for e in ev if e["type"] == "step_window"}
    assert "prof_compute_frac" not in windows[2]
    assert all("prof_idle_frac" in windows[s] for s in (4, 6))
    assert tr.metrics.gauge("prof_compute_frac").value() == windows[4]["prof_compute_frac"]


def test_sigusr2_writes_an_on_demand_trace(tmp_path):
    d = _config(tmp_path, "usr2", trace={"enabled": False, "capture_steps": 2})
    tr = _port_trainer(d, tmp_path / "r")
    real = tr.logger.log_metrics

    def log_metrics(step, line):
        real(step, line)
        if step == 2:
            os.kill(os.getpid(), signal.SIGUSR2)

    tr.logger.log_metrics = log_metrics
    tr.train()
    path = os.path.join(tr.run_dir, "trace_step5.json")
    doc = json.load(open(path))
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"dispatch", "data_wait"} <= names
    steps = {e["args"].get("step") for e in doc["traceEvents"] if e.get("name") == "dispatch"}
    assert steps == {3, 4}
    ev = [e for e in tevents.iter_events(tevents.events_path(tr.run_dir))
          if e["type"] == "trace_capture"]
    assert [(e["action"], e["step"]) for e in ev] == [("start", 3), ("stop", 5)]
    assert not tr.tracer.enabled  # back as it was
    assert signal.getsignal(signal.SIGUSR2) is not None


@pytest.mark.parametrize("name", ["model-config-1b-fsdp.yaml", "model-config-moe-1b.yaml",
                                  "model-config-sample.yaml"])
def test_configs_load_supervisor_and_logging_keys_as_jax(name):
    path = os.path.join(REPO, "configs", name)
    with open(path) as f:
        raw = yaml.safe_load(f)
    t, j = TConfig.from_dict(read_config_dict(path)), JConfig.from_dict(raw)
    for key in ("hang_timeout_s", "hang_kill_grace_s", "barrier_timeout_s"):
        assert getattr(t.supervisor, key) == getattr(j.supervisor, key), key
    for key in ("tensorboard", "wandb", "wandb_project", "wandb_entity", "profile_start",
                "profile_stop", "metrics_port", "trace", "profile_report", "events",
                "events_max_bytes", "stats_url", "profile_report_enabled",
                "profile_report_top_k"):
        assert getattr(t.logging, key) == getattr(j.logging, key), key
    if name != "model-config-sample.yaml":
        assert t.logging.metrics_port == 9100 and t.supervisor.hang_timeout_s == 900
    # the port writes the section back out
    assert t.to_dict()["supervisor"]["hang_timeout_s"] == t.supervisor.hang_timeout_s
