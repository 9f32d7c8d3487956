"""The torch port's scope plane (``obs/tsdb.py``, ``alerts.py``,
``scope.py``, ``monitor.py``, ``dashboard.py``) and the supervisor's
``--scope`` sidecar against the JAX package's, on the CPU.

- The TSDB: the same samples give byte-identical series files, each
  package reads the other's store, and every query answers the same.
- Every rule kind sees the same samples on a logical clock and must give
  the same transitions, ``for_s`` hold-downs included.
- ``configs/alerts.yaml`` validates in both packages (also through the
  port's YAML reader for hosts without PyYAML), and every metric its
  rules name is exported under that name by a port registry: the router,
  the engine, the trainer or the checkpoint manager.
- Two collectors over the same stub targets write the same TSDB series,
  alert events and bundle layout.
- The supervisor's ``--scope`` keeps the trainer's ``train_step`` series.
- The monitor's status line on one log, and ``DASHBOARD_HTML``, equal JAX's.
"""

import importlib
import json
import math
import os
import socket
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from mlx_cuda_distributed_pretraining_tpu.obs import alerts as jalerts
from mlx_cuda_distributed_pretraining_tpu.obs import dashboard as jdash
from mlx_cuda_distributed_pretraining_tpu.obs import scope as jscope
from mlx_cuda_distributed_pretraining_tpu.obs import tsdb as jtsdb
from mlx_cuda_distributed_pretraining_tpu_torch.obs import alerts as talerts
from mlx_cuda_distributed_pretraining_tpu_torch.obs import dashboard as tdash
from mlx_cuda_distributed_pretraining_tpu_torch.obs import scope as tscope
from mlx_cuda_distributed_pretraining_tpu_torch.obs import tsdb as ttsdb
from mlx_cuda_distributed_pretraining_tpu_torch.utils import yaml_lite

# ``obs.monitor`` is also the name of the function both ``obs/__init__``s export
jmonitor = importlib.import_module("mlx_cuda_distributed_pretraining_tpu.obs.monitor")
tmonitor = importlib.import_module("mlx_cuda_distributed_pretraining_tpu_torch.obs.monitor")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALERTS_YAML = os.path.join(REPO, "configs", "alerts.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the TSDB ---------------------------------------------------------------------
def _fill(db):
    """Counters with a reset, a gauge with float escapes and a NaN, and a
    histogram's buckets, on a 2.5 s clock."""
    for i in range(60):
        t = 1000.0 + 2.5 * i
        db.append("req_total", {"outcome": "ok", "instance": "r0"}, t,
                  float(7 * i if i < 30 else 7 * (i - 30)))
        db.append("req_total", {"outcome": "error", "instance": "r0"}, t, float(i // 7))
        db.append("loss", {"instance": "t0"}, t,
                  float("nan") if i == 41 else 3.0 / (1 + i) + 0.1234567 * (i % 3))
        db.append("big", None, t, 1e12 + i * 0.5)
        for le, frac in (("10", 0.5), ("100", 0.9), ("+Inf", 1.0)):
            db.append("lat_ms_bucket", {"le": le}, t, float(int(frac * 4 * i)))


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as fh:
            out[name] = fh.read()
    return out


def _queries(db):
    nan = lambda v: "nan" if isinstance(v, float) and math.isnan(v) else v  # noqa: E731
    return {
        "keys": sorted(db.keys()),
        "range": [(t, nan(v)) for t, v in db.query("loss", {"instance": "t0"}, 1050.0, 1110.0)],
        "select": db.select("req_total", {"instance": "r0"}),
        "latest": nan(db.latest("loss", {"instance": "t0"})),
        "increase": db.increase("req_total", {"outcome": "ok", "instance": "r0"},
                                1000.0, 1150.0),
        "rate": db.rate("req_total", {"outcome": "ok", "instance": "r0"}, 1000.0, 1150.0),
        "sum_increase": db.sum_increase("req_total", {}, 1000.0, 1150.0),
        "p50": db.quantile("lat_ms", {}, 0.5, 1000.0, 1150.0),
        "p99": db.quantile("lat_ms", {}, 0.99, 1050.0, 1150.0),
        "big": db.query("big")[-3:],
    }


def test_tsdb_files_and_queries_equal_jax(tmp_path):
    tdb = ttsdb.TSDB(str(tmp_path / "t"), max_points=64)
    jdb = jtsdb.TSDB(str(tmp_path / "j"), max_points=64)
    _fill(tdb)
    _fill(jdb)
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    assert _queries(tdb) == _queries(jdb)
    # each package reads the other's store (and compacts it alike)
    assert _queries(ttsdb.TSDB(str(tmp_path / "j"), max_points=64)) == _queries(jdb)
    assert _queries(jtsdb.TSDB(str(tmp_path / "t"), max_points=64)) == _queries(tdb)
    assert ttsdb.sparkline([0, 1, 5, 2]) == jtsdb.sparkline([0, 1, 5, 2])
    key = ttsdb.series_key("m", {"b": "2", "a": "1"})
    assert key == jtsdb.series_key("m", {"b": "2", "a": "1"})
    assert ttsdb.parse_series_key(key) == jtsdb.parse_series_key(key)


@pytest.mark.parametrize("values", [
    [2.5, 2.5, -1.0, 0.1234567, 1e12, float("inf"), -0.0, 3.0e-300],
    [float(i) for i in range(40)] + [5.0, 1e-9]])
def test_tsdb_records_and_torn_tails_as_jax(tmp_path, values):
    buf_t, buf_j = bytearray(), bytearray()
    for mod, buf in ((ttsdb, buf_t), (jtsdb, buf_j)):
        prev_t, prev_d, prev_v = 0, 0, 0.0
        for i, v in enumerate(values):
            t_ms = 1000 + 250 * i + (i % 3)
            buf.extend(mod.encode_record(t_ms, prev_t, prev_d, v, prev_v))
            prev_d, prev_t, prev_v = t_ms - prev_t, t_ms, v
    assert bytes(buf_t) == bytes(buf_j)
    assert ttsdb.decode_records(bytes(buf_t)) == jtsdb.decode_records(bytes(buf_j))
    # a torn tail: both stores stop at the last whole record and truncate
    for mod, sub in ((ttsdb, "t"), (jtsdb, "j")):
        db = mod.TSDB(str(tmp_path / sub))
        for i, v in enumerate(values):
            db.append("x", None, 10.0 + i, v)
        path = db._series[mod.series_key("x", None)].path
        with open(path, "ab") as fh:
            fh.write(b"\x83\x41")
    reread = {sub: mod.TSDB(str(tmp_path / sub)).query("x")
              for mod, sub in ((ttsdb, "t"), (jtsdb, "j"))}
    assert reread["t"] == reread["j"] and len(reread["t"]) == len(values)


# -- the rule kinds -----------------------------------------------------------------
def _baseline(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 2, "backends": {"cpu": {"cases": {
        "100m_flash": {"mfu": 0.30}}}}}))
    return str(path)


def _scenario(kind, tmp_path):
    """(rules, samples(step) -> [(name, labels, value)]) for one kind."""
    if kind == "threshold":
        rules = [{"name": "gn", "kind": "threshold", "metric": "train_grad_norm",
                  "op": "gt", "value": 100.0, "agg": "latest", "for_s": 10}]
        return rules, lambda i: [("train_grad_norm", {"instance": "p0"}, 2.0),
                                 ("train_grad_norm", {"instance": "p1"},
                                  150.0 if 8 <= i < 20 else 1.0)]
    if kind == "ratio_threshold":
        rules = [{"name": "kv", "kind": "ratio_threshold",
                  "numerator": "serve_kv_blocks_free",
                  "denominator": "serve_kv_blocks_used", "op": "lt", "value": 0.05,
                  "agg": "latest", "for_s": 5}]
        return rules, lambda i: [("serve_kv_blocks_free", {}, 1.0 if i > 10 else 60.0),
                                 ("serve_kv_blocks_used", {}, 100.0)]
    if kind == "error_burn_rate":
        rules = [{"name": "burn", "kind": "error_burn_rate",
                  "metric": "serve_router_requests_total", "bad_label": "outcome",
                  "bad_values": ["error", "timeout"], "objective": 0.9,
                  "fast_window_s": 30, "slow_window_s": 60, "for_s": 10}]
        return rules, lambda i: [
            ("serve_router_requests_total", {"outcome": "ok"}, 10.0 * i),
            ("serve_router_requests_total", {"outcome": "error"},
             0.0 if i < 12 else 6.0 * (i - 12) if i < 24 else 72.0)]
    if kind == "latency_burn_rate":
        rules = [{"name": "lat", "kind": "latency_burn_rate", "metric": "serve_ttft_ms",
                  "threshold_ms": 100, "objective": 0.5, "fast_window_s": 30,
                  "slow_window_s": 60, "for_s": 0}]

        def lat(i):
            n = 4 * i
            under = n if i < 10 else 40 + (n - 40) // 5
            return [("serve_ttft_ms_bucket", {"le": "100"}, float(under)),
                    ("serve_ttft_ms_bucket", {"le": "+Inf"}, float(n)),
                    ("serve_ttft_ms_count", {}, float(n))]
        return rules, lat
    if kind == "goodput_floor":
        rules = [{"name": "gp", "kind": "goodput_floor", "metric": "goodput_seconds_total",
                  "floor": 0.6, "good_components": ["dispatch"], "window_s": 60,
                  "for_s": 10}]
        return rules, lambda i: [
            ("goodput_seconds_total", {"component": "dispatch"},
             4.5 * i if i < 15 else 67.5 + 1.0 * (i - 15)),
            ("goodput_seconds_total", {"component": "data_wait_s"},
             0.5 * i if i < 15 else 7.5 + 4.0 * (i - 15))]
    if kind == "zscore":
        rules = [{"name": "spike", "kind": "zscore", "metric": "train_loss", "z": 4.0,
                  "window_s": 600, "direction": "above", "min_points": 8, "for_s": 0}]
        return rules, lambda i: [("train_loss", {"instance": "p0"},
                                  9.0 if i == 22 else 2.0 + 0.001 * (i % 4))]
    if kind == "nonfinite":
        rules = [{"name": "nan", "kind": "nonfinite", "metric": "train_loss"},
                 {"name": "nf", "kind": "nonfinite", "metric": "train_nonfinite_total",
                  "window_s": 120}]
        return rules, lambda i: [
            ("train_loss", None, float("nan") if i in (9, 10) else 2.0),
            ("train_nonfinite_total", None, 0.0 if i < 16 else 1.0)]
    if kind == "baseline_drop":
        rules = [{"name": "mfu", "kind": "baseline_drop", "metric": "train_mfu",
                  "baseline_file": _baseline(tmp_path), "backend": "cpu",
                  "case": "100m_flash", "baseline_key": "mfu", "max_drop_frac": 0.5,
                  "window_s": 30, "min_points": 3, "for_s": 5}]
        return rules, lambda i: [("train_mfu", None, 0.26 if i < 12 else 0.11)]
    if kind == "flap":
        rules = [{"name": "flap", "kind": "flap", "metric": "serve_breaker_state",
                  "window_s": 40, "threshold": 4, "for_s": 0}]
        return rules, lambda i: [("serve_breaker_state", {"dest": "r0"},
                                  float(2 * (i % 2)) if 5 <= i < 12 else 0.0)]
    raise KeyError(kind)


KINDS = ["threshold", "ratio_threshold", "error_burn_rate", "latency_burn_rate",
         "goodput_floor", "zscore", "nonfinite", "baseline_drop", "flap"]


def _timeline(mod_tsdb, mod_alerts, rules, samples):
    db = mod_tsdb.TSDB()
    eng = mod_alerts.RuleEngine([dict(r) for r in rules], db)
    out = []
    for i in range(40):
        now = 1000.0 + 5.0 * i
        for name, labels, value in samples(i):
            db.append(name, labels, now, value)
        for tr in eng.evaluate(now):
            v = tr["value"]
            out.append({**tr, "value": "nan" if isinstance(v, float) and math.isnan(v)
                        else v})
    return out, eng.snapshot(), eng.firing()


@pytest.mark.parametrize("kind", KINDS)
def test_every_rule_kind_gives_jaxs_transitions(tmp_path, kind):
    rules, samples = _scenario(kind, tmp_path)
    assert talerts.validate_rules({"alerts": {"rules": rules}}) == []
    t = _timeline(ttsdb, talerts, rules, samples)
    j = _timeline(jtsdb, jalerts, rules, samples)
    assert json.dumps(t, sort_keys=True, default=str) == \
        json.dumps(j, sort_keys=True, default=str)
    assert any(tr["to"] == "firing" for tr in t[0]), t[0]


# -- configs/alerts.yaml -------------------------------------------------------------
def test_alerts_yaml_validates_in_both_packages(tmp_path, monkeypatch, capsys):
    assert talerts.main(["--validate", ALERTS_YAML]) == 0
    assert jalerts.main(["--validate", ALERTS_YAML]) == 0
    want = jalerts.load_rules(ALERTS_YAML)
    assert talerts.load_rules(ALERTS_YAML) == want
    assert talerts.KNOWN_METRICS == jalerts.KNOWN_METRICS
    assert talerts.ACTIONS == jalerts.ACTIONS
    bad = tmp_path / "bad.yaml"
    bad.write_text("alerts:\n  rules:\n    - name: x\n      kind: nope\n")
    assert talerts.main(["--validate", str(bad)]) == 1
    assert talerts.validate_rules(yaml_lite.safe_load(bad.read_text())) == \
        jalerts.validate_rules(yaml_lite.safe_load(bad.read_text()))
    # a host without PyYAML (the card's machine) validates it the same way
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert talerts.main(["--validate", ALERTS_YAML]) == 0
    assert talerts.load_rules(ALERTS_YAML) == want
    assert "OK (10 rule(s))" in capsys.readouterr().out


def test_yaml_reader_reads_every_config_as_pyyaml():
    import glob

    import yaml

    paths = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
    assert len(paths) > 20
    for path in paths:
        with open(path) as fh:
            text = fh.read()
        assert repr(yaml_lite.safe_load(text)) == repr(yaml.safe_load(text)), path
    doc = "a: [1, 'x y', \"q\\n\", 1e-05, 1.0e-05, .5, ~, yes, Off]\nb: {k: -3}\n"
    assert repr(yaml_lite.safe_load(doc)) == repr(yaml.safe_load(doc))
    for bad in ("a: &anchor 1\n", "a: |\n  text\n", "---\na: 1\n---\nb: 2\n"):
        with pytest.raises(ValueError):
            yaml_lite.safe_load(bad)


def _port_registries(tmp_path):
    """The metric names each port registry exports, once each has run."""
    import torch

    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
        CheckpointManager,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
    from mlx_cuda_distributed_pretraining_tpu_torch.obs.metrics import MetricsRegistry
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import (
        BatchEngine,
        EngineConfig,
        FleetRouter,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer
    from test_torch_train import _config_dict

    names = {}
    router = FleetRouter(["http://127.0.0.1:9"], ["http://127.0.0.1:10"])
    router.policy.allow("http://127.0.0.1:9")
    router.policy.publish()
    router._publish_pool_gauges()
    names["router"] = set(router.metrics_registry.snapshot())
    args = tl.LlamaArgs(vocab_size=259, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                        max_position_embeddings=128)
    eng = BatchEngine(tl.init_params(args, torch.Generator().manual_seed(0), device="cpu"),
                      args, TokenizerManager(),
                      EngineConfig(num_slots=2, max_len=128, prefill_chunk=32,
                                   stats_interval_s=0.0)).start()
    try:
        eng.generate("hello there", max_tokens=3)
    finally:
        eng.stop()
    names["engine"] = set(eng.metrics_registry.snapshot())
    d = _config_dict(tmp_path, name="names", iters=2)
    tr = Trainer(Config.from_dict(d), runs_root=str(tmp_path / "runs"), quiet=True,
                 device="cpu")
    names["trainer"] = set(tr.metrics.snapshot())
    reg = MetricsRegistry()
    CheckpointManager(str(tmp_path / "ck"), metrics=reg)
    names["checkpoint"] = set(reg.snapshot())
    return names


def test_every_metric_the_shipped_rules_name_is_exported_by_a_port_registry(tmp_path):
    exported = _port_registries(tmp_path)
    everything = set().union(*exported.values())
    missing = []
    for rule in talerts.load_rules(ALERTS_YAML):
        for field in ("metric", "numerator", "denominator"):
            name = rule.get(field)
            if name and name not in everything:
                missing.append((rule["name"], name))
    assert missing == []
    assert "serve_router_requests_total" in exported["router"]
    assert "serve_breaker_state" in exported["router"]
    assert {"serve_ttft_ms", "serve_kv_free_block_watermark", "serve_kv_blocks_free",
            "serve_kv_blocks_used"} <= exported["engine"]
    assert {"train_loss", "train_grad_norm", "train_nonfinite_total",
            "goodput_seconds_total", "train_mfu"} <= exported["trainer"]


# -- the collector ----------------------------------------------------------------------
class _Target:
    """A scrape target: Prometheus text on ``/metrics?format=prom``, JSON on
    ``/trace`` and ``/snapshot``."""

    def __init__(self, text):
        target = self
        self.text = text

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    body, ctype = target.text.encode(), "text/plain"
                else:
                    body, ctype = json.dumps({"path": self.path}).encode(), "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _tree(root):
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            out.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(out)


def test_collectors_write_the_same_series_alerts_and_bundle_layout(tmp_path):
    a = _Target('train_grad_norm{instance="x"} 5\n')
    b = _Target('serve_queue_depth 3\nserve_router_requests_total{outcome="ok"} 7\n')
    dead = f"http://127.0.0.1:{_free_port()}"
    rules = [{"name": "gn", "kind": "threshold", "metric": "train_grad_norm", "op": "gt",
              "value": 100.0, "for_s": 10, "actions": ["bundle"]}]
    out = {}
    try:
        for pkg, mod in (("torch", tscope), ("jax", jscope)):
            run = tmp_path / pkg
            cfg = mod.ScopeConfig(targets=[{"name": "a", "url": a.url},
                                           {"name": "b", "url": b.url},
                                           {"name": "dead", "url": dead}],
                                  run_dir=str(run), rules=rules)
            c = mod.Collector(cfg, now_fn=lambda: 1000.0)
            rounds = []
            for i in range(6):
                a.text = f'train_grad_norm{{instance="x"}} {500 if i >= 2 else 5}\n'
                res = c.collect_once(now=1000.0 + 5.0 * i)
                rounds.append((res["targets"], res["up"],
                               [(t["from"], t["to"]) for t in res["transitions"]]))
            events = [(e["type"], e.get("rule"), e.get("to_state"))
                      for e in map(json.loads, open(run / "events.jsonl"))]
            bundles = sorted(os.listdir(run / "bundles"))
            alert = json.load(open(run / "bundles" / bundles[0] / "alert.json"))
            out[pkg] = (rounds, c.db.keys(), events, bundles, _tree(run / "bundles"),
                        alert, c.alerts()["alerts"], _tree(run / "scope_tsdb"))
            up = c.registry.gauge("graftscope_scrape_up")
            assert up.value(instance="dead") == 0.0 and up.value(instance="a") == 1.0
    finally:
        a.close()
        b.close()
    assert out["torch"] == out["jax"]
    rounds, keys, events, bundles, tree = out["torch"][:5]
    assert ("alert", "gn", "firing") in events and ("bundle", "gn", None) in events
    assert "a/metrics.txt" in "\n".join(tree) and "b/snapshot.json" in "\n".join(tree)
    assert sorted(keys) == sorted([
        'serve_queue_depth{instance=b}', 'serve_router_requests_total{instance=b,outcome=ok}',
        'train_grad_norm{instance=a}'])


def test_scope_config_reads_the_serve_sample_as_jax(monkeypatch):
    path = os.path.join(REPO, "configs", "serve-sample.yaml")
    want = vars(jscope.ScopeConfig.from_yaml(path))
    assert vars(tscope.ScopeConfig.from_yaml(path)) == want
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert vars(tscope.ScopeConfig.from_yaml(path)) == want
    text = 'a_total{x="1",y="two"} 3\n# HELP h\nplain 1.5\nbad nope\n'
    assert tscope.parse_prom_text(text) == jscope.parse_prom_text(text)
    doc = {"queue_depth": 3, "tok/s": 12.5, "engine": "batch", "live": True}
    assert tscope.parse_json_metrics(doc) == jscope.parse_json_metrics(doc)


def test_supervisor_scope_sidecar_keeps_the_trainers_series(tmp_path):
    """A fresh supervised launch: the child's overwrite wipes the run dir
    after the supervisor starts, so a collector started with the supervisor
    (JAX's order) would append into a deleted directory and keep nothing;
    the port's sidecar starts at the child's first heartbeat."""
    from mlx_cuda_distributed_pretraining_tpu_torch.train.supervisor import (
        supervise_from_args,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import build_parser
    from test_torch_supervisor import _chaos_config

    d, _ = _chaos_config(tmp_path)
    d["logging"]["metrics_port"] = _free_port()
    d["scope"] = {"interval_s": 0.2, "scrape_timeout_s": 1.0}
    d["logging"]["steps"]["checkpoint_interval"] = 100
    cfg = tmp_path / "scoped.json"
    cfg.write_text(json.dumps(d))
    rules = tmp_path / "rules.yaml"
    rules.write_text("alerts:\n  rules:\n    - name: steps\n      kind: threshold\n"
                     "      metric: train_step\n      op: ge\n      value: 1\n"
                     "      actions: []\n")
    args = build_parser().parse_args(
        ["--config", str(cfg), "--runs-root", str(tmp_path / "runs"), "--run-name", "sc",
         "--device", "cpu", "--auto-resume", "--scope", "--alerts-config", str(rules),
         "--iters", "200"])
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    out = supervise_from_args(args)
    assert out["exit_code"] == 0
    run_dir = out["run_dir"]
    db = ttsdb.TSDB(os.path.join(run_dir, "scope_tsdb"))
    (key,) = db.select("train_step", {"instance": "trainer0"})
    labels = ttsdb.parse_series_key(key)[1]
    steps = db.query("train_step", labels)
    assert steps and steps[-1][1] >= 1
    kinds = [json.loads(line)["type"] for line in open(os.path.join(run_dir, "events.jsonl"))]
    assert "alert" in kinds
    # the JAX package's store reads the port's
    assert jtsdb.TSDB(os.path.join(run_dir, "scope_tsdb")).query(
        "train_step", labels) == steps


def test_monitor_status_line_equals_jax(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    lines = [
        "Step 1: loss=5.1234 | ppl=167.9 | lr=1.000e-04 | tok/s=1234 | toks=2048",
        "Step 2: loss=4.9 | ppl=134.3 | lr=2.000e-04 | tok/s=2345 | mfu=unknown",
        "Step 2 validation: val_loss=4.8",
        "some other line",
        "Step 3: loss=4.5 | lr=3.000e-04 | tok/s=3456 | mfu=0.412 | moe_entropy=1.2 "
        "| moe_drop=3 | ttft_ms_p50=40 | ttft_ms_p95=90",
    ]
    (run / "log.txt").write_text("\n".join(lines) + "\npartial")
    hb = {"t": time.time(), "step": 3, "pid": 1, "process_index": 0}
    (run / "heartbeat.json").write_text(json.dumps(hb))
    seen = {}
    for pkg, mod in (("torch", tmonitor), ("jax", jmonitor)):
        got = []
        tail = mod.monitor(str(run), interval=0.0, max_iters=2, on_status=got.append)
        seen[pkg] = (got, tail.steps, tail.val_losses, tail.other_lines,
                     mod.alerts_status({"alerts": [{"state": "firing", "rule": "x"}]}),
                     mod.find_latest_run(str(tmp_path)))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] and "val_loss=4.8000@2" in seen["torch"][0][0]


def test_dashboard_is_jaxs_byte_for_byte_and_served(tmp_path):
    assert tdash.DASHBOARD_HTML == jdash.DASHBOARD_HTML
    assert tdash.render_dashboard(9000) == jdash.render_dashboard(9000)
    p = tdash.write_dashboard(str(tmp_path / "d" / "index.html"), ws_port=9001)
    assert open(p).read() == jdash.render_dashboard(9001)
    srv = tdash.serve_dashboard("127.0.0.1", 0, ws_port=9002)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    assert body == jdash.render_dashboard(9002)
