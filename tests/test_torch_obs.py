"""The torch port's ``obs/`` modules against the JAX package's, on the CPU.

Each test drives the JAX module and the port's with the same inputs (a
seeded sequence of calls) and compares what comes out: registry snapshots
and quantiles, the Prometheus text (byte for byte), event logs and
heartbeats read across the two packages both ways, the goodput ledger, the
span tracer under an injected clock, the profile attribution on a
synthetic Chrome trace, the log parser, and the stats hub with either
package's client. The logger's TensorBoard sink writes an event file; a
missing W&B logs the JAX logger's message.
"""

import asyncio
import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.obs import events as jevents
from mlx_cuda_distributed_pretraining_tpu.obs import flops as jflops
from mlx_cuda_distributed_pretraining_tpu.obs import metrics as jmetrics
from mlx_cuda_distributed_pretraining_tpu.obs import plotting as jplotting
from mlx_cuda_distributed_pretraining_tpu.obs import profile_report as jreport
from mlx_cuda_distributed_pretraining_tpu.obs import prometheus as jprom
from mlx_cuda_distributed_pretraining_tpu.obs import stats_client as jclient
from mlx_cuda_distributed_pretraining_tpu.obs import stats_server as jserver
from mlx_cuda_distributed_pretraining_tpu.obs import trace as jtrace
from mlx_cuda_distributed_pretraining_tpu_torch.obs import events as tevents
from mlx_cuda_distributed_pretraining_tpu_torch.obs import flops as tflops
from mlx_cuda_distributed_pretraining_tpu_torch.obs import metrics as tmetrics
from mlx_cuda_distributed_pretraining_tpu_torch.obs import plotting as tplotting
from mlx_cuda_distributed_pretraining_tpu_torch.obs import profile_report as treport
from mlx_cuda_distributed_pretraining_tpu_torch.obs import prometheus as tprom
from mlx_cuda_distributed_pretraining_tpu_torch.obs import stats_client as tclient
from mlx_cuda_distributed_pretraining_tpu_torch.obs import stats_server as tserver
from mlx_cuda_distributed_pretraining_tpu_torch.obs import trace as ttrace
from mlx_cuda_distributed_pretraining_tpu_torch.obs.logger import Logger


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _drive_registry(reg, seed: int):
    """A seeded sequence of declarations and updates, labels that need
    escaping, a custom-bucket histogram, and more series than the bound."""
    rng = np.random.default_rng(seed)
    steps = reg.counter("train_steps_total", "optimizer steps")
    good = reg.counter("goodput_seconds_total", "seconds by component")
    loss = reg.gauge("train_loss", "last loss")
    load = reg.gauge("moe_expert_load_frac", "load by expert")
    lat = reg.histogram("serve_ttft_ms", "ttft", buckets=jmetrics.LATENCY_MS_BUCKETS)
    wait = reg.histogram("input_data_wait_seconds", "wait")
    for i in range(200):
        steps.inc(float(rng.integers(1, 5)))
        good.inc(float(rng.random()), component=str(rng.choice(["dispatch_s", "eval_s"])))
        loss.set(float(rng.normal()))
        load.set(float(rng.random()), expert=str(int(rng.integers(0, 8))),
                 note='quote "x" \\ back\nslash')
        lat.observe(float(rng.lognormal(3.0, 1.5)))
        wait.observe(float(rng.exponential(0.05)), shard=str(i % 3))
        reg.gauge("spill", "bounded").set(float(i), k=str(i))  # > 64 series
    return reg


def test_registry_snapshots_and_quantiles_match_jax():
    j = _drive_registry(jmetrics.MetricsRegistry(), 0)
    t = _drive_registry(tmetrics.MetricsRegistry(), 0)
    assert t.snapshot() == j.snapshot()
    assert t.snapshot()["_dropped_series"] > 0
    assert t.flat() == j.flat()
    assert t.sum_series("goodput_seconds_total") == j.sum_series("goodput_seconds_total")
    assert t.counter("goodput_seconds_total").value(component="eval_s") == \
        j.counter("goodput_seconds_total").value(component="eval_s")
    s = t.snapshot()["serve_ttft_ms"]["series"][0]
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert tmetrics.quantile_from_buckets(s["buckets"], s["count"], q) == \
            jmetrics.quantile_from_buckets(s["buckets"], s["count"], q)
    assert tmetrics.quantile_from_buckets([], 0, 0.5) is None
    assert tmetrics.LATENCY_MS_BUCKETS == jmetrics.LATENCY_MS_BUCKETS
    with pytest.raises(TypeError):
        t.counter("train_loss")  # declared as a gauge


@pytest.mark.parametrize("process_index", [None, 3])
def test_render_prometheus_byte_identical(process_index):
    snap = _drive_registry(tmetrics.MetricsRegistry(), 1).snapshot()
    text = tprom.render_prometheus(snap, process_index=process_index)
    assert text == jprom.render_prometheus(snap, process_index=process_index)
    assert r'note="quote \"x\" \\ back\nslash"' in text
    assert "serve_ttft_ms_bucket{le=\"+Inf\"}" in text


def test_metrics_server_scrape_equals_render_and_taken_port_gives_none():
    reg = _drive_registry(tmetrics.MetricsRegistry(), 2)
    srv = tprom.start_metrics_server(reg, 0, host="127.0.0.1", process_index=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        assert body == tprom.render_prometheus(reg.snapshot(), process_index=0)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/snapshot",
                                    timeout=30) as resp:
            assert json.loads(resp.read()) == json.loads(json.dumps(reg.snapshot()))
        # the port is taken: no server, no exception
        assert tprom.start_metrics_server(reg, srv.port, host="127.0.0.1") is None
    finally:
        srv.shutdown()


def _write_events(mod, path, seed: int):
    rng = np.random.default_rng(seed)
    log = mod.EventLog(path, now=lambda: 1000.0)
    log.append("run_start", name="r", total_steps=30)
    for i in range(1, 7):
        log.append("step_window", step=5 * i, steps=5, toks=int(rng.integers(100, 999)),
                   loss=float(rng.random()), goodput={"dispatch_s": float(rng.random()),
                                                      "other_s": 0.0})
        if i % 2 == 0:
            log.append("checkpoint_save", step=5 * i, seconds=0.5, blocking=True)
    log.append("eval", loss=1.5, seconds=0.1)
    log.close()
    mod.append_event(path, "fault", kind="hang", stalled_s=31.0)
    mod.append_event(path, "restart", lost_s=12.5, resume="20")
    mod.append_event(path, "run_end", step=30)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_events_and_heartbeat_read_across_packages(tmp_path, writer):
    """Either package's events.jsonl reads the same through both packages'
    iter_events, replay_into and tally, and JAX's read_heartbeat reads the
    port's heartbeat (and the other way round)."""
    w, r = (tevents, jevents) if writer == "port" else (jevents, tevents)
    path = tevents.events_path(str(tmp_path))
    assert path == jevents.events_path(str(tmp_path))
    _write_events(w, path, 0)
    assert list(r.iter_events(path)) == list(w.iter_events(path))
    assert r.tally(path) == w.tally(path) == {
        "steps": 30.0, "toks": r.tally(path)["toks"], "checkpoint_saves": 3.0,
        "evals": 1.0, "faults": 1.0, "restarts": 1.0, "events": 14.0}
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    assert jevents.replay_into(jreg, path) == tevents.replay_into(treg, path) == 14
    assert treg.snapshot() == jreg.snapshot()
    assert treg.counter("goodput_seconds_total").value(component="restart_lost_s") == 12.5

    hb = w.heartbeat_path(str(tmp_path))
    assert hb == r.heartbeat_path(str(tmp_path))
    w.write_heartbeat(hb, step=17, process_index=0)
    got = r.read_heartbeat(hb)
    assert got["step"] == 17 and got["pid"] == os.getpid() and got["process_index"] == 0
    assert r.read_fleet_heartbeats(str(tmp_path)) == w.read_fleet_heartbeats(str(tmp_path))


def test_event_log_round_trip_torn_line_and_rotation(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = tevents.EventLog(path, now=lambda: 5.0, max_bytes=400)
    written = [log.append("step_window", step=i, steps=1, toks=10) for i in range(12)]
    log.close()
    rotated = tevents.rotated_events_path(path)
    assert os.path.isfile(rotated) and os.path.getsize(path) <= 400
    with open(path, "a") as f:
        f.write('{"v": 1, "type": "step_win')  # a crash mid-append
    got = list(tevents.iter_events(path))
    assert got == list(jevents.iter_events(path))
    # one rotation depth: the newest events survive, in order, torn tail skipped
    assert got == written[-len(got):] and len(got) >= 4
    assert tevents.read_heartbeat(str(tmp_path / "missing.json")) is None


def test_goodput_ledger_matches_jax():
    rng = np.random.default_rng(3)
    j, t = jflops.GoodputLedger(), tflops.GoodputLedger()
    assert tflops.GOODPUT_COMPONENTS == jflops.GOODPUT_COMPONENTS
    for _ in range(6):
        for _ in range(int(rng.integers(1, 9))):
            comp = str(rng.choice(tflops.GOODPUT_COMPONENTS))
            secs = float(rng.normal(0.2, 0.3))  # negative bookings clamp to 0
            j.add(comp, secs)
            t.add(comp, secs)
        assert t.window_view() == j.window_view()
        elapsed = float(rng.uniform(0.0, 3.0))  # sometimes under the booked sum
        wt, wj = t.close_window(elapsed), j.close_window(elapsed)
        assert wt == wj and wt["other_s"] >= 0.0
    assert t.totals() == j.totals()
    with pytest.raises(KeyError):
        t.add("nap_s", 1.0)


class _Clock:
    """An injected ``time`` for both tracers: perf_counter and time advance
    together by a fixed tick each call."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.00123
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _drive_tracer(mod, monkeypatch, capacity=16, sample=0.5):
    monkeypatch.setattr(mod, "time", _Clock())
    tr = mod.Tracer("svc", capacity=capacity, sample=sample)
    ids = ["%032x" % (0x1234567 * (i + 1) ** 5 % (1 << 128)) for i in range(10)]
    for i, tid in enumerate(ids):
        with tr.span("request", trace_id=tid, req=i):
            tr.instant("kv_alloc", trace_id=tid, slot=i % 3)
        tr.complete("dispatch", 0.25 * i, step=i, seconds=0.25 * i)
        s = tr.span("decode", ticks=i)
        s.end(extra=i)
        s.end()  # idempotent
    return tr, ids


def test_tracer_matches_jax_with_injected_clock(monkeypatch):
    jt, ids = _drive_tracer(jtrace, monkeypatch)
    tt, _ = _drive_tracer(ttrace, monkeypatch)
    assert tt.chrome_trace() == jt.chrome_trace()
    assert tt.stats() == jt.stats() and tt.stats()["dropped"] > 0  # the ring wrapped
    assert [ttrace.sampled(i, s) for i in ids for s in (0.0, 0.3, 0.7, 1.0)] == \
        [jtrace.sampled(i, s) for i in ids for s in (0.0, 0.3, 0.7, 1.0)]
    docs = [tt.chrome_trace(), jt.chrome_trace(clear=True)]
    assert ttrace.merge_chrome_traces(docs) == jtrace.merge_chrome_traces(docs)
    assert tt.drain() != [] and tt.drain() == []
    off = ttrace.Tracer("off", enabled=False)
    assert off.span("x") is ttrace._NULL_SPAN and off.stats()["recorded"] == 0
    assert ttrace.TRACE_HEADER == jtrace.TRACE_HEADER == "X-Trace-Id"
    assert len(ttrace.new_trace_id()) == 32


# op names the two classifiers put in the same class (XLA's names)
_SHARED_OPS = ["fusion.1", "dot.3", "custom-call.flash_fwd", "gmm_kernel.2",
               "all-gather-start.4", "all-reduce.1", "infeed.0", "copy.9",
               "reduce-scatter-done.2", "convolution.7"]


def _synthetic_trace(path, seed: int):
    """Three steps, two device lanes, overlapping compute and comm, host
    transfers and gaps; every op carries both packages' device markers
    (``cat: kernel`` and ``args.hlo_op``), every step both step markers."""
    rng = np.random.default_rng(seed)
    events = []
    t = 0.0
    for step in range(3):
        dur = 1000.0 + 200.0 * step
        events.append({"ph": "X", "name": f"ProfilerStep#{step + 10}", "cat": "user_annotation",
                       "ts": t, "dur": dur, "pid": 1, "tid": 1,
                       "args": {"step_num": step + 10}})
        for dev in (7, 8):
            for _ in range(12):
                name = str(rng.choice(_SHARED_OPS))
                ts = t + float(rng.uniform(-50, dur))
                events.append({"ph": "X", "name": name, "cat": "kernel", "ts": ts,
                               "dur": float(rng.uniform(5, 200)), "pid": dev, "tid": 7,
                               "args": {"hlo_op": name}})
        t += dur + 50.0
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_profile_report_attribution_matches_jax(tmp_path):
    path = str(tmp_path / "host.trace.json")
    _synthetic_trace(path, 4)
    analytic = {"tokens_per_step": 4096.0, "matmul_flops_per_token": 6e6,
                "attn_flops_per_token": 1e6}
    j = jreport.attribute([path], analytic=analytic, top_k=20)
    t = treport.attribute([path], analytic=analytic, top_k=20)
    assert t["n_devices"] == j["n_devices"] == 2
    assert [s["step"] for s in t["steps"]] == [s["step"] for s in j["steps"]] == [10, 11, 12]

    def close(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                close(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                close(x, y)
        elif isinstance(a, float):
            assert abs(a - b) <= 1e-12, (a, b)
        else:
            assert a == b

    close(t, j)
    for s in t["steps"]:
        total = s["compute_frac"] + s["comm_frac"] + s["host_frac"] + s["idle_frac"]
        assert abs(total - 1.0) <= 1e-12
    assert treport.prof_fields(t) == jreport.prof_fields(j)
    assert treport.PROF_FIELDS == jreport.PROF_FIELDS


@pytest.mark.parametrize("name,want", [
    ("void flash_fwd_bf16_wgmma_kernel<64, 2, 1, 0>(CUtensorMap, CUtensorMap)",
     ("compute", "flash")),
    ("void flash_bwd_dq_bf16_wgmma_kernel<64, 64, 2, 1, 0>(CUtensorMap)", ("compute", "flash")),
    ("void flash_bwd_dkv_f32_kernel<64>(FlashArgs)", ("compute", "flash")),
    ("void gmm_bf16_wgmma_kernel<2, 128, 4, false>(CUtensorMap, int const*)",
     ("compute", "gmm")),
    ("void (anonymous namespace)::tgmm_bf16_wgmma_kernel<128, 2, 4>(CUtensorMap, int)",
     ("compute", "gmm")),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16_wgmma_kernel<64, 128, 2, 0>"
     "(CUtensorMap)", ("compute", "flash")),
    ("void tgmm_bf16_wgmma_kernel<128, 2, 4>(CUtensorMap)", ("compute", "gmm")),
    ("void gmm_int8_wgmma_kernel<2, 128, 4>(CUtensorMap)", ("compute", "gmm")),
    ("gmm_f32_decode_kernel", ("compute", "gmm")),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopB_TNT", ("compute", "matmul")),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", ("compute", "matmul")),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_32x1_nn>"
     "(Params)", ("compute", "matmul")),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     ("comm", "all-reduce")),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     ("comm", "all-gather")),
    ("Memcpy HtoD (Pinned -> Device)", ("host", "host")),
    ("Memcpy DtoH (Device -> Pageable)", ("host", "host")),
    ("Memcpy DtoD (Device -> Device)", ("compute", "other")),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
     "(int, at::native::CUDAFunctor_add<float>)", ("compute", "other")),
])
def test_classify_cuda_kernel_names(name, want):
    assert treport.classify_op(name) == want
    if "wgmma_kernel" in name:  # the op table's row is the kernel's own name
        import re

        assert treport.base_op_name(name) == re.search(r"\w+_wgmma_kernel", name).group(0)


def test_profile_report_extends_steps_to_their_device_ops(tmp_path):
    """A torch.profiler-shaped trace: host step markers (TrainStep#N), the
    launches inside them, and kernels that run after the marker ends. Each
    kernel counts to the step that launched it, and each step's fractions
    still sum to 1."""
    ev = []
    for i, step in enumerate((5, 6)):
        t0 = 1000.0 * i
        ev.append({"ph": "X", "cat": "user_annotation", "name": f"TrainStep#{step}",
                   "ts": t0, "dur": 300.0, "pid": 1, "tid": 1})
        for k in range(3):
            corr = 10 * step + k
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": t0 + 50.0 * (k + 1), "dur": 5.0, "pid": 1, "tid": 1,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "ts": t0 + 400.0 + 100.0 * k,
                       "dur": 80.0, "pid": 0, "tid": 7, "args": {"correlation": corr},
                       "name": "void gmm_bf16_wgmma_kernel<2, 128, 4, false>(CUtensorMap)"})
        ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                   "ts": t0 + 10.0, "dur": 20.0, "pid": 0, "tid": 9, "args": {}})
    path = tmp_path / "h.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rep = treport.generate_report(str(tmp_path), top_k=5)
    assert [s["step"] for s in rep["steps"]] == [5, 6]
    for s in rep["steps"]:
        assert s["dur_s"] == pytest.approx(680e-6)
        assert abs(s["compute_frac"] + s["comm_frac"] + s["host_frac"]
                   + s["idle_frac"] - 1.0) <= 1e-12
    ops = {o["op"]: o for o in rep["ops"]}
    assert ops["gmm_bf16_wgmma_kernel"]["count"] == 6
    assert ops["gmm_bf16_wgmma_kernel"]["family"] == "gmm"
    assert ops["memcpy htod"]["category"] == "host"


def test_plotting_parses_a_port_log_as_jax(tmp_path):
    log = Logger(str(tmp_path), quiet=True)
    rng = np.random.default_rng(5)
    for step in range(5, 35, 5):
        log.log_metrics(step, {"loss": float(rng.random() + 2), "ppl": 9.0, "lr": 3e-4,
                               "tok/s": 1234.5, "toks": 4096, "mfu": "unknown",
                               "data_wait_s": 0.001, "h2d_wait_s": 0.0,
                               "dispatch_s": 0.5, "compile_s": 0.0, "ckpt_save_s": 0.0,
                               "eval_s": 0.0, "other_s": 0.01, "data_wait_frac": 0.002})
        if step % 10 == 0:
            log.log_validation(step, float(rng.random() + 2))
    log.close()
    path = str(tmp_path / "log.txt")
    t_steps, t_metrics = tplotting.parse_log(path)
    assert (t_steps, t_metrics) == jplotting.parse_log(path)
    assert t_steps == [5, 10, 15, 20, 25, 30] and t_metrics["mfu"] == [None] * 6
    assert tplotting.ema(t_metrics["loss"], 0.3) == jplotting.ema(t_metrics["loss"], 0.3)
    a = tplotting.write_csv(str(tmp_path / "t.csv"), t_steps, t_metrics)
    b = jplotting.write_csv(str(tmp_path / "j.csv"), t_steps, t_metrics)
    assert open(a).read() == open(b).read()
    tplotting.plot_run(str(tmp_path))
    assert os.path.isfile(tmp_path / "metrics.csv")


def test_logger_tensorboard_and_missing_wandb(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config

    cfg = Config.from_dict({"name": "tb", "logging": {"tensorboard": True, "wandb": True}})
    log = Logger(str(tmp_path), cfg, quiet=True)
    log.log_metrics(1, {"loss": 2.0, "tok/s": 10.0, "mfu": "unknown"})
    log.log_validation(1, 1.5)
    log.close()
    tb = tmp_path / "tensorboard"
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(tb))
    text = open(tmp_path / "log.txt").read()
    try:
        import wandb  # noqa: F401
    except ImportError:
        assert "wandb requested but unavailable; continuing without it" in text


class _Hub:
    """A stats server on its own event loop thread."""

    def __init__(self, mod):
        self.port = _free_port()
        self.server = mod.StatsServer(host="127.0.0.1", port=self.port)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        time.sleep(0.5)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.serve())

    def close(self):
        self.loop.call_soon_threadsafe(self.server.stop)
        self.thread.join(timeout=10)


def _publish(mod, url):
    client = mod.StatsClient(url, "worker-a", heartbeat_interval=0.5).start()
    client.register({"devices": 1})
    for step in range(3):
        client.log_metrics(step, {"loss": 3.0 - step, "tok/s": 1000.0 + step,
                                  "mfu": 0.25, "data_wait_frac": 0.01})
    return client


def _state_view(state):
    """The server state without its clocks."""
    workers = {w: {k: v for k, v in d.items() if k not in ("registered_at", "last_seen")}
               for w, d in state.workers.items()}
    history = [{k: v for k, v in h.items() if k != "t"} for h in state.history]
    return workers, history, state.aggregated()


@pytest.mark.parametrize("direction", ["port-client-to-jax-server", "jax-client-to-port-server"])
def test_stats_client_and_server_interoperate(direction):
    pytest.importorskip("websockets")
    client_mod, server_mod = ((tclient, jserver) if direction.startswith("port")
                              else (jclient, tserver))
    hub = _Hub(server_mod)
    try:
        client = _publish(client_mod, f"ws://127.0.0.1:{hub.port}")
        deadline = time.time() + 10
        while time.time() < deadline and \
                hub.server.state.workers.get("worker-a", {}).get("step") != 2:
            time.sleep(0.05)
        client.close()
    finally:
        hub.close()
    got = _state_view(hub.server.state)
    # the same messages handled by the other package's state directly
    other = (tserver if server_mod is jserver else jserver).StatsState()
    other.handle({"type": "register", "worker_id": "worker-a",
                  "capabilities": {"devices": 1}})
    for step in range(3):
        other.handle({"type": "metrics", "worker_id": "worker-a", "step": step,
                      "data": {"loss": 3.0 - step, "tok/s": 1000.0 + step,
                               "mfu": 0.25, "data_wait_frac": 0.01}})
    assert got == _state_view(other)
    assert got[2]["max_step"] == 2 and got[2]["mean_mfu"] == 0.25


def test_stats_client_buffers_without_a_hub():
    client = tclient.StatsClient(f"ws://127.0.0.1:{_free_port()}", "w",
                                 reconnect_delay=0.1).start()
    for i in range(5):
        client.log_metrics(i, {"loss": 1.0})
    time.sleep(0.5)
    client.close()
    assert len(client._buffer) == 5 and client.sent == 0
