"""The torch port's disaggregated serving fleet (``serve/fleet.py``, the
server's ``/prefill`` and ``/adopt_kv``, the engine's prefill-only
requests) against the JAX package's, on the CPU.

- Membership files written by either package are read by the other.
- A 1 prefill + 1 decode fleet of each package (the same tiny MoE weights,
  carried across with ``convert.params_from_jax``) serves the same
  requests: the handoffs' greedy texts equal the JAX fleet's and those of
  one port engine serving alone.
- An adopted chain recomputes only the prompt tokens past its last full
  block, as in JAX, and the decode engine's first token and logprob equal a
  local prefill's.
- A rolling swap hands no KV across weight versions: a prompt sent while
  only the decode pool has swapped, and one sharing its prefix after the
  rollout, decode as a fresh engine on the new weights does.
- Autoscale decisions and rolling swaps (canary, promotion, halt) over the
  same stub replicas equal JAX's.
- ``python -m ...serve.fleet`` routes a request, answers ``/metrics`` and
  exits on SIGINT.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import pytest
from test_torch_router import FIELDS, FLEET_PROMPTS, SEED, SHARED, _fleet, _post
from test_torch_serve import MAX_TOKENS, _random_params

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.serve import fleet as jfleet
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer import server as tserver
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.serve import fleet as tfleet
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEETS = {"jax": jfleet, "torch": tfleet}


@pytest.fixture(scope="module")
def np_params():
    return _random_params(jl.LlamaArgs(**FIELDS), seed=SEED)


# -- membership -------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_membership_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    w, r = FLEETS[writer], FLEETS[reader]
    fdir = str(tmp_path / "fleet")
    assert r.fleet_generation(fdir) == 0
    w.register_replica(fdir, "http://127.0.0.1:8451/", role="prefill", index=0)
    w.register_replica(fdir, "http://127.0.0.1:8452", role="decode", index=1)
    stale = w.register_replica(fdir, "http://127.0.0.1:8453", role="decode", index=2)
    rec = json.load(open(stale))
    rec["t"] -= 3600.0
    json.dump(rec, open(stale, "w"))
    w.register_replica(fdir, "http://127.0.0.1:9999", role="decode", index=0,
                       generation=7)
    view_w = w.read_fleet(fdir, stale_after_s=10.0, generation=1)
    view_r = r.read_fleet(fdir, stale_after_s=10.0, generation=1)
    assert view_r == view_w
    assert [(m["index"], m["role"], m["alive"]) for m in view_r["members"]] == [
        (0, "prefill", True), (1, "decode", True), (2, "decode", False)]
    assert r.fleet_generation(fdir) == w.fleet_generation(fdir) == 7
    # the heartbeat re-stamps the file in the other package's format
    stop = r.start_heartbeat(fdir, "http://127.0.0.1:8454", role="decode", index=3,
                             interval_s=0.05, generation=7)
    try:
        path = os.path.join(fdir, "members", "gen_7_p3.json")
        t0 = json.load(open(path))["t"]
        for _ in range(100):
            if json.load(open(path))["t"] > t0:
                break
            time.sleep(0.02)
        members = w.read_fleet(fdir)["members"]
        assert [m["url"] for m in members] == ["http://127.0.0.1:9999",
                                              "http://127.0.0.1:8454"]
        assert all(m["alive"] for m in members)
        with open(path, "rb") as fh:
            raw = fh.read()
        assert raw == json.dumps(json.loads(raw), sort_keys=True).encode()
    finally:
        stop.set()


def test_fleet_config_reads_the_serve_sample_as_jax(monkeypatch):
    path = os.path.join(REPO, "configs", "serve-sample.yaml")
    want = vars(jfleet.FleetConfig.from_yaml(path))
    assert vars(tfleet.FleetConfig.from_yaml(path)) == want
    monkeypatch.setitem(sys.modules, "yaml", None)  # a host without PyYAML
    assert vars(tfleet.FleetConfig.from_yaml(path)) == want


# -- the handoff ------------------------------------------------------------------
def _served_texts(url, prompts):
    out = []
    for p in prompts:
        code, _, raw = _post(url, {"prompt": p, "max_tokens": MAX_TOKENS}, timeout=300.0)
        assert code == 200
        out.append(json.loads(raw))
    return out


def test_handoff_greedy_tokens_equal_jax_fleet_and_one_engine(np_params):
    prompts = FLEET_PROMPTS
    results, stats = {}, {}
    for pkg in ("torch", "jax"):
        services, router, rhttpd = _fleet(pkg, np_params)
        try:
            url = f"http://127.0.0.1:{rhttpd.server_address[1]}"
            results[pkg] = _served_texts(url, prompts)
            (pre, _, _), (dec, _, _) = services
            stats[pkg] = (router._mc_handoffs.value(outcome="ok"),
                          dec.engine.metrics_registry.counter(
                              "serve_kv_transfer_blocks_total").value(kind="adopted"),
                          pre.engine.metrics()["completed"],
                          [int(r["prefix_cached_tokens"]) for r in results[pkg]])
        finally:
            rhttpd.shutdown()
            rhttpd.server_close()
            router.stop()
            for svc, httpd, _ in services:
                httpd.shutdown()
                httpd.server_close()
                svc.close()
    alone = tserver.InferenceService(params_from_jax(np_params, "cpu"),
                                     tl.LlamaArgs(**FIELDS), TokenizerManager(),
                                     run_name="tiny")
    alone.attach_engine(EngineConfig(num_slots=2, max_len=128, prefill_chunk=32,
                                     block_size=16, prefix_cache=False))
    try:
        single = [alone.generate(p, max_tokens=MAX_TOKENS) for p in prompts]
    finally:
        alone.close()
    assert [r["text"] for r in results["torch"]] == [r["text"] for r in results["jax"]]
    assert [r["text"] for r in results["torch"]] == [r["text"] for r in single]
    assert stats["torch"] == stats["jax"]
    handoffs, adopted, prefills, cached = stats["torch"]
    assert handoffs == 3 and prefills == 3 and adopted > 0
    assert cached[0] > 0 and cached[1] > 0 and cached[4] > 0
    assert cached[2] == cached[3] == 0  # under handoff_min_prompt_bytes


@pytest.mark.parametrize("prompt_len", [47, 48, 49, 100])
def test_adopted_chain_recomputes_only_the_last_prompt_token(np_params, prompt_len):
    """The decode side of a handoff adopts every full block but the one
    holding the last prompt token, so it prefills at most one block (the
    last token's logits seed sampling); its first token and logprob equal a
    local prefill's within the serving tolerance, and the cached count is
    JAX's. (The random tiny model's greedy margins along these prompts are
    not measured, so the texts are compared within the port only;
    test_handoff_greedy_tokens_equal_jax_fleet_and_one_engine compares
    them across packages on prompts whose margins are.)"""
    prompt = (SHARED * 3)[:prompt_len - 1]  # + BOS = prompt_len tokens
    cfg = dict(num_slots=2, max_len=128, prefill_chunk=32, block_size=16,
               prefix_cache=True)
    params = params_from_jax(np_params, "cpu")
    args, tok = tl.LlamaArgs(**FIELDS), TokenizerManager()
    pre = BatchEngine(params, args, tok, EngineConfig(role="prefill", **cfg)).start()
    dec = BatchEngine(params, args, tok, EngineConfig(role="decode", **cfg)).start()
    local = BatchEngine(params, args, tok, EngineConfig(**cfg)).start()
    try:
        req = pre.submit(prompt, max_tokens=1, prefill_only=True)
        assert req.wait(120) and req.error is None
        assert req.result["finish_reason"] == "prefill" and req.result["tokens"] == 0
        payload = pre.export_kv(req.prompt_ids)
        assert payload.num_blocks == prompt_len // 16
        dec.adopt_kv(payload)
        chunks0 = dec.prefill_chunks
        out = dec.generate(prompt, max_tokens=4)
        ref = local.generate(prompt, max_tokens=4)
        assert dec.metrics()["role"] == "decode"
    finally:
        for e in (pre, dec, local):
            e.stop()
    full = (prompt_len - 1) // 16 * 16
    assert out["prefix_cached_tokens"] == full
    assert dec.prefill_chunks - chunks0 == 1  # prompt_len - full <= 16 tokens
    assert out["token_ids"] == ref["token_ids"]
    assert abs(out["logprobs"][0] - ref["logprobs"][0]) <= 1e-5
    # the JAX engines adopt the same extent
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jargs, jtok = jl.LlamaArgs(**FIELDS), JTok(DataConfig())
    jpre = JEngine(jparams, jargs, jtok, JConfig(role="prefill", **cfg)).start()
    jdec = JEngine(jparams, jargs, jtok, JConfig(role="decode", **cfg)).start()
    try:
        jreq = jpre.submit(prompt, max_tokens=1, prefill_only=True)
        assert jreq.wait(120)
        jdec.adopt_kv(jpre.export_kv(jreq.prompt_ids))
        jout = jdec.generate(prompt, max_tokens=4)
    finally:
        jpre.stop()
        jdec.stop()
    assert int(jout["prefix_cached_tokens"]) == full


def test_a_weight_swap_empties_the_prefix_cache(np_params):
    """After a swap, a prompt whose blocks the old weights cached decodes as
    a fresh engine on the new weights does (JAX's engine keeps the cached
    blocks, and adopts KV of the old weights)."""
    other = _random_params(jl.LlamaArgs(**FIELDS), seed=0)
    cfg = EngineConfig(num_slots=2, max_len=128, prefill_chunk=32, block_size=16,
                       prefix_cache=True)
    args, tok = tl.LlamaArgs(**FIELDS), TokenizerManager()
    eng = BatchEngine(params_from_jax(np_params, "cpu"), args, tok, cfg).start()
    fresh = BatchEngine(params_from_jax(other, "cpu"), args, tok, cfg).start()
    try:
        prompt = FLEET_PROMPTS[0]
        eng.generate(prompt, max_tokens=MAX_TOKENS)
        assert eng.pool.prefix.cached_blocks > 0
        assert eng.swap_params(params_from_jax(other, "cpu")) == 1
        assert eng.pool.prefix.cached_blocks == 0
        out = eng.generate(prompt, max_tokens=MAX_TOKENS)
        want = fresh.generate(prompt, max_tokens=MAX_TOKENS)
    finally:
        eng.stop()
        fresh.stop()
    assert out["prefix_cached_tokens"] == 0
    assert out["token_ids"] == want["token_ids"]


def test_a_rolling_swap_leaves_no_stale_kv_in_the_decode_replicas(np_params, tmp_path):
    """A rolling swap takes the decode pool first, so for a while the prefill
    replica serves the old weights and the decode replica the new ones. A
    prompt sent then, and one sharing its prefix after the rollout, decode
    as a fresh engine on the new weights does: the router hands nothing off
    across the two versions, and a push computed on the old weights, sent
    straight to the swapped replica, adopts nothing."""
    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
        CheckpointManager,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.serve.kv_transfer import push_payload

    new = params_from_jax(_random_params(jl.LlamaArgs(**FIELDS), seed=0), "cpu")
    run_dir = str(tmp_path / "runs" / "new")
    CheckpointManager(run_dir).save(1, new)
    window = (SHARED * 2)[:96] + "during the swap"
    later = (SHARED * 2)[:96] + "after the rollout"
    fresh = BatchEngine(new, tl.LlamaArgs(**FIELDS), TokenizerManager(),
                        EngineConfig(num_slots=2, max_len=128, prefill_chunk=32,
                                     block_size=16, prefix_cache=False)).start()
    services, router, rhttpd = _fleet("torch", np_params)
    url = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    (pre, _, _), (dec, _, dec_url) = services
    ctl = tfleet.FleetController(router, tfleet.FleetConfig())
    try:
        router.poll_once()
        first = ctl.rolling_swap(run_dir=run_dir, canary_requests=0, roles=("decode",))
        out_window = _served_texts(url, [window])[0]
        # an old-weights push straight to the swapped decode replica
        req = pre.engine.submit(window, max_tokens=1, prefill_only=True)
        assert req.wait(120) and req.error is None
        payload = pre.engine.export_kv(req.prompt_ids)
        pushed = push_payload(dec_url, payload)
        second = ctl.rolling_swap(run_dir=run_dir, canary_requests=0, roles=("prefill",))
        out_later = _served_texts(url, [later])[0]
        handoffs = {o: router._mc_handoffs.value(outcome=o)
                    for o in ("ok", "version_skew")}
        skew = dec.engine.metrics_registry.counter(
            "serve_kv_transfer_failures_total").value(reason="version_skew")
        want = [fresh.generate(p, max_tokens=MAX_TOKENS)["token_ids"]
                for p in (window, later)]
    finally:
        fresh.stop()
        rhttpd.shutdown()
        rhttpd.server_close()
        router.stop()
        for svc, httpd, _ in services:
            httpd.shutdown()
            httpd.server_close()
            svc.close()
    assert [s["replica"] for s in first["swapped"]] == ["r1"] and not first["failed"]
    assert [s["replica"] for s in second["swapped"]] == ["r0"] and not second["failed"]
    assert out_window["token_ids"] == want[0]
    assert out_later["token_ids"] == want[1]
    # the later prompt reused the prefix that the decode replica computed
    # on the new weights during the swap
    assert int(out_later["prefix_cached_tokens"]) > 0
    assert handoffs == {"ok": 1, "version_skew": 1}
    assert payload.params_version == 0 and payload.num_blocks > 0
    assert pushed == {"adopted": 0, "reused": 0, "skipped": payload.num_blocks}
    assert skew == 1


# -- lifecycle over stub replicas ---------------------------------------------------
class _StubReplica:
    """An HTTP replica without a model: ``/metrics`` from a dict, the admin
    endpoints change it, a swap bumps ``params_version`` or fails on
    demand (JAX ``tests/test_fleet.py``'s stub)."""

    def __init__(self, role="decode"):
        self.state = {"queue_depth": 0, "batch_occupancy": 0, "role": role,
                      "draining": False, "params_version": 0,
                      "kv_blocks_free": 64, "kv_num_blocks": 64,
                      "kv_free_watermark": 64}
        self.fail_swap = False
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200, stub.state)

            def do_POST(self):
                path = self.path.rstrip("/")
                self.rfile.read(int(self.headers.get("Content-Length", "0") or 0))
                if path in ("/admin/drain", "/admin/undrain"):
                    stub.state["draining"] = path == "/admin/drain"
                    self._reply(200, {"draining": stub.state["draining"]})
                elif path == "/admin/swap_weights":
                    if stub.fail_swap:
                        self._reply(500, {"error": "bad checkpoint"})
                        return
                    stub.state["params_version"] += 1
                    self._reply(200, {"swapped": True,
                                      "params_version": stub.state["params_version"]})
                else:
                    self._reply(404, {"error": path})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# (queue depth, free-block watermark) of the decode pool's first replica,
# one autoscale tick each
GAUGE_SCRIPT = [(0, 64), (20, 64), (20, 64), (0, 64), (0, 64), (0, 64), (0, 2),
                (0, 64), (0, 64), (0, 64), (0, 64)]


@pytest.mark.parametrize("pool", ["decode", "prefill"])
def test_autoscale_decisions_equal_jax_under_the_same_gauges(pool):
    actions, calls = {}, {}
    for pkg, mod in FLEETS.items():
        first, spare = _StubReplica(role=pool), _StubReplica(role=pool)
        router = (mod.FleetRouter([], [first.url]) if pool == "decode"
                  else mod.FleetRouter([first.url], []))
        spawned, stopped = [], []
        ctl = mod.FleetController(
            router, mod.FleetConfig(scale_up_queue_depth=8, scale_down_idle_ticks=2,
                                    min_replicas_per_pool=1, max_replicas_per_pool=2,
                                    scale_up_kv_free_frac=0.05, drain_timeout_s=5.0),
            spawn_fn=lambda role, s=spare, log=spawned: (log.append(role), s.url)[1],
            stop_fn=stopped.append)
        seen = []
        try:
            for depth, watermark in GAUGE_SCRIPT:
                first.state["queue_depth"] = depth
                first.state["kv_free_watermark"] = watermark
                router.poll_once()
                seen.append([a.replace(spare.url, "SPARE") for a in ctl.autoscale_tick()])
                seen.append(sorted((p, s["live"], s["queue_depth"], s["kv_free_frac"])
                                   for p, s in ctl.pool_stats().items()))
        finally:
            first.close()
            spare.close()
            router.stop()
        actions[pkg] = seen
        calls[pkg] = (spawned, [u == spare.url for u in stopped], spare.state["draining"])
    assert actions["torch"] == actions["jax"]
    assert calls["torch"] == calls["jax"]
    flat = [a for step in actions["torch"][::2] for a in step]
    assert any(a.startswith(f"spawn {pool}") for a in flat)
    assert any(a.startswith(f"drain {pool}") for a in flat)


@pytest.mark.parametrize("case", ["promote", "halt"])
def test_rolling_swap_canary_and_halt_as_jax(case):
    out = {}
    for pkg, mod in FLEETS.items():
        d0, d1, p0 = _StubReplica(), _StubReplica(), _StubReplica(role="prefill")
        router = mod.FleetRouter([p0.url], [d0.url, d1.url], canary_fraction=0.5)
        ctl = mod.FleetController(router, mod.FleetConfig())
        router.poll_once()
        stop = threading.Event()

        def traffic(r=router):
            # deliveries tick the canary's ok counter, as the router's pipe does
            while not stop.wait(0.01):
                for rep in r.replicas.values():
                    if rep.canary:
                        rep.ok_count += 1

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            if case == "halt":
                d0.fail_swap = True
            res = ctl.rolling_swap(model_path="new.safetensors", canary_requests=3,
                                   canary_timeout_s=10.0)
            out[pkg] = ([s["replica"] for s in res["swapped"]],
                        [(s["replica"], s["params_version"]) for s in res["swapped"]],
                        [f["replica"] for f in res["failed"]],
                        [s.state["params_version"] for s in (d0, d1, p0)],
                        any(r.canary for r in router.replicas.values()))
        finally:
            stop.set()
            t.join(timeout=2.0)
            for s in (d0, d1, p0):
                s.close()
            router.stop()
    assert out["torch"] == out["jax"]
    if case == "promote":
        assert out["torch"][0] == ["r1", "r2", "r0"] and out["torch"][3] == [1, 1, 1]
    else:
        assert out["torch"][2] == ["r1"] and out["torch"][3] == [0, 0, 0]


def test_fleet_main_routes_answers_metrics_and_exits_on_sigint(np_params, tmp_path):
    services = []
    for i, role in enumerate(("prefill", "decode")):
        svc = tserver.InferenceService(params_from_jax(np_params, "cpu"),
                                       tl.LlamaArgs(**FIELDS), TokenizerManager(),
                                       run_name="tiny")
        svc.attach_engine(EngineConfig(num_slots=2, max_len=128, prefill_chunk=32,
                                       block_size=16, role=role))
        httpd = tserver.serve(svc, port=0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        tfleet.register_replica(str(tmp_path / "fleet"), url, role=role, index=i)
        services.append((svc, httpd))
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.serve.fleet",
         "--fleet-dir", str(tmp_path / "fleet"), "--port", str(port)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        for _ in range(300):
            try:
                urllib.request.urlopen(url + "/healthz", timeout=1.0).read()
                break
            except Exception:  # noqa: BLE001 - not listening yet
                time.sleep(0.1)
        code, _, raw = _post(url, {"prompt": "x" * 80, "max_tokens": 3}, timeout=120)
        assert code == 200 and json.loads(raw)["tokens"] >= 1
        prom = urllib.request.urlopen(url + "/metrics?format=prom", timeout=10).read()
        assert b'serve_fleet_handoffs_total{outcome="ok"} 1' in prom
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        for svc, httpd in services:
            httpd.shutdown()
            httpd.server_close()
            svc.close()
