"""The torch port's prefix-affinity router (``serve/router.py``) against the
JAX package's, on the CPU.

Routing decisions are compared directly (the ring, the routing keys, the
candidate order for the same replica loads). The HTTP behaviour runs both
routers over the same stub replicas: 429 with ``Retry-After`` when every
replica is saturated, replay on a replica that dies before its first byte,
and SSE piped through. Last, a seeded fault run through a 1 prefill + 1
decode fleet of each package (the same tiny MoE weights, carried across
with ``convert.params_from_jax``): each package's ``serve/faults.py``
corrupts one KV push, drops another and times out scrapes, and the
outcomes, counters and greedy texts of the two fleets must be equal.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import pytest
from test_torch_serve import MAX_TOKENS, PROMPTS, _random_params

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.infer import server as jserver
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.serve import faults as jfaults
from mlx_cuda_distributed_pretraining_tpu.serve import fleet as jfleet
from mlx_cuda_distributed_pretraining_tpu.serve import router as jrouter
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer import server as tserver
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.serve import faults as tfaults
from mlx_cuda_distributed_pretraining_tpu_torch.serve import fleet as tfleet
from mlx_cuda_distributed_pretraining_tpu_torch.serve import router as trouter
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

ROUTERS = {"jax": jrouter, "torch": trouter}
SHARED = "the quick brown fox jumps over the lazy dog again and "


@pytest.fixture(autouse=True)
def _disarm():
    for f in (jfaults, tfaults):
        f.reset()
    yield
    for f in (jfaults, tfaults):
        f.reset()


# -- routing decisions ---------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_the_same_keys_choose_the_same_replica_as_jax(n):
    urls = [f"http://10.0.0.{i}:8451" for i in range(n)]
    rt, rj = trouter.Router(urls), jrouter.Router(urls)
    bodies = ([{"prompt": SHARED * (i % 3 + 1) + f"tail {i}"} for i in range(40)]
              + [{"prompt": f"p{i}"} for i in range(20)]
              + [{"prompt": "x", "session": f"s{i}"} for i in range(20)]
              + [{"prompt": [SHARED + "list"]}, {"prompt": ""}, {}])
    for body in bodies:
        kt, kj = rt.routing_key(body), rj.routing_key(body)
        assert kt == kj
        if kt is not None:
            assert rt._ring.lookup(kt) == rj._ring.lookup(kj)
    assert all(trouter._hash64(b) == jrouter._hash64(b)
               for b in (b"", b"a", SHARED.encode(), bytes(range(256))))
    # the candidate order for the same loads: affinity first, spill past
    # spill_depth, drained and dead replicas out
    for r_ in (rt, rj):
        for i, rep in enumerate(sorted(r_.replicas.values(), key=lambda r: r.id)):
            rep.queue_depth = (3 * i) % 11
            rep.inflight = i % 2
            rep.draining = (i == 3)
            rep.up = (i != 4)
    for body in bodies[:50]:
        ct = [r.id for r in rt.candidates(rt.routing_key(body))]
        cj = [r.id for r in rj.candidates(rj.routing_key(body))]
        assert ct == cj
    assert rt.retry_after() == rj.retry_after()


def test_fleet_router_gates_canaries_as_jax():
    for n_dec in (2, 3):
        decode = [f"http://d{i}" for i in range(n_dec)]
        rt = tfleet.FleetRouter(["http://p0"], decode, canary_fraction=0.3)
        rj = jfleet.FleetRouter(["http://p0"], decode, canary_fraction=0.3)
        for r_ in (rt, rj):
            r_.set_canary("r1", True)
        for i in range(200):
            tid = f"trace-{i}"
            ct = [r.id for r in rt._gate_canary(rt.candidates(None, role="decode"), tid)]
            cj = [r.id for r in rj._gate_canary(rj.candidates(None, role="decode"), tid)]
            assert ct == cj
        for body in ({"prompt": "x" * 63}, {"prompt": "x" * 64}, {"prompt": ["y" * 80]},
                     {"prompt": 5}):
            for path in ("/generate", "/v1/completions", "/prefill"):
                assert rt._worth_handoff(path, body) == rj._worth_handoff(path, body)


# -- HTTP behaviour over stub replicas -------------------------------------------------
class _StubReplica:
    """A replica without a model: ``/metrics`` from a dict, ``/generate``
    answers its own name (as JSON, or as three SSE events when the body
    streams), 429 while ``saturated``; ``die_before_first_byte`` closes the
    connection without answering."""

    def __init__(self, name):
        stub = self
        self.name = name
        self.state = {"queue_depth": 0, "batch_occupancy": 0, "role": "any",
                      "draining": False, "params_version": 0}
        self.saturated = False
        self.die_before_first_byte = False
        self.served = 0

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._json(200, stub.state)

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", "0"))) or b"{}")
                if stub.die_before_first_byte:
                    self.close_connection = True
                    self.connection.shutdown(2)
                    return
                if stub.saturated:
                    self._json(429, {"error": "queue full"})
                    return
                stub.served += 1
                if body.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.end_headers()
                    for i in range(3):
                        self.wfile.write(b"data: " + json.dumps(
                            {"token": i, "text": stub.name[i]}).encode() + b"\n\n")
                        self.wfile.flush()
                    self.wfile.write(b"data: " + json.dumps(
                        {"done": True, "text": stub.name[:3]}).encode() + b"\n\n")
                    return
                self._json(200, {"text": stub.name, "prompt": body.get("prompt")})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class _Routed:
    """Both packages' routers over the same stub replicas."""

    def __init__(self, names, **kw):
        self.stubs = [_StubReplica(n) for n in names]
        urls = [s.url for s in self.stubs]
        self.routers, self.httpds, self.urls = {}, {}, {}
        for pkg, mod in ROUTERS.items():
            r = mod.Router(urls, poll_interval_s=30.0, **kw)
            self.routers[pkg] = r
            self.httpds[pkg] = mod.serve_router(r, port=0)
            self.urls[pkg] = f"http://127.0.0.1:{self.httpds[pkg].server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for pkg in ROUTERS:
            self.httpds[pkg].shutdown()
            self.httpds[pkg].server_close()
            self.routers[pkg].stop()
        for s in self.stubs:
            s.close()


def test_a_saturated_fleet_answers_429_with_retry_after_as_jax():
    with _Routed(["alpha", "bravo"]) as rt:
        for s in rt.stubs:
            s.saturated = True
            s.state["queue_depth"] = 13
        for r in rt.routers.values():
            r.poll_once()
        out = {pkg: _post(url, {"prompt": SHARED}) for pkg, url in rt.urls.items()}
        assert out["torch"][0] == out["jax"][0] == 429
        assert out["torch"][1]["Retry-After"] == out["jax"][1]["Retry-After"] == "4"
        # one replica frees up: both routers spill to it
        rt.stubs[1].saturated = False
        out = {pkg: _post(url, {"prompt": SHARED}) for pkg, url in rt.urls.items()}
        assert out["torch"][0] == out["jax"][0] == 200
        assert json.loads(out["torch"][2]) == json.loads(out["jax"][2])
        snaps = {pkg: {k: v.value(**{"replica": "r0", "outcome": "saturated"})
                       for k, v in [("sat", r.metrics_registry.counter(
                           "serve_router_requests_total"))]}
                 for pkg, r in rt.routers.items()}
        assert snaps["torch"] == snaps["jax"]


@pytest.mark.parametrize("stream", [False, True])
def test_replay_on_death_and_sse_pass_through_as_jax(stream):
    with _Routed(["alpha", "bravo", "charlie"], retries=2) as rt:
        body = {"prompt": SHARED + "route me", "stream": stream}
        first = {pkg: _post(url, body) for pkg, url in rt.urls.items()}
        assert first["torch"] == first["jax"] or (
            first["torch"][0] == first["jax"][0]
            and first["torch"][2] == first["jax"][2])
        served = json.loads(first["torch"][2])["text"] if not stream else None
        # the affinity target dies before its first byte: both routers
        # replay on the next candidate and answer the same bytes
        target = next(s for s in rt.stubs
                      if (served is None and s.served) or s.name == served)
        target.die_before_first_byte = True
        again = {pkg: _post(url, body) for pkg, url in rt.urls.items()}
        assert again["torch"][0] == again["jax"][0] == 200
        assert again["torch"][2] == again["jax"][2]
        if stream:
            events = [json.loads(chunk[len(b"data: "):])
                      for chunk in again["torch"][2].split(b"\n\n") if chunk]
            assert events[-1]["done"] is True and len(events) == 4
            assert again["torch"][1]["Content-Type"] == "text/event-stream"
        for pkg, r in rt.routers.items():
            dead = next(x for x in r.replicas.values() if x.url == target.url)
            assert dead.up is False
        dt = {r.id: r.up for r in rt.routers["torch"].replicas.values()}
        dj = {r.id: r.up for r in rt.routers["jax"].replicas.values()}
        assert dt == dj
        # the poller revives it once it answers again
        target.die_before_first_byte = False
        for r in rt.routers.values():
            r.poll_once()
            assert all(x.up for x in r.replicas.values())


# -- a seeded fault run through a 1+1 fleet of each package ----------------------------
# tests/test_torch_serve.py's MoE model (seed 2) and prompts: along their
# greedy trajectories the top-2 logit gap is at least 6.6e-3, against fp32
# differences near 1e-6 between the packages
FIELDS = dict(vocab_size=259, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128,
              num_local_experts=4, num_experts_per_tok=2)
SEED = 2
# long enough for the handoff (>= 32 bytes), short, and a repeat whose whole
# prompt is cached on the decode side
FLEET_PROMPTS = [PROMPTS[0], PROMPTS[1], PROMPTS[2], PROMPTS[3], PROMPTS[0]]


ENGINE = dict(num_slots=2, max_len=128, prefill_chunk=32, block_size=16,
              prefix_cache=True)


def _fleet(pkg, np_params):
    """One prefill and one decode replica behind a FleetRouter."""
    services = []
    for role in ("prefill", "decode"):
        if pkg == "jax":
            svc = jserver.InferenceService(
                jax.tree_util.tree_map(jnp.asarray, np_params), jl.LlamaArgs(**FIELDS),
                JTok(DataConfig()), run_name="tiny")
            svc.attach_engine(JConfig(role=role, **ENGINE))
            httpd = jserver.serve(svc, port=0)
        else:
            svc = tserver.InferenceService(params_from_jax(np_params, "cpu"),
                                           tl.LlamaArgs(**FIELDS), TokenizerManager(),
                                           run_name="tiny")
            svc.attach_engine(EngineConfig(role=role, **ENGINE))
            httpd = tserver.serve(svc, port=0)
        services.append((svc, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"))
    fleet_mod = jfleet if pkg == "jax" else tfleet
    # The run drives every scrape itself (poll_once after each request):
    # the seeded scrape.timeout rule fires by call index, so a background
    # poll landing inside one package's run (a run slower than the
    # interval, as under a loaded test suite) would shift the sequence in
    # that run only. Hence an interval no run reaches, and a scrape
    # timeout no real scrape on a loaded machine reaches (an injected
    # timeout raises at once, whatever its value).
    router = fleet_mod.FleetRouter([services[0][2]], [services[1][2]],
                                   poll_interval_s=3600.0, scrape_timeout_s=60.0,
                                   handoff_min_prompt_bytes=32, block_size=16)
    rhttpd = (jrouter if pkg == "jax" else trouter).serve_router(router, port=0)
    return services, router, rhttpd


def _fault_run(pkg, np_params):
    faults = jfaults if pkg == "jax" else tfaults
    services, router, rhttpd = _fleet(pkg, np_params)
    url = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    (pre, _, pre_url), (dec, _, dec_url) = services
    try:
        # push 1 corrupted, push 2 clean, push 3 dropped; about every
        # second scrape of the decode replica's /metrics times out (seeded)
        faults.inject("kv_transfer.corrupt", nth=1)
        faults.inject("kv_transfer.drop", nth=3)
        faults.inject("scrape.timeout", rate=0.5, seed=7, match=dec_url + "/metrics")
        rows = []
        for p in FLEET_PROMPTS:
            code, _, raw = _post(url, {"prompt": p, "max_tokens": MAX_TOKENS},
                                 timeout=300.0)
            out = json.loads(raw)
            router.poll_once()
            dr = next(r for r in router.replicas.values() if r.url == dec_url)
            rows.append((code, out.get("text"), out.get("tokens"),
                         out.get("prefix_cached_tokens") is not None,
                         dr.up, dr.stale))
        snap = dec.engine.metrics_registry.snapshot()

        def series(s, name):
            return sorted((tuple(sorted(x["labels"].items())), x["value"])
                          for x in s.get(name, {"series": []})["series"])

        counters = {
            "handoffs": series(router.metrics_registry.snapshot(),
                               "serve_fleet_handoffs_total"),
            "dec_kv": series(snap, "serve_kv_transfer_blocks_total"),
            "dec_fail": series(snap, "serve_kv_transfer_failures_total"),
            "pre_fail": series(pre.engine.metrics_registry.snapshot(),
                               "serve_kv_transfer_failures_total"),
            "faults": faults.counts(),
        }
        return rows, counters
    finally:
        rhttpd.shutdown()
        rhttpd.server_close()
        router.stop()
        for svc, httpd, _ in services:
            httpd.shutdown()
            httpd.server_close()
            svc.close()


def test_seeded_fault_run_through_a_fleet_equals_jax():
    np_params = _random_params(jl.LlamaArgs(**FIELDS), seed=SEED)
    t_rows, t_counts = _fault_run("torch", np_params)
    j_rows, j_counts = _fault_run("jax", np_params)
    assert [r[0] for r in t_rows] == [200] * 5
    assert [r[1] for r in t_rows] == [r[1] for r in j_rows]  # greedy texts
    assert [r[2] for r in t_rows] == [r[2] for r in j_rows]
    assert [r[4:] for r in t_rows] == [r[4:] for r in j_rows]  # up, stale
    # the publish-interval gauges aside, every counter agrees
    assert t_counts == j_counts
    assert t_counts["faults"]["kv_transfer.corrupt"] == 1
    assert t_counts["faults"]["kv_transfer.drop"] == 1
    assert t_counts["faults"]["scrape.timeout"] >= 1
    assert ((("reason", "corrupt"),), 1.0) in t_counts["dec_fail"]
