"""The torch port's serving telemetry against the JAX package's, on the CPU.

Both batch engines serve ``tests/test_torch_serve.py``'s tiny MoE model
(numpy weights from a seed, carried across with
``convert.params_from_jax``) with their tracers on, one request after
another. Each request's spans and markers come in the same order in both
engines; the greedy tokens with the tracer on equal those with it off; the
engines' ``metrics()`` carry JAX's keys (with the TTFT histogram's sum and
count) and their Prometheus expositions the same ``serve_*`` metrics. The
server answers ``/trace`` with the spans of the request whose
``X-Trace-Id`` it was sent.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.obs.prometheus import render_prometheus as jrender
from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import InferenceService, serve
from mlx_cuda_distributed_pretraining_tpu_torch.obs.prometheus import render_prometheus
from mlx_cuda_distributed_pretraining_tpu_torch.obs.trace import TRACE_HEADER
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

from test_torch_serve import BASE, MAX_TOKENS, MODELS, PROMPTS, _port_args, _random_params

IDS = ["%032x" % (0xABCDEF * (i + 3)) for i in range(len(PROMPTS))]
CFG = dict(num_slots=3, max_len=128, prefill_chunk=16)


def _run(engine, ids=IDS):
    """PROMPTS one after another, each under its trace id; returns the
    token lists."""
    engine.start()
    try:
        out = []
        for prompt, tid in zip(PROMPTS, ids):
            req = engine.submit(prompt, max_tokens=MAX_TOKENS, trace_id=tid)
            assert req.wait(120) and req.error is None
            out.append(list(req.tokens))
        return out
    finally:
        engine.stop()


def _by_trace(events):
    """trace id -> the names of its spans and markers, in record order."""
    out = {}
    for e in events:
        tid = (e.get("args") or {}).get("trace_id")
        if tid is not None and e.get("ph") in ("X", "i"):
            out.setdefault(tid, []).append(e["name"])
    return out


def _type_lines(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE serve_"))


@pytest.fixture(scope="module")
def engines():
    """The JAX and port engines (MoE, seed 2) after the same requests."""
    extra, seed = MODELS["moe"]
    jargs = jl.LlamaArgs(**BASE, **extra)
    np_params = _random_params(jargs, seed)
    jeng = JEngine(jax.tree_util.tree_map(jnp.asarray, np_params), jargs,
                   JTok(DataConfig()), JConfig(**CFG, trace=True))
    teng = BatchEngine(params_from_jax(np_params, "cpu"), _port_args(jargs),
                       TokenizerManager(), EngineConfig(**CFG, trace=True))
    jtok, ttok = _run(jeng), _run(teng)
    for eng in (jeng, teng):  # one more registry mirror, after the last request
        eng._last_publish = 0.0
        eng._publish()
    return jeng, teng, jtok, ttok, np_params, jargs


def test_spans_come_in_jax_order(engines):
    jeng, teng, jtok, ttok, _, _ = engines
    assert ttok == jtok
    jspans, tspans = _by_trace(jeng.tracer.chrome_events()), _by_trace(teng.tracer.chrome_events())
    assert sorted(tspans) == sorted(jspans) == sorted(IDS)
    for tid in IDS:
        assert tspans[tid] == jspans[tid], tid
        assert tspans[tid][0] == "queue_wait" and tspans[tid][-1] == "request"
    assert "prefix_adopt" in tspans[IDS[1]]  # the second prompt shares the first's blocks
    assert teng.tracer.stats()["dropped"] == 0


def test_tracing_changes_no_token(engines):
    _, _, _, ttok, np_params, jargs = engines
    off = BatchEngine(params_from_jax(np_params, "cpu"), _port_args(jargs),
                      TokenizerManager(), EngineConfig(**CFG))
    assert _run(off) == ttok
    assert off.tracer.stats() == {"recorded": 0, "dropped": 0, "buffered": 0}


def test_metrics_keys_and_exposition_match_jax(engines):
    jeng, teng, _, _, _, _ = engines
    jm, tm = jeng.metrics(), teng.metrics()
    assert set(jm) <= set(tm), set(jm) - set(tm)
    assert tm["ttft_ms_count"] == jm["ttft_ms_count"] == len(PROMPTS)
    assert tm["ttft_ms_sum"] > 0 and tm["completed"] == jm["completed"]
    tsnap, jsnap = teng.metrics_registry.snapshot(), jeng.metrics_registry.snapshot()
    assert _type_lines(render_prometheus(tsnap)) == _type_lines(jrender(jsnap))
    assert tsnap["serve_ttft_ms"]["series"][0]["count"] == len(PROMPTS)
    comps = {s["labels"]["component"] for s in tsnap["serve_ttft_component_ms"]["series"]}
    assert comps == {"queue", "prefill", "decode"}
    # (loop iterations depend on timing: idle iterations count too)
    for name in ("serve_requests_total", "serve_prefix_cache_hits_total",
                 "serve_prefix_cache_misses_total"):
        assert teng.metrics_registry.sum_series(name) == jeng.metrics_registry.sum_series(name)
    assert teng.metrics_registry.sum_series("serve_iterations_total") > 0


def test_server_trace_and_metrics_carry_the_request(engines):
    _, _, _, _, np_params, jargs = engines
    service = InferenceService(params_from_jax(np_params, "cpu"), _port_args(jargs),
                               TokenizerManager(), run_name="tiny")
    service.attach_engine(EngineConfig(**CFG, trace=True))
    httpd = serve(service, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for tid in IDS[:2]:
            req = urllib.request.Request(
                url + "/generate", data=json.dumps(
                    {"prompt": PROMPTS[0], "max_tokens": 4, "stream": tid == IDS[1]}).encode(),
                headers={"Content-Type": "application/json", TRACE_HEADER: tid})
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = resp.read()
            assert tid.encode() in body
        with urllib.request.urlopen(url + "/trace", timeout=60) as resp:
            doc = json.loads(resp.read())
        spans = _by_trace(doc["traceEvents"])
        assert sorted(spans) == sorted(IDS[:2])
        assert all(names.count("request") == 1 for names in spans.values())
        assert "stream_emit" in spans[IDS[1]] and "stream_emit" not in spans[IDS[0]]
        with urllib.request.urlopen(url + "/trace?clear=1", timeout=60) as resp:
            assert json.loads(resp.read())["traceEvents"]
        with urllib.request.urlopen(url + "/trace", timeout=60) as resp:
            left = json.loads(resp.read())["traceEvents"]
        assert [e["ph"] for e in left] == ["M"]  # drained: the process name only
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
