"""The torch port's HTTP server on the locked generation path, against the
JAX package's server, on the CPU.

Both servers serve the same tiny MoE model (numpy weights from a seed,
carried across with ``convert.params_from_jax``; the JAX gmm on its default
off-TPU backend) with the byte tokenizer. Covered: the default engine is
``locked``; the logit-reshaping knobs fall back from the batch engine to
the locked path; SSE (token events from the batch engine, one final event
from the locked path); ``/v1/completions`` and ``/v1/models`` in the JAX
server's shape; ``/trace`` and ``/metrics`` in the JAX server's shape; the
fleet endpoints and ``X-Deadline-Ms`` refused with the ROADMAP item that
ports them; the server's entry point in a subprocess.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.infer import server as jserver
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer import server as tserver
from mlx_cuda_distributed_pretraining_tpu_torch.infer.generate import generate_text
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(vocab_size=259, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
              max_position_embeddings=128, num_local_experts=4,
              num_experts_per_tok=2)
PROMPT = "the quick brown fox"


def _random_params(args, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if x.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        name = jax.tree_util.keystr(path)
        s = 0.05 if "tok_embeddings" in name else 1.5 * x.shape[-2] ** -0.5
        return (s * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jl.init_params(jax.random.PRNGKey(0), args))


@pytest.fixture(scope="module")
def np_params():
    return _random_params(jl.LlamaArgs(**FIELDS), seed=2)


def _service(np_params, **kw):
    return tserver.InferenceService(params_from_jax(np_params, "cpu"),
                                    tl.LlamaArgs(**FIELDS), TokenizerManager(),
                                    run_name="tiny", **kw)


class _Served:
    """A service behind ``serve`` on a free port; closes both on exit."""

    def __init__(self, service, server_mod):
        self.service = service
        self.httpd = server_mod.serve(service, port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()


def _call(url, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_locked_service_serves_every_knob(np_params):
    with _Served(_service(np_params), tserver) as s:
        greedy = tserver.request_generate(s.url, PROMPT, max_tokens=12)
        want = generate_text(s.service.params, s.service.args, s.service.tokenizer,
                             PROMPT, max_new_tokens=12)
        assert greedy["text"] == want and "engine" not in greedy
        assert greedy["speculative"] is False
        for knobs in ({"top_p": 0.9, "temperature": 0.8},
                      {"min_p": 0.1, "temperature": 0.8},
                      {"repetition_penalty": 1.3}):
            out = tserver.request_generate(s.url, PROMPT, max_tokens=6, **knobs)
            assert 1 <= out["tokens"] <= 6
        # client floats snapped to the 0.05 grid, max_tokens clamped
        out = tserver.request_generate(s.url, PROMPT, max_tokens=10 ** 6,
                                       temperature=0.73, top_p=0.912)
        assert out["effective_params"] == {
            "temperature": 0.75, "top_p": 0.9, "min_p": 0.0,
            "repetition_penalty": None, "max_tokens": 4096}
        health = _call(s.url, "/healthz")[1]
        assert "engine" not in health and health["kv_quant"] is False


def test_knobs_fall_back_from_the_batch_engine(np_params):
    service = _service(np_params)
    service.attach_engine(EngineConfig(num_slots=2, prefill_chunk=16))
    with _Served(service, tserver) as s:
        batch = tserver.request_generate(s.url, PROMPT, max_tokens=12)
        assert batch["engine"] == "batch"
        # the batch engine's greedy tokens are the locked path's
        assert batch["text"] == generate_text(service.params, service.args,
                                              service.tokenizer, PROMPT,
                                              max_new_tokens=12)
        for knobs in ({"top_p": 0.9, "temperature": 0.8}, {"min_p": 0.1},
                      {"repetition_penalty": 1.3}):
            out = tserver.request_generate(s.url, PROMPT, max_tokens=6, **knobs)
            assert "engine" not in out and "speculative" in out, knobs
        # no-op values stay on the engine (top_p 1.0 does not: JAX's rule)
        out = tserver.request_generate(s.url, PROMPT, max_tokens=4, top_p=0.0,
                                       repetition_penalty=1.0)
        assert out["engine"] == "batch"
        assert _call(s.url, "/healthz")[1]["engine"] == "batch"


def test_sse_streams_tokens_from_the_engine_and_one_event_when_locked(np_params):
    service = _service(np_params)
    service.attach_engine(EngineConfig(num_slots=2, prefill_chunk=16))
    with _Served(service, tserver) as s:
        events = list(tserver.request_stream(s.url, PROMPT, max_tokens=8))
        tokens = [e for e in events if "token" in e]
        done = events[-1]
        assert done["done"] is True and len(tokens) == done["tokens"] == 8
        assert [e["token"] for e in tokens] == done["token_ids"]
        assert "".join(e["text"] for e in tokens) == done["text"]
        locked = list(tserver.request_stream(s.url, PROMPT, max_tokens=8, top_p=0.9,
                                             temperature=0.5))
        assert len(locked) == 1 and locked[0]["done"] and "speculative" in locked[0]


def test_completions_and_models_have_the_jax_servers_keys(np_params):
    jservice = jserver.InferenceService(
        jax.tree_util.tree_map(jnp.asarray, np_params), jl.LlamaArgs(**FIELDS),
        JTok(DataConfig()), run_name="tiny")
    body = {"prompt": [PROMPT], "max_tokens": 10, "stop": "zzz"}
    with _Served(_service(np_params), tserver) as t, _Served(jservice, jserver) as j:
        tcode, tout = _call(t.url, "/v1/completions", body)
        jcode, jout = _call(j.url, "/v1/completions", body)
        assert tcode == jcode == 200
        assert set(tout) == set(jout)
        assert set(tout["choices"][0]) == set(jout["choices"][0])
        assert tout["usage"] == jout["usage"]
        assert tout["choices"][0]["text"] == jout["choices"][0]["text"]
        assert tout["choices"][0]["finish_reason"] == jout["choices"][0]["finish_reason"]
        tm, jm = _call(t.url, "/v1/models")[1], _call(j.url, "/v1/models")[1]
        assert set(tm) == set(jm) and set(tm["data"][0]) == set(jm["data"][0])
        # the locked /generate results carry the same keys
        tg_ = _call(t.url, "/generate", {"prompt": PROMPT, "max_tokens": 4})[1]
        jg_ = _call(j.url, "/generate", {"prompt": PROMPT, "max_tokens": 4})[1]
        assert set(tg_) == set(jg_) and tg_["text"] == jg_["text"]
        assert _call(t.url, "/generate", {"prompt": ["a", "b"]})[0] == 400


@pytest.mark.parametrize("method,path,item", [
    ("POST", "/prefill", 10), ("POST", "/adopt_kv", 10),
    ("POST", "/admin/drain", 10), ("POST", "/admin/swap_weights", 10),
    ("POST", "/generate?deadline", 10)])
def test_unported_endpoints_refuse_naming_their_item(np_params, method, path, item):
    with _Served(_service(np_params), tserver) as s:
        headers = None
        if path.endswith("?deadline"):
            path, headers = "/generate", {"X-Deadline-Ms": "500"}
        code, out = _call(s.url, path, {"prompt": "x"} if method == "POST" else None,
                          headers)
        assert code == 501 and f"ROADMAP queue 1 item {item}:" in out["error"]


def test_speculative_and_kv_quant_services(np_params):
    want = None
    with _Served(_service(np_params, speculative=True, draft_len=4), tserver) as s:
        out = tserver.request_generate(s.url, PROMPT, max_tokens=10)
        assert out["speculative"] is True and out["tokens_per_call"] >= 1.0
        want = out["text"]
        # a reshaping knob turns speculation off
        assert tserver.request_generate(s.url, PROMPT, max_tokens=4,
                                        min_p=0.1)["speculative"] is False
    with _Served(_service(np_params, kv_quant=True), tserver) as s:
        out = tserver.request_generate(s.url, PROMPT, max_tokens=10)
        assert s.service.health()["kv_quant"] is True
        assert out["text"] == want  # agrees with the fp32 cache at this size
        # the batch engine takes the service's int8 cache as its int8 pool
        engine = s.service.attach_engine(EngineConfig(num_slots=2, kv_quant=True))
        assert engine.pool.quantize and "k_q" in engine.pool.cache[0]


def test_server_entry_point_defaults_to_the_locked_engine(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(json.dumps({
        "name": "tiny-serve",
        "model": {"dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                 "num_layers": 2},
                  "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                                "max_position_embeddings": 128}}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.infer.server",
         "--config", str(cfg), "--device", "cpu", "--port", "0"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "engine=locked" in line, (line, proc.stderr.read() if proc.poll() else "")
        url = line.split(" on ")[-1].strip()
        code, out = _call(url, "/generate", {"prompt": "hi", "max_tokens": 3,
                                             "top_p": 0.9, "temperature": 0.7})
        assert code == 200 and 1 <= out["tokens"] <= 3 and "engine" not in out
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    # --kv-quant with --engine batch is ported; --weight-dtype needs the
    # batch engine, as in JAX
    bad = subprocess.run(
        [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.infer.server",
         "--config", str(cfg), "--device", "cpu", "--weight-dtype", "int8"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=120)
    assert bad.returncode == 2 and "--weight-dtype requires --engine batch" in bad.stderr


@pytest.mark.parametrize("path", ["/trace", "/metrics"])
def test_telemetry_endpoints_answer_as_jax(np_params, path):
    """``/trace`` and ``/metrics``, refused until ROADMAP queue 1 item 9,
    answer 200 in the JAX server's shape: on the locked path (no engine)
    the same bodies; behind the batch engine with its tracer on, the
    client's ``X-Trace-Id`` keys the request's spans and ``/metrics``
    carries the JAX keys and the TTFT histogram's sum and count."""
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jsvc = jserver.InferenceService(jparams, jl.LlamaArgs(**FIELDS), JTok(DataConfig()),
                                    run_name="tiny")
    with _Served(_service(np_params), tserver) as t, _Served(jsvc, jserver) as j:
        tcode, tout = _call(t.url, path)
        jcode, jout = _call(j.url, path)
    assert tcode == jcode == 200 and tout == jout
    service = _service(np_params)
    service.attach_engine(EngineConfig(num_slots=2, max_len=128, prefill_chunk=16,
                                       trace=True))
    with _Served(service, tserver) as t:
        code, out = _call(t.url, "/generate", {"prompt": PROMPT, "max_tokens": 4},
                          {"X-Trace-Id": "ab" * 16})
        assert code == 200 and out["trace_id"] == "ab" * 16
        import time

        for _ in range(100):  # the engine publishes its TTFT every second
            code, body = _call(t.url, path)
            if path == "/trace" or "ttft_ms_count" in body:
                break
            time.sleep(0.05)
    assert code == 200
    if path == "/trace":
        req = [e for e in body["traceEvents"] if e.get("name") == "request"]
        assert len(req) == 1 and req[0]["args"]["trace_id"] == "ab" * 16
    else:
        jkeys = {"iterations", "batch_occupancy", "num_slots", "kv_backend", "role",
                 "params_version", "mesh", "weight_dtype", "weight_bytes",
                 "prefix_cache", "draining"}
        assert jkeys <= set(body) and body["draining"] is False
        assert body["ttft_ms_count"] == 1 and body["ttft_ms_sum"] > 0
