"""The torch port's HTTP server on the locked generation path, against the
JAX package's server, on the CPU.

Both servers serve the same tiny MoE model (numpy weights from a seed,
carried across with ``convert.params_from_jax``; the JAX gmm on its default
off-TPU backend) with the byte tokenizer. Covered: the default engine is
``locked``; the logit-reshaping knobs fall back from the batch engine to
the locked path; SSE (token events from the batch engine, one final event
from the locked path); ``/v1/completions`` and ``/v1/models`` in the JAX
server's shape; ``/trace`` and ``/metrics`` in the JAX server's shape; the
fleet endpoints (``/prefill``, ``/adopt_kv``, ``/admin/*``) and
``X-Deadline-Ms`` beside the JAX server's, a multi-device ``--mesh`` still
refused (ROADMAP queue 1 item 10); the server's entry point in a
subprocess.
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


@pytest.fixture(scope="module")
def fleet_servers(np_params):
    """The port's and the JAX package's servers, each over a batch engine
    (paged pool, prefix cache, 16-token blocks) on the same weights."""
    cfg = dict(num_slots=2, max_len=128, prefill_chunk=32, block_size=16)
    tsvc = _service(np_params)
    tsvc.attach_engine(EngineConfig(**cfg))
    jsvc = jserver.InferenceService(jax.tree_util.tree_map(jnp.asarray, np_params),
                                    jl.LlamaArgs(**FIELDS), JTok(DataConfig()),
                                    run_name="tiny")
    from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig

    jsvc.attach_engine(JConfig(**cfg))
    with _Served(tsvc, tserver) as t, _Served(jsvc, jserver) as j:
        yield t, j


def _raw(url, path, data, headers=None):
    req = urllib.request.Request(url + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


LONG = PROMPT + ", then it jumps over the lazy dog twice"  # 3 blocks and a tail


@pytest.mark.parametrize("endpoint", ["prefill", "adopt_kv", "drain", "swap_weights",
                                      "deadline"])
def test_fleet_endpoints_answer_as_jax(fleet_servers, np_params, tmp_path, endpoint):
    """The fleet endpoints, refused until ROADMAP queue 1 item 10's serving
    plane was ported, answer as the JAX server's: the same status codes and
    keys, KV pushed across the two packages, the same texts after."""
    t, j = fleet_servers
    both = {"torch": t, "jax": j}
    if endpoint == "prefill":
        # each prefills and pushes its chain to the OTHER package's server
        out = {k: _call(s.url, "/prefill", {"prompt": LONG,
                                             "transfer_to": both[o].url})
               for k, s, o in (("torch", t, "jax"), ("jax", j, "torch"))}
        assert out["torch"][0] == out["jax"][0] == 200
        tb, jb = out["torch"][1], out["jax"][1]
        assert set(tb) == set(jb)
        for key in ("prefill", "prompt_tokens", "blocks", "transfer_bytes", "skipped"):
            assert tb[key] == jb[key], key
        # the JAX server adopts the port's chain; the port's already holds
        # the same blocks from its own prefill, so it reuses JAX's
        assert tb["blocks"] == 3 and (tb["adopted"], tb["reused"]) == (3, 0)
        assert (jb["adopted"], jb["reused"]) == (0, 3)
        gen = {k: _call(s.url, "/generate", {"prompt": LONG, "max_tokens": 6})[1]
               for k, s in both.items()}
        assert gen["torch"]["text"] == gen["jax"]["text"]
        assert gen["torch"]["prefix_cached_tokens"] == gen["jax"]["prefix_cached_tokens"] == 48
        assert _call(t.url, "/prefill", {"no": "prompt"})[0] == \
            _call(j.url, "/prefill", {"no": "prompt"})[0] == 400
    elif endpoint == "adopt_kv":
        from mlx_cuda_distributed_pretraining_tpu_torch.serve.kv_transfer import _corrupt

        prompt = "adopt me: " + LONG
        req = t.service.engine.submit(prompt, max_tokens=1, prefill_only=True)
        assert req.wait(120) and req.result["finish_reason"] == "prefill"
        data = t.service.engine.export_kv(req.prompt_ids).to_bytes()
        hdr = {"Content-Type": "application/octet-stream"}
        # the port's own server holds the chain already; the JAX one adopts it
        out = {k: _raw(s.url, "/adopt_kv", data, hdr) for k, s in both.items()}
        assert out["torch"] == (200, {"adopted": 0, "reused": 4, "skipped": 0})
        assert out["jax"] == (200, {"adopted": 4, "reused": 0, "skipped": 0})
        again = {k: _raw(s.url, "/adopt_kv", data, hdr) for k, s in both.items()}
        assert again["torch"] == again["jax"] == out["torch"]
        bad = {k: _raw(s.url, "/adopt_kv", _corrupt(data), hdr) for k, s in both.items()}
        assert bad["torch"][0] == bad["jax"][0] == 400
        junk = {k: _raw(s.url, "/adopt_kv", b"nonsense", hdr)[0] for k, s in both.items()}
        assert junk["torch"] == junk["jax"] == 400
    elif endpoint == "drain":
        body = {"prompt": PROMPT, "max_tokens": 4}
        for path, code in (("/admin/drain", 200), ("/generate", 503),
                           ("/prefill", 503), ("/healthz", 200), ("/admin/undrain", 200),
                           ("/generate", 200), ("/admin/nope", 404)):
            got = {k: (_call(s.url, path) if path == "/healthz" else
                       _call(s.url, path, body if "admin" not in path else {}))
                   for k, s in both.items()}
            assert got["torch"][0] == got["jax"][0] == code, path
            if path.startswith("/admin/") and code == 200:
                assert got["torch"][1] == got["jax"][1]
            if path == "/healthz":
                assert got["torch"][1]["status"] == got["jax"][1]["status"] == "draining"
            if path == "/generate" and code == 200:
                assert got["torch"][1]["text"] == got["jax"][1]["text"]
        assert t.service.metrics()["draining"] is False
    elif endpoint == "swap_weights":
        from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
            CheckpointManager,
        )

        run_dir = str(tmp_path / "run")
        CheckpointManager(run_dir).save(7, params_from_jax(np_params, "cpu"))
        out = {k: _call(s.url, "/admin/swap_weights", {"run_dir": run_dir})
               for k, s in both.items()}
        assert out["torch"][0] == out["jax"][0] == 200
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][1]["model_path"].endswith("step_7_model.safetensors")
        gen = {k: _call(s.url, "/generate", {"prompt": PROMPT, "max_tokens": 6})[1]["text"]
               for k, s in both.items()}
        assert gen["torch"] == gen["jax"]
        for body in ({}, {"run_dir": str(tmp_path / "empty")}):
            codes = {k: _call(s.url, "/admin/swap_weights", body)[0] for k, s in both.items()}
            assert codes["torch"] == codes["jax"] == 400
    else:
        body = {"prompt": PROMPT, "max_tokens": 4}
        steps0 = t.service.engine.prefill_chunks + t.service.engine.decode_steps
        for header, code in (("0", 504), ("-5", 504), ("60000", 200), ("abc", 200)):
            got = {k: _call(s.url, "/generate", body, {"X-Deadline-Ms": header})
                   for k, s in both.items()}
            assert got["torch"][0] == got["jax"][0] == code, header
            if code == 200:
                assert got["torch"][1]["text"] == got["jax"][1]["text"]
            else:
                assert got["torch"][1] == got["jax"][1]
                # answered before any engine work
                assert t.service.engine.prefill_chunks + \
                    t.service.engine.decode_steps == steps0
            pre = {k: _call(s.url, "/prefill", body, {"X-Deadline-Ms": header})[0]
                   for k, s in both.items()}
            assert pre["torch"] == pre["jax"]


@pytest.mark.parametrize("spec", ["tp=2", "dp=2,tp=1"])
def test_a_multi_device_serving_mesh_still_refuses_naming_item_10(spec):
    """``--mesh`` is refused before any weight loads where it cannot serve:
    a tp mesh outside a launched world of enough ranks names the launcher
    (item 10a is ported: ``tests/test_torch_tp_serve.py`` serves it under
    ``parallel.launch``), a dp axis names ROADMAP queue 1 item 10a-dp; a
    one-device mesh serves."""
    err, match = ((ValueError, "parallel.launch") if spec == "tp=2"
                  else (NotImplementedError, "ROADMAP queue 1 item 10a-dp"))
    with pytest.raises(err, match=match):
        tserver.main(["--config", os.path.join(REPO, "configs", "model-config-sample.yaml"),
                      "--engine", "batch", "--device", "cpu", "--mesh", spec])
    assert EngineConfig(mesh="tp=1,dp=1").mesh == {"tp": 1, "dp": 1}


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
