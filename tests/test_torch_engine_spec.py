"""The torch port's batch engine beyond the plain paged path, against the
JAX package's, on the CPU: the slotted pool, the int8 KV pool on both
backends, in-batch speculation (greedy and sampled, the degradation rung,
the ``arena.exhaust`` fault), ``EngineConfig.from_yaml`` and the server's
flags (JAX's ``tests/test_serve.py`` engine cases).

Weights are ``tests/test_torch_serve.py``'s fan-in-scaled numpy weights
(dense, seed 0), carried across with ``convert.params_from_jax``, so
greedy decisions have clear margins against the ~1e-6 fp32 differences
between the packages. Greedy tokens are compared exactly. Sampled tokens
come from per-request ``torch.Generator``s in the port and ``jax.random``
keys in JAX, so sampled runs are checked for termination and counts only.

The engine's telemetry knobs (``trace``, ``stats_url``, ``metrics_port``)
work here; its spans and metrics against JAX's are in
``tests/test_torch_serve_telemetry.py``. JAX-only tests with no counterpart
here: the TP-sharded engine (item 10).
"""

import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.infer.generate import (
    generate_speculative as j_generate_speculative,
)
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.serve.scheduler import Request as JRequest
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer.generate import generate_speculative
from mlx_cuda_distributed_pretraining_tpu_torch.serve import (
    BatchEngine,
    EngineConfig,
    SlotKVPool,
    faults,
)
from mlx_cuda_distributed_pretraining_tpu_torch.serve.scheduler import DECODE, Request
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

from test_torch_serve import BASE, _port_args, _random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = TokenizerManager()
JARGS = jl.LlamaArgs(**BASE, tie_word_embeddings=False)
NP_PARAMS = _random_params(JARGS, 0)
ARGS = _port_args(JARGS)
PARAMS = params_from_jax(NP_PARAMS, "cpu")
MAX_LEN = 128
PROMPTS = ["the quick brown fox", "pack my box with", "a b c a b c a",
           "hello world hello world hello", "zzz"]
SPEC_PROMPTS = ["a b c a b c a b", "the cat and the cat and the"]


def _engine(**kw):
    cfg = EngineConfig(**{"num_slots": 3, "max_len": MAX_LEN, "prefill_chunk": 16, **kw})
    return BatchEngine(PARAMS, ARGS, TOK, cfg)


def _collect(eng, prompts, max_tokens=20, temperature=0.0):
    eng.start()
    try:
        reqs = [eng.submit(p, max_tokens=max_tokens, temperature=temperature, seed=i)
                for i, p in enumerate(prompts)]
        assert all(r.wait(300) and r.error is None for r in reqs)
        return [dict(r.result) for r in reqs], eng.metrics()
    finally:
        eng.stop()


def _jax_tokens(prompts, max_tokens=20, **kw):
    """Greedy token ids from the JAX engine, one request at a time."""
    jtok = JTok(DataConfig())
    eng = JEngine(jax.tree_util.tree_map(jnp.asarray, NP_PARAMS), JARGS, jtok,
                  JConfig(**{"num_slots": 3, "max_len": MAX_LEN, "prefill_chunk": 16, **kw}))
    eng.start()
    try:
        out = []
        for p in prompts:
            req = eng.submit(p, max_tokens=max_tokens, temperature=0.0)
            assert req.wait(300) and req.error is None
            out.append(list(req.tokens))
        return out
    finally:
        eng.stop()


# -- pools ------------------------------------------------------------------------
def test_slot_pool_allocate_free_reset():
    pool = SlotKVPool(ARGS, num_slots=2, max_len=16, device="cpu")
    assert pool.kind == "slotted" and pool.capacity == 15
    assert "pos" not in pool.cache[0] and pool.cache[0]["k"].shape == (2, 16, 2, 8)
    a, b = pool.allocate(), pool.allocate()
    assert {a, b} == {0, 1} and pool.allocate() is None and pool.occupancy() == 1.0
    pool.lengths[a] = 7
    pool.free(a)
    with pytest.raises(ValueError, match="double-freed"):
        pool.free(a)
    assert pool.allocate() == a and pool.lengths[a] == 0
    pool.reset()
    assert pool.num_free == 2 and pool.ensure_capacity(0, 16)
    q = SlotKVPool(ARGS, num_slots=2, max_len=16, device="cpu", quantize=True)
    assert q.cache[0]["k_q"].dtype == torch.int8 and q.cache[0]["k_s"].shape == (2, 16, 2, 1)


def test_paged_vs_slotted_greedy_parity():
    slotted, _ = _collect(_engine(kv_backend="slotted"), PROMPTS)
    paged, m = _collect(_engine(kv_backend="paged", block_size=16), PROMPTS)
    assert m["kv_backend"] == "paged"
    for s, p in zip(slotted, paged):
        assert p["token_ids"] == s["token_ids"]
        assert p["finish_reason"] == s["finish_reason"]


def test_paged_int8_roundtrip_parity_with_slotted_int8():
    slotted, m = _collect(_engine(kv_backend="slotted", kv_quant=True), PROMPTS[:3])
    assert m["kv_backend"] == "slotted" and m["kv_quant"]
    eng = _engine(kv_backend="paged", kv_quant=True)
    assert "k_q" in eng.pool.cache[0] and eng.pool.cache[0]["k_s"].shape[-1] == 1
    paged, _ = _collect(eng, PROMPTS[:3])
    for s, p in zip(slotted, paged):
        assert p["token_ids"] == s["token_ids"]


@pytest.mark.parametrize("kw", [{"kv_backend": "slotted"},
                                {"kv_backend": "slotted", "kv_quant": True},
                                {"kv_quant": True}],
                         ids=["slotted", "slotted_kv8", "paged_kv8"])
def test_engine_backends_greedy_match_jax(kw):
    want = _jax_tokens(PROMPTS[:3], **kw)
    got, _ = _collect(_engine(**kw), PROMPTS[:3])
    assert [g["token_ids"] for g in got] == want


# -- speculation --------------------------------------------------------------------
def test_batched_spec_matches_jax_generate_speculative_greedy():
    jparams = jax.tree_util.tree_map(jnp.asarray, NP_PARAMS)
    singles = []
    for p in SPEC_PROMPTS:
        ids = [TOK.bos_id] + TOK.tokenize(p)
        jtoks, _ = j_generate_speculative(jparams, JARGS, ids, max_tokens=32, draft_len=4,
                                          max_ngram=3, stop_tokens=[TOK.eos_id],
                                          temperature=0.0)
        ttoks, _ = generate_speculative(PARAMS, ARGS, ids, max_tokens=32, draft_len=4,
                                        max_ngram=3, stop_tokens=[TOK.eos_id],
                                        temperature=0.0)
        assert list(ttoks) == list(jtoks)
        singles.append(list(jtoks))
    outs, m = _collect(_engine(spec_draft_len=4, spec_max_ngram=3), SPEC_PROMPTS,
                       max_tokens=32)
    assert [o["token_ids"] for o in outs] == singles
    assert m["spec_proposed"] > 0
    assert 0 < m["spec_accepted"] <= m["spec_proposed"]
    assert m["spec_acceptance_rate"] > 0.0 and m["spec_off_steps"] == 0
    plain, _ = _collect(_engine(), SPEC_PROMPTS, max_tokens=32)
    assert [o["token_ids"] for o in plain] == singles


def test_batched_spec_int8_pool_matches_unspeculated():
    # JAX's init weights (std 0.02): their greedy continuations repeat, so
    # prompt-lookup drafts are accepted
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), JARGS)), "cpu")

    def run(**kw):
        return _collect(BatchEngine(params, ARGS, TOK, EngineConfig(
            num_slots=3, max_len=MAX_LEN, prefill_chunk=16, kv_quant=True, **kw)),
            SPEC_PROMPTS, max_tokens=24)

    plain, _ = run()
    spec, m = run(spec_draft_len=3)
    assert [o["token_ids"] for o in spec] == [o["token_ids"] for o in plain]
    assert m["spec_accepted"] > 0


def test_batched_spec_sampled_still_terminates_and_counts():
    outs, m = _collect(_engine(spec_draft_len=3), PROMPTS[:3], max_tokens=8,
                       temperature=0.7)
    assert all(0 < o["tokens"] <= 8 for o in outs)
    assert m["spec_proposed"] >= m["spec_accepted"] >= 0 and m["spec_proposed"] > 0


def test_spec_turns_off_under_arena_pressure():
    # degradation rung 1: with the threshold above the whole arena every
    # step runs unspeculated, and greedy tokens stay the same
    plain, _ = _collect(_engine(), SPEC_PROMPTS, max_tokens=16)
    off, m = _collect(_engine(spec_draft_len=4, spec_off_kv_free_frac=1.01),
                      SPEC_PROMPTS, max_tokens=16)
    assert [o["token_ids"] for o in off] == [o["token_ids"] for o in plain]
    assert m["spec_proposed"] == 0 and m["spec_off_steps"] > 0


def test_arena_exhaust_fault_preempts_and_recomputes():
    reference, _ = _collect(_engine(spec_draft_len=2), PROMPTS[:2], max_tokens=12)
    faults.reset()
    try:
        with faults.active("arena.exhaust", nth=3) as rule:
            out, m = _collect(_engine(spec_draft_len=2), PROMPTS[:2], max_tokens=12)
        assert rule.fires == 1 and m["preempted"] >= 1
        assert m["faults_injected"] == {"arena.exhaust": 1}
        assert [o["token_ids"] for o in out] == [o["token_ids"] for o in reference]
    finally:
        faults.reset()


def test_spec_requires_the_paged_pool():
    with pytest.raises(ValueError, match="paged"):
        _engine(kv_backend="slotted", spec_draft_len=2)
    with pytest.raises(ValueError, match="kv_backend"):
        _engine(kv_backend="ring")


def test_spec_reserves_its_draft_positions():
    eng = _engine(spec_draft_len=4)
    with pytest.raises(ValueError, match="spec reserves 4"):
        eng._submit_ids([1] * 124, max_tokens=4, temperature=0.0, seed=0)
    req = eng._submit_ids([1] * 100, max_tokens=100, temperature=0.0, seed=0)
    assert req.max_tokens == eng.pool.capacity - 100 - 4


def test_request_position_and_queue_depth_as_jax():
    for prompt, tokens, state in (([1, 2, 3], [], "queued"), ([1, 2, 3], [7, 8], DECODE)):
        r, j = Request(list(prompt), 8), JRequest(list(prompt), 8)
        r.tokens, j.tokens = list(tokens), list(tokens)
        r.state = j.state = state
        r.prefilled = j.prefilled = 2
        assert r.position == j.position
    eng = _engine()
    eng.submit("hello", max_tokens=2)
    assert eng.scheduler.queue_depth() == 1
    eng.stop()


# -- config and server ---------------------------------------------------------------
def test_engine_config_from_yaml_reads_serve_sample():
    pytest.importorskip("yaml")
    path = os.path.join(REPO, "configs", "serve-sample.yaml")
    cfg = EngineConfig.from_yaml(path)
    from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JCfg

    jcfg = JCfg.from_yaml(path)
    for f in ("num_slots", "max_len", "max_queue", "prefill_chunk", "kv_quant",
              "weight_dtype", "kv_backend", "block_size", "num_blocks",
              "spec_draft_len", "spec_max_ngram", "spec_off_kv_free_frac",
              "prefix_cache", "prefix_min_hit_blocks", "default_deadline_s",
              "trace", "stats_url", "role", "metrics_port", "worker_id"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.mesh == {"tp": 1, "dp": 1}


@pytest.mark.parametrize("knob,value,item", [
    ("mesh", {"tp": 2}, "item 10"), ("mesh", "tp=2,dp=1", "item 10")])
def test_engine_config_refuses_what_is_not_ported(tmp_path, knob, value, item):
    path = tmp_path / "serve.json"
    section = {"trace": {"enabled": value}} if knob == "trace" else {knob: value}
    path.write_text(json.dumps({"serve": section}))
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        EngineConfig(**{knob: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        EngineConfig.from_yaml(str(path))
    assert EngineConfig(mesh="tp=1,dp=1").mesh == {"tp": 1, "dp": 1}


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_engine_config_role_builds_and_the_engine_publishes_it(tmp_path, role):
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"serve": {"role": role}}))
    assert EngineConfig(role=role).role == role
    assert EngineConfig.from_yaml(str(path)).role == role
    eng = _engine(role=role)
    assert eng.metrics()["role"] == role
    eng.stop()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("knob", ["trace", "stats_url", "metrics_port"])
def test_engine_config_telemetry_knobs_work(tmp_path, knob):
    """The three knobs the engine refused until ROADMAP queue 1 item 9 now
    build, from the dataclass and from a serve file, and act: spans land in
    the tracer; a stats client starts (no hub listens: it buffers, and the
    request is served all the same); the registry answers a scrape."""
    value = {"trace": True, "stats_url": "ws://127.0.0.1:9",
             "metrics_port": _free_port()}[knob]
    path = tmp_path / "serve.json"
    section = {"trace": {"enabled": value}} if knob == "trace" else {knob: value}
    path.write_text(json.dumps({"serve": section}))
    assert getattr(EngineConfig.from_yaml(str(path)), knob) == value
    eng = _engine(**{knob: value}).start()
    try:
        out = eng.generate("the quick brown fox", max_tokens=4, timeout=300.0)
        assert out["tokens"] >= 1 and len(out["trace_id"]) == 32
        if knob == "trace":
            names = {e["name"] for e in eng.tracer.chrome_events() if e.get("ph") == "X"}
            assert {"queue_wait", "prefill_chunk", "request"} <= names
        elif knob == "stats_url":
            assert eng._stats is not None and eng._stats.sent == 0
        else:
            eng._last_publish = 0.0  # mirror the registry now
            eng._publish()
            with urllib.request.urlopen(f"http://127.0.0.1:{value}/metrics",
                                        timeout=30) as resp:
                text = resp.read().decode()
            assert "serve_ttft_ms_count 1" in text
            assert 'serve_requests_total{outcome="completed"} 1' in text
    finally:
        eng.stop()
    assert eng._stats is None and eng._metrics_server is None


def test_server_batch_engine_flags(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "name": "tiny-serve",
        "model": {"dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                 "num_layers": 2},
                  "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                                "max_position_embeddings": 128}}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.infer.server",
         "--config", str(cfg), "--device", "cpu", "--port", "0", "--engine", "batch",
         "--kv-len", "128", "--kv-quant", "--spec-draft-len", "2", "--spec-max-ngram", "2",
         "--weight-dtype", "int4", "--block-size", "16"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "engine=batch" in line, (line, proc.stderr.read() if proc.poll() else "")
        url = line.split(" on ")[-1].strip()
        req = urllib.request.Request(url + "/generate", data=json.dumps(
            {"prompt": "a b a b a b", "max_tokens": 6, "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["engine"] == "batch" and 1 <= out["tokens"] <= 6
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            serve = json.loads(resp.read())["serve"]
        assert serve["kv_quant"] and serve["weight_dtype"] == "int4"
        assert serve["kv_backend"] == "paged" and serve["spec_proposed"] > 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
