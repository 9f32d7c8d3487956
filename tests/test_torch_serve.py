"""The torch port's serving path against the JAX package's, on the CPU.

Both batch engines serve the same tiny model (numpy weights from a seed,
carried across with ``convert.params_from_jax``) to the same schedule: one
request alone, then three concurrent greedy requests, one of which adopts
the first one's prompt blocks from the prefix cache. The JAX engine runs as
its own tests run it (the default "blocked" gmm backend off the TPU).

The seeds are chosen so greedy decoding is decided by a clear margin: along
every greedy trajectory below, the smallest top-2 logit gap is 6.6e-3 (MoE,
seed 2) and 2.0e-2 (dense, seed 0), against fp32 differences near 1e-6
between the two packages.
"""

import dataclasses
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
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
    InferenceService,
    request_generate,
    serve,
)
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "mlx_cuda_distributed_pretraining_tpu_torch"
BASE = dict(vocab_size=259, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
            max_position_embeddings=128)
MODELS = {
    "moe": (dict(num_local_experts=4, num_experts_per_tok=2), 2),
    "dense": (dict(tie_word_embeddings=False), 0),
}
PREFIX = "The quick brown fox jumps over the lazy dog; "  # > one 32-token block
# The two short prompts prefill in one 16-token chunk: the JAX engine's
# decode step writes junk through the tables of rows still prefilling, so a
# multi-chunk prefill beside a decoding row is not a schedule to compare on
# (test_concurrency_keeps_each_requests_greedy_tokens covers it in the port).
PROMPTS = [PREFIX + "again.", PREFIX + "and then?", "hello there",
           "zebra 123"]
MAX_TOKENS = 12


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


def _schedule(engine):
    """PROMPTS[0] alone (its blocks enter the prefix cache), then the rest
    concurrently. Returns (token lists, cached prompt tokens) per prompt."""
    engine.start()
    try:
        first = engine.submit(PROMPTS[0], max_tokens=MAX_TOKENS)
        assert first.wait(120)
        rest = [engine.submit(p, max_tokens=MAX_TOKENS) for p in PROMPTS[1:]]
        for r in rest:
            assert r.wait(120)
        reqs = [first] + rest
        assert all(r.error is None for r in reqs)
        return [list(r.tokens) for r in reqs], [r.cached_tokens for r in reqs]
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def models():
    """name -> (jax args, numpy params, JAX engine tokens, cached tokens)."""
    out = {}
    for name, (extra, seed) in MODELS.items():
        jargs = jl.LlamaArgs(**BASE, **extra)
        np_params = _random_params(jargs, seed)
        jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
        cfg = JConfig(num_slots=3, max_len=128, prefill_chunk=16)
        tokens, cached = _schedule(
            JEngine(jparams, jargs, JTok(DataConfig()), cfg))
        out[name] = (jargs, np_params, tokens, cached)
    return out


def _port_args(jargs):
    fields = {f.name for f in dataclasses.fields(tl.LlamaArgs)}
    return tl.LlamaArgs(**{k: v for k, v in dataclasses.asdict(jargs).items()
                           if k in fields})


def _port_engine(args, params):
    return BatchEngine(params, args, TokenizerManager(),
                       EngineConfig(num_slots=3, max_len=128, prefill_chunk=16))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_batch_engine_greedy_matches_jax(models, name):
    jargs, np_params, ref_tokens, ref_cached = models[name]
    tokens, cached = _schedule(
        _port_engine(_port_args(jargs), params_from_jax(np_params, "cpu")))
    assert tokens == ref_tokens
    assert sum(len(t) for t in tokens) >= 3 * MAX_TOKENS
    # the second prompt adopted the first one's full block from the cache
    assert cached == ref_cached and cached[1] == 32


def test_preemption_recompute_keeps_greedy_tokens(models):
    # An arena too small for both sequences at full length (2 rows x up to
    # 3 blocks, 4 blocks in all): the younger request is preempted and
    # re-prefilled, and both outputs equal an unconstrained run's.
    jargs, np_params, _, _ = models["moe"]
    args, params = _port_args(jargs), params_from_jax(np_params, "cpu")

    def run(**kw):
        eng = BatchEngine(params, args, TokenizerManager(), EngineConfig(
            num_slots=2, max_len=128, prefill_chunk=16, **kw)).start()
        try:
            reqs = [eng.submit(p, max_tokens=60) for p in PROMPTS[:2]]
            assert all(r.wait(120) and r.error is None for r in reqs)
            return [list(r.tokens) for r in reqs], eng.metrics()
        finally:
            eng.stop()

    roomy, _ = run()
    tight, m = run(num_blocks=4, block_size=32)
    assert tight == roomy and m["preempted"] >= 1
    assert m["kv_blocks_used"] == 0 and m["kv_blocks_free"] == 4


def test_concurrency_keeps_each_requests_greedy_tokens(models):
    # Multi-chunk prefills (4 and 7 chunks of 16) run beside a decoding row:
    # every request's greedy tokens equal the ones it gets when served alone
    # (decode steps must not write through the tables of rows that are still
    # prefilling; the JAX engine does, so it is not the reference here).
    jargs, np_params, _, _ = models["moe"]
    args, params = _port_args(jargs), params_from_jax(np_params, "cpu")
    long_prompt = PREFIX * 2 + "and so on."  # 101 tokens

    def serve_all(prompts):
        eng = _port_engine(args, params).start()
        try:
            reqs = [eng.submit(p, max_tokens=24) for p in prompts]
            assert all(r.wait(120) and r.error is None for r in reqs)
            return [list(r.tokens) for r in reqs], eng.metrics()
        finally:
            eng.stop()

    alone = [serve_all([p])[0][0] for p in (PROMPTS[2], long_prompt)]
    together, m = serve_all([PROMPTS[2], PROMPTS[0], long_prompt])
    assert together[0] == alone[0] and together[2] == alone[1]
    assert m["prefill_chunks"] == 1 + 4 + 7 and m["completed"] == 3


def test_load_trained_serves_jax_written_run(models, tmp_path):
    import yaml

    from mlx_cuda_distributed_pretraining_tpu.checkpoint.safetensors_io import (
        save_safetensors,
    )
    from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import load_trained

    jargs, np_params, ref_tokens, _ = models["moe"]
    run = tmp_path / "tiny-moe"
    (run / "checkpoints").mkdir(parents=True)
    cfg = {"name": "tiny-moe", "model": {
        "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                       "num_layers": 2},
        "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                      "max_position_embeddings": 128},
        "moe": {"num_local_experts": 4, "num_experts_per_tok": 2,
                "impl": "grouped"}}}
    (run / "config.yaml").write_text(yaml.safe_dump(cfg))
    JTok(DataConfig()).save_to_run_dir(str(run))
    flat = flatten_dict(np_params)
    save_safetensors(str(run / "checkpoints" / "step_20_model.safetensors"),
                     {k: v * 0 for k, v in flat.items()})  # older step
    save_safetensors(str(run / "checkpoints" / "step_final_model.safetensors"),
                     flat)

    params, args, tok, _cfg = load_trained(str(run), device="cpu")
    assert args == _port_args(jargs) and tok.vocab_size == 259
    tokens, _ = _schedule(_port_engine(args, params))
    assert tokens == ref_tokens


def test_safetensors_bf16_interop(tmp_path):
    import ml_dtypes

    from mlx_cuda_distributed_pretraining_tpu.checkpoint import safetensors_io as jst
    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint import (
        safetensors_io as tst,
    )

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((4,)).astype(np.float32)
    jst.save_safetensors(str(tmp_path / "j.safetensors"), {"a": a, "b": b})
    got, _ = tst.load_safetensors(str(tmp_path / "j.safetensors"))
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(got["b"].numpy(), b)
    tst.save_safetensors(str(tmp_path / "t.safetensors"), got)
    back, _ = jst.load_safetensors(str(tmp_path / "t.safetensors"))
    np.testing.assert_array_equal(back["a"].view(np.int16), a.view(np.int16))


def test_server_generate_on_cpu(models):
    jargs, np_params, ref_tokens, _ = models["dense"]
    service = InferenceService(params_from_jax(np_params, "cpu"),
                               _port_args(jargs), TokenizerManager(),
                               run_name="tiny")
    # EngineConfig's default max_len (2048) exceeds this model's 128
    # positions: attach_engine clamps it.
    service.attach_engine(EngineConfig(num_slots=2, prefill_chunk=16))
    httpd = serve(service, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = request_generate(url, PROMPTS[2], max_tokens=MAX_TOKENS)
        assert out["token_ids"] == ref_tokens[2]
        assert out["tokens"] == MAX_TOKENS and out["finish_reason"] == "length"
        # top_p reshapes the logits: served by the locked path (200), not
        # by the batch engine, which samples by temperature only
        out = request_generate(url, "abc", max_tokens=4, top_p=0.9)
        assert "engine" not in out and out["effective_params"]["top_p"] == 0.9
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["serve"]["completed"] == 1
        assert service.engine.pool.max_len == 128
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()


def test_port_imports_without_jax():
    # Every module of the port, and chip_smoke.py, imports with jax made
    # unimportable; the walk reaches the serving and the training slices.
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        f"import {PKG} as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.startswith("
        "'mlx_cuda_distributed_pretraining_tpu.') or m == "
        "'mlx_cuda_distributed_pretraining_tpu']\n"
        "assert not bad, bad\n"
        "print('\\n'.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    for mod in ("serve.engine", "infer.server", "ops.grouped_matmul",
                "ops.flash_attention", "ops.kernel_check", "models.llama",
                "models.moe", "optim.fused", "optim.schedules", "optim.factory",
                "data.memory",
                "checkpoint.manager", "obs.logger", "obs.flops",
                "train.train_step", "train.trainer", "utils.cuda_build",
                "optim.enhanced", "optim.muon", "optim.shampoo", "train.lr_finder",
                "ops.flex_attention", "infer.generate", "infer.samplers",
                "infer.cli", "infer.agent"):
        assert f"{PKG}.{mod}" in names, mod
