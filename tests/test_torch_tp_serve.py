"""The port's tensor-parallel batch engine on a {tp: 2} mesh against its
one-device engine and the JAX package's tp=2 engine, on the CPU.

The port side runs 2 gloo ranks started through the port's launcher
(``tests/torch_tp_serve_worker.py``): rank 0 leads each engine, rank 1
follows its steps. The references run in the test process: the port's
one-device engine, and JAX's engine on a 2-device serving mesh (the first
2 of the 8 virtual CPU devices). The models are ``tests/test_torch_serve``'s
MoE and a one-K/V-head dense model (its K/V heads do not split over tp, so
each rank's arena holds all of them), with a vocabulary of 260 so the
tables split; weights numpy from a seed.

- The arms of JAX's ``tests/test_serve_tp.py`` (base, ``kv_quant``,
  speculation) and the slotted pool: greedy tokens identical to both
  references, the first logprob within 1e-5 of the port's one-device
  engine's; the prefix cache's adoptions equal the one-device engine's.
- The mesh metrics and ``build_serve_mesh`` inside and outside a launched
  world; ``EngineConfig(mesh={"tp": 2, "dp": 2})`` names 10a-dp.
- Reshard-on-load of an fsdp2 run's file into tp=2 (fp and int4): each
  rank's bytes, its quantized slices equal to the whole-tensor
  quantization's, and its blocks equal to those a tp=2 engine keeps of the
  full weights, which serve the same tokens.
- ``swap_params`` into a live tp=2 decode engine, a request straddling the
  cutover; tokens after it equal the one-device engine's on the new
  weights.
- GKV1 between a tp=2 engine and a one-device engine, both ways: adopted
  and exported again, the same bytes.
- The server under the launcher (``--module ...infer.server -- --mesh
  tp=2``) answers ``/generate`` as the one-device server does, before and
  after ``POST /admin/swap_weights`` to a file of other weights, and every
  rank exits 0 after SIGTERM.
"""

import dataclasses
import json
import os
import re
import signal
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.parallel.mesh import (
    build_serve_mesh as jbuild_serve_mesh,
)
from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.safetensors_io import (
    save_safetensors,
)
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import InferenceService
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.models.quantize import quantize_weights
from mlx_cuda_distributed_pretraining_tpu_torch.parallel import mesh as tmesh
from mlx_cuda_distributed_pretraining_tpu_torch.parallel.sharding_rules import param_pspec
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict
from test_torch_dist_train import REPO, launch, wait_ok
from test_torch_serve import MAX_TOKENS, PROMPTS, _random_params, _schedule
from test_torch_dist_train import shared_once

WORKER = os.path.join(REPO, "tests", "torch_tp_serve_worker.py")
BASE = dict(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128)
MODELS = {  # name -> (args, seed)
    "moe": (dict(BASE, num_local_experts=4, num_experts_per_tok=2), 2),
    "moe_b": (dict(BASE, num_local_experts=4, num_experts_per_tok=2), 5),
    "mqa": (dict(BASE, num_kv_heads=1, tie_word_embeddings=False), 3),
}
ENGINE = dict(num_slots=3, max_len=128, prefill_chunk=16)
SPEC_ARM = {"spec_draft_len": 4, "spec_max_ngram": 3}
ARMS = [("moe", "base", {}), ("moe", "kv_quant", {"kv_quant": True}),
        ("moe", "spec", SPEC_ARM),
        ("moe", "slotted", {"kv_backend": "slotted", "prefix_cache": False}),
        ("mqa", "base", {})]


def np_params(name):
    return _random_params(jl.LlamaArgs(**MODELS[name][0]), MODELS[name][1])


def port_engine(name, params=None, **arm):
    args = tl.LlamaArgs(**MODELS[name][0])
    return BatchEngine(params_from_jax(params or np_params(name), "cpu"), args,
                       TokenizerManager(), EngineConfig(**ENGINE, **arm))


def jax_tp2_engine(name, **arm):
    params = jax.tree_util.tree_map(jnp.asarray, np_params(name))
    return JEngine(params, jl.LlamaArgs(**MODELS[name][0]), JTok(DataConfig()),
                   JConfig(**ENGINE, **arm),
                   mesh=jbuild_serve_mesh({"tp": 2}, devices=jax.devices()[:2]))


def _one_device(name, **arm):
    """(tokens, cached, first logprobs, prefix-cache hits) of the port's
    one-device engine."""
    eng = port_engine(name, **arm)
    eng.start()
    try:
        first = eng.submit(PROMPTS[0], max_tokens=MAX_TOKENS)
        assert first.wait(120)
        rest = [eng.submit(p, max_tokens=MAX_TOKENS) for p in PROMPTS[1:]]
        for r in rest:
            assert r.wait(120)
        reqs = [first] + rest
        return ([list(r.tokens) for r in reqs], [r.cached_tokens for r in reqs],
                [r.logprobs[0] for r in reqs], eng.metrics().get("prefix_cache_hits"))
    finally:
        eng.stop()


def _server_url(log_path, proc, timeout=240.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(log_path) as f:
            m = re.search(r"on (http://127\.0\.0\.1:\d+)", f.read())
        if m:
            return m.group(1)
        assert proc.poll() is None, open(log_path).read()[-4000:]
        time.sleep(0.2)
    raise AssertionError(open(log_path).read()[-4000:])


def _post(url, body, path="/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "tp_serve", _runs)


def _runs(out):
    for name in MODELS:
        np.savez(os.path.join(out, f"{name}.npz"), **jflatten(np_params(name)))
    # the fsdp2 run's file: the full arrays, whatever mesh wrote them
    save_safetensors(os.path.join(out, "model.safetensors"),
                     {k: v.contiguous() for k, v in flatten_dict(
                         params_from_jax(np_params("moe"), "cpu")).items()})
    # the server's swap: the sample config's weights from another seed, x4
    # (at the init's scale every seed's greedy text is the same letter)
    config = os.path.join(REPO, "configs", "model-config-sample.yaml")
    swap_path = os.path.join(out, "swap.safetensors")
    save_safetensors(swap_path, {k: (4 * v).contiguous() for k, v in flatten_dict(
        InferenceService.from_config(config, seed=7, device="cpu").params).items()})
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump({"models": {k: v[0] for k, v in MODELS.items()}, "engine": ENGINE,
                   "prompts": PROMPTS, "max_tokens": MAX_TOKENS, "arms": ARMS}, f)
    worker = launch(2, ["--script", WORKER, "--", out], os.path.join(out, "worker.log"))
    server_log = os.path.join(out, "server.log")
    server = launch(2, ["--module", "mlx_cuda_distributed_pretraining_tpu_torch.infer.server",
                        "--", "--config", config, "--engine", "batch", "--device", "cpu", "--mesh", "tp=2",
                        "--host", "127.0.0.1", "--port", "0", "--kv-len", "128"],
                    server_log)
    ref = {"one": {f"{m}_{a}": _one_device(m, **arm) for m, a, arm in ARMS},
           "jax": {f"{m}_{a}": _schedule(jax_tp2_engine(m, **arm)) for m, a, arm in ARMS
                   if a != "slotted"}}
    ref["one"]["swap_b"] = _one_device("moe_b")
    # the server: a request, a swap to other weights, a request, then
    # SIGTERM to the launcher (it forwards it); the same on one device
    url = _server_url(server_log, server)
    body = {"prompt": "hello there", "max_tokens": 8, "temperature": 0.0}
    got = [_post(url, body)]
    try:
        got.append(_post(url, {"model_path": swap_path}, "/admin/swap_weights"))
    except urllib.error.HTTPError as e:  # the test reads it
        got.append({"swapped": False, "error": e.read().decode()})
    got.append(_post(url, body))
    service = InferenceService.from_config(config, device="cpu")
    service.attach_engine(EngineConfig(max_len=128))
    try:
        want = [service.engine.generate(body["prompt"], max_tokens=8, temperature=0.0)]
        want.append(service.swap_weights({"model_path": swap_path}))
        want.append(service.engine.generate(body["prompt"], max_tokens=8, temperature=0.0))
    finally:
        service.close()
    server.send_signal(signal.SIGTERM)
    ref["server"] = {"got": got, "want": want, "rc": server.wait(timeout=120),
                     "log": open(server_log).read()}
    wait_ok(worker, os.path.join(out, "worker.log"))
    with open(os.path.join(out, "results.json")) as f:
        return json.load(f), ref


@pytest.mark.parametrize("arm", [f"{m}_{a}" for m, a, _ in ARMS])
def test_tp2_greedy_matches_one_device_and_jax_tp2(runs, arm):
    got, ref = runs
    res = got[arm]
    tokens, cached, lp0, hits = ref["one"][arm]
    assert res["tokens"] == tokens
    np.testing.assert_allclose(res["lp0"], lp0, rtol=0, atol=1e-5)
    if arm in ref["jax"]:
        assert res["tokens"] == ref["jax"][arm][0]
    assert res["cached"] == cached  # the prefix cache adopted as much
    assert res["hits"] == hits
    assert res["mesh"] == "tp=2"
    if arm == "moe_spec":
        assert res["spec"][0] >= res["spec"][1] > 0


def test_tp2_prefix_cache_adoption_matches_one_device(runs):
    got, ref = runs
    res = got["moe_base"]
    assert res["cached"] == ref["one"]["moe_base"][1] == ref["jax"]["moe_base"][1]
    assert sum(res["cached"]) > 0 and res["hits"] == ref["one"]["moe_base"][3] >= 1


def test_tp2_mesh_metrics_and_shapes(runs):
    got, _ = runs
    res = got["moe_base"]
    assert res["devices"] == 2 and res["axis_tp"] == 2
    assert got["mesh"] == {"shape": {"tp": 2}, "size": 2, "one": True}
    assert port_engine("moe").metrics()["mesh"] == "1dev"


@pytest.mark.parametrize("spec", ["tp=2", {"tp": 2}, "dp=1,tp=4"])
def test_serve_mesh_outside_a_launched_world_names_the_launcher(spec):
    with pytest.raises(ValueError, match="parallel.launch"):
        tmesh.build_serve_mesh(spec)
    assert tmesh.build_serve_mesh("tp=1,dp=1") is None


@pytest.mark.parametrize("mesh", [{"tp": 2, "dp": 2}, "dp=2,tp=1"])
def test_serving_dp_axis_names_10a_dp(mesh):
    with pytest.raises(NotImplementedError, match="10a-dp"):
        EngineConfig(mesh=mesh)
    with pytest.raises(NotImplementedError, match="10a-dp"):
        tmesh.build_serve_mesh(mesh)


@pytest.mark.parametrize("wd", ["fp", "int4"])
def test_reshard_on_load_fsdp2_file_into_tp2(runs, wd):
    got, ref = runs
    res = got[f"reshard_{wd}"]
    full = flatten_dict(params_from_jax(np_params("moe"), "cpu"))
    if wd != "fp":
        full = flatten_dict(quantize_weights(params_from_jax(np_params("moe"), "cpu"), wd))
    mesh = tmesh.abstract_mesh({"tp": 2})
    expected = actual = 0
    for k, v in full.items():
        nbytes = v.numel() * v.element_size()
        sharded = any(a is not None for a in param_pspec(k, tuple(v.shape), mesh))
        expected += nbytes * (1 if sharded else 2)
        actual += res["bytes"][0][k] + res["bytes"][1][k]
    assert actual == expected
    assert res["held"] == [True, True]  # the blocks a tp=2 engine serves
    assert actual < 2 * sum(v.numel() * v.element_size() for v in full.values())
    if wd != "fp":
        # each rank's quantized slice is its block of the whole tensor's
        from mlx_cuda_distributed_pretraining_tpu_torch.parallel.collectives import (
            block_index,
        )
        for r in (0, 1):
            m = tmesh.abstract_mesh({"tp": 2}, rank=r)
            for k, (hexed, shape) in res["blocks"][r].items():
                if hexed is None:
                    continue
                v = full[k]
                want = v[block_index(param_pspec(k, tuple(v.shape), m), v.shape, m)]
                assert list(want.shape) == list(shape), k
                assert bytes.fromhex(hexed) == want.contiguous().numpy().tobytes(), k
        q_bytes = sum(v.numel() * v.element_size() for k, v in full.items()
                      if k.endswith(("weight_q4", "weight_s")))
        assert 0 < q_bytes
    else:
        assert res["tokens"] == ref["one"]["moe_base"][0][:2]


def test_swap_params_into_a_tp2_decode_engine(runs):
    got, ref = runs
    res = got["swap"]
    assert res["version"] == 1 and res["params_version"] == 1
    assert res["base"] == ref["one"]["moe_base"][0][0]
    assert res["straddled"] == MAX_TOKENS  # the straddling request finished
    assert res["post"] == ref["one"]["swap_b"][0][0]  # the new weights' tokens


def test_gkv1_between_tp2_and_one_device_is_byte_identical(runs):
    got, _ = runs
    res = got["gkv1"]
    assert res["n_blocks"] >= 1 and res["p3_blocks"] >= 1
    assert res["adopt_tp"]["adopted"] == res["n_blocks"]
    assert res["adopt_one"]["adopted"] == res["p3_blocks"]
    assert res["tp_again"] and res["one_again"]


def test_server_under_the_launcher_answers_and_every_rank_exits_0(runs):
    _, ref = runs
    srv = ref["server"]
    assert srv["got"][0]["text"] == srv["want"][0]["text"]
    assert srv["got"][0]["tokens"] == srv["want"][0]["tokens"]
    assert srv["rc"] == 0, srv["log"][-4000:]
    assert "rank 1/2" in srv["log"]


def test_server_swap_weights_under_the_launcher(runs):
    """POST /admin/swap_weights on the tp=2 server: every rank cuts its
    blocks of the new file, and /generate answers as the one-device server
    does on the new weights."""
    _, ref = runs
    got, want = ref["server"]["got"], ref["server"]["want"]
    assert got[1]["swapped"], got[1]
    assert got[1]["params_version"] == want[1]["params_version"] == 1
    assert got[2]["tokens"] == want[2]["tokens"]
    assert got[2]["text"] == want[2]["text"]
    assert got[2]["text"] != got[0]["text"]  # the new weights answer


def test_port_tp_serving_config_fields_stay_jax_names():
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    assert "mesh" in fields and EngineConfig(mesh="tp=2").mesh == {"tp": 2}
