"""The torch port's weight-only quantization against the JAX package's, on
the CPU (JAX's ``tests/test_quantize.py``, serving half).

The same weights (JAX's ``init_params`` from a fixed key, carried across as
numpy with ``convert.params_from_jax``) are quantized by both packages: the
quantized leaves must be equal (int values and the fp32 scales, bitwise),
int4 packing bit-exact in both directions, and forwards over quantized
trees equal JAX's at fp32 tolerance (1e-5 relative and absolute). The batch
engine's w8 greedy tokens equal its fp ones on the test model (JAX's
acceptance bar), also over the int8 KV pool and under prefix-cache
adoption; quantize-on-load equals host quantization; a live w8 engine
hot-swaps an fp checkpoint into its own layout; and a quantized checkpoint
written by either package loads in the other.

JAX-only tests with no counterpart here: the reshard-on-load byte budget
(per-device slices of a mesh, ROADMAP queue 1 item 10), the dequant-
materialization audit rule and the compiled-program audit (they read
lowered XLA programs), and the decode-bandwidth roofline model
(``obs/flops.py``, item 9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.checkpoint.manager import (
    CheckpointManager as JManager,
)
from mlx_cuda_distributed_pretraining_tpu.checkpoint.safetensors_io import (
    save_safetensors as jsave,
)
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.models import quantize as jq
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflat
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import CheckpointManager
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.safetensors_io import (
    load_safetensors,
    save_safetensors,
)
from mlx_cuda_distributed_pretraining_tpu_torch.convert import (
    params_from_flat,
    params_from_jax,
)
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.models import quantize as tq
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict

TOL = dict(rtol=1e-5, atol=1e-5)
TOK = TokenizerManager()
BASE = dict(vocab_size=TOK.vocab_size, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
            max_position_embeddings=128)
JARGS = jl.LlamaArgs(**BASE)
JPARAMS = jl.init_params(jax.random.PRNGKey(0), JARGS)
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
MOE_JARGS = jl.LlamaArgs(**BASE, num_local_experts=4, num_experts_per_tok=2)
MOE_NP = jax.tree_util.tree_map(
    np.asarray, jl.init_params(jax.random.PRNGKey(1), MOE_JARGS))
MAX_LEN = 128
PROMPTS = ["the quick brown fox", "a b c a b c a"]


def _port_args(jargs, **kw):
    fields = {f.name for f in dataclasses.fields(tl.LlamaArgs)}
    return tl.LlamaArgs(**{**{k: v for k, v in dataclasses.asdict(jargs).items()
                              if k in fields}, **kw})


ARGS = _port_args(JARGS)
PARAMS = params_from_jax(NP_PARAMS, "cpu")


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in flatten_dict(tree).items()}


# -- quantization core --------------------------------------------------------
def test_check_weight_dtype_normalizes_and_rejects():
    for raw, want in ((None, "fp"), ("", "fp"), ("FP32", "fp"), ("bf16", "fp"),
                      ("INT8", "int8"), ("int4", "int4")):
        assert tq.check_weight_dtype(raw) == jq.check_weight_dtype(raw) == want
    with pytest.raises(ValueError, match="weight_dtype"):
        tq.check_weight_dtype("fp8")


@pytest.mark.parametrize("wd", ["int8", "int4"])
@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_per_channel_round_trip_matches_jax(wd, kind):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    leaf = tq.quantize_leaf(torch.from_numpy(w) if kind == "torch" else w, wd)
    jleaf = jq.quantize_leaf(jnp.asarray(w), wd)
    assert set(leaf) == set(jleaf)
    for k in leaf:  # exact: the same grid, the same rounding
        np.testing.assert_array_equal(np.asarray(leaf[k]), np.asarray(jleaf[k]), err_msg=k)
    back = np.asarray(tq.dequantize_leaf(leaf))
    step = np.asarray(leaf["weight_s"])
    assert (np.abs(back - w).max(axis=0) <= step / 2 + 1e-6).all()


def test_int4_pack_unpack_bit_exact_with_jax():
    rng = np.random.default_rng(1)
    vals = rng.integers(-7, 8, size=(64, 24)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(vals))
    assert packed.shape == (32, 24) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), vals)
    np.testing.assert_array_equal(tq.pack_int4(vals), np.asarray(jq.pack_int4(vals)))
    # the expert-bank layout, and JAX's packing unpacked by the port
    bank = rng.integers(-7, 8, size=(3, 16, 8)).astype(np.int8)
    jpacked = np.array(jq.pack_int4(jnp.asarray(bank)))
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(jpacked)).numpy(), bank)
    with pytest.raises(ValueError, match="even contraction"):
        tq.pack_int4(torch.from_numpy(vals[:63]))


def test_quantized_key_shapes_and_odd_contraction():
    cases = [("layers.0.attention.wq.weight", (32, 32), "int4"),
             ("layers.0.attention.wq.weight", (33, 32), "int4"),
             ("layers.0.attention.wq.weight", (33, 32), "int8"),
             ("layers.1.feed_forward.experts.w_down.weight", (4, 64, 32), "int4"),
             ("layers.0.attention_norm.weight", (32,), "int8"),
             ("tok_embeddings.weight", (256, 32), "int8"),
             ("layers.0.feed_forward.router.weight", (32, 4), "int8")]
    for path, shape, wd in cases:
        assert tq.quantized_key_shapes(path, shape, wd) == \
            jq.quantized_key_shapes(path, shape, wd), (path, shape, wd)
    assert tq.quantized_key_shapes("layers.0.attention.wq.weight", (33, 32), "int4") is None


@pytest.mark.parametrize("wd", ["int8", "int4"])
@pytest.mark.parametrize("model", ["dense", "moe"])
def test_quantize_weights_matches_jax_leaf_for_leaf(wd, model):
    np_params = NP_PARAMS if model == "dense" else MOE_NP
    got = _np(tq.quantize_weights(params_from_jax(np_params, "cpu"), wd))
    want = {k: np.asarray(v) for k, v in
            jflat(jq.quantize_weights(jax.tree_util.tree_map(jnp.asarray, np_params),
                                      wd)).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tq.weight_dtype_of(tq.quantize_weights(params_from_jax(np_params, "cpu"), wd)) == wd
    assert tq.weight_plane_bytes(tq.quantize_weights(params_from_jax(np_params, "cpu"), wd)) \
        == jq.weight_plane_bytes(jq.quantize_weights(np_params, wd))


def test_quantize_slice_np_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 32, 24)).astype(np.float32)
    for wd, bits in (("int8", 8), ("int4", 4)):
        s = tq.channel_scales(w, bits)
        np.testing.assert_array_equal(s, np.asarray(jq.channel_scales(w, bits)))
        idx = (slice(1, 3), slice(0, 8), slice(4, 20))
        np.testing.assert_array_equal(tq.quantize_slice_np(w, s, idx, wd),
                                      jq.quantize_slice_np(w, s, idx, wd))
        q = tq.quantize_slice_np(w, s, (slice(None),), wd)
        np.testing.assert_array_equal(tq.dequantize_np(q, s, wd == "int4"),
                                      jq.dequantize_np(q, s, wd == "int4"))


@pytest.mark.parametrize("wd", ["int8", "int4"])
@pytest.mark.parametrize("model", ["dense", "moe_grouped", "moe_einsum"])
def test_quantized_forward_matches_jax(wd, model):
    if model == "dense":
        jargs, np_params = JARGS, NP_PARAMS
    else:
        jargs = dataclasses.replace(MOE_JARGS, moe_impl=model.split("_")[1])
        np_params = MOE_NP
    jpq = jq.quantize_weights(jax.tree_util.tree_map(jnp.asarray, np_params), wd)
    tpq = tq.quantize_weights(params_from_jax(np_params, "cpu"), wd)
    toks = np.array([[5, 9, 3, 7, 2, 8, 1, 4]], np.int32)
    jout, _ = jl.forward(jpq, jnp.asarray(toks), jargs)
    tout, _ = tl.forward(tpq, torch.from_numpy(toks).long(), _port_args(jargs))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_quantize_params_int8_is_int8_quantize_weights():
    a = _np(tl.quantize_params_int8(PARAMS))
    b = _np(tq.quantize_weights(PARAMS, "int8"))
    assert set(a) == set(b) and all((a[k] == b[k]).all() for k in a)


def test_bf16_compute_keeps_int8_leaves_int8():
    # JAX's compute-dtype cast leaves int8 leaves int8 and casts the scales
    pq = tq.quantize_weights(PARAMS, "int8")
    cast = tl._cast(pq["layers"][0], torch.bfloat16)
    assert cast["attention"]["wq"]["weight_q"].dtype == torch.int8
    assert cast["attention"]["wq"]["weight_s"].dtype == torch.bfloat16
    toks = torch.tensor([[5, 9, 3, 7]])
    logits, _ = tl.forward(pq, toks, ARGS, compute_dtype=torch.bfloat16)
    assert torch.isfinite(logits).all()


# -- engine parity ------------------------------------------------------------
def _engine(**kw):
    cfg = EngineConfig(**{"num_slots": 2, "max_len": MAX_LEN, "prefill_chunk": 16, **kw})
    return BatchEngine(PARAMS, ARGS, TOK, cfg)


def _collect(eng, prompts, max_tokens=20):
    eng.start()
    try:
        reqs = [eng.submit(p, max_tokens=max_tokens, temperature=0.0) for p in prompts]
        assert all(r.wait(300) and r.error is None for r in reqs)
        return [dict(r.result) for r in reqs], eng.metrics()
    finally:
        eng.stop()


@pytest.mark.parametrize("arm", [
    {"weight_dtype": "int8"},
    {"weight_dtype": "int8", "kv_quant": True},   # w8 over the int8 KV pool
    {"weight_dtype": "int4"},
], ids=["w8", "w8_kv8", "w4"])
def test_weight_quant_greedy_matches_fp(arm):
    ref, _ = _collect(_engine(**{k: v for k, v in arm.items() if k != "weight_dtype"}),
                      PROMPTS)
    q, m = _collect(_engine(**arm), PROMPTS)
    assert m["weight_dtype"] == arm["weight_dtype"]
    assert m["weight_bytes"] < tq.weight_plane_bytes(PARAMS)
    for r, t in zip(ref, q):
        assert t["finish_reason"] == r["finish_reason"]
        if arm["weight_dtype"] == "int8":  # the acceptance bar: token-exact
            assert t["token_ids"] == r["token_ids"]


def test_weight_quant_engine_greedy_matches_jax_engine():
    from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
    from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
    from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
    from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok

    jeng = JEngine(JPARAMS, JARGS, JTok(DataConfig()),
                   JConfig(num_slots=2, max_len=MAX_LEN, prefill_chunk=16,
                           weight_dtype="int8", kv_quant=True)).start()
    try:
        want = [jeng.generate(p, max_tokens=20, temperature=0.0, timeout=300)["text"]
                for p in PROMPTS]
    finally:
        jeng.stop()
    eng = _engine(weight_dtype="int8", kv_quant=True).start()
    try:
        got = [eng.generate(p, max_tokens=20, temperature=0.0, timeout=300)["text"]
               for p in PROMPTS]
    finally:
        eng.stop()
    assert got == want


def test_weight_quant_prefix_cache_adoption_parity():
    shared = "the quick brown fox jumps over the lazy dog and then"
    prompts = [shared + " stops", shared + " keeps going"]

    def run(eng):
        eng.start()
        try:
            outs = [eng.generate(p, max_tokens=16, temperature=0.0, timeout=300)
                    for p in prompts]
            return outs, eng.metrics()["prefix_cache_hits"]
        finally:
            eng.stop()

    ref, ref_hits = run(_engine(block_size=16, prefix_min_hit_blocks=1))
    q, q_hits = run(_engine(block_size=16, prefix_min_hit_blocks=1, weight_dtype="int8"))
    assert q_hits == ref_hits and q_hits >= 1
    for r, t in zip(ref, q):
        assert t["token_ids"] == r["token_ids"]
        assert t["prefix_cached_tokens"] == r["prefix_cached_tokens"]
    assert q[1]["prefix_cached_tokens"] > 0


def test_engine_hot_swap_fp_checkpoint_into_quantized_replica(tmp_path):
    # a live w8 engine takes an fp checkpoint: swap_params quantizes it into
    # the serving layout, bumps the version, and greedy output is unchanged
    path = str(tmp_path / "model.safetensors")
    save_safetensors(path, flatten_dict(PARAMS))
    eng = _engine(weight_dtype="int8").start()
    try:
        base = eng.generate(PROMPTS[0], max_tokens=16, temperature=0.0, timeout=300)
        loaded = CheckpointManager.load_params(path, like=PARAMS)
        assert eng.swap_params(loaded) == 1
        post = eng.generate(PROMPTS[0], max_tokens=16, temperature=0.0, timeout=300)
        m = eng.metrics()
        assert m["params_version"] == 1 and m["weight_dtype"] == "int8"
        assert tq.weight_dtype_of(eng.params) == "int8"
        assert post["token_ids"] == base["token_ids"]
    finally:
        eng.stop()


def test_swap_fail_fault_leaves_the_weights_in_place():
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import faults

    eng = _engine(weight_dtype="int8")
    before = eng.params
    faults.reset()
    try:
        with faults.active("engine.swap_fail") as rule:
            with pytest.raises(RuntimeError, match="injected swap failure"):
                eng.swap_params(PARAMS)
        assert rule.fires == 1
        assert eng.params is before and eng.params_version == 0
        assert eng.metrics()["faults_injected"] == {"engine.swap_fail": 1}
    finally:
        faults.reset()


# -- quantize-on-load ---------------------------------------------------------
@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_load_params_quantize_matches_host_quantization(tmp_path, wd):
    path = str(tmp_path / "model.safetensors")
    save_safetensors(path, flatten_dict(PARAMS))
    loaded = CheckpointManager.load_params(path, like=PARAMS, weight_dtype=wd)
    want = _np(tq.quantize_weights(PARAMS, wd))
    got = _np(loaded)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    # a quantized like names the dtype without weight_dtype
    again = _np(CheckpointManager.load_params(path, like=tq.quantize_weights(PARAMS, wd)))
    assert all((again[k] == want[k]).all() for k in want)
    # and JAX's load of the same file gives the same leaves
    jloaded = JManager.load_params(path, like=JPARAMS, weight_dtype=wd)
    for k, v in jflat(jloaded).items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_quantized_checkpoint_loads_across_packages(tmp_path, direction):
    path = str(tmp_path / "model_int4.safetensors")
    toks = np.array([[5, 9, 3, 7, 2, 8]], np.int32)
    if direction == "jax_to_port":
        jpq = jq.quantize_weights(JPARAMS, "int4")
        jsave(path, {k: np.asarray(v) for k, v in jflat(jpq).items()})
        arrays, _ = load_safetensors(path)
        tpq = params_from_flat(arrays, "cpu")
    else:
        tpq = tq.quantize_weights(PARAMS, "int4")
        save_safetensors(path, flatten_dict(tpq))
        jpq = JManager.load_params(path, like=jq.quantize_weights(JPARAMS, "int4"))
    assert tq.weight_dtype_of(tpq) == jq.weight_dtype_of(jpq) == "int4"
    jout, _ = jl.forward(jpq, jnp.asarray(toks), JARGS)
    tout, _ = tl.forward(tpq, torch.from_numpy(toks).long(), ARGS)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_load_trained_and_cli_weight_quant(tmp_path):
    # a run trained by the port, served quantized through load_trained, the
    # server's from_run and the CLI's --weight-quant
    from test_torch_train import _config_dict

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.infer import cli
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import InferenceService
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer, load_trained

    runs = str(tmp_path / "runs")
    Trainer(Config.from_dict(_config_dict(tmp_path, name="q", iters=2)),
            runs_root=runs, device="cpu").train()
    params, _, _, _ = load_trained("q", runs_root=runs, device="cpu", weight_dtype="int4")
    fp, _, _, _ = load_trained("q", runs_root=runs, device="cpu")
    want = _np(tq.quantize_weights(fp, "int4"))
    got = _np(params)
    assert set(got) == set(want) and all((got[k] == want[k]).all() for k in want)
    svc = InferenceService.from_run("q", runs_root=runs, device="cpu", weight_dtype="int8")
    assert tq.weight_dtype_of(svc.params) == "int8"
    text = cli.main(["--run", "q", "--runs-root", runs, "--device", "cpu", "--prompt",
                     "the", "--max-tokens", "4", "--temperature", "0", "--weight-quant"])
    assert isinstance(text, str)
