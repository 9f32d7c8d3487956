"""The torch port's MoE block, decoder layer and paged serving steps against
the JAX package's, fp32 on the CPU.

Weights are drawn with numpy from a seed at the JAX parameter shapes and
carried into the port with ``convert.params_from_jax``; inputs likewise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.models import moe as jmoe
from mlx_cuda_distributed_pretraining_tpu.serve import batch_step as jbs
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.models import moe as tmoe
from mlx_cuda_distributed_pretraining_tpu_torch.serve import batch_step as tbs

FIELDS = dict(vocab_size=259, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
              max_position_embeddings=128, num_local_experts=4,
              num_experts_per_tok=2)
JARGS = jl.LlamaArgs(**FIELDS)
TARGS = tl.LlamaArgs(**FIELDS)
# fp32 on both sides; the two packages sum matmuls in different orders.
TOL = dict(atol=1e-5, rtol=1e-5)


def _random_params(args, seed):
    """numpy weights at the JAX shapes: fan-in-scaled projections, small
    tied embeddings, norms near one (so every layer moves the output)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if x.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        name = jax.tree_util.keystr(path)
        s = 0.05 if "tok_embeddings" in name else 1.5 * x.shape[-2] ** -0.5
        return (s * rng.standard_normal(x.shape)).astype(np.float32)

    shapes = jl.init_params(jax.random.PRNGKey(0), args)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _both(args, seed):
    np_params = _random_params(args, seed)
    return (jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_jax(np_params, "cpu"))


@pytest.mark.parametrize("backend", ["blocked", "pallas"])
def test_moe_block_matches_jax(backend, monkeypatch):
    # GMM_BACKEND=pallas runs the JAX Pallas kernel in interpret mode.
    monkeypatch.setenv("GMM_BACKEND", backend)
    jp, tp = _both(JARGS, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 9, 32)).astype(np.float32)
    ref, ref_aux = jmoe.moe_block(jp["layers"][0]["feed_forward"],
                                  jnp.asarray(x), JARGS)
    out, aux = tmoe.moe_block(tp["layers"][0]["feed_forward"],
                              torch.from_numpy(x), TARGS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)


def test_init_params_tree_matches_jax():
    from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflat
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict

    for args, targs in ((JARGS, TARGS), (
            dataclasses.replace(JARGS, num_local_experts=0,
                                num_experts_per_tok=0, tie_word_embeddings=False),
            dataclasses.replace(TARGS, num_local_experts=0,
                                num_experts_per_tok=0, tie_word_embeddings=False))):
        ref = {k: tuple(v.shape) for k, v in
               jflat(jl.init_params(jax.random.PRNGKey(0), args)).items()}
        got = {k: tuple(v.shape) for k, v in flatten_dict(
            tl.init_params(targs, torch.Generator().manual_seed(0),
                           device="cpu")).items()}
        assert got == ref


def test_decoder_layer_matches_jax():
    # One layer: the JAX cache-free block (reference attention, causal) vs
    # the port's paged layer stack writing a fresh arena; the port applies
    # the final norm, so the reference does too.
    args1 = dataclasses.replace(JARGS, num_layers=1)
    targs1 = dataclasses.replace(TARGS, num_layers=1)
    jp, tp = _both(args1, seed=5)
    S = 24
    x = np.random.default_rng(6).standard_normal((1, S, 32)).astype(np.float32)
    y, _cache, _aux = jl.transformer_block(
        jp["layers"][0], jnp.asarray(x), args1, jnp.arange(S))
    ref = jl.rms_norm(y, jp["norm"]["weight"], args1.rms_norm_eps)

    block = 8
    cache = tl.init_paged_cache(targs1, 5, block, device="cpu")
    table = torch.tensor([[1, 2, 3, 4]])
    positions = torch.arange(S)[None]
    mask = torch.arange(32)[None, :] <= positions[0][:, None]
    out = tbs._layers(tp, cache, torch.from_numpy(x), positions, table, mask,
                      targs1, attend_len=32, block_size=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_paged_steps_match_jax():
    # The slice's two device steps on a 2-layer MoE model: a 16-token
    # prefill chunk with logits, then one decode step for two rows (one of
    # them masked onto the junk block).
    jp, tp = _both(JARGS, seed=7)
    block, width, chunk = 8, 4, 16
    prompt = np.random.default_rng(8).integers(0, 256, size=11)
    toks = np.zeros(chunk, np.int32)
    toks[:11] = prompt
    table = np.array([3, 1, 0, 0], np.int32)

    jcache = jl.init_paged_cache(JARGS, 6, block)
    jstep = jbs.paged_prefill_step(JARGS, chunk, 16, width, block, True)
    jcache, jlog = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(table),
                         jnp.int32(0), jnp.int32(10))
    tcache = tl.init_paged_cache(TARGS, 6, block, device="cpu")
    tlog = tbs.paged_prefill_step(
        tp, tcache, torch.from_numpy(toks).long(),
        torch.from_numpy(table).long(), 0, 10, TARGS, attend_len=16,
        block_size=block, with_logits=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for jl_, tl_ in zip(jcache, tcache):
        np.testing.assert_allclose(tl_["k"].numpy(), np.asarray(jl_["k"]), **TOL)

    tables = np.array([[3, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    tokens = np.array([[int(np.argmax(np.asarray(jlog)))], [0]], np.int32)
    pos = np.array([11, 0], np.int32)
    jdec = jbs.paged_decode_step(JARGS, 0, 16, width, block)
    jout = jdec(jp, jcache, jnp.asarray(tokens), jnp.asarray(pos),
                jnp.asarray(tables), jnp.zeros(2, jnp.float32),
                jnp.zeros((2, 2), jnp.uint32))
    tlog = tbs.paged_decode_step(
        tp, tcache, torch.from_numpy(tokens[:, 0]).long(),
        torch.from_numpy(pos).long(), torch.from_numpy(tables).long(),
        TARGS, attend_len=16, block_size=block)
    # jout[1]/[2]: greedy predictions and their raw-logits logprobs
    tok, lp = tbs.sample_rows(tlog, [0.0, 0.0], [None, None])
    assert tok == [int(t) for t in np.asarray(jout[1])[:, 0]]
    np.testing.assert_allclose(lp, np.asarray(jout[2])[:, 0], **TOL)
