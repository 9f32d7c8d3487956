"""The torch port's locked generation path (``infer/generate.py``, the static
KV cache in ``models/llama.py``, ``infer/samplers.py``, ``infer/cli.py``)
against the JAX package's, fp32 on the CPU.

The cases mirror ``tests/test_generate.py`` with the port beside the JAX
package: the same tiny models (its ``ARGS``, and a 2-layer, 4-expert MoE
whose experts go through the grouped dispatch; the JAX gmm runs its
default off-TPU backend, as its own tests run it) with numpy weights from a
seed carried across with ``convert.params_from_jax``. Fan-in-scaled weights
keep greedy decoding away from ties: fp32 differences between the packages
are near 1e-6. Sampled paths are compared by their support and
distribution, never token for token (``torch.Generator`` and
``jax.random`` draw differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.infer import generate as jg
from mlx_cuda_distributed_pretraining_tpu.infer import samplers as js
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.infer import generate as tg
from mlx_cuda_distributed_pretraining_tpu_torch.infer import samplers as ts
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl

FIELDS = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128)
MODELS = {"dense": FIELDS,
          "moe": {**FIELDS, "vocab_size": 128, "num_local_experts": 4,
                  "num_experts_per_tok": 2}}
PROMPT = [1, 5, 9, 3, 7, 2, 11, 4]
REPEATING = [1, 5, 9, 3, 1, 5, 9, 3, 1, 5, 9, 3]
# fp32 on both sides, summed in different orders: |port - jax| stays under
# 1e-5 of the largest |jax| logit.
REL = 1e-5


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
def models():
    """name -> (jax args, jax params, port args, port params)."""
    out = {}
    for name, fields in MODELS.items():
        np_params = _random_params(jl.LlamaArgs(**fields), seed=1)
        out[name] = (jl.LlamaArgs(**fields),
                     jax.tree_util.tree_map(jnp.asarray, np_params),
                     tl.LlamaArgs(**fields), params_from_jax(np_params, "cpu"))
    return out


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _full_argmax(params, args, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        logits, _ = tl.forward(params, torch.tensor([seq]), args)
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(prompt):]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_greedy_matches_argmax_full_forward(models, name):
    ja, jp, ta, tp = models[name]
    ref, ref_stats = jg.generate_lite(jp, ja, PROMPT, max_tokens=12)
    toks, stats = tg.generate_lite(tp, ta, PROMPT, max_tokens=12)
    assert toks == ref
    assert toks == _full_argmax(tp, ta, PROMPT, 12)
    assert len(set(toks)) > 2  # the weights decode something other than a loop
    assert stats["generation_tokens"] == 12.0 and stats["mean_logprob"] <= 0.0
    assert abs(stats["mean_logprob"] - ref_stats["mean_logprob"]) < 1e-5


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_logits_match_jax(models, name, kv_quant):
    # prefill of 8 tokens, then 4 one-token steps, through both caches
    ja, jp, ta, tp = models[name]
    toks = np.random.default_rng(0).integers(1, 60, size=(1, 12))
    jcache = jl.init_cache(ja, 1, max_len=16, quantize=kv_quant)
    tcache = tl.init_cache(ta, 1, max_len=16, quantize=kv_quant, device="cpu")
    jlog, jcache = jl.forward(jp, jnp.asarray(toks[:, :8], jnp.int32), ja,
                              cache=jcache, start_pos=0)
    with torch.no_grad():
        tlog, tcache = tl.forward(tp, torch.from_numpy(toks[:, :8]), ta,
                                  cache=tcache, start_pos=0)
        _close(tlog.numpy(), jlog)
        for i in range(8, 12):
            jlog, jcache = jl.forward(jp, jnp.asarray(toks[:, i:i + 1], jnp.int32), ja,
                                      cache=jcache, start_pos=i, attend_len=16)
            tlog, tcache = tl.forward(tp, torch.from_numpy(toks[:, i:i + 1]), ta,
                                      cache=tcache, start_pos=i, attend_len=16)
            _close(tlog.numpy(), jlog)
    assert tcache[0]["pos"] == int(jcache[0]["pos"]) == 12


def test_stop_tokens(models):
    ja, jp, ta, tp = models["dense"]
    full, _ = tg.generate_lite(tp, ta, PROMPT, max_tokens=8)
    stop_at = full[2]
    toks, stats = tg.generate_lite(tp, ta, PROMPT, max_tokens=8, stop_tokens=[stop_at])
    ref, ref_stats = jg.generate_lite(jp, ja, PROMPT, max_tokens=8, stop_tokens=[stop_at])
    assert toks == ref == full[:full.index(stop_at)]
    assert stats["stopped_on_token"] == ref_stats["stopped_on_token"] == 1.0


def test_samplers_shapes_and_determinism():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64))
                              .astype(np.float32))
    for sampler in [ts.make_sampler(0.0), ts.make_sampler(0.8),
                    ts.top_p_sampler(1.0, 0.9), ts.min_p_sampler(1.0, 0.1),
                    ts.top_k_sampler(1.0, 5)]:
        out = sampler(torch.Generator().manual_seed(0), logits)
        assert out.shape == (2,) and out.dtype == torch.int64
        again = sampler(torch.Generator().manual_seed(0), logits)
        assert torch.equal(out, again)  # one seed, one draw
    assert torch.equal(ts.make_sampler(0.0)(None, logits), logits.argmax(-1))


# (JAX sampler, port sampler) at the same knobs
SUPPORT_CASES = {
    "top_p": (js.top_p_sampler(0.7, 0.6), ts.top_p_sampler(0.7, 0.6)),
    "min_p": (js.min_p_sampler(0.7, 0.2), ts.min_p_sampler(0.7, 0.2)),
    "top_k": (js.top_k_sampler(0.7, 4), ts.top_k_sampler(0.7, 4)),
}


@pytest.mark.parametrize("kind", sorted(SUPPORT_CASES))
def test_sampler_support_sets_equal_jax(kind):
    # Row 0 has a three-way tie at the top_k cut (top_k keeps ties, and
    # top_p's stable sort keeps ties in index order); 400 draws per row on
    # each side cover every token of mass > 2%.
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 24)).astype(np.float32) * 2.0
    logits[0, [2, 9, 17]] = np.sort(logits[0])[-4]
    jsamp, tsamp = SUPPORT_CASES[kind]
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    jdraws = np.stack([np.asarray(jsamp(k, jnp.asarray(logits))) for k in keys])
    gen = torch.Generator().manual_seed(0)
    tdraws = np.stack([tsamp(gen, torch.from_numpy(logits)).numpy() for _ in range(400)])
    for row in range(3):
        assert set(tdraws[:, row]) == set(jdraws[:, row]), (kind, row)
    # and the port's support is exactly the kept set the rule defines
    z = logits / 0.7
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    for row in range(3):
        if kind == "top_k":
            kept = set(np.flatnonzero(z[row] >= np.sort(z[row])[-4]))
        elif kind == "min_p":
            kept = set(np.flatnonzero(p[row] >= 0.2 * p[row].max()))
        else:
            order = np.argsort(-z[row], kind="stable")
            cum = np.cumsum(p[row][order])
            kept = set(order[cum - p[row][order] < 0.6])
        assert set(tdraws[:, row]) == kept, (kind, row)


def test_top_p_restricts_support():
    logits = torch.full((1, 10), -10.0)
    logits[0, 3] = 10.0
    s = ts.top_p_sampler(1.0, 0.5)
    gen = torch.Generator().manual_seed(1)
    assert all(int(s(gen, logits)[0]) == 3 for _ in range(5))


def test_repetition_penalty():
    history = np.array([[5, 7, -1, -1], [0, 0, 3, -1]])
    logits = np.random.default_rng(2).standard_normal((2, 10)).astype(np.float32)
    logits[0, 0] = 1.0
    ref = js.repetition_penalty_processor(2.0)(jnp.asarray(history, jnp.int32),
                                               jnp.asarray(logits))
    out = ts.repetition_penalty_processor(2.0)(torch.from_numpy(history),
                                               torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert float(out[0, 0]) == 1.0  # -1 padding marks nothing, token 0 included
    assert ts.make_logits_processors(1.0) == () == ts.make_logits_processors(None)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_beam_search_matches_jax(models, name):
    ja, jp, ta, tp = models[name]
    ref_seq, ref_score = jg.beam_search(jp, ja, PROMPT, num_beams=4, max_tokens=6)
    seq, score = tg.beam_search(tp, ta, PROMPT, num_beams=4, max_tokens=6)
    assert seq == ref_seq and len(seq) == 6
    assert abs(score - ref_score) <= REL * abs(ref_score)
    # the score is the sequence's mean logprob under a full forward
    logits, _ = tl.forward(tp, torch.tensor([PROMPT + seq]), ta)
    lsm = torch.log_softmax(logits[0], dim=-1)
    total = sum(float(lsm[len(PROMPT) - 1 + i, t]) for i, t in enumerate(seq))
    assert abs(total / len(seq) - score) < 1e-5
    # one beam is greedy
    seq1, _ = tg.beam_search(tp, ta, PROMPT, num_beams=1, max_tokens=6)
    assert seq1 == tg.generate_lite(tp, ta, PROMPT, max_tokens=6)[0]


def test_beam_search_retires_eos_beams_as_jax(models):
    ja, jp, ta, tp = models["dense"]
    eos = tg.generate_lite(tp, ta, PROMPT, max_tokens=3)[0][1]
    ref = jg.beam_search(jp, ja, PROMPT, num_beams=3, max_tokens=8, eos_id=eos)
    got = tg.beam_search(tp, ta, PROMPT, num_beams=3, max_tokens=8, eos_id=eos)
    assert got[0] == ref[0] and abs(got[1] - ref[1]) <= REL * abs(ref[1])


def test_top_k_ties_go_to_the_lower_index():
    x = torch.tensor([1.0, 3.0, 2.0, 3.0, 3.0, 0.0])
    vals, idx = tg._top_k(x, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [1, 3, 4]


def test_long_prompt_prefill_chunking(models):
    ja, jp, ta, tp = models["dense"]
    prompt = np.random.default_rng(0).integers(1, 60, size=100).tolist()
    toks, _ = tg.generate_lite(tp, ta, prompt, max_tokens=4, prefill_step_size=32)
    toks2, _ = tg.generate_lite(tp, ta, prompt, max_tokens=4, prefill_step_size=512)
    ref, _ = jg.generate_lite(jp, ja, prompt, max_tokens=4, prefill_step_size=32)
    assert toks == toks2 == ref


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kv_quant_cache_matches_jax(models, name):
    ja, jp, ta, tp = models[name]
    ref, _ = jg.generate_lite(jp, ja, PROMPT, max_tokens=8, kv_quant=True)
    toks, _ = tg.generate_lite(tp, ta, PROMPT, max_tokens=8, kv_quant=True)
    fp, _ = tg.generate_lite(tp, ta, PROMPT, max_tokens=8)
    assert toks == ref
    # int8 against the fp32 cache: at most one divergence, at the tail
    agree = sum(a == b for a, b in zip(fp, toks))
    assert agree >= len(fp) - 1 and fp[:-1] == toks[:-1], (fp, toks)


def test_kv_quant_logits_match_jax_at_moe_8x40m_width():
    # moe-8x40m's widths (one layer), drawn by the port's init_params as the
    # card's smoke draws them: a prefill then a one-token step through the
    # int8 cache, every logit within REL of JAX's, and the int8 cache's error
    # against the fp32 cache the same on both sides
    fields = dict(vocab_size=259, hidden_size=512, intermediate_size=1536, num_layers=1,
                  num_heads=8, num_kv_heads=8, head_dim=64, max_position_embeddings=1024,
                  num_local_experts=8, num_experts_per_tok=2)
    ta, ja = tl.LlamaArgs(**fields), jl.LlamaArgs(**fields)
    tp = tl.init_params(ta, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    toks = np.random.default_rng(3).integers(1, 256, size=(1, 25))
    logits = {}
    for quantize in (False, True):
        jcache = jl.init_cache(ja, 1, max_len=32, quantize=quantize)
        tcache = tl.init_cache(ta, 1, max_len=32, quantize=quantize, device="cpu")
        out = []
        with torch.no_grad():
            for lo, hi in ((0, 24), (24, 25)):
                jlog, jcache = jl.forward(jp, jnp.asarray(toks[:, lo:hi], jnp.int32), ja,
                                          cache=jcache, start_pos=lo)
                tlog, tcache = tl.forward(tp, torch.from_numpy(toks[:, lo:hi]), ta,
                                          cache=tcache, start_pos=lo)
                _close(tlog.numpy(), jlog)
                out.append((tlog.numpy()[0], np.asarray(jlog)[0]))
        logits[quantize] = np.concatenate(out, axis=1)  # [port | jax, position, V]
    err = np.abs(logits[True] - logits[False]).max(axis=(1, 2))
    assert err[1] > 0  # the int8 cache moves the logits
    assert abs(err[0] - err[1]) <= REL * np.abs(logits[False][1]).max(), err


def test_kv_quant_cache_buffers_are_int8():
    args = tl.LlamaArgs(**FIELDS)
    cache = tl.init_cache(args, 1, max_len=32, quantize=True, device="cpu")
    jcache = jl.init_cache(jl.LlamaArgs(**FIELDS), 1, max_len=32, quantize=True)
    for key in ("k_q", "k_s", "v_q", "v_s"):
        assert tuple(cache[0][key].shape) == tuple(jcache[0][key].shape)
        assert str(cache[0][key].dtype).split(".")[-1] == str(jcache[0][key].dtype)
    full = tl.init_cache(args, 1, max_len=32, device="cpu")
    q_bytes = cache[0]["k_q"].nbytes + cache[0]["k_s"].nbytes
    assert q_bytes < full[0]["k"].nbytes / 2


def test_quantize_kv_equals_jax_bitwise():
    # the same fp32 K/V in: the same int8 values and scales out, including
    # values exactly half-way between two steps (both round half to even)
    # and an all-zero row (scale floor 1e-8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    x[0, 0, 0] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 3], np.float32)
    x[1, 2, 1] = 0.0
    jq, js_ = jl._quantize_kv(jnp.asarray(x))
    tq, ts_ = tl._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    assert tq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, 126, 3]


def test_kv_quant_cache_contents_match_jax(models):
    # after a prefill and two decode steps: the scales agree within fp32
    # noise; an int8 value can differ by one step only where K itself sits
    # within that noise of a half-way point
    ja, jp, ta, tp = models["moe"]
    toks = np.random.default_rng(1).integers(1, 120, size=(1, 10))
    jcache = jl.init_cache(ja, 1, max_len=16, quantize=True)
    tcache = tl.init_cache(ta, 1, max_len=16, quantize=True, device="cpu")
    with torch.no_grad():
        for lo, hi in ((0, 8), (8, 9), (9, 10)):
            _, jcache = jl.forward(jp, jnp.asarray(toks[:, lo:hi], jnp.int32), ja,
                                   cache=jcache, start_pos=lo)
            tl.forward(tp, torch.from_numpy(toks[:, lo:hi]), ta, cache=tcache,
                       start_pos=lo)
    for jc, tc in zip(jcache, tcache):
        for s in ("k_s", "v_s"):
            np.testing.assert_allclose(tc[s].numpy(), np.asarray(jc[s]), rtol=1e-5)
        for q in ("k_q", "v_q"):
            d = np.abs(tc[q].numpy().astype(int) - np.asarray(jc[q]).astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_decode_across_attend_bucket_boundary_matches_full_forward():
    # decode positions 250..259 cross the 256-slot attend bucket
    fields = {**FIELDS, "max_position_embeddings": 512}
    np_params = _random_params(jl.LlamaArgs(**fields), seed=2)
    ja, jp = jl.LlamaArgs(**fields), jax.tree_util.tree_map(jnp.asarray, np_params)
    ta, tp = tl.LlamaArgs(**fields), params_from_jax(np_params, "cpu")
    prompt = np.random.default_rng(0).integers(1, 64, size=250).tolist()
    toks, stats = tg.generate_lite(tp, ta, prompt, max_tokens=10)
    assert toks == _full_argmax(tp, ta, prompt, 10)
    logits, _ = jl.forward(jp, jnp.asarray([prompt + toks], jnp.int32), ja)
    lsm = np.asarray(jax.nn.log_softmax(logits[0], axis=-1))
    assert [int(np.argmax(lsm[249 + i])) for i in range(10)] == toks
    ref_mean = np.mean([lsm[249 + i, t] for i, t in enumerate(toks)])
    assert abs(stats["mean_logprob"] - ref_mean) < 1e-5


def test_attend_bucket_helper():
    for n, cache_len in ((1, 4096), (256, 4096), (257, 4096), (5000, 8192),
                         (5000, 6000)):
        assert tg._attend_bucket(n, cache_len) == jg._attend_bucket(n, cache_len)
    assert tg._attend_bucket(257, 4096) == 512 and tg._attend_bucket(5000, 6000) == 6000


def test_moe_decode_matches_full_forward(models):
    # cached one-token decode through the grouped dispatch equals greedy by
    # full forward: the dropless dispatch drops no token at S 1
    ja, jp, ta, tp = models["moe"]
    toks, _ = tg.generate_lite(tp, ta, PROMPT[:5], max_tokens=6)
    assert toks == _full_argmax(tp, ta, PROMPT[:5], 6)
    assert toks == jg.generate_lite(jp, ja, PROMPT[:5], max_tokens=6)[0]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_speculative_matches_greedy_exactly(models, name):
    ja, jp, ta, tp = models[name]
    for prompt in (REPEATING, PROMPT, [3, 3, 3, 3]):
        ref, _ = tg.generate_lite(tp, ta, prompt, max_tokens=24)
        logits, _ = tl.forward(tp, torch.tensor([prompt + ref]), ta)
        lsm = torch.log_softmax(logits[0], dim=-1)
        ref_mean = np.mean([float(lsm[len(prompt) - 1 + i, t]) for i, t in enumerate(ref)])
        for k, n in ((8, 3), (4, 2), (1, 1)):
            out, stats = tg.generate_speculative(tp, ta, prompt, max_tokens=24,
                                                 draft_len=k, max_ngram=n)
            assert out == ref, (prompt, k, n)
            # a corrupted cache shifts the logprobs even where the tokens agree
            assert abs(stats["mean_logprob"] - ref_mean) < 1e-5
            if k == 8:
                first = stats
        jout, jstats = jg.generate_speculative(jp, ja, prompt, max_tokens=24, draft_len=8)
        assert jout == ref
        assert (first["verify_calls"], first["tokens_per_call"]) == \
            (jstats["verify_calls"], jstats["tokens_per_call"])


def test_speculative_stop_tokens_and_stats(models):
    ja, jp, ta, tp = models["dense"]
    prompt = REPEATING[:8]
    ref, _ = tg.generate_lite(tp, ta, prompt, max_tokens=40)
    stop = ref[5]
    ref_stopped, _ = tg.generate_lite(tp, ta, prompt, max_tokens=40, stop_tokens=[stop])
    out, stats = tg.generate_speculative(tp, ta, prompt, max_tokens=40, draft_len=6,
                                         stop_tokens=[stop])
    jout, jstats = jg.generate_speculative(jp, ja, prompt, max_tokens=40, draft_len=6,
                                           stop_tokens=[stop])
    assert out == ref_stopped == jout
    assert stats["stopped_on_token"] == jstats["stopped_on_token"] == 1.0
    assert stats["verify_calls"] == jstats["verify_calls"]


def test_weight_quant_refuses_naming_its_roadmap_item(models):
    # --weight-quant is ported (models/quantize.py; tests/test_torch_quantize.py
    # serves a run with it): the CLI now gets as far as loading the run, and
    # quantize_params_int8 is JAX's int8 quantize_weights
    from mlx_cuda_distributed_pretraining_tpu_torch.infer import cli
    from mlx_cuda_distributed_pretraining_tpu_torch.models import quantize as tq

    with pytest.raises(FileNotFoundError):
        cli.main(["--run", "no-such-run", "--weight-quant", "--device", "cpu"])
    tparams = next(iter(models.values()))[3]
    assert tq.weight_dtype_of(tl.quantize_params_int8(tparams)) == "int8"


def test_spec_accept_preserves_distribution():
    # emit(draft if accept else alt) ~ p for drafts the model likes and
    # drafts it hates: a chi-square test at 7 degrees of freedom (critical
    # value 24.3 at p = 0.001), and the acceptance rate is p(draft)
    probs = torch.tensor([0.4, 0.25, 0.15, 0.1, 0.05, 0.03, 0.015, 0.005])
    n = 60000
    gen = torch.Generator().manual_seed(0)
    for draft in (0, 5, 7):
        accept, alts = tg._spec_accept_one(gen, probs.expand(n, 8),
                                           torch.full((n,), draft))
        emitted = torch.where(accept, draft, alts)
        counts = np.bincount(emitted.numpy(), minlength=8)
        expected = n * probs.double().numpy()
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        assert chi2 < 24.3, (draft, chi2, counts)
        assert abs(float(accept.float().mean()) - float(probs[draft])) < 0.01
        assert (alts != draft).all()  # the fallback never re-proposes the draft


def test_speculative_sampling_runs_and_reproduces(models):
    ja, jp, ta, tp = models["dense"]
    prompt = REPEATING[:8]
    a1, s1 = tg.generate_speculative(tp, ta, prompt, max_tokens=24, temperature=0.9, seed=7)
    a2, _ = tg.generate_speculative(tp, ta, prompt, max_tokens=24, temperature=0.9, seed=7)
    assert a1 == a2 and len(a1) == 24
    assert s1["verify_calls"] >= 1 and np.isfinite(s1["mean_logprob"])
    b, _ = tg.generate_speculative(tp, ta, prompt, max_tokens=24, temperature=0.9, seed=8)
    c, _ = tg.generate_speculative(tp, ta, prompt, max_tokens=24, temperature=2.0, seed=9)
    assert (b != a1) or (c != a1)
    ref, _ = tg.generate_lite(tp, ta, prompt, max_tokens=24)
    assert tg.generate_speculative(tp, ta, prompt, max_tokens=24)[0] == ref


@pytest.mark.parametrize("name", sorted(MODELS))
def test_repetition_penalty_greedy_matches_jax(models, name):
    # A 60-token prompt and 30 new tokens: the 64-slot window drops prompt
    # tokens while decoding, so where each token enters it, and how often,
    # decides which logits are penalised.
    ja, jp, ta, tp = models[name]
    prompt = (REPEATING * 5)[:60]
    ref, _ = jg.generate_lite(jp, ja, prompt, max_tokens=30,
                              logits_processors=js.make_logits_processors(1.3))
    toks, _ = tg.generate_lite(tp, ta, prompt, max_tokens=30,
                               logits_processors=ts.make_logits_processors(1.3))
    assert toks == ref
    assert toks != tg.generate_lite(tp, ta, prompt, max_tokens=30)[0]


def test_repetition_history_counts_each_decoded_token_twice(models):
    # The JAX reference's quirk, mirrored: the host appends token i to the
    # history, and the step that decodes from it appends its own output
    # again, so from the second decoded token on each enters the window
    # twice and prompt tokens leave it two slots a step.
    ja, jp, ta, tp = models["dense"]
    seen = []
    pen = ts.repetition_penalty_processor(1.3)

    def recording(history, logits):
        seen.append(history[0].tolist())
        return pen(history, logits)

    toks, _ = tg.generate_lite(tp, ta, PROMPT, max_tokens=5, logits_processors=[recording])
    pad = [-1] * (64 - len(PROMPT))
    assert seen[0] == pad + PROMPT  # the prompt's logits
    assert seen[1] == (pad + PROMPT)[1:] + toks[:1]
    assert seen[2] == (pad + PROMPT)[3:] + [toks[0], toks[1], toks[1]]
    assert seen[3] == (pad + PROMPT)[5:] + [toks[0], toks[1], toks[1], toks[2], toks[2]]


def test_generate_text_matches_jax(models):
    from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
    from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
    from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

    fields = {**FIELDS, "vocab_size": 259}
    np_params = _random_params(jl.LlamaArgs(**fields), seed=4)
    ja, jp = jl.LlamaArgs(**fields), jax.tree_util.tree_map(jnp.asarray, np_params)
    ta, tp = tl.LlamaArgs(**fields), params_from_jax(np_params, "cpu")
    ref, ref_stats = jg.generate_text(jp, ja, JTok(DataConfig()), "Once upon a time",
                                      max_new_tokens=16, return_stats=True)
    text, stats = tg.generate_text(tp, ta, TokenizerManager(), "Once upon a time",
                                   max_new_tokens=16, return_stats=True)
    assert text == ref and stats["generation_tokens"] == ref_stats["generation_tokens"]
    spec = tg.generate_text(tp, ta, TokenizerManager(), "Once upon a time",
                            max_new_tokens=16, speculative=True)
    assert spec == text
    with pytest.raises(ValueError, match="temperature only"):
        tg.generate_text(tp, ta, TokenizerManager(), "x", speculative=True, top_p=0.9)


def test_cli_on_a_run_written_by_the_port_trainer(tmp_path, capsys):
    import json

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.infer import cli
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer, load_trained

    train = tmp_path / "train.jsonl"
    train.write_text("\n".join(json.dumps({"text": "the quick brown fox jumps "
                                                   "over the lazy dog " * 3})
                               for _ in range(20)) + "\n")
    cfg = {"name": "tiny-gen", "overwrite": True,
           "data": {"input_file": str(train),
                    "preprocessing": {"max_context_size": 32},
                    "tokenizer": {"normal_vocab_size": 256}},
           "model": {"architecture": "llama",
                     "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                    "num_layers": 2},
                     "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
           "training": {"hyperparameters": {"batch_size": 4, "learning_rate": 1e-2,
                                            "iters": 4},
                        "optimization": {"optimizer": "adamw"}},
           "logging": {"steps": {"logging_interval": 2, "checkpoint_interval": 100}},
           "system": {"seed": 0}}
    runs = str(tmp_path / "runs")
    Trainer(Config.from_dict(cfg), runs_root=runs, quiet=True, device="cpu").train()
    params, args, tok, _ = load_trained("tiny-gen", runs_root=runs, device="cpu")
    want = tg.generate_text(params, args, tok, "the quick", max_new_tokens=6)
    common = ["--run", "tiny-gen", "--runs-root", runs, "--device", "cpu",
              "--prompt", "the quick", "--max-tokens", "6"]
    assert cli.main(common + ["--temperature", "0"]) == want
    assert cli.main(common + ["--speculative"]) == want
    beam = cli.main(common + ["--beams", "2"])
    sampled = cli.main(common + ["--top-p", "0.9", "--repetition-penalty", "1.2"])
    assert isinstance(beam, str) and isinstance(sampled, str)
    assert "the quick" + want in capsys.readouterr().out
    for bad in (["--beams", "2", "--kv-quant"], ["--speculative", "--beams", "2"],
                ["--speculative", "--top-p", "0.9"]):
        with pytest.raises(SystemExit):
            cli.main(common + bad)
