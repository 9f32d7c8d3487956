"""The int8 KV cache on moe-8x40m's widths: the JAX package's locked path
beside the port's, on the CPU.

Draws the port's moe-8x40m weights as ``chip_smoke.py`` does (seed 0, all
12 layers, fp32), keeps the first ``--layers`` of them (a CPU run of the
whole model is too large to share a machine with), and carries them to the
JAX package. The prompt is the smoke's first greedy serving prompt. For
each package it reports greedy decoding with the fp32 and the int8 cache
(tokens, and the first token where the two part), and, with the fp32 cache's
tokens fed to both caches, how far the int8 cache's logits sit from the fp32
cache's (the largest error over the largest logit) and the fp32 top-2 gap
where the paths part. Then it holds the port to JAX: the same tokens, fp32
logits within 1e-5 of the largest, and int8 logits within 1e-3 (as
``chip_smoke.py`` holds the card's to the CPU's): fp32 noise near a
half-way point moves an int8 value by one step, and what that changes
downstream moves later layers' values further; the script counts both, per
layer.

Run from the repository root, with JAX on the CPU:
``PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/int8_cache_witness.py``
(``--layers``, ``--tokens``; ``--out`` writes the JSON there too). Exit 1
if the port and JAX disagree.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mlx_cuda_distributed_pretraining_tpu.infer import generate as jg
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu_torch.infer import generate as tg
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

MOE_8X40M = dict(vocab_size=259, hidden_size=512, intermediate_size=1536,
                 num_layers=12, num_heads=8, num_kv_heads=8, head_dim=64,
                 max_position_embeddings=1024, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=True,
                 num_local_experts=8, num_experts_per_tok=2, moe_impl="grouped")
PREFIX = ("In the port of a serving system, every request shares this "
          "system prompt: answer briefly, cite the layer you measured, "
          "and name the card and its power limit beside every number. ")
PROMPT = (PREFIX * 3)[:300] + " First question: what bounds decode?"


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.numpy()


def first_divergence(a, b):
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return i if i is not None or len(a) == len(b) else min(len(a), len(b))


def summary(toks_fp32, toks_int8, lf, lq):
    div = first_divergence(toks_fp32, toks_int8)
    err = np.abs(lq - lf).max(axis=-1)
    top2 = np.sort(lf, axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    at = div is not None and div < len(gap)
    return {"first_divergence": div,
            "int8_err_max": float(err.max()),
            "int8_rel_err": float(err.max() / np.abs(lf).max()),
            "gap_at_divergence": float(gap[div]) if at else None,
            "int8_err_at_divergence": float(err[div]) if at else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    full = tl.LlamaArgs(**MOE_8X40M)
    params = tl.init_params(full, torch.Generator().manual_seed(0), device="cpu")
    params["layers"] = params["layers"][:a.layers]
    fields = {**MOE_8X40M, "num_layers": a.layers}
    targs, jargs = tl.LlamaArgs(**fields), jl.LlamaArgs(**fields)
    jparams = jax.tree_util.tree_map(jnp.asarray, to_numpy(params))
    tok = TokenizerManager()
    ids = [tok.bos_id] + tok.tokenize(PROMPT)

    out = {"layers": a.layers, "prompt_tokens": len(ids), "tokens": a.tokens}
    runs = {}
    for kv_quant in (False, True):
        jt, _ = jg.generate_lite(jparams, jargs, ids, max_tokens=a.tokens, kv_quant=kv_quant)
        with torch.no_grad():
            tt, _ = tg.generate_lite(params, targs, ids, max_tokens=a.tokens,
                                     kv_quant=kv_quant)
        runs[kv_quant] = (list(map(int, jt)), list(map(int, tt)))
    seq = ids + runs[False][0]
    chose = slice(len(ids) - 1, len(seq) - 1)

    # the whole sequence through one cache of each kind: the logits behind
    # each generated token, and the cache
    def jax_forward(quantize):
        cache = jl.init_cache(jargs, 1, max_len=len(seq), quantize=quantize)
        logits, cache = jl.forward(jparams, jnp.asarray([seq], jnp.int32), jargs,
                                   cache=cache, start_pos=0)
        return np.asarray(logits[0])[chose], cache

    def port_forward(quantize):
        cache = tl.init_cache(targs, 1, max_len=len(seq), quantize=quantize, device="cpu")
        with torch.no_grad():
            logits, cache = tl.forward(params, torch.tensor([seq]), targs, cache=cache)
        return logits[0].numpy()[chose], cache

    (jf, _), (jq, jcache) = jax_forward(False), jax_forward(True)
    (tf, _), (tq, tcache) = port_forward(False), port_forward(True)
    per_layer = []
    for jc, tc in zip(jcache, tcache):
        steps = np.concatenate([
            np.abs(tc[q].numpy().astype(int) - np.asarray(jc[q]).astype(int)).ravel()
            for q in ("k_q", "v_q")])
        per_layer.append({"differing": int((steps > 0).sum()), "of": int(steps.size),
                          "max_steps": int(steps.max())})
    out["int8_values_port_vs_jax_by_layer"] = per_layer
    out["jax"] = summary(runs[False][0], runs[True][0], jf, jq)
    out["port"] = summary(runs[False][1], runs[True][1], tf, tq)
    out["tokens_equal"] = {"fp32": runs[False][0] == runs[False][1],
                           "int8": runs[True][0] == runs[True][1]}
    out["int8_logits_port_vs_jax_rel"] = float(np.abs(tq - jq).max() / np.abs(jq).max())
    out["fp32_logits_port_vs_jax_rel"] = float(np.abs(tf - jf).max() / np.abs(jf).max())
    out["greedy_fp32"], out["greedy_int8"] = runs[False][0], runs[True][0]
    text = json.dumps(out, indent=1)
    print(text)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    agree = (all(out["tokens_equal"].values()) and out["fp32_logits_port_vs_jax_rel"] <= 1e-5
             and out["int8_logits_port_vs_jax_rel"] <= 1e-3)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
