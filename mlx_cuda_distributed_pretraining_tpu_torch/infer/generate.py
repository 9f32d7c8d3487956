"""KV-cached generation: padded prefill, one-token decode steps, prompt-lookup
speculation and beam search over the static cache (``models/llama.py``
``init_cache``); the JAX package's ``infer/generate.py``.

Generation runs on the device the params live on, eagerly and under
``torch.no_grad``. The cache is written in place: a padded prefill and a
speculative verify write K/V past the true length, and ``pos`` is rewound
to it, so every junk slot is overwritten before a query can attend it. Each
decode step attends over a power-of-two bucket of the cache
(:func:`_attend_bucket`), so its cost follows the position, not the cache
length. As in JAX, step i+1 is launched before token i is read on the host.

Random draws come from a ``torch.Generator`` seeded with ``seed`` on the
params' device; they differ from ``jax.random``'s draws, so sampled tokens
are not comparable with the JAX package token for token (greedy tokens are).
The repetition-penalty history follows the JAX package exactly, including
that each decoded token after the first enters the window twice (once when
the host appends it, once inside the step that decodes it).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import llama
from .samplers import Sampler, categorical, greedy, make_logits_processors, make_sampler


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _attend_bucket(n: int, cache_len: int, lo: int = 256) -> int:
    """Smallest power of two >= n (at least ``lo``), clamped to the cache:
    decode attends over this prefix of the cache instead of the whole
    buffer, so per-token cost follows the position, not the context."""
    b = lo
    while b < n:
        b *= 2
    return min(b, cache_len)


def _device(params) -> torch.device:
    return params["tok_embeddings"]["weight"].device


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a 1-d ``x`` and their indices, ties to the lower
    index (as ``jax.lax.top_k``; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _cache_len(P: int, new: int, args: llama.LlamaArgs) -> int:
    return min(_round_up(P + new, 128), max(args.max_position_embeddings, P + new))


def _decode_step(params, args: llama.LlamaArgs, cache, token: torch.Tensor, pos: int,
                 generator: torch.Generator, history: torch.Tensor, sampler: Sampler,
                 processors: Sequence, attend_len: int):
    """One decode step: ``(next_token [B], logprob [B], history)``, the
    history with ``next_token`` appended."""
    logits, _ = llama.forward(params, token[:, None], args, cache=cache, start_pos=pos,
                              attend_len=attend_len)
    logits = logits[:, -1, :]
    for proc in processors:
        logits = proc(history, logits)
    next_token = sampler(generator, logits)
    lp = torch.log_softmax(logits, dim=-1).gather(-1, next_token[:, None])[:, 0]
    history = torch.cat([history[:, 1:], next_token[:, None]], dim=1)
    return next_token, lp, history


@torch.no_grad()
def prefill(params, args: llama.LlamaArgs, tokens: np.ndarray, cache_len: int,
            prefill_step_size: int = 512, cache_dtype=torch.float32,
            kv_quant: bool = False):
    """Build a KV cache for ``tokens [B, P]``; returns ``(cache,
    last_logits [B, V])``.

    The prompt is padded up to a multiple of ``prefill_step_size`` (clamped
    to the cache) and run as one forward; ``pos`` is then rewound to P so
    decode overwrites the junk tail before it can be attended. The cache is
    fp32 whatever the params' dtype, as in JAX; ``kv_quant`` stores it int8
    (``llama.init_cache``)."""
    B, P = tokens.shape
    step = max(min(prefill_step_size, cache_len), 1)
    bucket = min(max(_round_up(P, step), step), cache_len)
    if bucket < P:
        raise ValueError(f"prompt length {P} exceeds cache length {cache_len}")
    padded = np.zeros((B, bucket), np.int64)
    padded[:, :P] = tokens
    dev = _device(params)
    cache = llama.init_cache(args, B, max_len=cache_len, dtype=cache_dtype,
                             quantize=kv_quant, device=dev)
    logits, cache = llama.forward(params, torch.from_numpy(padded).to(dev), args,
                                  cache=cache, start_pos=0,
                                  attend_len=_attend_bucket(bucket, cache_len))
    for layer in cache:
        layer["pos"] = P
    return cache, logits[:, P - 1, :]


@torch.no_grad()
def generate_step(
    params,
    args: llama.LlamaArgs,
    prompt_tokens: Sequence[int],
    max_tokens: int = 128,
    sampler: Optional[Sampler] = None,
    logits_processors: Optional[Sequence] = None,
    prefill_step_size: int = 512,
    seed: int = 0,
    rep_context: int = 64,
    kv_quant: bool = False,
) -> Iterator[Tuple[int, float]]:
    """Yield ``(token, logprob)`` pairs, KV-cached. ``kv_quant`` uses an
    int8 cache."""
    sampler = sampler or greedy()
    processors = tuple(logits_processors or ())
    tokens = np.asarray(prompt_tokens, np.int64)[None, :]
    P = tokens.shape[1]
    cache_len = _cache_len(P, max_tokens, args)
    cache, last_logits = prefill(params, args, tokens, cache_len, prefill_step_size,
                                 kv_quant=kv_quant)
    dev = last_logits.device
    generator = _generator(dev, seed)
    history = torch.from_numpy(tokens[:, -rep_context:]).to(dev)
    pad = rep_context - history.shape[1]
    if pad > 0:
        history = torch.cat([torch.full((1, pad), -1, dtype=history.dtype, device=dev),
                             history], dim=1)

    for proc in processors:
        last_logits = proc(history, last_logits)
    tok = sampler(generator, last_logits)
    lp = torch.log_softmax(last_logits, dim=-1).gather(-1, tok[:, None])[:, 0]

    pos = P
    for i in range(max_tokens):
        # Launch the NEXT step before reading the current token on the host,
        # so the device works on step i+1 while the host yields token i.
        nxt = None
        if i < max_tokens - 1:
            hist_next = torch.cat([history[:, 1:], tok[:, None]], dim=1)
            nxt = _decode_step(params, args, cache, tok, pos, generator, hist_next,
                               sampler, processors, _attend_bucket(pos + 1, cache_len))
        yield int(tok[0]), float(lp[0])
        if nxt is None:
            break
        tok, lp, history = nxt
        pos += 1


def generate_lite(
    params,
    args: llama.LlamaArgs,
    prompt_tokens: Sequence[int],
    max_tokens: int = 128,
    sampler: Optional[Sampler] = None,
    logits_processors: Optional[Sequence] = None,
    stop_tokens: Optional[Sequence[int]] = None,
    prefill_step_size: int = 512,
    seed: int = 0,
    verbose: bool = False,
    kv_quant: bool = False,
) -> Tuple[List[int], Dict[str, float]]:
    """Generate with stop tokens and throughput stats: ``(tokens, stats)``."""
    stop = set(stop_tokens or ())
    t0 = time.perf_counter()
    out: List[int] = []
    logprobs: List[float] = []
    stopped = False
    for tok, lp in generate_step(
        params, args, prompt_tokens, max_tokens, sampler, logits_processors,
        prefill_step_size, seed, kv_quant=kv_quant,
    ):
        if tok in stop:
            stopped = True
            break
        out.append(tok)
        logprobs.append(lp)
    dt = max(time.perf_counter() - t0, 1e-9)
    stats = {
        "generation_tokens": float(len(out)),
        "generation_tps": len(out) / dt,
        "mean_logprob": float(np.mean(logprobs)) if logprobs else 0.0,
        "prompt_tokens": float(len(prompt_tokens)),
        # a stop token met exactly at the budget is a stop, not a truncation
        "stopped_on_token": float(stopped),
    }
    if verbose:
        print(f"[generate] {len(out)} tokens at {stats['generation_tps']:.1f} tok/s")
    return out, stats


def _verify_step(params, args: llama.LlamaArgs, cache, toks: torch.Tensor, pos: int,
                 attend_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify: one forward over ``[current token + drafts]``;
    the model's greedy token at every position and its logprob."""
    logits, _ = llama.forward(params, toks, args, cache=cache, start_pos=pos,
                              attend_len=attend_len)
    preds = torch.argmax(logits[0], dim=-1)
    lp = torch.log_softmax(logits[0], dim=-1).gather(-1, preds[:, None])[:, 0]
    return preds, lp


def _spec_accept_one(generator: Optional[torch.Generator], probs: torch.Tensor,
                     draft: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-mass-proposal speculative sampling at each row of ``probs [N,
    V]`` with ``draft [N]``: accept the draft with probability p(draft),
    and pre-sample the fallback from p with the draft's mass removed.
    Emitting ``draft if accept else alt`` is distributed exactly as p."""
    rows = torch.arange(probs.shape[0], device=probs.device)
    accept = torch.rand(probs.shape[0], generator=generator,
                        device=probs.device) < probs[rows, draft]
    residual = probs.clone()
    residual[rows, draft] = 0.0
    alt = torch.multinomial(residual + 1e-30, 1, generator=generator)[:, 0]
    return accept, alt


def _verify_step_sampled(params, args: llama.LlamaArgs, cache, toks: torch.Tensor,
                         pos: int, attend_len: int, temperature: float,
                         generator: torch.Generator):
    """Speculative verify for sampling at ``temperature``: per drafted
    position, accept with probability p(draft) or fall back to the
    pre-sampled residual draw (exact: the draft is a point-mass proposal);
    the bonus position samples from p. Returns ``(accept, lp of the drafts,
    alts, lp of the alts, bonus, lp of the bonus)``."""
    logits, _ = llama.forward(params, toks, args, cache=cache, start_pos=pos,
                              attend_len=attend_len)
    probs = torch.softmax(logits[0] / temperature, dim=-1)  # [chunk, V]
    lp = torch.log(probs + 1e-30)
    k = toks.shape[1] - 1
    drafts = toks[0, 1:]
    accept, alts = _spec_accept_one(generator, probs[:k], drafts)
    bonus = categorical(generator, lp[k:k + 1])[0]

    def gather(rows, idx):
        return rows.gather(-1, idx[:, None])[:, 0]

    return (accept, gather(lp[:k], drafts), alts, gather(lp[:k], alts),
            bonus, lp[k, bonus])


def _prompt_lookup_draft(seq: List[int], k: int, max_ngram: int,
                         window: int = 2048) -> List[int]:
    """Draft k tokens by prompt lookup: the continuation of the most recent
    earlier occurrence of the longest suffix n-gram (n = max_ngram..1)
    within the last ``window`` tokens. Always k tokens: with no match it
    repeats the last token."""
    lo = max(0, len(seq) - window)
    for n in range(min(max_ngram, len(seq) - 1), 0, -1):
        pat = seq[-n:]
        for j in range(len(seq) - n - 1, lo - 1, -1):
            if seq[j:j + n] == pat:
                cont = seq[j + n:j + n + k]
                if cont:
                    return (cont + [seq[-1]] * (k - len(cont)))[:k]
    return [seq[-1]] * k


@torch.no_grad()
def generate_speculative(
    params,
    args: llama.LlamaArgs,
    prompt_tokens: Sequence[int],
    max_tokens: int = 128,
    draft_len: int = 8,
    max_ngram: int = 3,
    stop_tokens: Optional[Sequence[int]] = None,
    prefill_step_size: int = 512,
    kv_quant: bool = False,
    temperature: float = 0.0,
    seed: int = 0,
) -> Tuple[List[int], Dict[str, float]]:
    """Decoding with prompt-lookup speculation (self-drafting).

    Each iteration verifies ``draft_len`` drafted tokens plus the current
    token in one forward and emits the accepted drafts plus one token of
    the model's own: greedy output equals :func:`generate_lite`'s token for
    token. ``temperature > 0`` runs exact speculative sampling
    (:func:`_verify_step_sampled`). A verify writes ``draft_len + 1`` KV
    entries, and ``pos`` is rewound to the slot of the last emitted token,
    whose KV the next verify writes first, so the junk is overwritten
    before any query attends it."""
    k = max(1, int(draft_len))
    stop = set(stop_tokens or ())
    t0 = time.perf_counter()
    if max_tokens < 1:
        return [], {"generation_tokens": 0.0, "generation_tps": 0.0,
                    "mean_logprob": 0.0,
                    "prompt_tokens": float(len(prompt_tokens)),
                    "verify_calls": 0.0, "tokens_per_call": 0.0,
                    "stopped_on_token": 0.0}
    tokens = np.asarray(prompt_tokens, np.int64)[None, :]
    P = tokens.shape[1]
    # + k headroom: the last verify window may write past the final token
    cache_len = _cache_len(P, max_tokens + k, args)
    cache, last_logits = prefill(params, args, tokens, cache_len,
                                 prefill_step_size, kv_quant=kv_quant)
    dev = last_logits.device

    seq: List[int] = [int(t) for t in prompt_tokens]
    sampled = temperature > 0.0
    generator = _generator(dev, seed)
    if sampled:
        first = int(categorical(generator, last_logits[0] / temperature))
        lp_first = float(torch.log_softmax(last_logits / temperature, dim=-1)[0, first])
    else:
        first = int(torch.argmax(last_logits[0]))
        lp_first = float(torch.log_softmax(last_logits, dim=-1)[0, first])
    out: List[int] = [first]
    logprobs: List[float] = [lp_first]
    seq.append(first)
    stopped = first in stop

    pos = P
    calls = 0
    while len(out) < max_tokens and out[-1] not in stop:
        drafts = _prompt_lookup_draft(seq, k, max_ngram)
        toks = torch.tensor([[seq[-1]] + drafts], dtype=torch.long, device=dev)
        bucket = _attend_bucket(pos + k + 1, cache_len)
        if sampled:
            res = _verify_step_sampled(params, args, cache, toks, pos, bucket,
                                       temperature, generator)
            # one transfer for the small outputs
            accept_h, lp_draft, alts_h, lp_alt, bonus_h, lp_bonus = (
                t.cpu().numpy() for t in res)
            m = 0
            while m < k and accept_h[m]:
                m += 1
            if m < k:
                emitted = drafts[:m] + [int(alts_h[m])]
                lp_h = np.concatenate([lp_draft[:m], [float(lp_alt[m])]])
            else:
                emitted = drafts[:k] + [int(bonus_h)]
                lp_h = np.concatenate([lp_draft, [float(lp_bonus)]])
        else:
            preds, lp = _verify_step(params, args, cache, toks, pos, bucket)
            preds_h, lp_h = preds.cpu().numpy(), lp.cpu().numpy()
            m = 0
            while m < k and drafts[m] == int(preds_h[m]):
                m += 1
            emitted = drafts[:m] + [int(preds_h[m])]  # m accepted + 1 bonus
        calls += 1
        for i, t in enumerate(emitted):
            if len(out) >= max_tokens:
                break
            out.append(t)
            logprobs.append(float(lp_h[i]))
            seq.append(t)
            if t in stop:
                stopped = True
                break
        # Rewind to the slot of the last emitted token: its KV was never
        # written (it was an output, not an input), so the next verify feeds
        # it as toks[0] and writes it there. out[i] sits at slot P + i.
        pos = P + len(out) - 1
        for layer in cache:
            layer["pos"] = pos

    while out and out[-1] in stop:
        out.pop()
        logprobs.pop()
    dt = max(time.perf_counter() - t0, 1e-9)
    stats = {
        "generation_tokens": float(len(out)),
        "generation_tps": len(out) / dt,
        "mean_logprob": float(np.mean(logprobs)) if logprobs else 0.0,
        "prompt_tokens": float(P),
        "verify_calls": float(calls),
        # the prefill's first token cost no verify call
        "tokens_per_call": round(max(len(out) - 1, 0) / max(calls, 1), 2),
        "stopped_on_token": float(stopped),
    }
    return out, stats


def generate_text(
    params,
    args: llama.LlamaArgs,
    tokenizer,
    prompt: str,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_p: float = 0.0,
    min_p: float = 0.0,
    repetition_penalty: Optional[float] = None,
    seed: int = 0,
    kv_quant: bool = False,
    return_stats: bool = False,
    speculative: bool = False,
    draft_len: int = 8,
):
    """str -> str with an EOS stop; ``(text, stats)`` with ``return_stats``.
    The one place prompt encoding, sampler and stop wiring live, shared by
    the CLI, the server, the agent and the trainer's samples.
    ``speculative`` takes temperature only (top_p, min_p and a repetition
    penalty reshape the distribution the acceptance rule assumes)."""
    ids = [tokenizer.bos_id] + tokenizer.tokenize(prompt)
    if speculative:
        if top_p or min_p or (repetition_penalty or 1.0) != 1.0:
            raise ValueError(
                "speculative decoding supports temperature only "
                "(top_p/min_p/repetition_penalty reshape the proposal "
                "distribution the acceptance rule assumes)")
        toks, stats = generate_speculative(
            params, args, ids, max_tokens=max_new_tokens,
            draft_len=draft_len, stop_tokens=[tokenizer.eos_id],
            temperature=temperature, seed=seed, kv_quant=kv_quant,
        )
    else:
        sampler = make_sampler(temp=temperature, top_p=top_p, min_p=min_p)
        toks, stats = generate_lite(
            params, args, ids, max_tokens=max_new_tokens, sampler=sampler,
            logits_processors=make_logits_processors(repetition_penalty),
            stop_tokens=[tokenizer.eos_id], seed=seed, kv_quant=kv_quant,
        )
    text = tokenizer.detokenize(toks)
    return (text, stats) if return_stats else text


@torch.no_grad()
def beam_search(
    params,
    args: llama.LlamaArgs,
    prompt_tokens: Sequence[int],
    num_beams: int = 4,
    max_tokens: int = 64,
    eos_id: Optional[int] = None,
    length_penalty: float = 1.0,
    prefill_step_size: int = 512,
) -> Tuple[List[int], float]:
    """Batched beam decode with EOS beam retirement and length-normalised
    scores: ``(best sequence, its normalised score)``. Beams ride the batch
    axis of one fp32 cache; each step reorders every 4-d cache buffer on
    axis 0 by the beams' origins (``pos`` is shared)."""
    tokens = np.asarray(prompt_tokens, np.int64)[None, :]
    P = tokens.shape[1]
    cache_len = _cache_len(P, max_tokens, args)
    cache, last_logits = prefill(params, args, np.repeat(tokens, num_beams, axis=0),
                                 cache_len, prefill_step_size)
    dev = last_logits.device
    no_eos = eos_id if eos_id is not None else -1

    def expand(cache, toks, pos, scores, alive, attend_len):
        logits, cache = llama.forward(params, toks[:, None], args, cache=cache,
                                      start_pos=pos, attend_len=attend_len)
        lp = torch.log_softmax(logits[:, -1, :], dim=-1)  # [k, V]
        V = lp.shape[-1]
        # finished beams may only extend with EOS, at no cost
        if eos_id is not None:
            frozen = torch.full((V,), float("-inf"), device=dev)
            frozen[eos_id] = 0.0
            lp = torch.where(alive[:, None], lp, frozen[None, :])
        top_scores, top_idx = _top_k((scores[:, None] + lp).reshape(-1), num_beams)
        origin = top_idx // V
        new_tok = top_idx % V
        cache = [{n: (a[origin] if isinstance(a, torch.Tensor) and a.dim() == 4 else a)
                  for n, a in layer.items()} for layer in cache]
        new_alive = alive[origin] & (new_tok != no_eos)
        return cache, new_tok, top_scores, new_alive, origin

    # first expansion from the prompt's logits (every beam alike: row 0)
    scores, toks = _top_k(torch.log_softmax(last_logits[0], dim=-1), num_beams)
    alive = toks != no_eos
    seqs = [[int(t)] for t in toks.cpu().numpy()]

    pos = P
    for _ in range(max_tokens - 1):
        if not bool(alive.any()):
            break
        cache, toks, scores, alive, origin = expand(
            cache, toks, pos, scores, alive, _attend_bucket(pos + 1, cache_len))
        origin_h, toks_h = origin.cpu().numpy(), toks.cpu().numpy()
        seqs = [seqs[origin_h[i]] + [int(toks_h[i])] for i in range(num_beams)]
        pos += 1

    scores_h = scores.cpu().numpy()
    lengths = np.array([len(s) if eos_id is None
                        else (s.index(eos_id) + 1 if eos_id in s else len(s))
                        for s in seqs])
    norm = scores_h / (lengths ** length_penalty)
    best = int(np.argmax(norm))
    seq = seqs[best]
    if eos_id is not None and eos_id in seq:
        seq = seq[: seq.index(eos_id)]
    return seq, float(norm[best])
