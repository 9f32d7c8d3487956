"""Prefill and decode steps for the continuous-batching engine, over either
pool (``serve/kv_pool.py``).

Slotted: :func:`decode_step` advances every slot one token, each row at its
own position (masked rows write the reserved last position of their slot),
and :func:`prefill_step` writes one chunk of one prompt into its slot.

Paged: every KV read and write goes through block tables into the arena
(``models/llama.init_paged_cache``): position ``p`` of a sequence lives at
``(table[p // block_size], p % block_size)``. Masked rows and positions past
a table's extent write into the shared junk block 0.
:func:`paged_decode_step` also verifies speculative drafts: each row carries
``[last token, d1..dk]`` (S = k + 1 positions), one forward scores them all,
and :func:`verify_rows` gives the greedy and the sampled acceptance outputs;
the engine commits only the accepted prefix by advancing the row's length.
The drafts' K/V lands in the row's own blocks past its length, or the junk
block past the table's extent, and is overwritten before it is attendable.

An int8 cache stores ``llama._quantize_kv``'s values and scales; a step
writes them, then dequantizes only the window it gathers.

Differences from the JAX package's ``serve/batch_step.py``, which compiles
each step once per shape bucket and donates the cache:

- the steps run eagerly, and the cache is updated IN PLACE (``index_put_``
  without accumulation; colliding junk writes are harmless by construction).
  ``attend_len`` buckets still bound how much of each row is read;
- sampling draws from per-request ``torch.Generator``s, so sampled tokens
  (and sampled speculation's acceptances) differ from JAX's; greedy tokens
  are comparable;
- the steps return logits and the host-side helpers (:func:`sample_rows`,
  :func:`verify_rows`) sample from them, where JAX samples inside the step.

Numerics follow the JAX steps op for op: fp32 serving compute, RMSNorm and
RoPE in fp32, the same positional validity masks, fp32 logits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..infer.generate import _attend_bucket, _round_up
from ..infer.samplers import make_sampler
from ..models import llama
from ..ops.attention import reference_attention

# Re-exported so the engine sizes buckets the same way the single-sequence
# generator does.
attend_bucket = _attend_bucket
round_up = _round_up

LayerCache = Dict[str, torch.Tensor]


def _rope_rows(x: torch.Tensor, positions: torch.Tensor,
               args: llama.LlamaArgs) -> torch.Tensor:
    """Per-row RoPE: ``x [B, S, H, D]`` rotated by ``positions [B, S]``."""
    cos, sin = llama.rope_cos_sin(positions, args.head_dim, args.rope_theta,
                                  args.rope_scaling_factor)
    return llama.apply_rope(x, cos, sin, args.rope_traditional)


def _ffn(p, x: torch.Tensor, args: llama.LlamaArgs) -> torch.Tensor:
    """Post-attention half of a block: dense SwiGLU or the MoE block."""
    if args.is_moe:
        from ..models.moe import moe_block

        return moe_block(p["feed_forward"], x, args)[0]  # serving drops aux
    return llama.mlp_block(p["feed_forward"], x)


def _project_logits(params, x: torch.Tensor, args: llama.LlamaArgs) -> torch.Tensor:
    """fp32 output projection (tied embeddings or the output head)."""
    if args.tie_word_embeddings or "output" not in params:
        logits = x.float() @ params["tok_embeddings"]["weight"].float().T
    else:
        logits = x.float() @ params["output"]["weight"].float()
        if "bias" in params["output"]:
            logits = logits + params["output"]["bias"].float()
    if args.logit_scale:
        logits = logits * args.logit_scale
    return logits


def _paged_write(layer_cache: LayerCache, k: torch.Tensor, v: torch.Tensor,
                 blocks: torch.Tensor, offs: torch.Tensor) -> None:
    """Scatter K/V ``[B, S, H, D]`` into the arena IN PLACE at per-position
    ``(block, offset)`` coordinates ``[B, S]``. Real rows own their blocks,
    so their destinations are unique; masked positions all target junk
    block 0, where the last of the colliding writes wins (never read)."""
    B, S, H, D = k.shape
    bi, oi = blocks.reshape(-1), offs.reshape(-1)
    for name, value in _stored(layer_cache, k, v).items():
        buf = layer_cache[name]
        buf[bi, oi] = value.reshape((B * S,) + buf.shape[2:]).to(buf.dtype)


def _stored(layer_cache: LayerCache, k: torch.Tensor,
            v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """What a cache layer stores for K/V ``[B, S, H, D]``: the tensors
    themselves, or for the int8 quartet ``_quantize_kv``'s values and
    scales."""
    if "k_q" in layer_cache:
        kq, ks = llama._quantize_kv(k)
        vq, vs = llama._quantize_kv(v)
        return {"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs}
    return {"k": k, "v": v}


def _read(layer_cache: LayerCache, index) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V at ``index`` of a cache layer; an int8 layer dequantizes (fp32)
    only what it reads."""
    if "k_q" in layer_cache:
        return (layer_cache["k_q"][index].float() * layer_cache["k_s"][index],
                layer_cache["v_q"][index].float() * layer_cache["v_s"][index])
    return layer_cache["k"][index], layer_cache["v"][index]


def _paged_gather(layer_cache: LayerCache, tables: torch.Tensor,
                  nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sequence's first ``nb`` blocks as contiguous K/V
    ``[B, nb * block_size, H, D]``."""
    keys, values = _read(layer_cache, tables[:, :nb])
    B, _, T, H, D = keys.shape
    return keys.reshape(B, nb * T, H, D), values.reshape(B, nb * T, H, D)


def _block_coords(positions: torch.Tensor, tables: torch.Tensor,
                  block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write coordinates for ``positions [B, S]``; positions past the table
    extent go to the junk block (the engine's token budgets keep real rows
    inside it, this keeps an off-by-one from corrupting a neighbour)."""
    safe = positions < tables.shape[1] * block_size
    pc = torch.where(safe, positions, 0)
    blocks = torch.gather(tables, 1, pc // block_size)
    return torch.where(safe, blocks, 0), pc % block_size


def _stack(params, cache: List[LayerCache], x: torch.Tensor,
           positions: torch.Tensor, mask: torch.Tensor, args: llama.LlamaArgs,
           write, read) -> torch.Tensor:
    """Run every decoder layer over ``x [B, S, D]`` at ``positions [B, S]``:
    ``write(layer_cache, k, v)`` stores this step's K/V, ``read(layer_cache)``
    gives the K/V to attend over under ``mask``."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = args.num_heads, args.num_kv_heads, args.head_dim
    for p, layer_cache in zip(params["layers"], cache):
        h = llama.rms_norm(x, p["attention_norm"]["weight"], args.rms_norm_eps)
        pa = p["attention"]
        q = llama._linear(h, pa["wq"]).reshape(B, S, Hq, Dh)
        k = llama._linear(h, pa["wk"]).reshape(B, S, Hkv, Dh)
        v = llama._linear(h, pa["wv"]).reshape(B, S, Hkv, Dh)
        q = _rope_rows(q, positions, args)
        k = _rope_rows(k, positions, args)
        write(layer_cache, k, v)
        ck, cv = read(layer_cache)
        out = reference_attention(q, ck, cv, explicit_mask=mask)
        x = x + llama._linear(out.reshape(B, S, Hq * Dh), pa["wo"])
        x = x + _ffn(p, llama.rms_norm(x, p["ffn_norm"]["weight"],
                                       args.rms_norm_eps), args)
    return llama.rms_norm(x, params["norm"]["weight"], args.rms_norm_eps)


def _layers(params, cache: List[LayerCache], x: torch.Tensor,
            positions: torch.Tensor, tables: torch.Tensor, mask: torch.Tensor,
            args: llama.LlamaArgs, attend_len: int, block_size: int) -> torch.Tensor:
    """:func:`_stack` through ``tables [B, W]`` (the paged pool): writes at
    ``positions``, reads the first ``attend_len`` positions of each row's
    table."""
    blocks, offs = _block_coords(positions, tables, block_size)
    nb = attend_len // block_size
    return _stack(params, cache, x, positions, mask, args,
                  lambda c, k, v: _paged_write(c, k, v, blocks, offs),
                  lambda c: _paged_gather(c, tables, nb))


def _check_attend(attend_len: int, block_size: int) -> None:
    if attend_len % block_size:
        raise ValueError(f"attend_len {attend_len} not a multiple of "
                         f"block_size {block_size}")


# -- the slotted pool -------------------------------------------------------------
def _write_kv_rows(layer_cache: LayerCache, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor) -> None:
    """Write decode K/V ``[B, 1, H, D]`` at each row's own position, in
    place (JAX's ``_write_kv_rows``)."""
    rows = torch.arange(k.shape[0], device=k.device)
    for name, value in _stored(layer_cache, k, v).items():
        buf = layer_cache[name]
        buf[rows, pos] = value[:, 0].to(buf.dtype)


def _write_kv_slot(layer_cache: LayerCache, k: torch.Tensor, v: torch.Tensor,
                   slot: int, pos: int) -> None:
    """Write a prefill chunk's K/V ``[1, C, H, D]`` into ``slot`` at ``pos``,
    in place (JAX's ``_write_kv_slot``)."""
    C = k.shape[1]
    for name, value in _stored(layer_cache, k, v).items():
        buf = layer_cache[name]
        if pos + C > buf.shape[1]:
            raise ValueError(f"prefill write at {pos} of {C} positions overruns "
                             f"the slot's {buf.shape[1]}")
        buf[slot, pos:pos + C] = value[0].to(buf.dtype)


@torch.no_grad()
def decode_step(params, cache: List[LayerCache], tokens: torch.Tensor,
                pos: torch.Tensor, args: llama.LlamaArgs,
                attend_len: int) -> torch.Tensor:
    """Advance every slot one token: ``tokens [B]`` (0 on masked rows),
    ``pos [B]`` each row's write position (``max_len - 1``, the reserved junk
    position, on masked rows). Attends the first ``attend_len`` positions of
    each slot; returns fp32 logits ``[B, V]``."""
    positions = pos[:, None]  # [B, 1]
    x = params["tok_embeddings"]["weight"][tokens][:, None, :]  # [B, 1, D]
    k_idx = torch.arange(attend_len, device=x.device)
    mask = k_idx[None, None, :] <= positions[:, :, None]  # [B, 1, L]
    x = _stack(params, cache, x, positions, mask[:, None, None], args,
               lambda c, k, v: _write_kv_rows(c, k, v, pos),
               lambda c: _read(c, (slice(None), slice(0, attend_len))))
    return _project_logits(params, x, args)[:, 0, :]


@torch.no_grad()
def prefill_step(params, cache: List[LayerCache], tokens: torch.Tensor, slot: int,
                 pos: int, last_idx: int, args: llama.LlamaArgs, attend_len: int,
                 with_logits: bool) -> Optional[torch.Tensor]:
    """Write one chunk ``tokens [C]`` of one prompt into ``slot`` at ``pos``;
    returns the logits ``[1, V]`` at ``last_idx`` (the true last prompt
    token) of the final chunk, else None. Pad junk past the prompt is
    overwritten by decode before it is attendable."""
    chunk = tokens.shape[0]
    x = params["tok_embeddings"]["weight"][tokens][None]  # [1, C, D]
    positions = (torch.arange(chunk, device=x.device) + pos)[None]  # [1, C]
    k_idx = torch.arange(attend_len, device=x.device)
    mask = (k_idx[None, :] <= positions[0][:, None]) \
        & (k_idx[None, :] < pos + chunk)  # [C, L]
    x = _stack(params, cache, x, positions, mask, args,
               lambda c, k, v: _write_kv_slot(c, k, v, slot, pos),
               lambda c: _read(c, (slice(slot, slot + 1), slice(0, attend_len))))
    if not with_logits:
        return None
    return _project_logits(params, x[:, last_idx:last_idx + 1], args)[:, 0, :]


# -- the paged pool -----------------------------------------------------------------
@torch.no_grad()
def paged_decode_step(params, cache: List[LayerCache], tokens: torch.Tensor,
                      pos: torch.Tensor, tables: torch.Tensor,
                      args: llama.LlamaArgs, attend_len: int,
                      block_size: int) -> torch.Tensor:
    """Advance every pool row: ``tokens [B, S]`` per row the last emitted
    (not yet written) token followed by its ``S - 1`` speculative drafts
    (zeros on masked rows), or ``[B]`` for plain decode; ``pos [B]`` each
    row's first write position (its written length; 0 on masked rows, whose
    table rows map to the junk block); ``tables [B, W]``. Position ``s`` of
    a row attends everything at or before ``pos + s``: its own K/V is
    written first, so a draft sees the drafts before it. Writes the arena
    in place and returns fp32 logits ``[B, S, V]`` (``[B, V]`` for
    ``tokens [B]``)."""
    _check_attend(attend_len, block_size)
    plain = tokens.dim() == 1
    if plain:
        tokens = tokens[:, None]
    S = tokens.shape[1]
    positions = pos[:, None] + torch.arange(S, device=pos.device)[None, :]  # [B, S]
    x = params["tok_embeddings"]["weight"][tokens]  # [B, S, D]
    k_idx = torch.arange(attend_len, device=x.device)
    mask = k_idx[None, None, :] <= positions[:, :, None]  # [B, S, L]
    x = _layers(params, cache, x, positions, tables, mask[:, None, None],
                args, attend_len, block_size)
    logits = _project_logits(params, x, args)
    return logits[:, 0, :] if plain else logits


@torch.no_grad()
def paged_prefill_step(params, cache: List[LayerCache], tokens: torch.Tensor,
                       table: torch.Tensor, pos: int, last_idx: int,
                       args: llama.LlamaArgs, attend_len: int, block_size: int,
                       with_logits: bool) -> Optional[torch.Tensor]:
    """Write one chunk ``tokens [C]`` of one prompt through its block-table
    row ``table [W]`` starting at position ``pos``. Only the final chunk
    needs logits: returns ``[1, V]`` at ``last_idx`` (the true last prompt
    token), else None. Pad junk past the prompt lands in the request's own
    tail blocks, overwritten by decode before it is attendable."""
    _check_attend(attend_len, block_size)
    chunk = tokens.shape[0]
    x = params["tok_embeddings"]["weight"][tokens][None]  # [1, C, D]
    positions = (torch.arange(chunk, device=x.device) + pos)[None]  # [1, C]
    k_idx = torch.arange(attend_len, device=x.device)
    # the same positional validity mask as the single-sequence cached path
    mask = (k_idx[None, :] <= positions[0][:, None]) \
        & (k_idx[None, :] < pos + chunk)  # [C, L]
    x = _layers(params, cache, x, positions, table[None], mask, args,
                attend_len, block_size)
    if not with_logits:
        return None
    return _project_logits(params, x[:, last_idx:last_idx + 1], args)[:, 0, :]


@torch.no_grad()
def sample_rows(logits: torch.Tensor, temps: Sequence[float],
                generators: Sequence[Optional[torch.Generator]]
                ) -> Tuple[List[int], List[float]]:
    """One token per row of ``logits [B, V]``: argmax with its raw-logits
    logprob where ``temps[b] == 0``, else a draw from ``softmax(logits /
    t)`` with ``generators[b]`` and its logprob under that distribution."""
    tok = torch.argmax(logits, dim=-1)
    lp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    for b, t in enumerate(temps):
        if t > 0.0:
            draw = make_sampler(t)(generators[b], logits[b:b + 1])
            probs = torch.softmax(logits[b] / max(t, 1e-6), dim=-1)
            tok[b] = draw[0]
            lp[b] = torch.log(probs[draw[0]] + 1e-30)
    return tok.tolist(), lp.tolist()


@torch.no_grad()
def verify_rows(logits: torch.Tensor, tokens: torch.Tensor, temps: Sequence[float],
                generators: Sequence[Optional[torch.Generator]], rows: Sequence[int]):
    """The verify outputs of a speculative decode step (JAX's
    ``paged_decode_step`` returns them from inside the step), for ``logits
    [B, S, V]`` over ``tokens [B, S]`` (last token + ``k = S - 1`` drafts):

    - greedy: ``preds [B, S]`` = argmax at every position and ``lp_preds``
      their raw-logits logprobs (``infer/generate._verify_step``'s contract);
    - sampled, for each of ``rows`` whose ``temps[b] > 0``, the point-mass
      acceptance of ``infer/generate._verify_step_sampled`` at the row's own
      temperature with its own generator: ``{b: (accept [k], lp of the
      drafts [k], alts [k], lp of the alts [k], bonus, lp of the bonus)}``.

    Everything comes back as host lists in one transfer each."""
    from ..infer.generate import _spec_accept_one
    from ..infer.samplers import categorical

    def gather(rows, idx):
        return rows.gather(-1, idx[..., None])[..., 0]

    preds = torch.argmax(logits, dim=-1)
    lp_preds = gather(torch.log_softmax(logits, dim=-1), preds)
    k = tokens.shape[1] - 1
    sampled = {}
    for b in rows:
        t = temps[b]
        if t <= 0.0:
            continue
        probs = torch.softmax(logits[b] / max(t, 1e-6), dim=-1)  # [S, V]
        lp = torch.log(probs + 1e-30)
        drafts = tokens[b, 1:]
        accept, alts = _spec_accept_one(generators[b], probs[:k], drafts)
        bonus = categorical(generators[b], lp[k:k + 1])[0]
        sampled[b] = (accept.tolist(), gather(lp[:k], drafts).tolist(), alts.tolist(),
                      gather(lp[:k], alts).tolist(), int(bonus), float(lp[k, bonus]))
    return preds.tolist(), lp_preds.tolist(), sampled


@torch.no_grad()
def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator]) -> Tuple[int, float]:
    """Sample one token from ``logits [1, V]`` (the prefill's last row);
    the logprob is under the raw logits, as in the JAX engine."""
    tok = make_sampler(temperature)(generator, logits)
    lp = torch.log_softmax(logits, dim=-1)[0, tok[0]]
    return int(tok[0]), float(lp)
