"""Paged prefill and decode steps for the continuous-batching engine.

Every KV read and write goes through block tables into the paged arena
(``models/llama.init_paged_cache``): position ``p`` of a sequence lives at
``(table[p // block_size], p % block_size)``. Masked rows and positions past
a table's extent write into the shared junk block 0.

Differences from the JAX package's ``serve/batch_step.py``, which compiles
each step once per shape bucket and donates the cache:

- the steps run eagerly, and the arena is updated IN PLACE (``index_put_``
  without accumulation; colliding junk writes are harmless by construction).
  ``attend_len`` buckets still bound how much of each table is gathered;
- decode verifies no speculative drafts (``draft_len == 0`` only);
- sampling draws from per-request ``torch.Generator``s, so sampled tokens
  differ from JAX's; greedy tokens are comparable.

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
    dt = layer_cache["k"].dtype
    layer_cache["k"][bi, oi] = k.reshape(B * S, H, D).to(dt)
    layer_cache["v"][bi, oi] = v.reshape(B * S, H, D).to(dt)


def _paged_gather(layer_cache: LayerCache, tables: torch.Tensor,
                  nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sequence's first ``nb`` blocks as contiguous K/V
    ``[B, nb * block_size, H, D]``."""
    idx = tables[:, :nb]
    keys, values = layer_cache["k"][idx], layer_cache["v"][idx]
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


def _layers(params, cache: List[LayerCache], x: torch.Tensor,
            positions: torch.Tensor, tables: torch.Tensor, mask: torch.Tensor,
            args: llama.LlamaArgs, attend_len: int, block_size: int) -> torch.Tensor:
    """Run every decoder layer over ``x [B, S, D]`` at ``positions [B, S]``:
    write this step's K/V through ``tables [B, W]``, attend over the first
    ``attend_len`` positions under ``mask``."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = args.num_heads, args.num_kv_heads, args.head_dim
    blocks, offs = _block_coords(positions, tables, block_size)
    nb = attend_len // block_size
    for p, layer_cache in zip(params["layers"], cache):
        h = llama.rms_norm(x, p["attention_norm"]["weight"], args.rms_norm_eps)
        pa = p["attention"]
        q = llama._linear(h, pa["wq"]).reshape(B, S, Hq, Dh)
        k = llama._linear(h, pa["wk"]).reshape(B, S, Hkv, Dh)
        v = llama._linear(h, pa["wv"]).reshape(B, S, Hkv, Dh)
        q = _rope_rows(q, positions, args)
        k = _rope_rows(k, positions, args)
        _paged_write(layer_cache, k, v, blocks, offs)
        ck, cv = _paged_gather(layer_cache, tables, nb)
        out = reference_attention(q, ck, cv, explicit_mask=mask)
        x = x + llama._linear(out.reshape(B, S, Hq * Dh), pa["wo"])
        x = x + _ffn(p, llama.rms_norm(x, p["ffn_norm"]["weight"],
                                       args.rms_norm_eps), args)
    return llama.rms_norm(x, params["norm"]["weight"], args.rms_norm_eps)


def _check_attend(attend_len: int, block_size: int) -> None:
    if attend_len % block_size:
        raise ValueError(f"attend_len {attend_len} not a multiple of "
                         f"block_size {block_size}")


@torch.no_grad()
def paged_decode_step(params, cache: List[LayerCache], tokens: torch.Tensor,
                      pos: torch.Tensor, tables: torch.Tensor,
                      args: llama.LlamaArgs, attend_len: int,
                      block_size: int) -> torch.Tensor:
    """Advance every pool row one token: ``tokens [B]`` (the last emitted,
    not yet written token; 0 on masked rows), ``pos [B]`` (its write
    position; 0 on masked rows, whose table rows map to the junk block),
    ``tables [B, W]``. Writes the arena in place and returns fp32 logits
    ``[B, V]``."""
    _check_attend(attend_len, block_size)
    positions = pos[:, None]  # [B, 1]
    x = params["tok_embeddings"]["weight"][tokens][:, None, :]  # [B, 1, D]
    k_idx = torch.arange(attend_len, device=x.device)
    # keys at or before each row's own position (its KV is written first)
    mask = k_idx[None, None, :] <= positions[:, :, None]  # [B, 1, L]
    x = _layers(params, cache, x, positions, tables, mask[:, None, None],
                args, attend_len, block_size)
    return _project_logits(params, x, args)[:, 0, :]


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
def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator]) -> Tuple[int, float]:
    """Sample one token from ``logits [1, V]`` (the prefill's last row);
    the logprob is under the raw logits, as in the JAX engine."""
    tok = make_sampler(temperature)(generator, logits)
    lp = torch.log_softmax(logits, dim=-1)[0, tok[0]]
    return int(tok[0]), float(lp)
