"""Samplers and logits processors on ``logits [B, V]``: the JAX package's
``infer/samplers.py``.

A sampler is ``(generator, logits) -> token ids [B]``. Random draws come from
an explicit ``torch.Generator`` on the logits' device (one per request in the
engine, one per call in ``infer/generate.py``); the draws differ from
``jax.random``'s, so sampled output is compared with the JAX package by its
support and distribution, and only greedy output token for token. A logits
processor is ``(history [B, T], logits [B, V]) -> logits [B, V]``, with
``history`` the last T token ids padded with -1.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

Sampler = Callable[[Optional[torch.Generator], torch.Tensor], torch.Tensor]
LogitsProcessor = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical(generator: Optional[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` (``-inf`` never drawn), as
    ``jax.random.categorical``."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def greedy() -> Sampler:
    return lambda generator, logits: torch.argmax(logits, dim=-1)


def temperature_sampler(temp: float) -> Sampler:
    def sample(generator, logits):
        return categorical(generator, logits.float() / max(temp, 1e-6))

    return sample


def top_p_sampler(temp: float, top_p: float) -> Sampler:
    """Nucleus sampling: keep the smallest prefix of the sorted
    probabilities whose mass reaches ``top_p`` (the top token always). The
    sort is stable, as ``jnp.argsort`` is, so ties keep index order."""

    def sample(generator, logits):
        logits = logits.float() / max(temp, 1e-6)
        sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, sorted_idx)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        masked = sorted_logits.masked_fill(~keep, float("-inf"))
        choice = categorical(generator, masked)
        return torch.gather(sorted_idx, -1, choice[:, None])[:, 0]

    return sample


def min_p_sampler(temp: float, min_p: float) -> Sampler:
    """Keep the tokens whose probability is at least ``min_p`` times the
    largest."""

    def sample(generator, logits):
        logits = logits.float() / max(temp, 1e-6)
        probs = torch.softmax(logits, dim=-1)
        cutoff = min_p * probs.amax(dim=-1, keepdim=True)
        return categorical(generator, logits.masked_fill(probs < cutoff, float("-inf")))

    return sample


def top_k_sampler(temp: float, top_k: int) -> Sampler:
    """Keep every logit at or above the k-th largest (ties included)."""

    def sample(generator, logits):
        logits = logits.float() / max(temp, 1e-6)
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        return categorical(generator, logits.masked_fill(logits < kth, float("-inf")))

    return sample


def make_sampler(temp: float = 0.0, top_p: float = 0.0, min_p: float = 0.0,
                 top_k: int = 0) -> Sampler:
    """The JAX package's precedence: greedy at temperature 0, then min_p,
    then top_p (strictly inside (0, 1)), then top_k, then temperature."""
    if temp == 0.0:
        return greedy()
    if min_p and min_p > 0.0:
        return min_p_sampler(temp, min_p)
    if top_p and 0.0 < top_p < 1.0:
        return top_p_sampler(temp, top_p)
    if top_k and top_k > 0:
        return top_k_sampler(temp, top_k)
    return temperature_sampler(temp)


def repetition_penalty_processor(penalty: float, context_size: int = 64) -> LogitsProcessor:
    """Divide the positive logits (multiply the negative ones) of the tokens
    in the last ``context_size`` entries of ``history`` by ``penalty``;
    entries of -1 are padding."""

    def process(history, logits):
        hist = history[:, -context_size:].long()
        B, V = logits.shape
        # padding goes to an extra column, so a duplicate index never
        # carries both a seen and an unseen mark
        idx = torch.where(hist >= 0, hist, V)
        seen = torch.zeros(B, V + 1, dtype=torch.bool, device=logits.device)
        seen = seen.scatter_(1, idx, True)[:, :V]
        penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
        return torch.where(seen, penalized, logits)

    return process


def make_logits_processors(repetition_penalty: Optional[float] = None,
                           repetition_context_size: int = 64) -> tuple:
    out: List[LogitsProcessor] = []
    if repetition_penalty and repetition_penalty != 1.0:
        out.append(repetition_penalty_processor(repetition_penalty, repetition_context_size))
    return tuple(out)
