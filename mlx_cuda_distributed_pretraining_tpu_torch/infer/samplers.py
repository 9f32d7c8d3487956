"""Greedy and temperature samplers on ``logits [B, V]``.

A sampler is ``(generator, logits) -> token ids [B]``. Random draws come from
an explicit ``torch.Generator`` on the logits' device (one per request in the
engine); the draws differ from ``jax.random``'s, so only greedy output can be
compared token for token with the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Sampler = Callable[[Optional[torch.Generator], torch.Tensor], torch.Tensor]


def greedy() -> Sampler:
    return lambda generator, logits: torch.argmax(logits, dim=-1)


def temperature_sampler(temp: float) -> Sampler:
    def sample(generator, logits):
        probs = torch.softmax(logits.float() / max(temp, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample


def make_sampler(temp: float = 0.0) -> Sampler:
    """Greedy at temperature 0, temperature sampling above it (top-p, min-p
    and top-k wait for the locked path's port)."""
    return greedy() if temp == 0.0 else temperature_sampler(temp)
