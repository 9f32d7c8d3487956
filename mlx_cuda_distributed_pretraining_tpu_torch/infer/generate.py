"""Shape bucketing shared with the serving engine.

The locked single-sequence ``generate_text`` path of the JAX package is not
ported yet; the batch engine uses these two helpers to size prefill chunks
and attention windows the same way.
"""

from __future__ import annotations


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
