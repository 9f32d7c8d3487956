"""Automatic prefix caching over the paged KV pool (vLLM-style).

Every FULL block of a sequence is content-addressable: its key is
``hash(parent_key, token_ids)`` over the ``block_size`` tokens whose KV
it holds, chained from the key of the block before it. Full blocks are
immutable by construction — a sequence only ever writes at positions
``>= length``, which always land in its not-yet-full tail block (or in
fresh spec-verify blocks), so a full block's bytes are frozen the moment
it fills. That makes zero-copy reuse safe: a new request whose prompt
shares a prefix walks the hash map, adopts the longest cached
block-chain by bumping refcounts (block tables simply point at the
shared physical blocks), and chunked prefill resumes AFTER the adopted
tokens — the dominant cost of templated traffic (system prompts,
few-shot prefixes) collapses to the unshared tail.

This module is the pure host-side bookkeeping half: the key↔block map,
the LRU retire list, and the hit/miss/eviction counters. Refcounts and
block ownership live in ``kv_pool.PagedKVPool`` (it owns the arena);
the pool consults this cache on allocate/free/register.

Lifecycle of a cached block:

- ``register(key, block)``   — the owning sequence filled it; the key is
  published unless an identical-content block already holds it (first
  writer wins; the duplicate stays private and frees normally).
- refcount > 0               — live: mapped by one or more block tables.
- refcount 0 + registered    — retired to the LRU list instead of the
  free list; its bytes are intact and it is still adoptable.
- eviction                   — allocation pressure pops the LRU end,
  unpublishes the key, and hands the block back as an ordinary free
  block (refcount-0 blocks only, by construction of the LRU list).

Keys are chained blake2b digests (stable, collision-resistant), so a
chain match at block ``i`` certifies the ENTIRE token prefix
``[0, (i+1) * block_size)`` — no per-token comparison on the hot path.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "chain_keys"]


def _block_key(parent_key: Optional[bytes],
               token_ids: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_key or b"\x00")
    h.update(",".join(str(int(t)) for t in token_ids).encode())
    return h.digest()


def chain_keys(token_ids: Sequence[int], block_size: int,
               parent_key: Optional[bytes] = None,
               start_block: int = 0) -> List[bytes]:
    """Keys for the full blocks of ``token_ids`` from ``start_block`` on
    (``parent_key`` = key of block ``start_block - 1``). Partial tail
    tokens produce no key — only full blocks are content-addressable."""
    keys: List[bytes] = []
    key = parent_key
    for i in range(start_block, len(token_ids) // block_size):
        key = _block_key(key, token_ids[i * block_size:(i + 1) * block_size])
        keys.append(key)
    return keys


class PrefixCache:
    """Key↔block map + LRU retire list + counters (host-side only).

    Unlocked by design: the owning pool belongs to the engine thread, and
    every mutator here runs inside a pool mutator."""

    def __init__(self, block_size: int, min_hit_blocks: int = 1):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.min_hit_blocks = max(1, int(min_hit_blocks))
        self._by_key: Dict[bytes, int] = {}      # key -> physical block
        self._key_of: Dict[int, bytes] = {}      # registered block -> key
        # refcount-0 registered blocks, oldest-retired first
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # counters (monotonic; the engine mirrors them into obs)
        self.hits = 0            # requests that adopted >= min_hit_blocks
        self.misses = 0          # requests that adopted nothing
        self.hit_tokens = 0      # prompt tokens served from cache
        self.miss_tokens = 0     # prompt tokens that had to be computed
        self.evictions = 0       # cached blocks reclaimed by allocation

    # -- sizes ---------------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        """Blocks currently content-addressable (live + retired)."""
        return len(self._by_key)

    @property
    def retired_blocks(self) -> int:
        """Refcount-0 cached blocks parked on the LRU list."""
        return len(self._lru)

    def hit_rate(self) -> float:
        """Fraction of offered prompt tokens served from cache (0.0 on a
        fresh cache — never NaN)."""
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    # -- lookup --------------------------------------------------------------
    def match(self, token_ids: Sequence[int],
              max_blocks: Optional[int] = None
              ) -> Tuple[List[int], Optional[bytes]]:
        """Longest cached block-chain covering a prefix of ``token_ids``.

        Returns ``(blocks, last_key)``; at most ``max_blocks`` entries and
        never the final token (the sampler needs its logits, so at least
        one prompt token is always recomputed). Pure lookup: no state
        change — the pool commits the adoption (refcounts, LRU revival)
        only once the whole allocation is known to fit."""
        limit = (len(token_ids) - 1) // self.block_size
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        blocks: List[int] = []
        key: Optional[bytes] = None
        for k in chain_keys(token_ids[:limit * self.block_size],
                            self.block_size):
            b = self._by_key.get(k)
            if b is None:
                break
            blocks.append(b)
            key = k
        if len(blocks) < self.min_hit_blocks:
            return [], None
        return blocks, key

    # -- publication ---------------------------------------------------------
    def register(self, key: bytes, block: int) -> bool:
        """Publish ``block`` under ``key``. False (no-op) when the key is
        already held — the first writer wins and the duplicate block
        stays private (frees through the plain free list)."""
        if key in self._by_key:
            return False
        self._by_key[key] = block
        self._key_of[block] = key
        return True

    def key_of(self, block: int) -> Optional[bytes]:
        return self._key_of.get(block)

    def lookup(self, key: bytes) -> Optional[int]:
        """Physical block published under ``key`` (None if unpublished): no
        LRU touch and no counters, so resolving a chain for a KV export
        leaves the eviction order alone."""
        return self._by_key.get(key)

    # -- refcount-edge notifications (called by the pool) --------------------
    def retire(self, block: int) -> bool:
        """Refcount hit 0: park a registered block on the LRU list (True)
        or report it unregistered (False → plain free list)."""
        if block not in self._key_of:
            return False
        self._lru[block] = None
        self._lru.move_to_end(block)
        return True

    def revive(self, block: int) -> None:
        """A retired block was adopted again (refcount 0 → 1)."""
        self._lru.pop(block, None)

    def evict_lru(self) -> Optional[int]:
        """Reclaim the least-recently-retired cached block for reuse:
        unpublish its key and hand it back as an ordinary free block."""
        if not self._lru:
            return None
        block, _ = self._lru.popitem(last=False)
        key = self._key_of.pop(block)
        del self._by_key[key]
        self.evictions += 1
        return block

    def drop(self, block: int) -> None:
        """Unpublish a block without counting an eviction (quarantine)."""
        key = self._key_of.pop(block, None)
        if key is not None:
            self._by_key.pop(key, None)
        self._lru.pop(block, None)

    def clear(self) -> None:
        self._by_key.clear()
        self._key_of.clear()
        self._lru.clear()

    # -- accounting ----------------------------------------------------------
    def note_lookup(self, prompt_tokens: int, adopted_tokens: int) -> None:
        """Count one admission's outcome (tokens, then hit/miss)."""
        if adopted_tokens > 0:
            self.hits += 1
            self.hit_tokens += adopted_tokens
            self.miss_tokens += max(prompt_tokens - adopted_tokens, 0)
        else:
            self.misses += 1
            self.miss_tokens += prompt_tokens

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_cache_hits": self.hits,
            "prefix_cache_misses": self.misses,
            "prefix_cache_hit_tokens": self.hit_tokens,
            "prefix_cache_miss_tokens": self.miss_tokens,
            "prefix_cache_evictions": self.evictions,
            "prefix_cache_hit_rate": round(self.hit_rate(), 4),
            "prefix_cached_blocks": self.cached_blocks,
            "prefix_retired_blocks": self.retired_blocks,
        }
