"""Paged KV pool for continuous batching (vLLM-style block tables over a
global arena).

One preallocated arena per layer, shared by every in-flight request; block
tables, lengths and refcounts are host-side state owned by the engine thread.
The slotted pool of the JAX package and its KV export/adopt/quarantine for
disaggregated serving are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import llama
from .prefix_cache import PrefixCache, chain_keys


class PagedKVPool:
    """Paged KV pool (PagedAttention, Kwon et al. 2023): one global arena of
    fixed-size blocks per layer shared by every sequence, addressed through
    per-sequence block tables. A sequence holds only the blocks covering its
    written length; admission is gated on free blocks (plus a free batch
    row), and blocks are mapped on demand as decode advances.

    Layout and invariants:

    - arena: per layer ``{"k", "v"}`` of ``[num_blocks+1, block_size, Hkv,
      Dh]`` on the pool's device (``llama.init_paged_cache``). Logical
      position ``p`` of sequence ``s`` lives at ``(tables[s][p //
      block_size], p % block_size)``; tables are host-side int32 numpy.
    - physical block 0 is a reserved shared junk block, never allocated:
      unmapped table entries point at it, and freed/masked rows (which the
      batched decode step still writes every iteration) scatter their junk
      there.
    - freeing never zeroes data: the validity mask (k_idx <= row position)
      makes stale entries unattendable.
    - ``_watermark`` is the lowest free-block count seen (the headroom the
      arena kept under the heaviest load so far).

    Automatic prefix caching (``prefix_cache=True``): every physical block
    carries a refcount, full blocks become content-addressable through a
    ``PrefixCache`` (key = hash(parent_key, token_ids)), and
    ``allocate(token_ids=...)`` adopts the longest cached block-chain for
    the prompt — table entries point at SHARED physical blocks (refcount++,
    zero copy) and ``lengths[seq]`` starts at the adopted token count so
    chunked prefill skips the hit prefix. Freed refcount-0 blocks with
    published keys retire to an LRU list instead of the free list;
    allocation evicts from its old end only when the free list runs dry.
    """

    def __init__(self, args: llama.LlamaArgs, num_seqs: int, max_len: int,
                 block_size: int = 32, num_blocks: int = 0, device="cuda",
                 dtype=torch.float32, prefix_cache: bool = False,
                 min_hit_blocks: int = 1):
        if num_seqs < 1:
            raise ValueError(f"num_seqs must be >= 1, got {num_seqs}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if block_size < 1 or (block_size & (block_size - 1)) != 0:
            raise ValueError(
                f"block_size must be a power of two, got {block_size}")
        if max_len % block_size != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of block_size "
                f"({block_size}) so attend buckets align to block bounds")
        self.args = args
        self.num_slots = num_seqs  # batch rows
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max_len // block_size  # table width per sequence
        if num_blocks <= 0:
            # Default: every row can hold max_len tokens at once.
            num_blocks = num_seqs * self.max_blocks
        self.num_blocks = num_blocks
        # +1: physical block 0 is the reserved junk block. The serving steps
        # write this arena in place.
        self.cache = llama.init_paged_cache(args, num_blocks + 1, block_size,
                                            device=device, dtype=dtype)
        self.tables = np.zeros((num_seqs, self.max_blocks), dtype=np.int32)
        self.lengths: List[int] = [0] * num_seqs
        self._mapped: List[int] = [0] * num_seqs  # blocks mapped per row
        self._free_rows: List[int] = list(range(num_seqs - 1, -1, -1))
        self._free_blocks: List[int] = list(range(num_blocks, 0, -1))
        self._watermark = num_blocks
        # Prefix cache: per-block refcounts + content-hash bookkeeping.
        # Block 0 (junk) is never allocated, registered, or refcounted.
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(block_size, min_hit_blocks) if prefix_cache else None)
        self._ref: List[int] = [0] * (num_blocks + 1)
        # per row: leading full blocks already published + chain parent key
        self._registered: List[int] = [0] * num_seqs
        self._chain_key: List[Optional[bytes]] = [None] * num_seqs

    # -- capacity ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Longest sequence a row's table can address, leaving one position
        for the successor of the final emitted token (whose KV is written by
        the decode step that samples the next token)."""
        return self.max_len - 1

    @property
    def num_free(self) -> int:
        """Free batch rows (the admission gate also checks free blocks)."""
        return len(self._free_rows)

    @property
    def num_used(self) -> int:
        return self.num_slots - len(self._free_rows)

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: the plain free list plus retired (refcount
        0, still content-addressable) cached blocks — both satisfy an
        allocation, retired ones via LRU eviction."""
        free = len(self._free_blocks)
        if self.prefix is not None:
            free += self.prefix.retired_blocks
        return free

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - self.free_blocks

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size) if tokens > 0 else 0

    def fragmentation(self) -> float:
        """Internal fragmentation: fraction of mapped KV positions holding no
        live token (0.0 = every mapped block full)."""
        mapped_tokens = self.blocks_in_use * self.block_size
        if mapped_tokens == 0:
            return 0.0
        used = sum(self.lengths[s] for s in range(self.num_slots)
                   if s not in self._free_rows)
        return 1.0 - min(used, mapped_tokens) / mapped_tokens

    def _note_free_level(self) -> None:
        free = self.free_blocks
        if free < self._watermark:
            self._watermark = free

    # -- block supply --------------------------------------------------------
    def _take_block(self) -> Optional[int]:
        """One allocatable block: the plain free list first, then — with
        the prefix cache on — evict the least-recently-retired cached
        block (refcount-0 only by construction; its key is unpublished
        before reuse, so a stale chain can never match recycled bytes)."""
        if self._free_blocks:
            return self._free_blocks.pop()
        if self.prefix is not None:
            return self.prefix.evict_lru()
        return None

    def _release_block(self, block: int) -> None:
        """Refcount-- ; at zero a registered block retires to the prefix
        LRU (bytes stay adoptable), an unregistered one frees outright."""
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return
        if self.prefix is None or not self.prefix.retire(block):
            self._free_blocks.append(block)

    # -- sequence lifecycle --------------------------------------------------
    def allocate(self, need_tokens: int = 0,
                 token_ids: Optional[Sequence[int]] = None) -> Optional[int]:
        """Claim a batch row and map enough blocks for ``need_tokens``
        (the prompt). None when no row is free OR the arena cannot cover
        the request — admission is gated on actual free blocks.

        With the prefix cache on and ``token_ids`` given, the longest
        cached block-chain covering the prompt is ADOPTED instead of
        allocated: those table entries point at shared physical blocks
        (refcount++, zero copy) and ``lengths[seq]`` starts at the
        adopted token count — the engine's chunked prefill resumes there.
        At least the final prompt token is always recomputed (its logits
        seed sampling), and nothing is mutated on refusal."""
        adopted: List[int] = []
        adopted_key: Optional[bytes] = None
        if self.prefix is not None and token_ids is not None \
                and need_tokens > 0:
            adopted, adopted_key = self.prefix.match(
                token_ids, max_blocks=self.max_blocks)
        need = self.blocks_for(need_tokens)
        fresh = need - len(adopted)
        # Retired blocks about to be adopted are NOT allocatable supply:
        # revival pulls them off the LRU, so exclude them from the gate.
        adopting_retired = sum(1 for b in adopted if self._ref[b] == 0)
        if not self._free_rows or fresh > self.free_blocks - adopting_retired:
            return None
        seq = self._free_rows.pop()
        self.tables[seq, :] = 0
        for i, b in enumerate(adopted):
            self.tables[seq, i] = b
            self._ref[b] += 1
            if self._ref[b] == 1:
                self.prefix.revive(b)
        for i in range(len(adopted), need):
            b = self._take_block()
            self.tables[seq, i] = b
            self._ref[b] = 1
        self._mapped[seq] = need
        cached = len(adopted) * self.block_size
        self.lengths[seq] = cached
        self._registered[seq] = len(adopted)
        self._chain_key[seq] = adopted_key
        if self.prefix is not None and need_tokens > 0:
            self.prefix.note_lookup(need_tokens, cached)
        self._note_free_level()
        return seq

    def ensure_capacity(self, seq: int, length: int) -> bool:
        """Map blocks on demand so positions ``[0, length)`` are addressable.
        False (no state change) when the arena is exhausted — the caller
        decides whether to preempt."""
        if length > self.max_len:
            return False
        need = self.blocks_for(length)
        grow = need - self._mapped[seq]
        if grow <= 0:
            return True
        if grow > self.free_blocks:
            return False
        for i in range(self._mapped[seq], need):
            b = self._take_block()
            self.tables[seq, i] = b
            self._ref[b] = 1
        self._mapped[seq] = need
        self._note_free_level()
        return True

    def register_upto(self, seq: int, token_ids: Sequence[int]) -> None:
        """Publish content-hash keys for this row's newly-FULL blocks
        (``lengths[seq] // block_size`` leading blocks hold immutable,
        fully-written KV; the tail block is still mutable and never
        published). ``token_ids`` must be the fed-token sequence whose KV
        the row holds — prompt plus generated — so generated blocks are
        adoptable too (RadixAttention-style). Idempotent per block: each
        row tracks how far its chain has been published."""
        if self.prefix is None:
            return
        full = min(self.lengths[seq] // self.block_size, self._mapped[seq])
        if full <= self._registered[seq]:
            return
        keys = chain_keys(token_ids[:full * self.block_size],
                          self.block_size,
                          parent_key=self._chain_key[seq],
                          start_block=self._registered[seq])
        for i, key in zip(range(self._registered[seq], full), keys):
            self.prefix.register(key, int(self.tables[seq, i]))
            self._chain_key[seq] = key
        self._registered[seq] = full

    def free(self, seq: int) -> None:
        """Return the row; each mapped block's refcount drops, and blocks
        reaching zero either retire to the prefix LRU (registered) or
        rejoin the free list. O(mapped) list ops."""
        if not 0 <= seq < self.num_slots:
            raise ValueError(f"seq {seq} out of range 0..{self.num_slots - 1}")
        if seq in self._free_rows:
            raise ValueError(f"seq {seq} double-freed")
        for i in range(self._mapped[seq]):
            self._release_block(int(self.tables[seq, i]))
        self.tables[seq, :] = 0  # unmapped rows scatter to the junk block
        self._mapped[seq] = 0
        self._registered[seq] = 0
        self._chain_key[seq] = None
        self._free_rows.append(seq)

    def reset(self) -> None:
        """Free every row and block (buffers are NOT zeroed)."""
        self.tables[:, :] = 0
        self.lengths = [0] * self.num_slots
        self._mapped = [0] * self.num_slots
        self._free_rows = list(range(self.num_slots - 1, -1, -1))
        self._free_blocks = list(range(self.num_blocks, 0, -1))
        self._watermark = self.num_blocks
        self._ref = [0] * (self.num_blocks + 1)
        self._registered = [0] * self.num_slots
        self._chain_key = [None] * self.num_slots
        if self.prefix is not None:
            self.prefix.clear()
