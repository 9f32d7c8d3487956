"""KV-cache pools for continuous batching: slotted (a fixed row per
request) and paged (vLLM-style block tables over a global arena).

One preallocated cache per layer, shared by every in-flight request: fp
``{"k", "v"}`` or, with ``quantize``, the int8 quartet ``{"k_q", "k_s",
"v_q", "v_s"}`` (int8 values, fp32 scales per position and head, as
``models/llama.py`` ``_quantize_kv`` makes them; the steps dequantize only
the window they gather). Lengths, block tables and refcounts are host-side
state owned by the engine thread; other threads reach them through
``BatchEngine.call_in_loop``. The steps write the cache in place.

Freeing never zeroes data: chunked prefill overwrites from position 0 and
the validity mask (k_idx <= row position) makes stale entries unattendable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import llama
from .prefix_cache import PrefixCache, chain_keys


@dataclass
class KVExport:
    """A pinned view of one request's full KV blocks, from
    ``PagedKVPool.export_blocks``: every listed block carries an extra
    refcount, so it cannot be recycled or evicted while the export lives,
    and full blocks are never written again, so ``cache`` (the arena's
    per-layer tensors) can be read off the engine thread. Callers read the
    bytes, then call ``release_export`` exactly once."""

    keys: List[bytes]          # chain keys, one per exported full block
    blocks: List[int]          # pinned physical block ids, chain order
    cache: list = field(repr=False, default_factory=list)
    released: bool = False


class SlotKVPool:
    """Fixed pool of KV-cache rows, one per request, with per-slot lengths:
    per layer ``[num_slots, max_len, Hkv, Dh]`` (or the int8 quartet). The
    LAST position of every slot is the junk-write target of masked rows in
    the batched decode step, so a slot holds ``max_len - 1`` tokens."""

    kind = "slotted"

    def __init__(self, args: llama.LlamaArgs, num_slots: int, max_len: int,
                 device="cuda", dtype=torch.float32, quantize: bool = False):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.args = args
        self.num_slots = num_slots
        self.max_len = max_len
        self.quantize = quantize
        self.cache = llama.init_cache(args, num_slots, max_len=max_len,
                                      dtype=dtype, quantize=quantize, device=device)
        for layer in self.cache:  # slot positions live pool-side
            layer.pop("pos", None)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        # Written length per slot (the next write position). Free slots keep
        # their stale value; allocate() resets it.
        self.lengths: List[int] = [0] * num_slots

    @property
    def capacity(self) -> int:
        """Longest sequence a slot can hold (its last position is the junk
        target of masked rows)."""
        return self.max_len - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_slots - len(self._free)

    def occupancy(self) -> float:
        return self.num_used / self.num_slots

    def allocate(self, need_tokens: int = 0,
                 token_ids: Optional[Sequence[int]] = None) -> Optional[int]:
        """Claim a free slot (its length reset); None when all are taken.
        ``need_tokens``/``token_ids`` belong to the pools' shared interface:
        a slot always holds ``capacity`` tokens and has no prefix cache."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.lengths[slot] = 0
        return slot

    def ensure_capacity(self, slot: int, length: int) -> bool:
        """A slot's whole extent is allocated up front."""
        return length <= self.max_len

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range 0..{self.num_slots - 1}")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)

    def reset(self) -> None:
        """Free every slot (buffers are NOT zeroed)."""
        self._free = list(range(self.num_slots - 1, -1, -1))
        self.lengths = [0] * self.num_slots


class PagedKVPool:
    """Paged KV pool (PagedAttention, Kwon et al. 2023): one global arena of
    fixed-size blocks per layer shared by every sequence, addressed through
    per-sequence block tables. A sequence holds only the blocks covering its
    written length; admission is gated on free blocks (plus a free batch
    row), and blocks are mapped on demand as decode advances.

    Layout and invariants:

    - arena: per layer ``{"k", "v"}`` of ``[num_blocks+1, block_size, Hkv,
      Dh]`` on the pool's device, or the int8 quartet with ``quantize``
      (``llama.init_paged_cache``). Logical
      position ``p`` of sequence ``s`` lives at ``(tables[s][p //
      block_size], p % block_size)``; tables are host-side int32 numpy.
    - physical block 0 is a reserved shared junk block, never allocated:
      unmapped table entries point at it, and freed/masked rows (which the
      batched decode step still writes every iteration) scatter their junk
      there.
    - freeing never zeroes data: the validity mask (k_idx <= row position)
      makes stale entries unattendable.
    - ``_watermark`` is the lowest free-block count since the last
      :meth:`read_watermark` (how close the arena came to exhaustion).

    Automatic prefix caching (``prefix_cache=True``): every physical block
    carries a refcount, full blocks become content-addressable through a
    ``PrefixCache`` (key = hash(parent_key, token_ids)), and
    ``allocate(token_ids=...)`` adopts the longest cached block-chain for
    the prompt — table entries point at SHARED physical blocks (refcount++,
    zero copy) and ``lengths[seq]`` starts at the adopted token count so
    chunked prefill skips the hit prefix. Freed refcount-0 blocks with
    published keys retire to an LRU list instead of the free list;
    allocation evicts from its old end only when the free list runs dry.
    Chain keys are also the addresses of a KV transfer between replicas
    (:meth:`export_blocks`, :meth:`adopt_blocks`, :meth:`quarantine`).
    """

    kind = "paged"

    def __init__(self, args: llama.LlamaArgs, num_seqs: int, max_len: int,
                 block_size: int = 32, num_blocks: int = 0, device="cuda",
                 dtype=torch.float32, quantize: bool = False,
                 prefix_cache: bool = False, min_hit_blocks: int = 1):
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
        self.quantize = quantize
        # +1: physical block 0 is the reserved junk block. The serving steps
        # write this arena in place.
        self.cache = llama.init_paged_cache(args, num_blocks + 1, block_size,
                                            device=device, dtype=dtype,
                                            quantize=quantize)
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

    def occupancy(self) -> float:
        return self.num_used / self.num_slots

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

    def read_watermark(self) -> int:
        """Lowest free-block count since the previous call (then reset)."""
        w = self._watermark
        self._watermark = self.free_blocks
        return w

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

    # -- KV transfer -----------------------------------------------------------
    # The handoff between replicas (serve/kv_transfer.py) moves KV through
    # these calls; both sides run with the prefix cache on, whose chain keys
    # are the addresses, so a shared prefix transfers at most once.

    def export_blocks(self, token_ids: Sequence[int]) -> KVExport:
        """Pin and return the cached block chain covering ``token_ids`` (the
        fed-token sequence ``register_upto`` published: prompt plus
        generated). Each full block whose chain key is published gets
        refcount++ (revived off the LRU if retired); the chain stops at the
        first unpublished key, and a prompt shorter than a block exports
        nothing. Engine thread only."""
        if self.prefix is None:
            raise ValueError("export_blocks requires prefix_cache=True "
                             "(chain keys are the transfer addresses)")
        full = len(token_ids) // self.block_size
        keys: List[bytes] = []
        blocks: List[int] = []
        for key in chain_keys(token_ids[:full * self.block_size], self.block_size):
            b = self.prefix.lookup(key)
            if b is None:
                break
            keys.append(key)
            blocks.append(b)
        for b in blocks:
            if self._ref[b] == 0:
                self.prefix.revive(b)
            self._ref[b] += 1
        self._note_free_level()
        return KVExport(keys=keys, blocks=blocks,
                        cache=[dict(layer) for layer in self.cache])

    def release_export(self, export: KVExport) -> None:
        """Unpin an export's blocks (refcount--; at zero a registered block
        retires to the prefix LRU). Exactly once per export: a second
        release raises instead of corrupting the refcounts."""
        if export.released:
            raise ValueError("KV export already released (double release "
                             "would double-decrement block refcounts)")
        for b in export.blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(
                    f"refcount invariant violated: exported block {b} has "
                    f"refcount {self._ref[b]} at release")
        export.released = True
        export.cache = []
        for b in export.blocks:
            self._release_block(b)

    def adopt_blocks(self, keys: Sequence[bytes],
                     blocks_data: Sequence[Sequence[Dict[str, np.ndarray]]]
                     ) -> Dict[str, int]:
        """Install transferred KV blocks under their chain keys (in chain
        order). ``blocks_data[i]`` is block i's per-layer ``{name: array
        [block_size, Hkv, Dh or 1]}``, whose names, shapes and dtypes must
        match this arena exactly (a mismatch raises before anything
        changes). A key already published here is skipped (``reused``);
        a fresh one takes a block, gets the bytes, is registered, and
        retires to the prefix LRU at refcount 0, adoptable by the next
        ``allocate(token_ids=...)`` and evictable like any cached block.
        When the arena runs out the chain stops (``skipped`` counts the
        rest). Engine thread only."""
        if self.prefix is None:
            raise ValueError("adopt_blocks requires prefix_cache=True")
        if len(keys) != len(blocks_data):
            raise ValueError(f"{len(keys)} keys but {len(blocks_data)} "
                             "block payloads")
        layout = [{name: (tuple(t.shape[1:]), _np_dtype(t.dtype))
                   for name, t in layer.items()} for layer in self.cache]
        for i, data in enumerate(blocks_data):
            if len(data) != len(layout):
                raise ValueError(f"block {i}: {len(data)} layers, arena "
                                 f"has {len(layout)}")
            for li, layer in enumerate(data):
                if set(layer) != set(layout[li]):
                    raise ValueError(
                        f"block {i} layer {li}: names {sorted(layer)} != "
                        f"arena {sorted(layout[li])} (fp/int8 mismatch?)")
                for name, arr in layer.items():
                    want_shape, want_dtype = layout[li][name]
                    got = np.asarray(arr)
                    if tuple(got.shape) != want_shape or got.dtype != want_dtype:
                        raise ValueError(
                            f"block {i} layer {li} '{name}': "
                            f"{got.shape}/{got.dtype} != arena "
                            f"{want_shape}/{want_dtype}")
        reused = adopted = 0
        staged: List[int] = []   # fresh blocks, pinned until the bytes land
        staged_data = []
        for key, data in zip(keys, blocks_data):
            if self.prefix.lookup(key) is not None:
                reused += 1
                continue
            b = self._take_block()
            if b is None:
                break  # arena full of live data; keep the chain prefix
            if self._ref[b] != 0:
                raise RuntimeError(
                    f"refcount invariant violated: free block {b} has "
                    f"refcount {self._ref[b]}")
            # pinned while staging, so a later _take_block in this loop
            # cannot evict a block just adopted
            self._ref[b] = 1
            self.prefix.register(key, b)
            staged.append(b)
            staged_data.append(data)
            adopted += 1
        if staged:
            self._write_blocks(staged, staged_data)
        for b in staged:
            self._release_block(b)  # refcount 0: retires to the LRU
        self._note_free_level()
        return {"adopted": adopted, "reused": reused,
                "skipped": len(keys) - adopted - reused}

    def quarantine(self, keys: Sequence[bytes]) -> int:
        """Unpublish suspect chain keys (a refused or corrupt transfer must
        not leave them adoptable). A retired block rejoins the free list;
        a block live rows still hold only loses its key and frees when they
        release it. Unknown keys are ignored. Returns the number of keys
        dropped. Engine thread only."""
        if self.prefix is None:
            return 0
        dropped = 0
        for key in keys:
            b = self.prefix.lookup(key)
            if b is None:
                continue
            self.prefix.drop(b)
            if self._ref[b] == 0:  # was on the LRU: back to the free list
                self._free_blocks.append(b)
            dropped += 1
        return dropped

    def unpublish_all(self) -> int:
        """Unpublish every cached chain key, and stop the live rows from
        publishing more of theirs: after a weight swap, KV computed with the
        old weights must not seed a request on the new ones. Returns the
        keys dropped. Engine thread only."""
        if self.prefix is None:
            return 0
        for seq in range(self.num_slots):
            if seq not in self._free_rows:
                self._registered[seq] = self.max_blocks
        return self.quarantine(list(self.prefix._by_key))

    def _write_blocks(self, block_ids: Sequence[int], blocks_data) -> None:
        """Scatter transferred bytes into the arena: one indexed copy per
        layer tensor."""
        idx = torch.tensor(list(block_ids), dtype=torch.long)
        for li, layer in enumerate(self.cache):
            for name, t in layer.items():
                stack = torch.from_numpy(np.stack([np.asarray(d[li][name])
                                                   for d in blocks_data]))
                t[idx.to(t.device)] = stack.to(t.device)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))
