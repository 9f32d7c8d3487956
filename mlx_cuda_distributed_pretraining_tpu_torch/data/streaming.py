"""Streaming data (the JAX package's ``data/streaming.py``).

Streams text from local JSONL or WebDataset tar shards, from synthetic
documents, or from the HuggingFace hub (``datasets`` streaming mode,
imported only when that source is built), tokenizes it on the fly and
serves fixed-shape packed batches: a shuffle buffer, a producer thread
with a bounded queue, a disk-space cap for an on-disk cache, and per-host
sharding by ``process_index`` modulo ``process_count`` over documents.

Every batch is ``[B, L]`` int32 (inputs, targets) and float32 (mask), the
in-memory loader's shapes, so the trainer is source-agnostic. Local shard
sources resume exactly: each served batch carries a snapshot of the
source position and the packer's leftover tokens, and the checkpoint keys
(``docs_consumed``, ``buf``, ``source``, ``hf``, ``process_count``,
``process_index``) are the JAX package's, so a run resumes across the two
packages.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import queue
import tarfile
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

Batch = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Disk cap (reference: fineweb_stream_limited.py:25-100 DiskSpaceManager)
# ---------------------------------------------------------------------------
class DiskSpaceManager:
    """Keeps a cache directory under ``max_gb`` by LRU file removal."""

    def __init__(self, cache_dir: str, max_gb: float = 10.0):
        self.cache_dir = cache_dir
        self.max_bytes = int(max_gb * (1 << 30))
        os.makedirs(cache_dir, exist_ok=True)

    def usage_bytes(self) -> int:
        total = 0
        for root, _dirs, files in os.walk(self.cache_dir):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
        return total

    def _files_by_atime(self) -> List[str]:
        out = []
        for root, _dirs, files in os.walk(self.cache_dir):
            for name in files:
                p = os.path.join(root, name)
                try:
                    out.append((os.path.getatime(p), p))
                except OSError:
                    pass
        return [p for _t, p in sorted(out)]

    def cleanup(self) -> int:
        """Remove least-recently-accessed files until under the cap.
        Returns number of files removed."""
        removed = 0
        usage = self.usage_bytes()
        if usage <= self.max_bytes:
            return 0
        for path in self._files_by_atime():
            try:
                size = os.path.getsize(path)
                os.remove(path)
                usage -= size
                removed += 1
            except OSError:
                continue
            if usage <= self.max_bytes:
                break
        return removed

    def ensure_space(self, incoming_bytes: int = 0) -> None:
        if self.usage_bytes() + incoming_bytes > self.max_bytes:
            self.cleanup()


# ---------------------------------------------------------------------------
# Text sources
# ---------------------------------------------------------------------------
def iter_jsonl_shards(
    paths: Iterable[str], text_key: str = "text", repeat: bool = True
) -> Iterator[str]:
    """Yield document texts from local JSONL shard files, looping forever
    when ``repeat`` (reference: fineweb_stream_local.py)."""
    paths = list(paths)
    if not paths:
        return
    while True:
        for path in paths:
            with open(path, "r") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(obj, dict) and text_key in obj:
                        yield obj[text_key]
                    elif isinstance(obj, str):
                        yield obj
        if not repeat:
            return


def load_shard_docs(path: str, text_key: str = "text") -> List[str]:
    """Read all documents of one shard file into memory.

    Supports JSONL shards (one object or raw string per line) and WebDataset
    ``.tar``/``.tar.gz`` shards (reference: fineweb_stream.py:18-57 streams
    FineWeb tar shards via ``wds.WebDataset``): each ``.txt`` member is a
    document; each ``.json`` member contributes ``obj[text_key]``. Shards
    are sized to fit in host memory (FineWeb shards are ~100MB), which is
    what makes the deterministic within-shard shuffle and O(one-shard)
    exact resume possible."""
    docs: List[str] = []
    if path.endswith((".tar", ".tar.gz", ".tgz")):
        with tarfile.open(path, "r:*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name.lower()
                if not name.endswith((".txt", ".json")):
                    continue
                f = tf.extractfile(member)
                if f is None:
                    continue
                raw = f.read().decode("utf-8", errors="replace")
                if name.endswith(".txt"):
                    if raw:
                        docs.append(raw)
                else:
                    try:
                        obj = json.loads(raw)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(obj, dict) and obj.get(text_key):
                        docs.append(obj[text_key])
        return docs
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and text_key in obj:
                docs.append(obj[text_key])
            elif isinstance(obj, str):
                docs.append(obj)
    return docs


class SeekableShuffledSource:
    """Deterministically shuffled document stream over local shard files
    (JSONL or WebDataset tar) with **exact O(one-shard) resume**.

    Instead of a reservoir shuffle (whose state is the buffer contents),
    shuffling is a pure function of ``(seed, epoch)``: shard order is a
    permutation of the shard list, document order within each shard is a
    permutation of that shard's documents. The stream position is then just
    ``(epoch, shard_ptr, doc_ptr, emitted)`` — four integers — and resume
    recomputes the permutations, reloads ONE shard, and continues from the
    exact document. Per-host sharding (``emitted % process_count``) is folded into
    the same counters so multi-host resume is exact too.

    **Elastic (N → M host) resume.** A snapshot taken at
    ``process_count=N`` can resume at ``process_count=M`` with zero
    skipped and zero replayed documents. The mechanism is an *exclusion
    table* per past world (``remap_seekable_states``): the old hosts'
    ``emitted`` positions plus a running assignment ordinal ``taken``.
    Replaying the old world's round-robin rule (``taken % N``) against
    each document ordinal tells every new host — identically, with no
    communication — whether the old world already consumed that document
    (its ordinal is below the consuming host's recorded position).
    Unconsumed stragglers are re-dealt round-robin over the new world by
    a fresh ``taken % M`` counter. Tables chain, so repeated reshapes
    (4 → 2 → 3 hosts) stay exact; a table is dropped once the stream
    passes its maximum recorded position (it can never exclude again)."""

    def __init__(
        self,
        shards: List[str],
        text_key: str = "text",
        seed: int = 42,
        repeat: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if not shards:
            raise ValueError("SeekableShuffledSource needs at least one shard")
        self.shards = list(shards)
        self.text_key = text_key
        self.seed = seed
        self.repeat = repeat
        self.process_index = process_index
        self.process_count = max(1, process_count)
        # position of the NEXT document to consider (pre-host-filter)
        self.epoch = 0
        self.shard_ptr = 0
        self.doc_ptr = 0
        self.emitted = 0  # global counter driving the host filter
        # Assignment ordinal: count of documents not excluded by a past
        # world's table. Equal to ``emitted`` on fresh (non-remapped)
        # runs, so the fresh-run take rule is bit-identical to before.
        self.taken = 0
        # Exclusion tables from past worlds (see class docstring); each is
        # {"world": N, "positions": [emitted_i], "taken": ordinal}.
        self._tables: List[Dict[str, Any]] = []

    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "epoch": self.epoch,
            "shard_ptr": self.shard_ptr,
            "doc_ptr": self.doc_ptr,
            "emitted": self.emitted,
            "taken": self.taken,
            "process_count": self.process_count,
            "process_index": self.process_index,
        }
        if self._tables:
            state["tables"] = [dict(t) for t in self._tables]
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        snap_count = state.get("process_count")
        snap_index = state.get("process_index")
        if snap_count is not None and int(snap_count) != self.process_count:
            raise ValueError(
                f"data snapshot world mismatch: snapshot has "
                f"process_count={int(snap_count)} but this source runs with "
                f"process_count={self.process_count}; remap it with "
                f"data.streaming.remap_seekable_states (or "
                f"remap_data_states) instead of loading it directly — a "
                f"direct load would skip or double-consume documents")
        if (snap_index is not None and snap_count is not None
                and int(snap_count) == self.process_count
                and int(snap_index) != self.process_index):
            raise ValueError(
                f"data snapshot host mismatch: snapshot process_index="
                f"{int(snap_index)} loaded on process_index="
                f"{self.process_index} (process_count={self.process_count})")
        self.epoch = int(state.get("epoch", 0))
        self.shard_ptr = int(state.get("shard_ptr", 0))
        self.doc_ptr = int(state.get("doc_ptr", 0))
        self.emitted = int(state.get("emitted", 0))
        self.taken = int(state.get("taken", self.emitted))
        self._tables = [
            {"world": int(t["world"]),
             "positions": [int(p) for p in t["positions"]],
             "taken": int(t["taken"])}
            for t in (state.get("tables") or [])
        ]

    def _take_next(self) -> bool:
        """Advance the stream by one document ordinal; True when this host
        consumes it. Pure counter arithmetic — every host of the new world
        evaluates the exclusion tables identically, so the partition of
        surviving documents over hosts is deterministic and disjoint."""
        x = self.emitted
        consumed = False
        for t in self._tables:
            if consumed:
                break
            i = t["taken"] % t["world"]
            t["taken"] += 1
            if x < t["positions"][i]:
                consumed = True  # the old world already trained on doc x
        take = False
        if not consumed:
            take = self.taken % self.process_count == self.process_index
            self.taken += 1
        self.emitted += 1
        if self._tables and all(
                x >= max(t["positions"]) for t in self._tables):
            # Past every recorded position: no table can exclude again.
            self._tables = []
        return take

    def _shard_order(self, epoch: int) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch)).permutation(len(self.shards))

    def _doc_order(self, epoch: int, shard_ptr: int, n_docs: int) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch, shard_ptr)).permutation(n_docs)

    def __iter__(self) -> Iterator[str]:
        while True:
            shard_order = self._shard_order(self.epoch)
            while self.shard_ptr < len(self.shards):
                path = self.shards[int(shard_order[self.shard_ptr])]
                docs = load_shard_docs(path, self.text_key)
                order = self._doc_order(self.epoch, self.shard_ptr, len(docs))
                while self.doc_ptr < len(docs):
                    idx = int(order[self.doc_ptr])
                    take = self._take_next()
                    self.doc_ptr += 1
                    if take:
                        yield docs[idx]
                self.doc_ptr = 0
                self.shard_ptr += 1
            self.shard_ptr = 0
            self.epoch += 1
            if not self.repeat:
                return


def iter_hf_stream(
    dataset: str,
    name: Optional[str] = None,
    split: str = "train",
    text_key: str = "text",
    cache_dir: Optional[str] = None,
) -> Iterator[str]:
    """Stream documents from the HF hub with ``datasets`` streaming mode
    (reference: fineweb_stream_hf.py uses load_dataset(..., streaming=True)).
    Thin convenience wrapper over :class:`HFStreamSource` (which adds exact
    resume); kept for script use."""
    yield from HFStreamSource(dataset=dataset, name=name, split=split,
                              text_key=text_key, cache_dir=cache_dir)


class HFStreamSource:
    """Resumable HF-hub streaming source.

    The whole document pipeline is built inside ``datasets``-land — shuffle
    via ``ds.shuffle(buffer_size=...)``, multi-host sharding via
    ``datasets.distributed.split_dataset_by_node`` — so the library's
    native ``state_dict()`` / ``load_state_dict()`` (IterableDataset,
    datasets >= 2.18) captures the stream position (shard index + in-shard
    offset + shuffle RNG) and resume costs O(one shard), not O(consumed)
    skip-replay.

    Exactness: resume is **position-exact**. With ``shuffle_buffer <= 1``
    it is also bit-exact (batch N+1 after resume == without resume). With
    a shuffle buffer, the ``datasets`` state API does not persist buffer
    contents — on resume the buffer is refilled from the restored
    position, so up to ``shuffle_buffer`` in-flight documents are dropped
    (the library's documented semantics, and far stronger than the
    reference, which resumes only step count — core/training.py:1545-1564;
    its fineweb_stream_hf.py has no resume at all). Set
    ``streaming.shuffle_buffer: 0`` where bit-exact resume matters.

    When the underlying dataset predates the state API, ``state_dict()``
    returns None and the manager falls back to skip-replay.

    ``ds_factory`` injects the dataset object (tests use a mocked hub
    source; production defaults to ``load_dataset(..., streaming=True)``).
    """

    def __init__(
        self,
        dataset: str = "HuggingFaceFW/fineweb-edu",
        name: Optional[str] = None,
        split: str = "train",
        text_key: str = "text",
        cache_dir: Optional[str] = None,
        shuffle_buffer: int = 0,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        ds_factory: Optional[Any] = None,
    ):
        self.text_key = text_key
        if ds_factory is None:
            def ds_factory():
                try:
                    from datasets import load_dataset
                except Exception as exc:  # pragma: no cover - env dependent
                    raise RuntimeError(
                        "data.source='hf_stream' requires the `datasets` "
                        "package; use source='jsonl' with streaming.shards "
                        "for local files") from exc
                return load_dataset(dataset, name=name, split=split,
                                    streaming=True, cache_dir=cache_dir)

        ds = ds_factory()
        if shuffle_buffer and shuffle_buffer > 1:
            if hasattr(ds, "shuffle"):
                ds = ds.shuffle(seed=seed, buffer_size=shuffle_buffer)
            else:
                import logging

                logging.getLogger(__name__).warning(
                    "hf_stream: dataset object has no .shuffle; streaming "
                    "UNSHUFFLED (shuffle_buffer=%d requested)", shuffle_buffer)
        self._manual_shard = False
        if process_count > 1:
            try:
                from datasets.distributed import split_dataset_by_node

                ds = split_dataset_by_node(ds, rank=process_index,
                                           world_size=process_count)
            except Exception as exc:
                # Non-datasets object (mock) or old library: index-modulo
                # sharding outside the ds; exact resume is then unavailable
                # because the wrapper's enumerate restarts at 0. Say so —
                # silent degradation to O(consumed) skip-replay is the
                # failure mode this class exists to remove.
                import logging

                logging.getLogger(__name__).warning(
                    "hf_stream: split_dataset_by_node unavailable (%s); "
                    "using index-modulo host sharding — checkpoint resume "
                    "degrades to skip-replay", exc)
                self._manual_shard = True
        self.ds = ds
        self.process_index = process_index
        self.process_count = process_count

    @property
    def supports_exact_resume(self) -> bool:
        return (
            not self._manual_shard
            and hasattr(self.ds, "state_dict")
            and hasattr(self.ds, "load_state_dict")
        )

    def state_dict(self) -> Optional[Dict[str, Any]]:
        if not self.supports_exact_resume:
            return None
        return self.ds.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.ds.load_state_dict(state)

    def __iter__(self) -> Iterator[str]:
        it: Iterator[Any] = iter(self.ds)
        if self._manual_shard:
            it = sharded(it, self.process_index, self.process_count)
        for sample in it:
            text = sample.get(self.text_key) if isinstance(sample, dict) else None
            if text:
                yield text


def iter_synthetic(seed: int = 0, vocab: int = 1000) -> Iterator[str]:
    """Deterministic synthetic documents for tests and smoke runs."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    while True:
        n = int(rng.integers(8, 200))
        yield " ".join(words[int(i)] for i in rng.integers(0, vocab, n))


# ---------------------------------------------------------------------------
# Shuffle buffer (reference: fineweb_stream.py .shuffle(10_000))
# ---------------------------------------------------------------------------
def shuffled(it: Iterator[str], buffer_size: int, seed: int) -> Iterator[str]:
    if buffer_size <= 1:
        yield from it
        return
    rng = np.random.default_rng(seed)
    buf: List[str] = []
    for item in it:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        j = int(rng.integers(0, buffer_size))
        yield buf[j]
        buf[j] = item
    rng.shuffle(buf)
    yield from buf


def sharded(it: Iterator[Any], process_index: int, process_count: int) -> Iterator[Any]:
    """Every host keeps documents where ``i % process_count == process_index``."""
    if process_count <= 1:
        yield from it
        return
    for i, item in enumerate(it):
        if i % process_count == process_index:
            yield item


# ---------------------------------------------------------------------------
# Streaming manager
# ---------------------------------------------------------------------------
class StreamingDataManager:
    """Token-packing streaming loader with background prefetch.

    Serves the same batch dict as ``DataManager`` (inputs/targets/mask,
    all ``[B, L]`` static shapes) so the trainer is source-agnostic.

    Resume: local shard sources (JSONL / WebDataset tar) resume **exactly**
    — each served batch carries a snapshot of (source position, packer
    token buffer), so batch N+1 after resume equals batch N+1 without
    resume, at O(one shard) cost (SeekableShuffledSource). hf_stream
    resumes position-exactly via the datasets-native IterableDataset state
    API (HFStreamSource.state_dict — shard + offset + shuffle RNG, also
    O(one shard); bit-exact when shuffle_buffer <= 1, see HFStreamSource);
    only when that API is unavailable does it fall back to consumed-count
    skip-replay (the reference resumes only step count —
    core/training.py:1545-1564)."""

    # state_dict() tracks a stream position that advances with every served
    # batch (unlike the pure-function-of-step loaders). DevicePrefetcher
    # keys on this to snapshot per-fetch and report the CONSUMED position.
    stream_stateful = True

    def __init__(
        self,
        data_config: Any,
        tokenizer: Any,
        batch_size: int,
        seq_len: Optional[int] = None,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 4,
        base_dir: str = ".",
    ):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_len = seq_len or tokenizer.max_context_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.pad_id = tokenizer.pad_id
        self.prefetch = max(1, prefetch)
        self.base_dir = base_dir

        cfg = getattr(data_config, "streaming", {}) or {}
        self.source = getattr(data_config, "source", "jsonl")
        self.stream_cfg = cfg
        self.shuffle_buffer = int(cfg.get("shuffle_buffer", 2048))
        self.text_key = cfg.get("text_key", "text")
        self.docs_consumed = 0
        self._skip_docs = 0
        self._seekable: Optional[SeekableShuffledSource] = None
        self._hf_source: Optional[HFStreamSource] = None
        self._hf_resumed = False
        self._resume_state: Optional[Dict[str, Any]] = None
        self._last_snapshot: Optional[Dict[str, Any]] = None

        cache_dir = cfg.get("cache_dir")
        self.disk = (
            DiskSpaceManager(cache_dir, float(cfg.get("max_cache_gb", 10.0)))
            if cache_dir
            else None
        )

        self._queue: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=self.prefetch)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exhausted = False
        self.total_tokens_served = 0

    # -- source construction -------------------------------------------------
    def _expand_shards(self) -> List[str]:
        out: List[str] = []
        for p in self.stream_cfg.get("shards", []):
            full = p if os.path.isabs(p) else os.path.join(self.base_dir, p)
            if any(c in full for c in "*?["):
                out.extend(sorted(_glob.glob(full)))
            else:
                out.append(full)
        return out

    def _doc_stream(self) -> Iterator[str]:
        cfg = self.stream_cfg
        if self.source == "hf_stream":
            # Shuffle + host sharding live INSIDE the source so its
            # state_dict covers them (exact resume); no outer wrappers.
            self._hf_source = HFStreamSource(
                dataset=cfg.get("dataset", "HuggingFaceFW/fineweb-edu"),
                name=cfg.get("name"),
                split=cfg.get("split", "train"),
                text_key=self.text_key,
                cache_dir=cfg.get("cache_dir"),
                shuffle_buffer=self.shuffle_buffer,
                seed=self.seed,
                process_index=self.process_index,
                process_count=self.process_count,
                ds_factory=cfg.get("ds_factory"),
            )
            if (self._resume_state and "hf" in self._resume_state
                    and self._hf_source.supports_exact_resume):
                self._hf_source.load_state_dict(self._resume_state["hf"])
                self._hf_resumed = True
                self._skip_docs = 0
            return iter(self._hf_source)
        if self.source == "synthetic":
            docs = iter_synthetic(seed=self.seed)
        else:  # local shard files (JSONL or WebDataset tar): seekable path
            self._seekable = SeekableShuffledSource(
                self._expand_shards(), self.text_key, seed=self.seed,
                repeat=bool(cfg.get("repeat", True)),
                process_index=self.process_index, process_count=self.process_count,
            )
            if self._resume_state and "source" in self._resume_state:
                self._seekable.load_state_dict(self._resume_state["source"])
            return iter(self._seekable)
        docs = sharded(docs, self.process_index, self.process_count)
        return shuffled(docs, self.shuffle_buffer, self.seed + self.process_index)

    # -- producer ------------------------------------------------------------
    def _producer(self) -> None:
        row_len = self.seq_len + 1
        rows_needed = self.batch_size
        buf = np.zeros(0, np.int32)
        rows: List[np.ndarray] = []
        consumed_local = 0
        try:
            stream = self._doc_stream()  # sets self._seekable/_hf_source
            if self._resume_state is not None and (
                    (self._seekable is not None and "source" in self._resume_state)
                    or self._hf_resumed):
                # Guarded on the snapshot actually matching the source type:
                # an hf-state checkpoint resumed into a local-shard run (or
                # vice versa) must NOT splice a foreign token buffer onto a
                # from-scratch stream.
                # Exact resume: the source already seeked; restore the
                # partial token buffer captured with the last served batch,
                # so packing continues mid-stream bit-exactly.
                buf = np.asarray(self._resume_state.get("buf", []), np.int32)
                consumed_local = int(self._resume_state.get("docs_consumed", 0))
            for text in stream:
                if self._stop.is_set():
                    return
                consumed_local += 1
                if self._seekable is None and consumed_local <= self._skip_docs:
                    continue  # non-seekable source: skip-ahead replay
                ids = np.asarray(
                    self.tokenizer.tokenize_doc(text, max_length=10**9), np.int32
                )
                buf = np.concatenate([buf, ids])
                while len(buf) >= row_len:
                    rows.append(buf[:row_len])
                    buf = buf[row_len:]
                    if len(rows) == rows_needed:
                        batch_rows = np.stack(rows)
                        rows = []
                        inputs = batch_rows[:, :-1]
                        targets = batch_rows[:, 1:]
                        mask = (targets != self.pad_id).astype(np.float32)
                        self.docs_consumed = consumed_local
                        # rows is always [] here (just cleared); only the
                        # leftover token buffer is packer state. Keep it as
                        # an ndarray — state_dict converts for JSON.
                        snapshot = {
                            "docs_consumed": consumed_local,
                            "buf": buf,
                        }
                        if self._seekable is not None:
                            snapshot["source"] = self._seekable.state_dict()
                        elif self._hf_source is not None:
                            hf_state = self._hf_source.state_dict()
                            if hf_state is not None:
                                snapshot["hf"] = hf_state
                        item = (
                            {"inputs": inputs, "targets": targets, "mask": mask},
                            snapshot,
                        )
                        while not self._stop.is_set():
                            try:
                                self._queue.put(item, timeout=0.2)
                                break
                            except queue.Full:
                                continue
                        if self._stop.is_set():
                            return
                if self.disk is not None and consumed_local % 1000 == 0:
                    self.disk.ensure_space()
        except Exception as exc:  # noqa: BLE001 - surfaced to the consumer
            self._error = exc
        finally:
            self._exhausted = True
            # The end-of-stream sentinel must not be dropped: retry until the
            # consumer makes room (it drains one item per generate_batch) or
            # the manager is stopped.
            while not self._stop.is_set():
                try:
                    self._queue.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start(self) -> "StreamingDataManager":
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Drain so a blocked producer can observe the stop flag.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- consumer API (DataManager-compatible surface) -----------------------
    def generate_batch(self, step: int) -> Batch:  # step kept for API parity
        self.start()
        item = self._queue.get()
        if item is None:
            if self._error is not None:
                raise RuntimeError(f"streaming producer failed: {self._error}") from self._error
            raise StopIteration("stream exhausted")
        batch, snapshot = item
        self._last_snapshot = snapshot
        self.total_tokens_served += int(batch["inputs"].size)
        return batch

    def __iter__(self) -> Iterator[Batch]:
        while True:
            try:
                yield self.generate_batch(0)
            except StopIteration:
                return

    @property
    def has_validation_data(self) -> bool:
        return False

    def num_validation_batches(self, cap: int = 50) -> int:
        return 0

    # -- checkpoint state ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Snapshot of the state as of the last *served* batch (not the last
        produced one — prefetched batches in the queue don't count). The
        snapshot is stamped with the world it was taken under
        (``process_count``/``process_index``) so a resume under a different
        world is detected instead of silently double-consuming documents."""
        if self._last_snapshot is not None:
            out = dict(self._last_snapshot)
            if isinstance(out.get("buf"), np.ndarray):
                out["buf"] = out["buf"].tolist()
        else:
            out = {"docs_consumed": self.docs_consumed}
        out.setdefault("process_count", self.process_count)
        out.setdefault("process_index", self.process_index)
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        snap_count = state.get("process_count")
        if snap_count is not None and int(snap_count) != self.process_count:
            raise ValueError(
                f"data snapshot world mismatch: snapshot keys "
                f"process_count={int(snap_count)}/process_index="
                f"{state.get('process_index')} vs this manager's "
                f"process_count={self.process_count}/process_index="
                f"{self.process_index}; pass all hosts' snapshots through "
                f"data.streaming.remap_data_states first")
        if "source" in state or "hf" in state:
            self._resume_state = dict(state)
            # If the hf source turns out not to support the state API
            # (library downgrade between save and load), fall back to
            # skip-replay from the same snapshot.
            self._skip_docs = int(state.get("docs_consumed", 0)) if "hf" in state else 0
        else:
            self._skip_docs = int(state.get("docs_consumed", 0))


# -- elastic world remapping ----------------------------------------------


def _check_world_states(states: List[Dict[str, Any]], what: str,
                        count_key: str = "process_count",
                        index_key: str = "process_index") -> List[Dict[str, Any]]:
    """Validate that ``states`` is one complete world: every snapshot
    stamped, stamps agree, indices exactly 0..N-1. Returns them sorted by
    process index; raises ValueError naming the offending keys."""
    if not states:
        raise ValueError(f"remap needs at least one {what} snapshot")
    n = len(states)
    for s in states:
        if count_key not in s or index_key not in s:
            raise ValueError(
                f"{what} snapshot lacks '{count_key}'/'{index_key}' keys — "
                f"it predates world stamping and cannot be remapped safely")
        if int(s[count_key]) != n:
            raise ValueError(
                f"{what} snapshots disagree with the set size: "
                f"'{count_key}'={int(s[count_key])} but {n} snapshot(s) "
                f"were provided — pass every host's snapshot of ONE world")
    ordered = sorted(states, key=lambda s: int(s[index_key]))
    indices = [int(s[index_key]) for s in ordered]
    if indices != list(range(n)):
        raise ValueError(
            f"{what} snapshots are not one complete world: "
            f"'{index_key}' values {indices} != {list(range(n))}")
    return ordered


def remap_seekable_states(
    states: List[Dict[str, Any]], new_index: int, new_count: int,
) -> Dict[str, Any]:
    """Remap one complete old world's :class:`SeekableShuffledSource`
    snapshots (``process_count=N``) to the state for host ``new_index`` of
    a ``new_count=M`` world, with zero skipped and zero replayed
    documents.

    The new stream restarts at the *least advanced* old host's position;
    everything any old host consumed beyond that point is encoded as an
    exclusion table (see :class:`SeekableShuffledSource`) that the new
    world's take rule replays deterministically. Chained reshapes stay
    exact because the base host's own tables ride along.
    """
    ordered = _check_world_states(states, "SeekableShuffledSource")
    n = len(ordered)
    if not (0 <= int(new_index) < int(new_count)):
        raise ValueError(
            f"new_index {new_index} out of range for new_count {new_count}")
    if n == int(new_count):
        out = dict(ordered[int(new_index)])
        return out
    base = min(ordered, key=lambda s: int(s["emitted"]))
    positions = [int(s["emitted"]) for s in ordered]
    tables = [
        {"world": int(t["world"]),
         "positions": [int(p) for p in t["positions"]],
         "taken": int(t["taken"])}
        for t in (base.get("tables") or [])
    ]
    tables.append({
        "world": n,
        "positions": positions,
        "taken": int(base.get("taken", base["emitted"])),
    })
    return {
        "epoch": int(base.get("epoch", 0)),
        "shard_ptr": int(base.get("shard_ptr", 0)),
        "doc_ptr": int(base.get("doc_ptr", 0)),
        "emitted": int(base["emitted"]),
        "taken": 0,
        "tables": tables,
        "process_count": int(new_count),
        "process_index": int(new_index),
    }


def remap_data_states(
    states: List[Dict[str, Any]], new_index: int, new_count: int,
) -> Dict[str, Any]:
    """Remap one complete old world's :class:`StreamingDataManager`
    snapshots to host ``new_index`` of a ``new_count`` world.

    Only seekable-source snapshots (``"source"`` key) are remappable: the
    take rule is replayed via exclusion tables and the leftover token
    buffers are re-dealt round-robin (old host ``i``'s buffer goes to new
    host ``i % new_count`` — deterministic and disjoint; buffers hold
    token remainders of documents the old world already consumed, so no
    document is skipped or replayed). HF-streaming snapshots (``"hf"``)
    carry datasets-library-native state bound to the world that wrote
    them and are refused with a named-key error.
    """
    ordered = _check_world_states(states, "StreamingDataManager")
    n = len(ordered)
    if n == int(new_count):
        return dict(ordered[int(new_index)])
    for s in ordered:
        if "hf" in s:
            raise ValueError(
                f"cannot remap 'hf' data snapshot (process_index="
                f"{s.get('process_index')}) from process_count={n} to "
                f"{new_count}: datasets-native stream state is bound to "
                f"the world that wrote it; restart the stream or resume "
                f"with the original process count")
        if "source" not in s:
            raise ValueError(
                f"cannot remap data snapshot (process_index="
                f"{s.get('process_index')}) without a 'source' key from "
                f"process_count={n} to {new_count}: only seekable-source "
                f"snapshots support exact cross-world resume")
    source = remap_seekable_states(
        [s["source"] for s in ordered], new_index, new_count)
    buf: List[int] = []
    for i, s in enumerate(ordered):
        if i % int(new_count) == int(new_index):
            buf.extend(int(v) for v in (s.get("buf") or []))
    total_docs = sum(int(s.get("docs_consumed", 0)) for s in ordered)
    return {
        "docs_consumed": total_docs // int(new_count),
        "buf": buf,
        "source": source,
        "process_count": int(new_count),
        "process_index": int(new_index),
    }


def build_data_manager(
    config: Any,
    tokenizer: Any,
    batch_size: int,
    seq_len: Optional[int] = None,
    seed: int = 42,
    process_index: int = 0,
    process_count: int = 1,
    base_dir: str = ".",
):
    """Source dispatch: in-memory JSONL (default, reference DataManager
    semantics) vs streaming (reference fineweb_stream* semantics)."""
    from .memory import DataManager

    data_cfg = config.data if hasattr(config, "data") else config
    source = getattr(data_cfg, "source", "jsonl")
    streaming_cfg = getattr(data_cfg, "streaming", {}) or {}
    if source == "token_shards":
        from .token_shards import TokenShardDataManager

        shard_dir = getattr(data_cfg, "input_file", None) or streaming_cfg.get("shard_dir")
        if not shard_dir:
            raise ValueError(
                "data.source=token_shards requires data.input_file or "
                "data.streaming.shard_dir to point at the shard directory"
            )
        if not os.path.isabs(shard_dir):
            shard_dir = os.path.join(base_dir, shard_dir)
        val_fraction = float(streaming_cfg.get("val_fraction", 0.01))
        return TokenShardDataManager(
            shard_dir, batch_size, seq_len or data_cfg.max_context_size,
            seed=seed, process_index=process_index, process_count=process_count,
            val_fraction=val_fraction,
        )
    if source in ("hf_stream", "synthetic", "webdataset") or streaming_cfg.get("shards"):
        return StreamingDataManager(
            data_cfg, tokenizer, batch_size, seq_len=seq_len, seed=seed,
            process_index=process_index, process_count=process_count,
            base_dir=base_dir,
        )
    return DataManager(
        data_cfg, tokenizer, batch_size, seq_len=seq_len, seed=seed,
        process_index=process_index, process_count=process_count, base_dir=base_dir,
    )
