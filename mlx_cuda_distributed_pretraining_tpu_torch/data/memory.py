"""In-memory JSONL data manager (the JAX package's ``data/memory.py``).

Loads JSONL ``{"text": ...}`` files, tokenizes each document (BOS/EOS
wrapped), chunks long documents at token level with ``chunk_overlap``, and
packs the stream into ``[N, L+1]`` rows; serves deterministic shuffled train
batches (a new permutation per epoch from ``np.random.default_rng(seed +
epoch)``) and sequential validation batches with a persistent ``val_ptr``.
Batches are numpy arrays; the trainer moves them to the device.

With the byte tokenizer the rows come from the C++ packer (``native/``),
which gives the Python tokenize -> chunk -> pack path's rows; where the
library cannot be built the Python path runs, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .packing import batch_views, chunk_tokens, pack_documents

Batch = Dict[str, np.ndarray]


def load_jsonl_texts(path: str) -> List[str]:
    texts: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and "text" in obj:
                texts.append(obj["text"])
            elif isinstance(obj, str):
                texts.append(obj)
    return texts


class DataManager:
    def __init__(self, data_config: Any, tokenizer: Any, batch_size: int,
                 seq_len: Optional[int] = None, seed: int = 42, base_dir: str = "."):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_len = seq_len or tokenizer.max_context_size
        self.seed = seed
        self.pad_id = tokenizer.pad_id
        self.chunk_overlap = getattr(data_config, "chunk_overlap", 0)
        self.val_ptr = 0
        val_file = getattr(data_config, "validation_file", None)
        self.train_rows = self._load_split(
            os.path.join(base_dir, data_config.input_file) if data_config.input_file else None)
        self.val_rows = self._load_split(os.path.join(base_dir, val_file) if val_file else None)
        if len(self.train_rows) == 0:
            raise ValueError("no training data: input_file missing or empty")

    def _load_split(self, path: Optional[str]) -> np.ndarray:
        if not path or not os.path.exists(path):
            return np.zeros((0, self.seq_len + 1), np.int32)
        texts = load_jsonl_texts(path)
        rows = self._native_pack(texts)
        if rows is not None:
            return rows
        docs: List[List[int]] = []
        for text in texts:
            ids = self.tokenizer.tokenize_doc(text, max_length=10**9)
            docs.extend(chunk_tokens(ids, self.seq_len + 1, self.chunk_overlap))
        return pack_documents(docs, self.seq_len, self.pad_id)

    def _native_pack(self, texts: List[str]) -> Optional[np.ndarray]:
        """The C++ packer's rows for a byte tokenizer (None for another
        tokenizer, or without the library)."""
        from .. import native
        from ..tokenizer import ByteTokenizer

        byte_tok = getattr(self.tokenizer, "tokenizer", None)
        if not isinstance(byte_tok, ByteTokenizer):
            return None
        return native.byte_pack_docs(
            texts, normal_vocab=byte_tok.normal_vocab_size, bos=byte_tok.bos_id,
            eos=byte_tok.eos_id, pad=byte_tok.pad_id, row_len=self.seq_len + 1,
            overlap=self.chunk_overlap)

    # -- batches ------------------------------------------------------------
    @property
    def batches_per_epoch(self) -> int:
        return max(1, len(self.train_rows) // self.batch_size)

    def generate_batch(self, step: int) -> Batch:
        """Deterministic batch for global step ``step``."""
        epoch = step // self.batches_per_epoch
        perm = np.random.default_rng(self.seed + epoch).permutation(len(self.train_rows))
        lo = (step % self.batches_per_epoch) * self.batch_size
        sel = perm[lo: lo + self.batch_size]
        if len(sel) < self.batch_size:  # wrap the tail
            sel = np.concatenate([sel, perm[: self.batch_size - len(sel)]])
        inputs, targets, mask = batch_views(self.train_rows[sel], self.pad_id)
        return {"inputs": inputs, "targets": targets, "mask": mask}

    @property
    def has_validation_data(self) -> bool:
        return len(self.val_rows) >= self.batch_size

    def generate_validation_batch(self, batch_idx: Optional[int] = None) -> Batch:
        if batch_idx is not None:
            self.val_ptr = batch_idx * self.batch_size
        if self.val_ptr + self.batch_size > len(self.val_rows):
            self.val_ptr = 0
        rows = self.val_rows[self.val_ptr: self.val_ptr + self.batch_size]
        self.val_ptr += self.batch_size
        inputs, targets, mask = batch_views(rows, self.pad_id)
        return {"inputs": inputs, "targets": targets, "mask": mask}

    def num_validation_batches(self, cap: int = 50) -> int:
        return min(cap, len(self.val_rows) // self.batch_size)

    def iter_validation(self, cap: int = 50) -> Iterator[Batch]:
        for i in range(self.num_validation_batches(cap)):
            yield self.generate_validation_batch(i)

    def state_dict(self) -> Dict[str, int]:
        """The loader position a checkpoint carries: the validation
        pointer (train batches are a function of the step)."""
        return {"val_ptr": self.val_ptr}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.val_ptr = int(state.get("val_ptr", 0))
