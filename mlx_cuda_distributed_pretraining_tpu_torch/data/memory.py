"""In-memory JSONL data manager (the JAX package's ``data/memory.py``).

Loads JSONL ``{"text": ...}`` files, tokenizes each document (BOS/EOS
wrapped), chunks long documents at token level with ``chunk_overlap``, and
packs the stream into ``[N, L+1]`` rows; serves deterministic shuffled train
batches (a new permutation per epoch from ``np.random.default_rng(seed +
epoch)``) and sequential validation batches with a persistent ``val_ptr``.
Batches are numpy arrays; the trainer moves them to the device.

The Python tokenize -> chunk -> pack path only: the JAX package's C++ packer
(``native/``) gives the same rows and is not ported.
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
                 seq_len: Optional[int] = None, seed: int = 42):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_len = seq_len or tokenizer.max_context_size
        self.seed = seed
        self.pad_id = tokenizer.pad_id
        self.chunk_overlap = getattr(data_config, "chunk_overlap", 0)
        self.val_ptr = 0
        self.train_rows = self._load_split(data_config.input_file)
        self.val_rows = self._load_split(getattr(data_config, "validation_file", None))
        if len(self.train_rows) == 0:
            raise ValueError("no training data: input_file missing or empty")

    def _load_split(self, path: Optional[str]) -> np.ndarray:
        if not path or not os.path.exists(path):
            return np.zeros((0, self.seq_len + 1), np.int32)
        docs: List[List[int]] = []
        for text in load_jsonl_texts(path):
            ids = self.tokenizer.tokenize_doc(text, max_length=10**9)
            docs.extend(chunk_tokens(ids, self.seq_len + 1, self.chunk_overlap))
        return pack_documents(docs, self.seq_len, self.pad_id)

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
