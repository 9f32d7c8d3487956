"""Fixed-shape sequence packing (the JAX package's ``data/packing.py``).

Every batch is a static ``[B, L+1]`` int32 array:

- ``pack_documents``: concatenates tokenized docs (already BOS/EOS wrapped)
  into a stream and cuts it into ``L+1``-token rows;
- ``pad_documents``: one doc per row, right-padded with ``pad_id``.

Rows yield ``inputs = row[:-1]``, ``targets = row[1:]`` and a loss mask that
zeroes pad targets.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np


def pack_documents(
    docs: Iterable[List[int]], seq_len: int, pad_id: int, drop_remainder: bool = False
) -> np.ndarray:
    """Concatenate token lists and reshape into ``[N, seq_len + 1]`` rows."""
    row = seq_len + 1
    stream = np.concatenate([np.asarray(d, dtype=np.int32) for d in docs]) if docs else np.zeros(0, np.int32)
    n_full = len(stream) // row
    tail = len(stream) - n_full * row
    if tail and not drop_remainder:
        pad = np.full(row - tail, pad_id, dtype=np.int32)
        stream = np.concatenate([stream, pad])
        n_full += 1
    else:
        stream = stream[: n_full * row]
    return stream.reshape(n_full, row) if n_full else np.zeros((0, row), np.int32)


def pad_documents(docs: Iterable[List[int]], seq_len: int, pad_id: int) -> np.ndarray:
    """One document per fixed-length row, truncated/padded to ``seq_len+1``."""
    row = seq_len + 1
    out = []
    for d in docs:
        a = np.asarray(d[:row], dtype=np.int32)
        if len(a) < row:
            a = np.concatenate([a, np.full(row - len(a), pad_id, np.int32)])
        out.append(a)
    return np.stack(out) if out else np.zeros((0, row), np.int32)


def chunk_tokens(tokens: List[int], max_len: int, overlap: int = 0) -> List[List[int]]:
    """Split a long token list into ``max_len``-sized chunks with ``overlap``
    tokens of context carried between chunks (reference:
    core/training.py:479-492 does this at the character level; token level is
    strictly better behaved)."""
    if len(tokens) <= max_len:
        return [tokens]
    step = max(1, max_len - overlap)
    return [tokens[i : i + max_len] for i in range(0, len(tokens) - overlap, step)]


def batch_views(rows: np.ndarray, pad_id: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``rows [B, L+1]`` → (inputs [B,L], targets [B,L], loss_mask [B,L] f32)."""
    inputs = rows[:, :-1]
    targets = rows[:, 1:]
    mask = (targets != pad_id).astype(np.float32)
    return inputs, targets, mask
