"""Pre-tokenized binary token shards: the writer and the memmap loader
(the JAX package's ``data/token_shards.py``).

Shards are flat token arrays memmapped from disk; every batch is a set of
fixed-length windows, so there is no tokenization at train time, and the
window order is a seeded permutation per epoch, so resume needs only the
step.

Shard format (byte for byte the JAX package's, so shards written by either
package train in the other): ``shard_NNNNN.bin`` (little-endian uint16 or
uint32 raw tokens) plus ``index.json``:
  {"dtype": "uint16", "shard_tokens": N, "total_tokens": M,
   "files": [...], "vocab_size": V, "eos_id": E}
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def write_token_shards(
    docs: Iterator[str],
    tokenizer: Any,
    out_dir: str,
    shard_tokens: int = 1 << 24,
    max_tokens: Optional[int] = None,
    append_eos: bool = True,
) -> Dict[str, Any]:
    """Tokenize a document stream into binary shards under ``out_dir``.

    Stops at ``max_tokens`` (the reference's fixed token budget). Returns
    the index dict (also written to ``out_dir/index.json``).
    """
    os.makedirs(out_dir, exist_ok=True)
    vocab = int(tokenizer.vocab_size)
    dtype = np.uint16 if vocab <= 0xFFFF else np.uint32
    eos = int(getattr(tokenizer, "eos_id", 0) or 0)

    files: List[str] = []
    total = 0
    buf: List[int] = []

    def flush():
        nonlocal buf, total
        if not buf:
            return
        name = f"shard_{len(files):05d}.bin"
        np.asarray(buf, dtype=dtype).tofile(os.path.join(out_dir, name))
        files.append(name)
        total += len(buf)
        buf = []

    for doc in docs:
        ids = tokenizer.tokenize(doc)
        if append_eos and eos:
            ids = list(ids) + [eos]
        buf.extend(int(i) for i in ids)
        while len(buf) >= shard_tokens:
            if max_tokens is not None and total + shard_tokens > max_tokens:
                break
            chunk, buf = buf[:shard_tokens], buf[shard_tokens:]
            name = f"shard_{len(files):05d}.bin"
            np.asarray(chunk, dtype=dtype).tofile(os.path.join(out_dir, name))
            files.append(name)
            total += shard_tokens
        if max_tokens is not None and total + len(buf) >= max_tokens:
            buf = buf[: max(0, max_tokens - total)]
            break
    flush()

    index = {
        "dtype": np.dtype(dtype).name,
        "shard_tokens": shard_tokens,
        "total_tokens": total,
        "files": files,
        "vocab_size": vocab,
        "eos_id": eos,
    }
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return index


class TokenShardDataManager:
    """Fixed-length window batches over memmapped token shards.

    Matches the DataManager protocol the Trainer consumes
    (``generate_batch(step)``, ``iter_validation``, ``state_dict``/
    ``load_state_dict``, ``has_validation_data``). Windows are seq_len+1
    tokens (inputs/targets shifted); window order is a seeded permutation,
    re-derivable from (seed, epoch) so resume is exact. Per-host sharding
    slices the permutation by ``process_index``.
    """

    def __init__(
        self,
        shard_dir: str,
        batch_size: int,
        seq_len: int,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        val_fraction: float = 0.01,
    ):
        with open(os.path.join(shard_dir, "index.json")) as f:
            self.index = json.load(f)
        dtype = np.dtype(self.index["dtype"])
        parts = [
            np.memmap(os.path.join(shard_dir, name), dtype=dtype, mode="r")
            for name in self.index["files"]
        ]
        if not parts:
            raise ValueError(f"no shards in {shard_dir}")
        self.tokens = parts[0] if len(parts) == 1 else np.concatenate(parts)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

        window = seq_len + 1
        n_windows = len(self.tokens) // window
        if n_windows < 2:
            raise ValueError(
                f"{len(self.tokens)} tokens < 2 windows of {window}; "
                "need more data or a shorter context"
            )
        n_val = max(1, int(n_windows * val_fraction))
        self.n_train = n_windows - n_val
        self.val_starts = np.arange(self.n_train, n_windows) * window
        self.per_host = max(1, batch_size // process_count)
        self.batches_per_epoch = max(1, self.n_train // max(batch_size, 1))

    def _window_starts(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n_train) * (self.seq_len + 1)

    def _batch_from_starts(self, starts: np.ndarray) -> Dict[str, np.ndarray]:
        window = self.seq_len + 1
        toks = np.stack([self.tokens[s : s + window] for s in starts]).astype(np.int32)
        return {
            "inputs": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((len(starts), self.seq_len), np.float32),
        }

    def generate_batch(self, step: int) -> Dict[str, np.ndarray]:
        epoch = step // self.batches_per_epoch
        i = step % self.batches_per_epoch
        starts = self._window_starts(epoch)
        base = i * self.batch_size
        mine = starts[base + self.process_index * self.per_host :
                      base + (self.process_index + 1) * self.per_host]
        if len(mine) < self.per_host:  # tail: wrap deterministically
            mine = np.concatenate([mine, starts[: self.per_host - len(mine)]])
        return self._batch_from_starts(mine)

    @property
    def has_validation_data(self) -> bool:
        return len(self.val_starts) > 0

    def iter_validation(self, cap: int = 50):
        for i in range(0, min(len(self.val_starts), cap * self.per_host), self.per_host):
            chunk = self.val_starts[i : i + self.per_host]
            b = self._batch_from_starts(chunk)
            if len(chunk) < self.per_host:
                # Pad the tail chunk to the fixed batch shape with
                # zero-masked rows (exact: eval counts tokens via mask).
                # Dropping it instead made validation silently empty when
                # the val split was smaller than one batch.
                pad = self.per_host - len(chunk)
                b = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                     for k, v in b.items()}
            yield b

    def state_dict(self) -> Dict[str, Any]:
        return {"val_ptr": 0}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        pass  # order is re-derived from (seed, step); nothing to restore
