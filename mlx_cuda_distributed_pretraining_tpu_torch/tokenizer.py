"""Byte-level tokenizer and the run-directory tokenizer loader.

Ids ``0..normal_vocab_size-1`` are raw bytes and the special tokens follow
(pad, bos, eos by default: vocabulary 259). A run directory written by the
JAX trainer stores ``tokenizer/byte_tokenizer.json``; runs with an external
``tokenizer.json`` are not served by the port yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

_DEFAULT_SPECIAL = {"pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}


class ByteTokenizer:
    """Byte-level tokenizer: ids below ``normal_vocab_size`` are raw bytes,
    special tokens follow."""

    def __init__(self, normal_vocab_size: int = 256,
                 special_tokens: Optional[Dict[str, str]] = None):
        special_tokens = special_tokens or dict(_DEFAULT_SPECIAL)
        self.normal_vocab_size = normal_vocab_size
        self.special_token_names = dict(special_tokens)
        self.special_token_ids: Dict[str, int] = {
            key: normal_vocab_size + i for i, key in enumerate(special_tokens)}
        self.vocab_size = normal_vocab_size + len(special_tokens)

    @property
    def pad_id(self) -> int:
        return self.special_token_ids.get("pad", 0)

    @property
    def bos_id(self) -> int:
        return self.special_token_ids.get("bos", self.vocab_size - 2)

    @property
    def eos_id(self) -> int:
        return self.special_token_ids.get("eos", self.vocab_size - 1)

    def encode(self, text: str) -> List[int]:
        return [b for b in text.encode("utf-8") if b < self.normal_vocab_size]

    def decode(self, ids: List[int]) -> str:
        raw = bytes(i for i in ids if 0 <= i < self.normal_vocab_size)
        return raw.decode("utf-8", errors="replace")


class TokenizerManager:
    """The tokenizer a config or run directory names (byte-level only).
    With ``run_dir`` it records itself there as the JAX trainer does
    (``tokenizer/byte_tokenizer.json``)."""

    def __init__(self, data_config: Any = None, run_dir: Optional[str] = None):
        tok_cfg = dict(getattr(data_config, "tokenizer", None) or {})
        special = dict(tok_cfg.get("special_tokens") or _DEFAULT_SPECIAL)
        self.max_context_size = int(
            (getattr(data_config, "preprocessing", None) or {}).get(
                "max_context_size", 1024))
        tok_path = getattr(data_config, "tokenizer_path", None)
        if tok_path and (os.path.isfile(tok_path) or os.path.isfile(
                os.path.join(tok_path, "tokenizer.json"))):
            raise NotImplementedError(
                "external tokenizer.json files are not ported; the torch "
                "port runs the byte tokenizer")
        self.tokenizer = ByteTokenizer(
            int(tok_cfg.get("normal_vocab_size", 256)), special)
        if run_dir:
            self.save_to_run_dir(run_dir)

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    @property
    def pad_id(self) -> int:
        return self.tokenizer.pad_id

    @property
    def bos_id(self) -> int:
        return self.tokenizer.bos_id

    @property
    def eos_id(self) -> int:
        return self.tokenizer.eos_id

    def tokenize(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def detokenize(self, ids: List[int]) -> str:
        return self.tokenizer.decode(list(ids))

    def tokenize_doc(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """BOS + tokens + EOS, the tokens cut to ``max_length``."""
        max_length = self.max_context_size if max_length is None else max_length
        return [self.bos_id] + self.tokenize(text)[:max_length] + [self.eos_id]

    def save_to_run_dir(self, run_dir: str) -> None:
        tok_dir = os.path.join(run_dir, "tokenizer")
        os.makedirs(tok_dir, exist_ok=True)
        meta = {"type": "byte",
                "normal_vocab_size": self.tokenizer.normal_vocab_size,
                "special_tokens": self.tokenizer.special_token_names}
        with open(os.path.join(tok_dir, "byte_tokenizer.json"), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def from_run_dir(cls, run_dir: str) -> "TokenizerManager":
        """Rehydrate the byte tokenizer a run directory recorded."""
        from .config import DataConfig

        tok_dir = os.path.join(run_dir, "tokenizer")
        if os.path.isfile(os.path.join(tok_dir, "tokenizer.json")):
            raise NotImplementedError(
                f"{run_dir} uses an external tokenizer.json; the torch port "
                "serves byte-tokenizer runs only")
        byte_file = os.path.join(tok_dir, "byte_tokenizer.json")
        if not os.path.isfile(byte_file):
            return cls(DataConfig())
        with open(byte_file) as f:
            meta = json.load(f)
        return cls(DataConfig(tokenizer={
            "normal_vocab_size": meta.get("normal_vocab_size", 256),
            "special_tokens": meta.get("special_tokens"),
        }))
