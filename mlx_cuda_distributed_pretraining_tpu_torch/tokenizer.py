"""The byte-level tokenizer, the HuggingFace ``tokenizer.json`` wrapper,
and the run-directory tokenizer loader.

Byte-level: ids ``0..normal_vocab_size-1`` are raw bytes and the special
tokens follow (pad, bos, eos by default: vocabulary 259). With
``data.tokenizer_path`` naming a ``tokenizer.json`` (or a directory holding
one) the run uses it through the ``tokenizers`` package, imported only when
such a file is loaded. A run directory stores the tokenizer as the JAX
trainer does: ``tokenizer/tokenizer.json`` (a copy of the external file) or
``tokenizer/byte_tokenizer.json``, so a run written by either package loads
in the other.
"""

from __future__ import annotations

import json
import os
import shutil
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


class HFTokenizer:
    """A HuggingFace ``tokenizers`` ``tokenizer.json``; the special tokens
    are looked up by their text, and those the vocabulary lacks keep the
    defaults pad 0, bos 1, eos 2."""

    def __init__(self, tokenizer_file: str,
                 special_tokens: Optional[Dict[str, str]] = None):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(tokenizer_file)
        self.tokenizer_file = tokenizer_file
        self.vocab_size = self._tok.get_vocab_size()
        special_tokens = special_tokens or dict(_DEFAULT_SPECIAL)
        self.special_token_names = dict(special_tokens)
        self.special_token_ids: Dict[str, int] = {}
        for key, text in special_tokens.items():
            tid = self._tok.token_to_id(text)
            if tid is not None:
                self.special_token_ids[key] = tid

    @property
    def pad_id(self) -> int:
        return self.special_token_ids.get("pad", 0)

    @property
    def bos_id(self) -> int:
        return self.special_token_ids.get("bos", 1)

    @property
    def eos_id(self) -> int:
        return self.special_token_ids.get("eos", 2)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: List[int]) -> str:
        special = set(self.special_token_ids.values())
        return self._tok.decode([i for i in ids if i not in special],
                                skip_special_tokens=True)


class TokenizerManager:
    """The tokenizer a config or run directory names: the external
    ``tokenizer.json`` under ``data.tokenizer_path`` when there is one,
    else the byte tokenizer. With ``run_dir`` it records itself there as
    the JAX trainer does."""

    def __init__(self, data_config: Any = None, run_dir: Optional[str] = None):
        tok_cfg = dict(getattr(data_config, "tokenizer", None) or {})
        special = dict(tok_cfg.get("special_tokens") or _DEFAULT_SPECIAL)
        self.max_context_size = int(
            (getattr(data_config, "preprocessing", None) or {}).get(
                "max_context_size", 1024))
        self.external_path: Optional[str] = None
        tok_path = getattr(data_config, "tokenizer_path", None)
        if tok_path:
            candidate = os.path.join(tok_path, "tokenizer.json")
            if os.path.isfile(candidate):
                self.external_path = candidate
            elif os.path.isfile(tok_path):
                self.external_path = tok_path
        if self.external_path:
            self.tokenizer: Any = HFTokenizer(self.external_path, special)
        else:
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
        if self.external_path:
            shutil.copy(self.external_path, os.path.join(tok_dir, "tokenizer.json"))
            return
        meta = {"type": "byte",
                "normal_vocab_size": self.tokenizer.normal_vocab_size,
                "special_tokens": self.tokenizer.special_token_names}
        with open(os.path.join(tok_dir, "byte_tokenizer.json"), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def from_run_dir(cls, run_dir: str) -> "TokenizerManager":
        """Rehydrate the tokenizer a run directory recorded."""
        from .config import DataConfig

        tok_dir = os.path.join(run_dir, "tokenizer")
        if os.path.isfile(os.path.join(tok_dir, "tokenizer.json")):
            return cls(DataConfig(tokenizer_path=tok_dir))
        byte_file = os.path.join(tok_dir, "byte_tokenizer.json")
        if not os.path.isfile(byte_file):
            return cls(DataConfig())
        with open(byte_file) as f:
            meta = json.load(f)
        return cls(DataConfig(tokenizer={
            "normal_vocab_size": meta.get("normal_vocab_size", 256),
            "special_tokens": meta.get("special_tokens"),
        }))
