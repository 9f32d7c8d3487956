"""The port's C++ dataplane (``native/``) against the JAX package's and the
Python tokenize -> chunk -> pack path, on the CPU.

The port builds its own copy of ``dataplane.cpp`` into the git-ignored
``build/native/`` (never beside the source); its rows must equal the JAX
package's native rows and the Python path's, with and without overlap,
with a byte vocabulary below 256 and with truncation. The in-memory loader
takes the fast path and gives JAX's rows.
"""

import json
import os

import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu import native as jnative
from mlx_cuda_distributed_pretraining_tpu.config import DataConfig as JDataConfig
from mlx_cuda_distributed_pretraining_tpu.data.memory import DataManager as JData
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch import native
from mlx_cuda_distributed_pretraining_tpu_torch.config import DataConfig as TDataConfig
from mlx_cuda_distributed_pretraining_tpu_torch.data.memory import DataManager as TData
from mlx_cuda_distributed_pretraining_tpu_torch.data.packing import (
    chunk_tokens,
    pack_documents,
)
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import ByteTokenizer
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager as TTok


@pytest.fixture
def built():
    if not native.available():  # the container has g++: a failed build is a fault
        pytest.fail(f"the port's dataplane did not build: {native.build_error()}")


def _texts(seed=0, n=40):
    rng = np.random.default_rng(seed)
    pieces = ["hello", "world", "café", "☃", "naïve", "x" * 90, "", "été 🎉"]
    return [" ".join(rng.choice(pieces, size=int(rng.integers(0, 30))))
            for _ in range(n)] + ["", "a" * 500]


def _python_rows(texts, tok, row_len, overlap=0, max_doc_tokens=10**9):
    docs = []
    for t in texts:
        ids = [tok.bos_id] + tok.encode(t)[:max_doc_tokens] + [tok.eos_id]
        docs.extend(chunk_tokens(ids, row_len, overlap))
    return pack_documents(docs, row_len - 1, tok.pad_id)


@pytest.mark.parametrize("max_doc_tokens", [10**9, 50])
@pytest.mark.parametrize("normal_vocab", [256, 128])
@pytest.mark.parametrize("overlap", [0, 3, 31])
def test_byte_pack_docs_equals_jax_native_and_python(built, overlap, normal_vocab,
                                                     max_doc_tokens):
    tok = ByteTokenizer(normal_vocab_size=normal_vocab)
    texts, row_len = _texts(), 33
    kw = dict(normal_vocab=normal_vocab, bos=tok.bos_id, eos=tok.eos_id, pad=tok.pad_id,
              row_len=row_len, overlap=overlap, max_doc_tokens=max_doc_tokens)
    got = native.byte_pack_docs(texts, **kw)
    assert got.dtype == np.int32 and got.shape[1] == row_len
    np.testing.assert_array_equal(got, _python_rows(texts, tok, row_len, overlap,
                                                    max_doc_tokens))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.byte_pack_docs(texts, **kw))


def test_byte_pack_docs_of_nothing(built):
    tok = ByteTokenizer()
    got = native.byte_pack_docs([], normal_vocab=256, bos=tok.bos_id, eos=tok.eos_id,
                                pad=tok.pad_id, row_len=17)
    assert got.shape == (0, 17)


def test_library_builds_into_build_native_under_a_source_hash(built):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("libdataplane-") and path.suffix == ".so"
    assert sorted(p.name for p in native.SRC.parent.iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "dataplane.cpp"]


def test_a_failed_build_is_reported_and_the_rows_are_none(tmp_path, monkeypatch):
    broken = tmp_path / "dataplane.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    assert "g++ failed" in native.build_error()
    assert native.byte_pack_docs(["x"], 256, 257, 258, 256, 9) is None
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("overlap", [0, 5])
def test_data_manager_rows_take_the_native_path_and_equal_jax(built, tmp_path, monkeypatch,
                                                              overlap):
    path = tmp_path / "train.jsonl"
    path.write_text("".join(json.dumps({"text": t}) + "\n" for t in _texts(1, 60)))
    data = dict(input_file=str(path),
                preprocessing={"max_context_size": 48, "chunk_overlap": overlap})
    jmgr = JData(JDataConfig(**data), JTok(JDataConfig(**data)), batch_size=2, seq_len=48)
    calls = []
    real = native.byte_pack_docs
    monkeypatch.setattr(native, "byte_pack_docs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tmgr = TData(TDataConfig(**data), TTok(TDataConfig(**data)), batch_size=2, seq_len=48)
    assert calls  # the fast path ran
    np.testing.assert_array_equal(tmgr.train_rows, jmgr.train_rows)
    # without the library the Python path gives the same rows
    monkeypatch.setattr(native, "byte_pack_docs", lambda *a, **k: None)
    slow = TData(TDataConfig(**data), TTok(TDataConfig(**data)), batch_size=2, seq_len=48)
    np.testing.assert_array_equal(slow.train_rows, tmgr.train_rows)
    for step in (0, 3, 40):
        for k, v in jmgr.generate_batch(step).items():
            np.testing.assert_array_equal(tmgr.generate_batch(step)[k], v)


def test_data_manager_with_an_hf_tokenizer_takes_the_python_path(tmp_path, monkeypatch):
    from test_torch_tokenizer import train_tokenizer

    tok_dir = train_tokenizer(tmp_path / "tok")
    path = tmp_path / "train.jsonl"
    path.write_text("".join(json.dumps({"text": t}) + "\n" for t in _texts(2, 20)))
    data = dict(input_file=str(path), tokenizer_path=str(tok_dir),
                preprocessing={"max_context_size": 24})
    monkeypatch.setattr(native, "byte_pack_docs", lambda *a, **k: pytest.fail("native"))
    tmgr = TData(TDataConfig(**data), TTok(TDataConfig(**data)), batch_size=2, seq_len=24)
    jmgr = JData(JDataConfig(**data), JTok(JDataConfig(**data)), batch_size=2, seq_len=24)
    np.testing.assert_array_equal(tmgr.train_rows, jmgr.train_rows)
    assert os.path.isfile(str(tok_dir / "tokenizer.json"))
