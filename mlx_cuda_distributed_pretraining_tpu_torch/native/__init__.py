"""ctypes bindings for the native C++ data-plane (``dataplane.cpp``).

The library is compiled on first use with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``build/native/`` at the repository root (git-ignored), under
a name that carries a hash of the source: an edited source rebuilds, an
unchanged one is reused, and nothing is written beside the source. The
compiler's output is kept beside the library as ``.log``.

:func:`available` says whether the library built and loaded;
:func:`byte_pack_docs` returns None when it did not (the in-memory loader
then takes the Python path, as the JAX package's does), and
:func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "dataplane.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdataplane-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
        capture_output=True, text=True, timeout=120)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = str(exc)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.byte_pack_count.argtypes = [u8p, i64p, i64, i32, i64, i64, i64]
        lib.byte_pack_count.restype = i64
        lib.byte_pack_fill.argtypes = [u8p, i64p, i64, i32, i64, i64, i64,
                                       i32, i32, i32, i32p, i64]
        lib.byte_pack_fill.restype = i64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the
    first attempt)."""
    return _error


def byte_pack_docs(
    texts: List[str],
    normal_vocab: int,
    bos: int,
    eos: int,
    pad: int,
    row_len: int,
    overlap: int = 0,
    max_doc_tokens: int = 10**9,
) -> Optional[np.ndarray]:
    """Byte-tokenize, chunk and pack documents into ``[N, row_len]`` int32
    rows: the rows of the Python tokenize -> chunk -> pack path. None when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    blobs = [t.encode("utf-8") for t in texts]
    data = b"".join(blobs)
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(0, np.uint8)
    buf = np.ascontiguousarray(buf)

    u8p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    offp = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    n_tokens = lib.byte_pack_count(
        u8p, offp, len(blobs), normal_vocab, max_doc_tokens, row_len, overlap)
    n_rows = (n_tokens + row_len - 1) // row_len
    out = np.empty(max(n_rows, 0) * row_len, np.int32)
    written = lib.byte_pack_fill(
        u8p, offp, len(blobs), normal_vocab, max_doc_tokens, row_len, overlap,
        bos, eos, pad,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
    if written < 0:
        raise RuntimeError("byte_pack_fill overran the count byte_pack_count gave")
    return out[:written].reshape(-1, row_len)
