"""Pure-Python safetensors reader/writer over torch tensors.

Format: ``u64le header_len | header JSON | raw tensor bytes``; each header
entry maps name -> {dtype, shape, data_offsets}. bf16 and fp8 are carried
through torch's own dtypes (raw bits viewed as same-width integers), so no
``ml_dtypes`` is needed. Files written by the JAX package's
``checkpoint/safetensors_io.py`` load here unchanged.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .faults import commit_write

# safetensors dtype -> (torch dtype, numpy dtype of the same width the raw
# bytes are read as; torch views them as the real dtype)
_ST = {
    "F64": (torch.float64, np.float64),
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.int16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
    "F8_E4M3": (torch.float8_e4m3fn, np.uint8),
    "F8_E5M2": (torch.float8_e5m2, np.uint8),
}
_TORCH_TO_ST = {t: name for name, (t, _) in _ST.items()}
_RAW_VIEW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
             torch.float8_e5m2: torch.uint8}


def save_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> Tuple[int, int]:
    """Write ``tensors`` (flat dict) to ``path`` via temp file + rename
    (:func:`faults.commit_write`). Each tensor's bytes stream out from its
    host copy, and the returned ``(nbytes, crc32)`` is of the bytes as
    they went out: the step manifest records what the writer meant to put
    on disk, so a torn or dropped write fails verification."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        st = _TORCH_TO_ST.get(t.dtype)
        if st is None:
            raise ValueError(f"unsupported dtype {t.dtype} for tensor {name!r}")
        arr = t.view(_RAW_VIEW.get(t.dtype, t.dtype)).numpy()
        header[name] = {"dtype": st, "shape": list(t.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    header_bytes += b" " * ((8 - len(header_bytes) % 8) % 8)
    head = struct.pack("<Q", len(header_bytes)) + header_bytes
    crc = zlib.crc32(head)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head)
        for arr in arrays:
            data = memoryview(arr.reshape(-1)).cast("B")
            f.write(data)
            crc = zlib.crc32(data, crc)
    commit_write(tmp, path)
    return len(head) + offset, crc


def load_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Read ``path`` -> (flat dict of CPU tensors, metadata dict)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
        body = f.read()
    metadata = header.pop("__metadata__", {}) or {}
    tensors: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in _ST:
            raise ValueError(f"unsupported safetensors dtype {info['dtype']!r}")
        dtype, raw = _ST[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = np.frombuffer(body[begin:end], dtype=raw).reshape(info["shape"])
        tensors[name] = torch.from_numpy(arr.copy()).view(dtype)
    return tensors, metadata
