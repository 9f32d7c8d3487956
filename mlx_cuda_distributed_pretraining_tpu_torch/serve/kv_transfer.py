"""KV-block transfer between serving replicas: the JAX package's
``serve/kv_transfer.py`` payload and its GKV1 wire format, byte for byte,
so a payload exported by either package adopts in the other.

Blocks are addressed by the prefix cache's content-hash chain keys
(``prefix_cache.chain_keys``), so a block the receiver already holds is
skipped and a shared prefix crosses at most once.

Wire format (``GKV1``, little-endian)::

    b"GKV1" | u32 header_len | header JSON | block bytes...

The JSON header carries ``block_size``, ``quantized``, the covered
``token_ids``, the hex chain ``keys`` and the per-layer tensor layout
``{name: {shape, dtype}}`` (the fp ``k``/``v`` pair or the int8
``k_q``/``k_s``/``v_q``/``v_s`` quartet; the receiver's arena must match
exactly). Block bytes follow in chain order, per block per layer per
sorted tensor name, C-contiguous raw buffers. The receiver recomputes the
chain keys from ``token_ids`` and refuses a payload whose keys disagree.

``push_payload`` POSTs a payload to a decode replica's ``/adopt_kv``
through the serving plane's call policy (``serve/policy.py``), with the
``kv_transfer.corrupt`` and ``kv_transfer.drop`` fault points
(``serve/faults.py``). A payload exported by a port engine knows the
``params_version`` of the weights that computed it; the push sends it as
``X-Params-Version`` (outside the GKV1 bytes, which JAX fixes), and a
receiver on other weights adopts nothing. Arena bookkeeping is
``kv_pool.PagedKVPool.export_blocks`` / ``adopt_blocks``, and the engine
thread's part ``BatchEngine.export_kv`` / ``adopt_kv``.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs.trace import TRACE_HEADER
from . import faults
from .policy import CallPolicy, Deadline
from .prefix_cache import chain_keys

__all__ = ["KVTransferPayload", "build_payload", "push_payload"]

MAGIC = b"GKV1"
# the sender's weights version, beside the payload (JAX sends no such header,
# and a receiver without one adopts as JAX's does)
PARAMS_VERSION_HEADER = "X-Params-Version"


@dataclass
class KVTransferPayload:
    """One request's exportable KV blocks, in chain order."""

    token_ids: List[int]           # exactly the tokens the blocks cover
    block_size: int
    quantized: bool
    keys: List[bytes]              # chain keys, one per block
    # blocks[i][layer] = {tensor name: ndarray[block_size, Hkv, Dh or 1]}
    blocks: List[List[Dict[str, np.ndarray]]] = field(repr=False,
                                                      default_factory=list)
    # the exporting engine's params_version; not part of the GKV1 bytes
    params_version: Optional[int] = field(default=None, compare=False)

    @property
    def num_blocks(self) -> int:
        return len(self.keys)

    def nbytes(self) -> int:
        return sum(arr.nbytes for blk in self.blocks
                   for layer in blk for arr in layer.values())

    def verify_keys(self) -> None:
        """Recompute the chain from ``token_ids`` and compare: the receiver's
        integrity gate."""
        want = chain_keys(self.token_ids[:self.num_blocks * self.block_size],
                          self.block_size)
        if list(self.keys) != want:
            raise ValueError(
                "KV transfer keys do not match the chain recomputed from "
                "token_ids (corrupt or misaddressed payload)")

    def to_bytes(self) -> bytes:
        if self.blocks and len(self.blocks) != len(self.keys):
            raise ValueError(f"{len(self.keys)} keys but "
                             f"{len(self.blocks)} blocks")
        layers = []
        if self.blocks:
            layers = [{name: {"shape": list(arr.shape),
                              "dtype": np.dtype(arr.dtype).name}
                       for name, arr in layer.items()}
                      for layer in self.blocks[0]]
        header = json.dumps({
            "block_size": self.block_size,
            "quantized": bool(self.quantized),
            "token_ids": [int(t) for t in self.token_ids],
            "keys": [k.hex() for k in self.keys],
            "layers": layers,
        }).encode()
        parts = [MAGIC, struct.pack("<I", len(header)), header]
        for blk in self.blocks:
            for layer in blk:
                for name in sorted(layer):
                    parts.append(np.ascontiguousarray(layer[name]).tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVTransferPayload":
        if data[:4] != MAGIC:
            raise ValueError(f"bad KV transfer magic {data[:4]!r}")
        (hlen,) = struct.unpack_from("<I", data, 4)
        header = json.loads(data[8:8 + hlen].decode())
        keys = [bytes.fromhex(k) for k in header["keys"]]
        layers = header["layers"]
        blocks: List[List[Dict[str, np.ndarray]]] = []
        off = 8 + hlen
        for _ in keys:
            blk = []
            for layer in layers:
                tensors = {}
                for name in sorted(layer):
                    shape = tuple(layer[name]["shape"])
                    dtype = np.dtype(layer[name]["dtype"])
                    n = int(np.prod(shape)) * dtype.itemsize
                    tensors[name] = np.frombuffer(
                        data[off:off + n], dtype=dtype).reshape(shape)
                    off += n
                blk.append(tensors)
            blocks.append(blk)
        if off != len(data):
            raise ValueError(f"KV transfer payload has {len(data) - off} "
                             "trailing bytes")
        out = cls(token_ids=[int(t) for t in header["token_ids"]],
                  block_size=int(header["block_size"]),
                  quantized=bool(header["quantized"]),
                  keys=keys, blocks=blocks)
        out.verify_keys()
        return out


def build_payload(export, token_ids: Sequence[int], block_size: int,
                  quantized: bool,
                  params_version: Optional[int] = None) -> KVTransferPayload:
    """Materialize a ``kv_pool.KVExport`` as a wire payload: one gather and
    one copy to the host per layer tensor. The export's blocks are pinned
    and full, so no step writes them while this reads."""
    covered = len(export.keys) * block_size
    blocks: List[List[Dict[str, np.ndarray]]] = [[] for _ in export.blocks]
    if export.blocks:
        idx = torch.tensor(export.blocks, dtype=torch.long)
        for layer in export.cache:
            fetched = {name: arr[idx.to(arr.device)].cpu().numpy()
                       for name, arr in layer.items()}
            for i in range(len(export.blocks)):
                blocks[i].append({name: fetched[name][i] for name in fetched})
    return KVTransferPayload(
        token_ids=[int(t) for t in token_ids[:covered]],
        block_size=block_size, quantized=quantized,
        keys=list(export.keys), blocks=blocks, params_version=params_version)


def _corrupt(data: bytes) -> bytes:
    """Same-length corruption for the ``kv_transfer.corrupt`` fault: flip the
    first hex digit of the first chain key inside the JSON header, so the
    receiver's ``verify_keys`` refuses it (the block offsets stay valid;
    only the advertised address lies). With no key (an empty chain) the
    magic is clobbered instead; either way the receiver must refuse."""
    marker = b'"keys": ["'
    i = data.find(marker)
    if i < 0:
        return b"GKV0" + data[4:]
    j = i + len(marker)
    flipped = b"1" if data[j:j + 1] == b"0" else b"0"
    return data[:j] + flipped + data[j + 1:]


# Pushes made outside a service (tests, tools) share this policy; a serving
# process passes its own, so a replica's breaker and budget are the same
# for its pushes as for its other outbound calls.
_default_policy = CallPolicy()


def push_payload(url: str, payload: KVTransferPayload,
                 timeout: float = 30.0,
                 trace_id: Optional[str] = None,
                 deadline: Optional[Deadline] = None,
                 policy: Optional[CallPolicy] = None) -> Dict[str, int]:
    """POST a payload to a decode replica's ``/adopt_kv``; returns its
    adopt stats (``{"adopted": n, "reused": n, "skipped": n}``).

    The socket timeout is clamped to the request's remaining deadline, and
    a connection-level failure gets at most one budgeted replay: the
    receiver dedups by chain key, so a replay is safe, and on a final
    failure the caller falls back to local prefill."""
    data = payload.to_bytes()
    if faults.take("kv_transfer.corrupt", url) is not None:
        data = _corrupt(data)
    if faults.take("kv_transfer.drop", url) is not None:
        # lost in flight but reported sent: the decode side misses its
        # cache and prefills locally, so the tokens are the same
        return {"adopted": 0, "reused": 0, "skipped": 0}
    headers = {"Content-Type": "application/octet-stream"}
    if trace_id:
        headers[TRACE_HEADER] = trace_id
    if payload.params_version is not None:
        headers[PARAMS_VERSION_HEADER] = str(payload.params_version)
    pol = policy if policy is not None else _default_policy
    body = pol.call(url.rstrip("/") + "/adopt_kv", data=data,
                    headers=headers, timeout=timeout, deadline=deadline,
                    method="POST", max_attempts=2,
                    backoff_key=trace_id or url)
    return json.loads(body.decode())
