"""Run-directory checkpoints in the JAX package's ``runs/`` layout::

    runs/<name>/
        log.txt
        config.yaml
        metadata.json          # ledger of checkpoints
        tokenizer/
        checkpoints/
            step_<N>_model.safetensors
            step_<N>_optimizer.safetensors
            step_<N>_state.json
            step_<N>.manifest.json        # integrity manifest, written last

A step exists once its manifest does: the manifest lists each artifact with
its byte size and CRC32, and :meth:`CheckpointManager.verify` re-reads and
checks them (the JAX ``load_trained`` serves only verified steps). The
optimizer file holds the optimizer state's tensors under their flattened
names; its non-tensor leaves ride in the safetensors metadata as JSON.

Saves here block until written. Async writes, retention GC, quarantine,
the ledger rebuild and resume are not ported.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils.tree import flatten_dict
from .safetensors_io import save_safetensors

MANIFEST_VERSION = 1


def _crc32_file(path: str, chunk_size: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _atomic_json(path: str, obj: Any) -> Tuple[int, int]:
    """Temp file + rename; returns ``(nbytes, crc32)`` of what was written."""
    data = json.dumps(obj, indent=2).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return len(data), zlib.crc32(data)


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.checkpoint_dir = os.path.join(run_dir, "checkpoints")

    @staticmethod
    def setup_run_directory(runs_root: str, name: str, overwrite: bool = False) -> str:
        run_dir = os.path.join(runs_root, name)
        if os.path.exists(run_dir):
            if not overwrite:
                raise ValueError(
                    f"Run directory {run_dir!r} already exists; set overwrite: true "
                    "or choose a unique run name")
            shutil.rmtree(run_dir)
        os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
        return run_dir

    def paths_for_step(self, step) -> Tuple[str, str, str]:
        base = os.path.join(self.checkpoint_dir, f"step_{step}")
        return (f"{base}_model.safetensors", f"{base}_optimizer.safetensors",
                f"{base}_state.json")

    def manifest_path(self, step) -> str:
        return os.path.join(self.checkpoint_dir, f"step_{step}.manifest.json")

    def save(self, step, params: Any, opt_state: Optional[Any] = None,
             training_state: Optional[Dict[str, Any]] = None,
             metadata_extra: Optional[Dict[str, Any]] = None) -> Dict[str, str]:
        """Write the step's model / optimizer / state files, then its
        manifest, then append it to ``metadata.json``."""
        model_path, opt_path, state_path = self.paths_for_step(step)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        written: List[str] = [model_path]
        save_safetensors(model_path, flatten_dict(params), metadata={"format": "pt"})
        if opt_state is not None:
            flat = flatten_dict(opt_state)
            tensors = {k: v for k, v in flat.items() if isinstance(v, torch.Tensor)}
            scalars = {k: v for k, v in flat.items() if not isinstance(v, torch.Tensor)}
            save_safetensors(opt_path, tensors,
                             metadata={"scalars": json.dumps(scalars)})
            written.append(opt_path)
        training_state = dict(training_state or {})
        training_state.setdefault("step", int(step) if str(step).isdigit() else step)
        _atomic_json(state_path, training_state)
        written.append(state_path)
        _atomic_json(self.manifest_path(step), {
            "format_version": MANIFEST_VERSION,
            "step": int(step) if str(step).isdigit() else step,
            "written_at": time.time(),
            "artifacts": {os.path.basename(p): {"bytes": os.path.getsize(p),
                                                "crc32": _crc32_file(p)}
                          for p in sorted(written)},
        })
        entry = {"step": step, "path": model_path, "timestamp": time.time()}
        entry.update(metadata_extra or {})
        ledger = self._load_ledger()
        entries = ledger.setdefault("checkpoints", [])
        entries[:] = [e for e in entries if str(e.get("step")) != str(step)]
        entries.append(entry)
        _atomic_json(os.path.join(self.run_dir, "metadata.json"), ledger)
        return {"model": model_path, "optimizer": opt_path, "state": state_path}

    def _load_ledger(self) -> Dict[str, Any]:
        path = os.path.join(self.run_dir, "metadata.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def update_ledger(self, **fields: Any) -> None:
        """Merge top-level fields into ``metadata.json``."""
        ledger = self._load_ledger()
        ledger.update(fields)
        _atomic_json(os.path.join(self.run_dir, "metadata.json"), ledger)

    def verify(self, step) -> Tuple[bool, str]:
        """Re-read every artifact the step's manifest lists and check its
        size and CRC32. Returns ``(ok, reason)``."""
        mpath = self.manifest_path(step)
        if not os.path.isfile(mpath):
            return False, "no manifest"
        try:
            with open(mpath) as f:
                artifacts = json.load(f)["artifacts"]
            if not isinstance(artifacts, dict) or not artifacts:
                raise ValueError("empty artifacts table")
        except (json.JSONDecodeError, OSError, KeyError, ValueError, TypeError) as e:
            return False, f"torn manifest ({type(e).__name__}: {e})"
        for name, info in artifacts.items():
            path = os.path.join(self.checkpoint_dir, name)
            if not os.path.isfile(path):
                return False, f"missing artifact {name}"
            if os.path.getsize(path) != int(info["bytes"]):
                return False, f"size mismatch for {name}"
            if _crc32_file(path) != int(info["crc32"]):
                return False, f"crc32 mismatch for {name}"
        return True, "ok"
