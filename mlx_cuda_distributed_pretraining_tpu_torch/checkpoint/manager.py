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
            step_<N>_data_p<P>.json       # per-host data-loader position
            step_<N>.manifest.json        # integrity manifest, written last
            quarantine/                   # artifacts that failed verify

The optimizer file holds the optimizer state's tensors under their
flattened names; its non-tensor leaves ride in the safetensors metadata as
JSON. Files written by either package load in the other.

Crash consistency, as in the JAX manager: a step exists once its manifest
does. The manifest is written after every other artifact of the step and
lists each with its byte size and CRC32 (of the bytes the writer streamed
out). :meth:`CheckpointManager.latest_complete_step` walks the manifested
steps newest first, re-reads and checksums each, quarantines one that
fails and falls back to the next older one; steps from before manifests
load as a last resort. Every artifact reaches its final name through
:func:`faults.commit_write`, where tests plant ENOSPC, truncation, dropped
writes and blocked writes.

``save(blocking=False)`` hands the disk write to one background thread.
The port's optimizers update parameters and moments in place, so ``save``
first copies every tensor to host memory (pinned, for a device tensor)
and waits for the copies before it returns: the writer never sees a later
step's values. At most two snapshots are alive: one being written, one
queued; a third ``save`` blocks until the writer takes one.

``load_params(..., weight_dtype="int8"|"int4")`` quantizes the linear
weights as they load (``models/quantize.py``; the fp file stays canonical).

With a ``metrics`` registry (``obs/metrics.py``) the manager counts its
write requests by mode, its manifest verifications by outcome and its
quarantined steps, as the JAX manager does.

Under a mesh the files stay the one-device layout (the trainer's chief
writes the full state, gathered from every rank's blocks), so a step
written at any world size, or by the JAX package, loads on any mesh: each
rank reads the full tensors and keeps its blocks (:func:`shard_arrays`).
JAX's ``load_params_stacked`` has no counterpart: the port never stacks
its layers.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..utils.tree import flatten_dict, tree_map, unflatten_dict
from .faults import commit_write
from .safetensors_io import load_safetensors, save_safetensors

MANIFEST_VERSION = 1


def to_host_tree(tree: Any) -> Any:
    """A snapshot of ``tree`` on the host: every tensor leaf copied (a
    device tensor into pinned memory), other leaves kept. Returns once the
    copies are complete, so the caller may update the tensors in place."""
    devices = set()

    def to_host(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type == "cpu":
            return x.clone()
        devices.add(x.device)
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x, non_blocking=True)

    out = tree_map(to_host, tree)
    for device in devices:
        torch.cuda.synchronize(device)
    return out


class StaleBackgroundWriteError(RuntimeError):
    """An EARLIER async checkpoint write failed; the blocking write that
    surfaced this error DID land on disk. Callers on exit paths (final /
    preemption saves) can catch exactly this and proceed."""


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint failed manifest verification (or an expected artifact
    is missing/unreadable) and the caller asked for strict handling."""


def _atomic_json(path: str, obj: Any) -> Tuple[int, int]:
    """Temp file + rename (:func:`faults.commit_write`); returns ``(nbytes,
    crc32)`` of what was written."""
    data = json.dumps(obj, indent=2).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    commit_write(tmp, path)
    return len(data), zlib.crc32(data)


def _crc32_file(path: str, chunk_size: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _step_sort_key(tag: str) -> Tuple[int, int]:
    """Newest first: "final" outranks any numeric step, numeric steps
    descend, unknown tags come last."""
    if tag == "final":
        return (0, 0)
    if str(tag).isdigit():
        return (1, -int(tag))
    return (2, 0)


def _tag_value(step):
    return int(step) if str(step).isdigit() else step


class CheckpointManager:
    def __init__(self, run_dir: str, keep_last: int = 0, keep_every: int = 0,
                 notify: Optional[Callable[[str], None]] = None,
                 metrics: Any = None):
        self.run_dir = run_dir
        self.checkpoint_dir = os.path.join(run_dir, "checkpoints")
        # Retention: keep_last=0 disables GC; keep_every=M always keeps
        # steps divisible by M. "final" and protected steps (the in-flight
        # write, the resume source) are never deleted.
        self.keep_last = int(keep_last or 0)
        self.keep_every = int(keep_every or 0)
        self.protect_steps: Set[str] = set()
        # Integrity events (quarantine, ledger rebuild, GC) go to the run
        # log when the trainer sets this, else to stderr.
        self.notify = notify
        # Optional obs.MetricsRegistry: integrity outcomes as counters.
        self._m_writes = self._m_verify = self._m_quarantined = None
        if metrics is not None:
            self._m_writes = metrics.counter(
                "checkpoint_writes_total", "checkpoint write requests by mode")
            self._m_verify = metrics.counter(
                "checkpoint_verify_total", "manifest verifications by outcome")
            self._m_quarantined = metrics.counter(
                "checkpoint_quarantined_total", "steps moved to quarantine/")
        self._writer: Optional[threading.Thread] = None
        self._queue: Optional[queue.Queue] = None
        self._write_error: Optional[Exception] = None
        # metadata.json is read-modify-written by the writer thread (ledger
        # append) and the trainer (summary fields): one lock for both.
        self._meta_lock = threading.Lock()

    def _notify(self, msg: str) -> None:
        if self.notify is not None:
            self.notify(msg)
        else:
            print(f"checkpoint: {msg}", file=sys.stderr)

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

    # -- paths --------------------------------------------------------------
    def paths_for_step(self, step) -> Tuple[str, str, str]:
        base = os.path.join(self.checkpoint_dir, f"step_{step}")
        return (f"{base}_model.safetensors", f"{base}_optimizer.safetensors",
                f"{base}_state.json")

    def manifest_path(self, step) -> str:
        return os.path.join(self.checkpoint_dir, f"step_{step}.manifest.json")

    def _sidecar_paths(self, step) -> List[str]:
        return sorted(glob.glob(
            os.path.join(self.checkpoint_dir, f"step_{step}_data_p*.json")))

    # -- save ---------------------------------------------------------------
    def save(self, step, params: Any, opt_state: Optional[Any] = None,
             training_state: Optional[Dict[str, Any]] = None,
             metadata_extra: Optional[Dict[str, Any]] = None,
             blocking: bool = True) -> Dict[str, str]:
        """Write the step's model / optimizer / state files, then its
        manifest, then its ledger entry, then run retention GC.
        ``blocking=False`` queues the disk write for the background thread
        and returns once the host copies exist. Writes are FIFO; a failed
        background write raises on the next ``save`` or ``wait``."""
        model_path, opt_path, state_path = self.paths_for_step(step)
        flat_params = flatten_dict(to_host_tree(params))
        arrays = scalars = None
        if opt_state is not None:
            flat_opt = flatten_dict(to_host_tree(opt_state))
            arrays = {k: v for k, v in flat_opt.items() if isinstance(v, torch.Tensor)}
            scalars = {k: v for k, v in flat_opt.items() if not isinstance(v, torch.Tensor)}
        training_state = dict(training_state or {})
        training_state.setdefault("step", _tag_value(step))
        payload = (step, model_path, opt_path, state_path, flat_params,
                   arrays, scalars, training_state, metadata_extra)
        if self._m_writes is not None:
            self._m_writes.inc(mode="blocking" if blocking else "async")
        if blocking:
            # Drain the queue first (FIFO), but write this step even when an
            # earlier background write failed: a blocking save is usually
            # the final or preemption checkpoint. Then surface the failure.
            if self._queue is not None:
                self._queue.join()
            try:
                self._raise_pending()
            except RuntimeError as earlier:
                self._write(payload)
                raise StaleBackgroundWriteError(
                    f"checkpoint for step {step} was written, but an earlier "
                    f"background write had failed: {earlier}") from earlier
            self._write(payload)
        else:
            if self._writer is None:
                # maxsize=1: the writer holds one payload and one waits in
                # the queue; a third put() blocks (the memory bound).
                self._queue = queue.Queue(maxsize=1)
                self._writer = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer", daemon=True)
                self._writer.start()
            self._raise_pending()
            self._queue.put(payload)
        return {"model": model_path, "optimizer": opt_path, "state": state_path}

    def _write(self, payload) -> None:
        (step, model_path, opt_path, state_path, flat_params,
         arrays, scalars, training_state, metadata_extra) = payload
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        artifacts: Dict[str, Tuple[int, int]] = {}
        artifacts[os.path.basename(model_path)] = save_safetensors(
            model_path, flat_params, metadata={"format": "pt"})
        if arrays is not None:
            artifacts[os.path.basename(opt_path)] = save_safetensors(
                opt_path, arrays, metadata={"scalars": json.dumps(scalars)})
        artifacts[os.path.basename(state_path)] = _atomic_json(state_path, training_state)
        for sc in self._sidecar_paths(step):
            artifacts[os.path.basename(sc)] = (os.path.getsize(sc), _crc32_file(sc))
        _atomic_json(self.manifest_path(step), {
            "format_version": MANIFEST_VERSION,
            "step": _tag_value(step),
            "written_at": time.time(),
            "artifacts": {name: {"bytes": int(n), "crc32": int(crc)}
                          for name, (n, crc) in sorted(artifacts.items())},
        })
        self._append_metadata(step, model_path, metadata_extra)
        try:
            self.gc_checkpoints(in_flight=step)
        except OSError as e:
            # Retention is best effort: it must not fail the save that landed.
            self._notify(f"WARNING: checkpoint GC failed: {e}")

    def _writer_loop(self) -> None:
        while True:
            payload = self._queue.get()
            try:
                self._write(payload)
            except Exception as e:  # noqa: BLE001 - surfaced on the next save/wait
                with self._meta_lock:
                    self._write_error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        with self._meta_lock:
            err, self._write_error = self._write_error, None
        if err is not None:
            raise RuntimeError(f"background checkpoint write failed: {err}") from err

    def wait(self) -> None:
        """Drain pending background writes; re-raise any write failure."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    # -- the ledger ---------------------------------------------------------
    def _load_ledger(self) -> Dict[str, Any]:
        meta_path = os.path.join(self.run_dir, "metadata.json")
        if not os.path.exists(meta_path):
            return {}
        try:
            with open(meta_path) as f:
                return json.load(f)
        except json.JSONDecodeError:
            # Keep the bad bytes for forensics and rebuild the checkpoint
            # list from the directory, so the next append resets nothing.
            corrupt = meta_path + ".corrupt"
            try:
                os.replace(meta_path, corrupt)
                self._notify(f"WARNING: metadata.json is corrupt; preserved as "
                             f"{corrupt} and rebuilding the ledger from a "
                             f"checkpoint-dir scan")
            except OSError:
                pass
            return self._rebuild_ledger()
        except OSError:
            return {}

    def _rebuild_ledger(self) -> Dict[str, Any]:
        """The checkpoint list from a scan of the checkpoint directory,
        oldest first; timestamps from the manifests, else file mtimes."""
        entries: List[Dict[str, Any]] = []
        if os.path.isdir(self.checkpoint_dir):
            tags = [f[len("step_"):-len("_model.safetensors")]
                    for f in os.listdir(self.checkpoint_dir)
                    if f.startswith("step_") and f.endswith("_model.safetensors")]
            for tag in sorted(tags, key=_step_sort_key, reverse=True):
                model_path = self.paths_for_step(tag)[0]
                ts = os.path.getmtime(model_path)
                try:
                    with open(self.manifest_path(tag)) as f:
                        ts = float(json.load(f).get("written_at", ts))
                except (OSError, json.JSONDecodeError, TypeError, ValueError):
                    pass
                entries.append({"step": _tag_value(tag), "path": model_path,
                                "timestamp": ts, "rebuilt": True})
        return {"checkpoints": entries, "ledger_rebuilt_at": time.time()} if entries else {}

    def _append_metadata(self, step, model_path: str,
                         extra: Optional[Dict[str, Any]]) -> None:
        with self._meta_lock:
            ledger = self._load_ledger()
            entries = ledger.setdefault("checkpoints", [])
            entries[:] = [e for e in entries if str(e.get("step")) != str(step)]
            entry = {"step": step, "path": model_path, "timestamp": time.time()}
            entry.update(extra or {})
            entries.append(entry)
            _atomic_json(os.path.join(self.run_dir, "metadata.json"), ledger)

    def update_ledger(self, **fields: Any) -> None:
        """Merge top-level fields into ``metadata.json`` (under the lock
        the writer's appends take)."""
        with self._meta_lock:
            ledger = self._load_ledger()
            ledger.update(fields)
            _atomic_json(os.path.join(self.run_dir, "metadata.json"), ledger)

    # -- load ---------------------------------------------------------------
    def load(self, step, like_params: Optional[Any] = None,
             like_opt_state: Optional[Any] = None, strict: bool = False,
             with_params: bool = True) -> Tuple[Any, Optional[Any], Dict[str, Any]]:
        """``(params, opt_state, training_state)`` of a step, tensors on the
        CPU, shaped and typed like ``like_params`` / ``like_opt_state``.
        When optimizer state is expected but the file is missing,
        unreadable or short of leaves, this warns and returns
        ``opt_state=None`` (or fills the missing leaves from ``like``);
        ``strict`` raises :class:`CheckpointIntegrityError` instead."""
        model_path, opt_path, state_path = self.paths_for_step(step)
        params = self.load_params(model_path, like=like_params) if with_params else None
        opt_state = None
        if like_opt_state is not None:
            flat = None
            if not os.path.exists(opt_path):
                msg = (f"checkpoint step {step}: expected optimizer file "
                       f"{opt_path} is MISSING — resuming would silently "
                       f"reset the optimizer")
                if strict:
                    raise CheckpointIntegrityError(msg)
                self._notify(f"WARNING: {msg}; continuing with a fresh "
                             f"optimizer (resume.strict: true to fail instead)")
            else:
                try:
                    arrays, meta = load_safetensors(opt_path)
                    flat = dict(arrays)
                    flat.update(json.loads(meta.get("scalars", "{}")))
                except Exception as e:  # noqa: BLE001 - any torn or garbled file
                    msg = (f"checkpoint step {step}: optimizer file "
                           f"{opt_path} is UNREADABLE ({type(e).__name__}: {e})")
                    if strict:
                        raise CheckpointIntegrityError(msg) from e
                    self._notify(f"WARNING: {msg}; continuing with a fresh "
                                 f"optimizer (resume.strict: true to fail instead)")
            if flat is not None:
                like_flat = flatten_dict(like_opt_state)
                rebuilt, missing = {}, []
                for k, ref in like_flat.items():
                    if k not in flat:
                        missing.append(k)
                        rebuilt[k] = ref
                        continue
                    v = flat[k]
                    if isinstance(ref, torch.Tensor) and isinstance(v, torch.Tensor):
                        rebuilt[k] = v.to(ref.dtype).reshape(ref.shape)
                    elif ref is None or v is None or isinstance(v, torch.Tensor):
                        rebuilt[k] = v
                    else:
                        rebuilt[k] = type(ref)(v)
                if missing:
                    msg = (f"checkpoint step {step}: optimizer file lacks "
                           f"{len(missing)}/{len(like_flat)} expected leaves "
                           f"(e.g. {missing[0]!r}) — those keep fresh values")
                    if strict:
                        raise CheckpointIntegrityError(msg)
                    self._notify(f"WARNING: {msg}")
                opt_state = _restructure_like(like_opt_state, unflatten_dict(rebuilt))
        training_state: Dict[str, Any] = {}
        if os.path.exists(state_path):
            with open(state_path) as f:
                training_state = json.load(f)
        return params, opt_state, training_state

    @staticmethod
    def load_params(model_path: str, like: Optional[Any] = None,
                    weight_dtype: str = "fp", mesh: Optional[Any] = None) -> Any:
        """A model file as nested CPU tensors. With ``like``: shaped and typed
        like it, keys the file lacks keep ``like``'s value, extra keys are
        dropped.

        With a ``mesh`` this is reshard-on-load: the file holds the full
        arrays (whatever mesh wrote it) and each rank keeps its blocks under
        ``parallel/sharding_rules.param_pspec`` (``like`` then holds the
        blocks). A quantized load quantizes only the rank's own slice, on
        the whole tensor's per-channel scales (:func:`shard_flat`).

        ``weight_dtype`` "int8"/"int4" quantizes the linear weights at the
        load (:func:`_quantize_flat`). An fp ``like`` is then quantized too,
        so the merge sees the quantized leaf names; with no ``weight_dtype``
        a quantized ``like`` (a hot swap into an int8/int4 engine) names the
        dtype."""
        from ..models.quantize import (check_weight_dtype, quantize_weights,
                                       weight_dtype_of)

        wd = check_weight_dtype(weight_dtype)
        if wd == "fp" and like is not None:
            wd = weight_dtype_of(like)
        elif wd != "fp" and isinstance(like, dict) and "layers" in like \
                and weight_dtype_of(like) == "fp":
            like = quantize_weights(like, wd)
        arrays, _ = load_safetensors(model_path)
        if mesh is not None:
            arrays = shard_flat(arrays, mesh, wd)
        elif wd != "fp":
            arrays = _quantize_flat(arrays, wd)
        if like is None:
            return unflatten_dict(arrays)
        out = {}
        for k, ref in flatten_dict(like).items():
            if k in arrays:
                v = arrays[k]
                if mesh is not None and (v.dtype != ref.dtype
                                         or tuple(v.shape) != tuple(ref.shape)):
                    raise CheckpointIntegrityError(
                        f"reshard-on-load: {k} is {v.dtype}{tuple(v.shape)} on disk "
                        f"but {ref.dtype}{tuple(ref.shape)} in the model; a cast or "
                        "reshape would re-materialize the full array on one host")
                out[k] = v.to(ref.dtype).reshape(ref.shape)
            else:
                out[k] = ref
        return _restructure_like(like, unflatten_dict(out))

    def data_sidecar_states(self, step) -> Dict[int, Dict[str, Any]]:
        """The per-host data-loader sidecars of a step, by the process index
        that wrote them."""
        out: Dict[int, Dict[str, Any]] = {}
        for path in self._sidecar_paths(step):
            m = re.search(r"_data_p(\d+)\.json$", path)
            if not m:
                continue
            try:
                with open(path, "r", encoding="utf-8") as f:
                    obj = json.load(f)
            except (OSError, json.JSONDecodeError, ValueError) as e:
                self._notify(f"WARNING: unreadable data sidecar {path} "
                             f"({type(e).__name__}: {e}); skipping it")
                continue
            if isinstance(obj, dict):
                out[int(m.group(1))] = obj
        return out

    def latest_step(self) -> Optional[str]:
        """Highest numeric step with a model file, or "final" if present
        (unverified)."""
        tags = self._model_tags()
        if "final" in tags:
            return "final"
        steps = [int(t) for t in tags if t.isdigit()]
        return str(max(steps)) if steps else None

    def _model_tags(self) -> List[str]:
        if not os.path.isdir(self.checkpoint_dir):
            return []
        return [f[len("step_"):-len("_model.safetensors")]
                for f in os.listdir(self.checkpoint_dir)
                if f.startswith("step_") and f.endswith("_model.safetensors")]

    # -- integrity: manifests, verification, quarantine, retention ----------
    def manifested_steps(self) -> List[str]:
        """Tags with a manifest file, newest first."""
        if not os.path.isdir(self.checkpoint_dir):
            return []
        tags = [f[len("step_"):-len(".manifest.json")]
                for f in os.listdir(self.checkpoint_dir)
                if f.startswith("step_") and f.endswith(".manifest.json")]
        return sorted(tags, key=_step_sort_key)

    def verify(self, step) -> Tuple[bool, str]:
        """Re-read every artifact the step's manifest lists and check its
        existence, size and CRC32. Returns ``(ok, reason)``."""
        ok, reason = self._verify_inner(step)
        if self._m_verify is not None:
            self._m_verify.inc(ok=str(ok).lower())
        return ok, reason

    def _verify_inner(self, step) -> Tuple[bool, str]:
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
            try:
                want_bytes, want_crc = int(info["bytes"]), int(info["crc32"])
            except (KeyError, TypeError, ValueError):
                return False, f"torn manifest entry for {name}"
            if os.path.getsize(path) != want_bytes:
                return False, (f"size mismatch for {name} "
                               f"({os.path.getsize(path)} != {want_bytes})")
            if _crc32_file(path) != want_crc:
                return False, f"crc32 mismatch for {name}"
        return True, "ok"

    def quarantine_step(self, step, reason: str) -> List[str]:
        """Move every file of a corrupt step into ``checkpoints/quarantine/``
        with a reason note: it can never shadow a good checkpoint, and
        stays for forensics."""
        qdir = os.path.join(self.checkpoint_dir, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        victims = glob.glob(os.path.join(self.checkpoint_dir, f"step_{step}_*"))
        if os.path.isfile(self.manifest_path(step)):
            victims.append(self.manifest_path(step))
        moved = []
        for path in victims:
            try:
                os.replace(path, os.path.join(qdir, os.path.basename(path)))
                moved.append(os.path.basename(path))
            except OSError:
                pass  # partly quarantined is still out of the resume path
        with open(os.path.join(qdir, f"step_{step}.reason.txt"), "a") as f:
            f.write(f"{time.time():.0f} {reason}; moved: {', '.join(moved) or 'nothing'}\n")
        self._notify(f"WARNING: quarantined checkpoint step {step} ({reason}) -> {qdir}")
        if self._m_quarantined is not None:
            self._m_quarantined.inc()
        return moved

    def latest_complete_step(self, quarantine: bool = True) -> Optional[str]:
        """Newest tag that passes manifest verification. A candidate that
        fails is quarantined (``quarantine=False``: skipped and left in
        place, the read-only scan of serving) and the next older one is
        tried. When no manifested step verifies, the newest step without a
        manifest is returned, with a warning (runs from before manifests,
        and mixed-era runs)."""
        candidates = self.manifested_steps()
        failed: Set[str] = set()
        for tag in candidates:
            ok, reason = self.verify(tag)
            if ok:
                return tag
            failed.add(str(tag))
            if quarantine:
                self.quarantine_step(tag, reason)
            else:
                self._notify(f"skipping checkpoint step {tag} ({reason}); "
                             f"read-only scan, not quarantining")
        legacy = self._latest_unmanifested(exclude=failed)
        if legacy is not None:
            if candidates:
                self._notify(f"every manifested checkpoint failed verification; "
                             f"resuming unverified pre-manifest step {legacy}")
            else:
                self._notify(f"checkpoints in {self.checkpoint_dir} predate integrity "
                             f"manifests; resuming unverified step {legacy}")
        return legacy

    def _latest_unmanifested(self, exclude: Set[str] = frozenset()) -> Optional[str]:
        """Newest tag with a model file, skipping ``exclude`` (steps whose
        manifest failed in this scan: under a read-only scan their files
        are still there, and are never a fallback)."""
        tags = sorted((t for t in self._model_tags() if t not in exclude),
                      key=_step_sort_key)
        return tags[0] if tags else None

    def gc_checkpoints(self, in_flight=None) -> List[str]:
        """Retention GC, after each manifest write: delete the oldest
        manifested numeric steps beyond ``keep_last``, except steps divisible
        by ``keep_every``, ``protect_steps``, the in-flight step and
        "final". Artifacts go first and the manifest last, so a crash
        mid-delete leaves a step that fails verification."""
        if self.keep_last <= 0:
            return []
        numeric = sorted(int(t) for t in self.manifested_steps() if str(t).isdigit())
        keep = set(numeric[-self.keep_last:])
        if self.keep_every > 0:
            keep.update(s for s in numeric if s % self.keep_every == 0)
        protected = {str(s) for s in self.protect_steps}
        if in_flight is not None:
            protected.add(str(in_flight))
        removed = []
        for s in numeric:
            if s in keep or str(s) in protected:
                continue
            for path in glob.glob(os.path.join(self.checkpoint_dir, f"step_{s}_*")):
                os.unlink(path)
            if os.path.isfile(self.manifest_path(s)):
                os.unlink(self.manifest_path(s))
            removed.append(str(s))
        if removed:
            self._prune_ledger(removed)
            self._notify(f"retention GC removed step(s) {', '.join(removed)} "
                         f"(keep_last={self.keep_last}, keep_every={self.keep_every})")
        return removed

    def _prune_ledger(self, steps: List[str]) -> None:
        """Drop GC'd steps from the ledger: an entry whose files are gone
        would read as a phantom checkpoint."""
        gone = {str(s) for s in steps}
        with self._meta_lock:
            ledger = self._load_ledger()
            entries = ledger.get("checkpoints") or []
            kept = [e for e in entries if str(e.get("step")) not in gone]
            if len(kept) != len(entries):
                ledger["checkpoints"] = kept
                _atomic_json(os.path.join(self.run_dir, "metadata.json"), ledger)


def latest_model_path(run_dir: str) -> Optional[str]:
    """The newest verified model file under ``run_dir`` (a read-only scan:
    a trainer on the same run is left alone). A fleet's rolling weight swap
    resolves a run directory through this, so a torn newest checkpoint
    costs the swap one interval instead of failing it."""
    mgr = CheckpointManager(run_dir)
    step = mgr.latest_complete_step(quarantine=False)
    if step is None:
        return None
    return mgr.paths_for_step(step)[0]


def shard_arrays(tree: Any, specs: Any, mesh) -> Any:
    """This rank's blocks of a full tensor tree (new tensors), by the spec
    tree of ``parallel/sharding_rules.py`` (``state_sharding``); other
    leaves pass through. The loader of a checkpoint onto any mesh."""
    from ..parallel.collectives import shard_of, spec_axes

    def cut(x, spec):
        if isinstance(x, torch.Tensor) and not x.is_meta and spec_axes(spec):
            return shard_of(x, spec, mesh).clone()
        return x

    if isinstance(tree, dict):
        return {k: shard_arrays(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_arrays(v, specs[i], mesh) for i, v in enumerate(tree)]
    return cut(tree, specs)


def shard_flat(arrays: Dict[str, torch.Tensor], mesh,
               weight_dtype: str = "fp") -> Dict[str, torch.Tensor]:
    """This rank's blocks of a flat ``{dotted.path: full tensor}`` dict by
    ``param_pspec`` (JAX's ``CheckpointManager.shard_arrays``). Under
    "int8"/"int4" each quantizable key becomes its quantized keys: the
    per-channel scales are computed on the whole tensor, and only this
    rank's slice is quantized."""
    from ..models.quantize import (channel_scales, check_weight_dtype,
                                   quantize_slice_np, quantized_key_shapes)
    from ..parallel.collectives import block_index
    from ..parallel.sharding_rules import param_pspec

    wd = check_weight_dtype(weight_dtype)
    out: Dict[str, torch.Tensor] = {}
    for k, v in arrays.items():
        qk = quantized_key_shapes(k, tuple(v.shape), wd) if wd != "fp" else None
        if not qk:
            idx = block_index(param_pspec(k, tuple(v.shape), mesh), v.shape, mesh)
            out[k] = v[idx].clone()
            continue
        arr = v.float().numpy()
        scales = channel_scales(arr, 8 if wd == "int8" else 4)
        for qkey, qshape in qk.items():
            idx = block_index(param_pspec(qkey, qshape, mesh), qshape, mesh)
            leaf = (scales[idx] if qkey.endswith(".weight_s")
                    else quantize_slice_np(arr, scales, idx, wd))
            out[qkey] = torch.from_numpy(np.ascontiguousarray(leaf))
    return out


def _quantize_flat(arrays: Dict[str, torch.Tensor],
                   weight_dtype: str) -> Dict[str, torch.Tensor]:
    """Quantize a flat checkpoint dict on the host (JAX's
    ``_quantize_flat_np``): each quantizable key becomes its
    ``weight_q``/``weight_q4`` and ``weight_s`` keys, the rest pass."""
    from ..models.quantize import quantize_leaf, quantized_key_shapes

    out: Dict[str, torch.Tensor] = {}
    for k, v in arrays.items():
        qk = quantized_key_shapes(k, tuple(v.shape), weight_dtype)
        if not qk:
            out[k] = v
            continue
        base = k[: -len(".weight")]
        for name, leaf in quantize_leaf(v, weight_dtype).items():
            out[f"{base}.{name}"] = leaf
    return out


def _restructure_like(like: Any, nested: Any) -> Any:
    """Map a nested plain dict (string keys, list indices as strings) back
    onto the structure of ``like`` (dicts, lists, tuples)."""
    if isinstance(like, dict):
        return {k: _restructure_like(v, nested[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_restructure_like(v, nested[str(i)]) for i, v in enumerate(like)]
        return type(like)(vals) if isinstance(like, tuple) else vals
    return nested
