"""Deterministic fault injection for checkpoint IO.

Every checkpoint artifact (safetensors files, JSON sidecars, manifests,
the metadata ledger) is written temp-file-then-rename, and every one of
those renames funnels through :func:`commit_write` below. That single
choke point lets tests — and manual chaos drills — make a *specific*
write fail in a *specific* way without monkeypatching internals:

    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint import faults

    with faults.active("model", "enospc", match="step_20"):
        trainer.save_checkpoint(20)          # raises ENOSPC

Injection points are derived from the artifact filename, so callers
never thread point names through the IO layer:

    ``model``      step_<N>_model.safetensors
    ``optimizer``  step_<N>_optimizer.safetensors
    ``state``      step_<N>_state.json
    ``manifest``   step_<N>.manifest.json
    ``ledger``     metadata.json
    ``sidecar``    step_<N>_data_p<P>.json
    ``other``      anything else routed through the atomic writers

Modes:

    ``enospc``    remove the temp file and raise OSError(ENOSPC) — the
                  write never lands (a full disk / failed background write)
    ``truncate``  chop ``truncate_bytes`` off the temp file, then rename —
                  the final file is torn relative to what the writer (and
                  the step manifest) believe was written
    ``drop``      remove the temp file and report success — the artifact
                  silently never exists (lost page cache, vanished rename)
    ``block``     wait on ``event`` before committing — deterministic
                  back-pressure / in-flight-write tests

With no rules installed (production), :func:`commit_write` is a plain
``os.replace``.
"""

from __future__ import annotations

import contextlib
import errno
import os
import threading
from typing import List, Optional

MODES = ("enospc", "truncate", "drop", "block")


def point_for(path: str) -> str:
    """Derive the injection-point name from an artifact path."""
    name = os.path.basename(path)
    if name.endswith("_model.safetensors"):
        return "model"
    if name.endswith("_optimizer.safetensors"):
        return "optimizer"
    if name.endswith("_state.json"):
        return "state"
    if name.endswith(".manifest.json"):
        return "manifest"
    if name == "metadata.json":
        return "ledger"
    if "_data_p" in name and name.endswith(".json"):
        return "sidecar"
    return "other"


class Rule:
    """One armed fault: fires on writes whose point (and optional path
    substring) match, at most ``times`` times (None = unlimited)."""

    def __init__(
        self,
        point: str,
        mode: str,
        match: Optional[str] = None,
        times: Optional[int] = 1,
        truncate_bytes: int = 64,
        event: Optional[threading.Event] = None,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (expected one of {MODES})")
        if mode == "block" and event is None:
            raise ValueError("mode='block' requires an event")
        self.point = point
        self.mode = mode
        self.match = match
        self.times = times
        self.truncate_bytes = truncate_bytes
        self.event = event
        self.hits = 0

    def _applies(self, point: str, path: str) -> bool:
        if self.point != point:
            return False
        if self.times is not None and self.hits >= self.times:
            return False
        return self.match is None or self.match in path

    def __repr__(self) -> str:  # shows up in test failures — keep it useful
        return (f"Rule({self.point!r}, {self.mode!r}, match={self.match!r}, "
                f"times={self.times}, hits={self.hits})")


_rules: List[Rule] = []
_lock = threading.Lock()


def inject(
    point: str,
    mode: str,
    *,
    match: Optional[str] = None,
    times: Optional[int] = 1,
    truncate_bytes: int = 64,
    event: Optional[threading.Event] = None,
) -> Rule:
    """Arm a fault rule. Returns the rule so tests can assert ``hits``."""
    rule = Rule(point, mode, match=match, times=times,
                truncate_bytes=truncate_bytes, event=event)
    with _lock:
        _rules.append(rule)
    return rule


def reset() -> None:
    """Disarm every rule (tests call this in teardown)."""
    with _lock:
        _rules.clear()


@contextlib.contextmanager
def active(point: str, mode: str, **kwargs):
    """Context-managed :func:`inject` that disarms only its own rule."""
    rule = inject(point, mode, **kwargs)
    try:
        yield rule
    finally:
        with _lock:
            if rule in _rules:
                _rules.remove(rule)


def _take(point: str, path: str) -> Optional[Rule]:
    with _lock:
        for rule in _rules:
            if rule._applies(point, path):
                rule.hits += 1
                return rule
    return None


def commit_write(tmp: str, path: str) -> None:
    """Commit ``tmp`` to ``path`` (atomic rename), honoring armed faults.

    This is the only way checkpoint artifacts reach their final name;
    both the safetensors writer and the atomic-JSON writer call it.
    """
    rule = _take(point_for(path), path)
    if rule is None:
        os.replace(tmp, path)
        return
    if rule.mode == "block":
        rule.event.wait()
        os.replace(tmp, path)
        return
    if rule.mode == "truncate":
        size = os.path.getsize(tmp)
        with open(tmp, "r+b") as f:
            f.truncate(max(0, size - rule.truncate_bytes))
        os.replace(tmp, path)
        return
    if rule.mode == "drop":
        os.unlink(tmp)
        return
    # enospc
    os.unlink(tmp)
    raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC), path)
