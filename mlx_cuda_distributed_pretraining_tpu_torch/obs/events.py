"""Structured run event log: schema-versioned, append-only ``events.jsonl``
(the JAX package's ``obs/events.py``: either package reads the other's
files).

One file per run dir, one JSON object per line::

    {"v": 1, "type": "step_window", "t": 1722890000.1, ...payload}

Event types written by the trainer / supervisor:

  run_start        fresh run began (config name, total_steps, n_params)
  resume           run resumed from a checkpoint (tag, step)
  compile          first dispatch finished compiling (seconds)
  step_window      one logging window (step, steps, toks, loss, tok_s,
                   mfu, goodput breakdown)
  checkpoint_save  a checkpoint landed (step, seconds, blocking)
  verify           checkpoint verification outcome (tag, ok, reason)
  eval             validation ran (step, loss, seconds)
  profiler         trace started/stopped (action, step)
  fault            something went wrong (kind: hang/crash/..., detail)
  restart          supervisor relaunched the child (lost_s booked into
                   the goodput ledger as restart_lost_s)
  postmortem       supervisor's view of a dead child (rc, crashes)
  run_end          training finished (final_loss, steps)

The log is the DURABLE source: on resume the in-process metrics registry
is rebuilt by replaying it (:func:`replay_into`), so Prometheus counters
survive process death without any side database. Appends are a single
``write()`` of one line + flush; readers tolerate a torn final line
(crash mid-append) by skipping lines that fail to parse.

The heartbeat file lives here too: a tiny atomically-replaced JSON the
trainer touches every step window and the supervisor's hang watchdog
polls (train/supervisor.py) — same durability ethos, different cadence.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterator, Optional

SCHEMA_VERSION = 1
EVENTS_FILENAME = "events.jsonl"
ROTATED_EVENTS_FILENAME = "events.1.jsonl"
HEARTBEAT_FILENAME = "heartbeat.json"


def events_path(run_dir: str) -> str:
    return os.path.join(run_dir, EVENTS_FILENAME)


def rotated_events_path(path: str) -> str:
    """``events.jsonl`` → ``events.1.jsonl`` next to it (one rotation
    depth: the previous generation is enough for resume replay, and a
    bounded pair keeps long runs from growing without limit)."""
    d, base = os.path.split(path)
    stem, ext = os.path.splitext(base)
    return os.path.join(d, f"{stem}.1{ext}")


def heartbeat_path(run_dir: str, process_index: int = 0) -> str:
    """Per-host heartbeat file. Process 0 keeps the legacy
    ``heartbeat.json`` name (the supervisor's watchdog reads it); other
    hosts get ``heartbeat_p<idx>.json``."""
    if process_index:
        return os.path.join(run_dir, f"heartbeat_p{int(process_index)}.json")
    return os.path.join(run_dir, HEARTBEAT_FILENAME)


def read_fleet_heartbeats(run_dir: str) -> Dict[int, Dict[str, Any]]:
    """All per-host heartbeats of a run dir, keyed by process index
    (``heartbeat.json`` maps to 0) — lets a watchdog attribute a fleet
    stall to the host that stopped beating."""
    out: Dict[int, Dict[str, Any]] = {}
    hb = read_heartbeat(os.path.join(run_dir, HEARTBEAT_FILENAME))
    if hb is not None:
        out[0] = hb
    try:
        names = os.listdir(run_dir)
    except OSError:
        names = []
    for name in names:
        m = re.match(r"heartbeat_p(\d+)\.json$", name)
        if not m:
            continue
        hb = read_heartbeat(os.path.join(run_dir, name))
        if hb is not None:
            out[int(m.group(1))] = hb
    return out


class EventLog:
    """Append-only writer. Keeps the fd open; one flushed write per event
    so a crash loses at most the in-flight line (which readers skip).

    ``max_bytes`` (``logging.events.max_bytes`` in the config) bounds the
    live file: when an append would push past the cap the current file is
    rotated to ``events.1.jsonl`` (replacing any previous rotation) and a
    fresh ``events.jsonl`` is opened.  Rotation happens BETWEEN complete
    lines, so both files stay independently torn-tail tolerant and
    :func:`iter_events`/:func:`replay_into` read the pair in order.
    0 (the default) means unbounded — the pre-rotation behavior."""

    def __init__(self, path: str, now: Callable[[], float] = time.time,
                 max_bytes: int = 0):
        self.path = path
        self._now = now
        self.max_bytes = int(max_bytes or 0)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
        except OSError:
            self._size = 0

    def _rotate(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass
        try:
            os.replace(self.path, rotated_events_path(self.path))
        except OSError:
            pass  # keep appending to the oversized file over losing events
        self._f = open(self.path, "a", encoding="utf-8")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
        except OSError:
            self._size = 0

    def append(self, type: str, **fields: Any) -> Dict[str, Any]:
        ev = {"v": SCHEMA_VERSION, "type": str(type),
              "t": float(self._now()), **fields}
        line = json.dumps(ev, separators=(",", ":")) + "\n"
        if (self.max_bytes > 0 and self._size > 0
                and self._size + len(line) > self.max_bytes):
            self._rotate()
        self._f.write(line)
        self._f.flush()
        self._size += len(line)
        return ev

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


def append_event(path: str, type: str, **fields: Any) -> None:
    """One-shot append for writers without a long-lived EventLog (the
    supervisor). Open-append-close keeps it safe across the child's own
    EventLog appends: O_APPEND line writes don't interleave at this size."""
    ev = {"v": SCHEMA_VERSION, "type": str(type), "t": time.time(), **fields}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(ev, separators=(",", ":")) + "\n")


def iter_events(path: str) -> Iterator[Dict[str, Any]]:
    """Yield parsed events in append order; torn/garbage lines are
    skipped, unknown future schema versions are yielded as-is (readers
    filter on what they know).  When a rotated generation
    (``events.1.jsonl``) sits next to ``path`` it is read first, so
    replay after a size-capped rotation still sees the whole history."""
    for p in (rotated_events_path(path), path):
        if not os.path.isfile(p):
            continue
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line from a crash mid-append
                if isinstance(ev, dict) and "type" in ev:
                    yield ev


def replay_into(registry, path: str) -> int:
    """Rebuild the durable counters of a metrics registry from the event
    log; returns the number of events replayed.

    Only monotonic run-lifetime counters are rebuilt (steps, tokens,
    checkpoint saves, goodput seconds, faults, restarts) — gauges like
    loss/MFU are live-window quantities the next step window overwrites.
    The one gauge exception is ``pipeline_bubble_frac``: it is a constant
    of the schedule shape (pp, microbatches, interleave), so the last
    ``step_window`` carrying a ``bubble`` field restores it — a resumed pp
    run exports the gauge before its first new window closes.
    """
    steps = registry.counter("train_steps_total",
                             "optimizer steps completed over the run lifetime")
    toks = registry.counter("train_tokens_total",
                            "non-pad target tokens trained on")
    saves = registry.counter("checkpoint_saves_total", "checkpoints written")
    evals = registry.counter("eval_runs_total", "validation passes")
    faults = registry.counter("faults_total", "faults by kind")
    restarts = registry.counter("restarts_total", "supervisor child relaunches")
    goodput = registry.counter("goodput_seconds_total",
                               "wall-clock seconds by goodput component")
    n = 0
    for ev in iter_events(path):
        n += 1
        et = ev.get("type")
        if et == "step_window":
            steps.inc(float(ev.get("steps", 0) or 0))
            toks.inc(float(ev.get("toks", 0) or 0))
            for comp, secs in (ev.get("goodput") or {}).items():
                if isinstance(secs, (int, float)) and secs > 0:
                    goodput.inc(float(secs), component=comp)
            bubble = ev.get("bubble")
            if isinstance(bubble, (int, float)):
                registry.gauge(
                    "pipeline_bubble_frac",
                    "fraction of pipeline schedule ticks spent in the "
                    "warmup/drain bubble (idle with compute-skip)",
                ).set(float(bubble))
        elif et == "checkpoint_save":
            saves.inc()
        elif et == "eval":
            evals.inc()
        elif et == "fault":
            faults.inc(kind=str(ev.get("kind", "unknown")))
        elif et == "restart":
            restarts.inc()
            lost = ev.get("lost_s")
            if isinstance(lost, (int, float)) and lost > 0:
                goodput.inc(float(lost), component="restart_lost_s")
    return n


def tally(path: str) -> Dict[str, float]:
    """Grand totals straight from the log (no registry) — what tests and
    postmortems compare Prometheus counters against."""
    out = {"steps": 0.0, "toks": 0.0, "checkpoint_saves": 0.0,
           "evals": 0.0, "faults": 0.0, "restarts": 0.0, "events": 0.0}
    for ev in iter_events(path):
        out["events"] += 1
        et = ev.get("type")
        if et == "step_window":
            out["steps"] += float(ev.get("steps", 0) or 0)
            out["toks"] += float(ev.get("toks", 0) or 0)
        elif et == "checkpoint_save":
            out["checkpoint_saves"] += 1
        elif et == "eval":
            out["evals"] += 1
        elif et == "fault":
            out["faults"] += 1
        elif et == "restart":
            out["restarts"] += 1
    return out


# -- heartbeat ------------------------------------------------------------


def write_heartbeat(path: str, step: int, pid: Optional[int] = None,
                    process_index: Optional[int] = None) -> None:
    """Atomically replace the heartbeat file: {t, step, pid[,
    process_index]}. The watchdog must never read a torn heartbeat, hence
    temp + os.replace (same pattern as checkpoint/manager._atomic_json)."""
    tmp = path + ".tmp"
    payload = {"t": time.time(), "step": int(step),
               "pid": int(pid if pid is not None else os.getpid())}
    if process_index is not None:
        payload["process_index"] = int(process_index)
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            hb = json.load(f)
        return hb if isinstance(hb, dict) and "t" in hb else None
    except (OSError, json.JSONDecodeError, ValueError):
        return None
