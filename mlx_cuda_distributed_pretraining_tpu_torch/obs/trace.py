"""In-process span tracer exporting Chrome trace-event JSON (the JAX
package's ``obs/trace.py``).

A :class:`Tracer` is a thread-safe, bounded ring buffer of spans.  Code
that already books time (the trainer's goodput ledger, the serve
engine's request lifecycle) records spans into it and the buffer can be
dumped at any point as Chrome trace-event JSON — loadable in Perfetto or
``chrome://tracing`` — or drained over HTTP via the ``/trace`` endpoints
on the serve engine's server.

Design constraints, in order:

* **Disabled means free.**  ``tracer.span(...)`` on a disabled tracer
  returns a shared module-level singleton; no span object is allocated
  and nothing is appended.  Hot paths additionally guard on
  ``tracer.enabled`` so even argument packing is skipped.
* **Bounded.**  The ring holds ``capacity`` events; once full the oldest
  are overwritten and ``dropped`` counts how many were lost, so a
  forgotten tracer can never grow without bound.
* **Cross-process mergeable.**  Timestamps are wall-clock anchored but
  monotonic-derived: each tracer records ``(time.time(), perf_counter())``
  once at construction and stamps events as ``anchor_wall + (now_mono -
  anchor_mono)``.  Files from the router and N replicas therefore share
  one timeline (to NTP accuracy) while individual durations keep
  monotonic precision.
* **W3C-style propagation.**  :func:`new_trace_id` mints a 16-byte hex
  trace id; the router sends it as the ``X-Trace-Id`` header
  (:data:`TRACE_HEADER`) and every span recorded on behalf of that
  request carries it in ``args["trace_id"]``, so files from several
  processes merge by id (:func:`merge_chrome_traces`).

Timestamps inside the Chrome JSON are microseconds, per the trace-event
spec.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "TRACE_HEADER",
    "Span",
    "Tracer",
    "new_trace_id",
    "sampled",
]

# Header used to propagate a trace id across HTTP hops (router -> replica).
TRACE_HEADER = "X-Trace-Id"


def new_trace_id() -> str:
    """Mint a W3C-style 16-byte lowercase-hex trace id."""
    return uuid.uuid4().hex


def sampled(trace_id: str, sample: float) -> bool:
    """Deterministic sampling decision for ``trace_id``.

    Every process holding the same id reaches the same verdict, so a
    request is either traced end to end or not at all.  ``sample`` is a
    fraction in [0, 1].
    """
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    try:
        bucket = int(trace_id[:8], 16) / float(0xFFFFFFFF)
    except (ValueError, IndexError):
        return True
    return bucket < sample


class Span:
    """A live span handle; ``end()`` (or ``with``) records it."""

    __slots__ = ("_tracer", "name", "args", "_t0", "trace_id")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 trace_id: Optional[str], args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.args = args
        self._t0 = time.perf_counter()

    def end(self, **extra: Any) -> float:
        """Record the span; returns its duration in seconds."""
        dur = time.perf_counter() - self._t0
        if self._tracer is not None:
            if extra:
                if self.args is None:
                    self.args = extra
                else:
                    self.args.update(extra)
            self._tracer._record(self.name, self._t0, dur, self.trace_id,
                                 self.args)
            self._tracer = None  # idempotent
        return dur

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end()


class _NullSpan:
    """Shared no-op span returned by disabled/sampled-out tracers."""

    __slots__ = ()

    def end(self, **extra: Any) -> float:
        return 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe bounded span recorder with Chrome trace-event export.

    Parameters
    ----------
    service:
        Process name stamped on exported events (Perfetto shows it as the
        track group), e.g. ``"trainer"``, ``"router"``, ``"replica-0"``.
    capacity:
        Ring-buffer size in events.  Oldest events are overwritten once
        full; ``stats()["dropped"]`` counts the casualties.
    sample:
        Fraction of *trace-id'd* spans to keep (deterministic per id via
        :func:`sampled`).  Spans without a trace id (trainer phases) are
        always recorded.
    enabled:
        Master switch.  When False every entry point is a cheap no-op
        and :meth:`span` returns the shared null span.
    """

    def __init__(self, service: str, capacity: int = 16384,
                 sample: float = 1.0, enabled: bool = True):
        self.service = service
        self.capacity = max(1, int(capacity))
        self.sample = float(sample)
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        # Wall anchor + monotonic origin: event ts = wall0 + (mono - mono0).
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        self._lock = threading.Lock()
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._head = 0          # next write index
        self._count = 0         # valid entries (<= capacity)
        self._recorded = 0
        self._dropped = 0

    # -- recording ---------------------------------------------------------

    def _wall_us(self, mono: float) -> int:
        return int((self._wall0 + (mono - self._mono0)) * 1e6)

    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if self._ring[self._head] is not None:
                self._dropped += 1
            self._ring[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            if self._count < self.capacity:
                self._count += 1
            self._recorded += 1

    def _record(self, name: str, t0_mono: float, dur_s: float,
                trace_id: Optional[str], args: Optional[Dict[str, Any]]) -> None:
        a = dict(args) if args else {}
        if trace_id is not None:
            a["trace_id"] = trace_id
        self._push({
            "name": name,
            "ph": "X",
            "ts": self._wall_us(t0_mono),
            "dur": max(0, int(dur_s * 1e6)),
            "pid": self.pid,
            "tid": threading.get_ident(),
            "args": a,
        })

    def span(self, name: str, trace_id: Optional[str] = None,
             **args: Any):
        """Start a span; ``end()`` it (or use as a context manager)."""
        if not self.enabled:
            return _NULL_SPAN
        if trace_id is not None and not sampled(trace_id, self.sample):
            return _NULL_SPAN
        return Span(self, name, trace_id, args or None)

    # ``begin`` is an alias kept for call sites that read better with it.
    begin = span

    def complete(self, name: str, dur_s: float,
                 trace_id: Optional[str] = None,
                 end_mono: Optional[float] = None, **args: Any) -> None:
        """Record an already-measured span after the fact.

        Used where a duration has just been computed for another ledger
        (e.g. the trainer's goodput components) so the span carries the
        *identical* number.  The span is placed ending at ``end_mono``
        (default: now) and extending ``dur_s`` back.
        """
        if not self.enabled:
            return
        if trace_id is not None and not sampled(trace_id, self.sample):
            return
        end = time.perf_counter() if end_mono is None else end_mono
        self._record(name, end - dur_s, dur_s, trace_id, args or None)

    def instant(self, name: str, trace_id: Optional[str] = None,
                **args: Any) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        if trace_id is not None and not sampled(trace_id, self.sample):
            return
        a = dict(args) if args else {}
        if trace_id is not None:
            a["trace_id"] = trace_id
        self._push({
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._wall_us(time.perf_counter()),
            "pid": self.pid,
            "tid": threading.get_ident(),
            "args": a,
        })

    # -- export ------------------------------------------------------------

    def _snapshot(self, clear: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            if self._count < self.capacity:
                evs = [e for e in self._ring[: self._count] if e is not None]
            else:
                # Oldest entry sits at the write head once the ring wrapped.
                evs = [e for e in
                       self._ring[self._head:] + self._ring[: self._head]
                       if e is not None]
            if clear:
                self._ring = [None] * self.capacity
                self._head = 0
                self._count = 0
        return evs

    def chrome_events(self, clear: bool = False) -> List[Dict[str, Any]]:
        """Buffered events plus process-name metadata, oldest first."""
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": self.pid,
            "args": {"name": self.service},
        }]
        return meta + self._snapshot(clear=clear)

    def chrome_trace(self, clear: bool = False) -> Dict[str, Any]:
        """Full Chrome trace-event document."""
        return {
            "traceEvents": self.chrome_events(clear=clear),
            "displayTimeUnit": "ms",
            "metadata": {"service": self.service, **self.stats()},
        }

    def export(self, path: str, clear: bool = False) -> str:
        """Write the trace document to ``path``; returns the path."""
        doc = self.chrome_trace(clear=clear)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def drain(self) -> List[Dict[str, Any]]:
        """Return buffered events and clear the ring."""
        return self._snapshot(clear=True)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "recorded": self._recorded,
                "dropped": self._dropped,
                "buffered": self._count,
            }


def merge_chrome_traces(docs: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge several Chrome trace documents into one (shared timeline)."""
    events: List[Dict[str, Any]] = []
    for doc in docs:
        events.extend(doc.get("traceEvents", []))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
