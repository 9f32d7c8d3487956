"""Deterministic fault injection for the serving plane: the JAX package's
``serve/faults.py``, which is pure host code.

The serving-side mirror of ``checkpoint/faults.py``: named fault points
armed by tests instead of monkeypatched internals. HTTP calls funnel
through one choke point, :func:`urlopen` below, so a single armed rule can
refuse, slow, or tear any hop (router dispatch and scrapes, the fleet's
handoff and admin calls, KV pushes, the scope collector's scrapes);
engine-side points (weight swap, arena pressure) and the KV payload's
corruption hook their own call sites through :func:`take`.

Points::

    http.connect_refused   urlopen raises URLError(ECONNREFUSED) —
                           nobody listening (replica death)
    http.slow_read         each body read stalls ``delay_s`` first —
                           a live-but-slow peer (GIL hog, long prefill)
    http.truncate_body     body reads serve at most ``truncate_bytes``
                           total, then raise ECONNRESET — a connection
                           torn mid-response (0 = dies before any byte)
    kv_transfer.corrupt    the pushed GKV1 payload is corrupted in
                           flight (a chain key no longer matches the
                           tokens — the receiver must refuse it)
    kv_transfer.drop       the push silently vanishes (reported ok,
                           receiver never sees it)
    engine.swap_fail       swap_params raises before the cutover
    arena.exhaust          the paged arena reports exhaustion (forces
                           preemption / degradation without actually
                           filling device memory)
    scrape.timeout         the call raises TimeoutError before the
                           request leaves (a scrape that never answers —
                           stale, not dead)

Triggers (exactly one per rule; default fires once, on the first
matching call)::

    nth=N          fire on the Nth eligible call only (1-based)
    every=K        fire on every Kth eligible call
    rate=p, seed=s fire on a deterministic pseudo-random fraction p of
                   eligible calls — hash of (seed, call index), no
                   global RNG state, so a seeded chaos run replays
                   exactly

``match`` restricts a rule to calls whose label (the URL, for HTTP
points) contains the substring; ``times`` caps total fires. With no
rules armed every hook is a plain passthrough — injection off is zero
behavior change.
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

__all__ = ["POINTS", "Rule", "inject", "reset", "active", "take",
           "counts", "urlopen"]

POINTS = (
    "http.connect_refused",
    "http.slow_read",
    "http.truncate_body",
    "kv_transfer.corrupt",
    "kv_transfer.drop",
    "engine.swap_fail",
    "arena.exhaust",
    "scrape.timeout",
)


def _hash01(seed: int, n: int) -> float:
    """Deterministic uniform-ish [0, 1) from (seed, call index) — the
    seeded-rate trigger must replay identically across runs."""
    h = hashlib.blake2b(f"{seed}:{n}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64


class Rule:
    """One armed fault: fires on calls whose point (and optional label
    substring) match, per its trigger, at most ``times`` times."""

    def __init__(self, point: str,
                 nth: Optional[int] = None,
                 every: Optional[int] = None,
                 rate: Optional[float] = None,
                 seed: int = 0,
                 match: Optional[str] = None,
                 times: Optional[int] = None,
                 delay_s: float = 0.05,
                 truncate_bytes: int = 0):
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(expected one of {POINTS})")
        armed = sum(x is not None for x in (nth, every, rate))
        if armed > 1:
            raise ValueError("pick one trigger: nth, every, or rate")
        if armed == 0:
            nth = 1  # default: fire once, on the first matching call
        self.point = point
        self.nth = nth
        self.every = every
        self.rate = rate
        self.seed = int(seed)
        self.match = match
        self.times = times
        self.delay_s = float(delay_s)
        self.truncate_bytes = int(truncate_bytes)
        self.calls = 0   # eligible (point+match) calls seen
        self.fires = 0   # times the fault actually fired

    def _fire(self, label: str) -> bool:
        """Decide (and count) whether this rule fires for one call.
        Caller holds the module lock."""
        if self.match is not None and self.match not in label:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        self.calls += 1
        if self.nth is not None:
            hit = self.calls == self.nth
        elif self.every is not None:
            hit = self.calls % self.every == 0
        else:
            hit = _hash01(self.seed, self.calls) < float(self.rate)
        if hit:
            self.fires += 1
        return hit

    def __repr__(self) -> str:  # shows up in test failures — keep useful
        trig = (f"nth={self.nth}" if self.nth is not None
                else f"every={self.every}" if self.every is not None
                else f"rate={self.rate}, seed={self.seed}")
        return (f"Rule({self.point!r}, {trig}, match={self.match!r}, "
                f"calls={self.calls}, fires={self.fires})")


_rules: List[Rule] = []  # guarded by _lock
_counts: Dict[str, int] = {}  # guarded by _lock
_lock = threading.Lock()


def inject(point: str, **kwargs) -> Rule:
    """Arm a fault rule. Returns the rule so tests can assert ``fires``."""
    rule = Rule(point, **kwargs)
    with _lock:
        _rules.append(rule)
    return rule


def reset() -> None:
    """Disarm every rule and zero the fire counts (test teardown)."""
    with _lock:
        _rules.clear()
        _counts.clear()


@contextlib.contextmanager
def active(point: str, **kwargs):
    """Context-managed :func:`inject` that disarms only its own rule."""
    rule = inject(point, **kwargs)
    try:
        yield rule
    finally:
        with _lock:
            if rule in _rules:
                _rules.remove(rule)


def take(point: str, label: str = "") -> Optional[Rule]:
    """The hook call sites use: returns the fired rule (first match
    wins) or None. Firing bumps the per-point count that the engine's
    ``metrics()`` reports as ``faults_injected`` and a bound call policy
    publishes as ``serve_faults_injected_total{point}``."""
    with _lock:
        if not _rules:  # production fast path: one lock op, no scan
            return None
        for rule in _rules:
            if rule.point == point and rule._fire(label):
                _counts[point] = _counts.get(point, 0) + 1
                return rule
    return None


def counts() -> Dict[str, int]:
    """Fires per point since the last :func:`reset` (metrics surface)."""
    with _lock:
        return dict(_counts)


class _FaultyBody:
    """Response proxy perturbing body reads: ``slow`` stalls each read,
    ``trunc`` serves at most ``truncate_bytes`` total then raises
    ECONNRESET (truncate_bytes=0 = the connection dies before the first
    byte — the retryable pre-stream case). Header/status accessors pass
    through so callers cannot tell it from the real response."""

    def __init__(self, resp, slow: Optional[Rule], trunc: Optional[Rule]):
        self._resp = resp
        self._slow = slow
        self._trunc = trunc
        self._served = 0

    @property
    def headers(self):
        return self._resp.headers

    @property
    def status(self):
        return self._resp.status

    def getheader(self, name, default=None):
        return self._resp.headers.get(name, default)

    def __getattr__(self, name):
        # Anything not perturbed here (fp, status aliases, ...) passes
        # through — callers cannot tell this from the real response.
        return getattr(self._resp, name)

    def _read(self, fn, n):
        if self._slow is not None:
            time.sleep(self._slow.delay_s)
        if self._trunc is not None:
            budget = self._trunc.truncate_bytes - self._served
            if budget <= 0:
                raise ConnectionResetError(
                    errno.ECONNRESET, "injected truncate_body")
            n = budget if n is None else min(int(n), budget)
        chunk = fn(n) if n is not None else fn()
        self._served += len(chunk)
        return chunk

    def read(self, n=None):
        return self._read(self._resp.read, n)

    def read1(self, n=8192):
        return self._read(self._resp.read1, n)

    def close(self):
        self._resp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def urlopen(req, timeout: Optional[float] = None):
    """The serving plane's single HTTP egress choke point.

    Outbound serving calls open connections here, so one armed rule can
    perturb any of them. With nothing armed this is a plain
    ``urllib.request.urlopen``.
    """
    url = getattr(req, "full_url", None) or str(req)
    if take("http.connect_refused", url) is not None:
        raise urllib.error.URLError(ConnectionRefusedError(
            errno.ECONNREFUSED, "injected connect refused"))
    if take("scrape.timeout", url) is not None:
        raise TimeoutError("injected scrape timeout")
    resp = urllib.request.urlopen(req, timeout=timeout)
    slow = take("http.slow_read", url)
    trunc = take("http.truncate_body", url)
    if slow is not None or trunc is not None:
        return _FaultyBody(resp, slow, trunc)
    return resp
