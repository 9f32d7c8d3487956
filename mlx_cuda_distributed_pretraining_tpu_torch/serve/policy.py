"""Unified outbound-call policy for the serving plane (the JAX package's
``serve/policy.py``, which is pure host code: the same keys and clock give
the same jitter sequence, budgets and breaker transitions).

Every outbound hop of the serving plane (the router's dispatch and
scrapes, the fleet's handoff and admin calls, KV pushes, the scope
collector's scrapes) decides its failure behaviour here:

- **deadline propagation** — a request's remaining time budget rides
  the ``X-Deadline-Ms`` header. Each hop reads the remaining budget
  (:meth:`Deadline.from_header`), clamps its socket timeout to it
  (:meth:`Deadline.clamp`), forwards the *new* remaining value, and
  answers 504 the moment the budget is exhausted instead of spending
  compute on a request nobody is waiting for. ``DeadlineExceeded``
  subclasses ``TimeoutError`` so every existing 504 mapping applies.
- **capped exponential backoff with deterministic jitter** — replays
  wait ``base * 2^attempt`` capped at ``max_backoff_s``, jittered by a
  hash of (key, attempt) so a seeded chaos run replays exactly and a
  thundering herd still de-synchronizes.
- **per-destination retry budget** — a token bucket per replica:
  every replay spends a token, tokens refill at a bounded rate, so
  retries cannot amplify an outage into a retry storm (the budget is
  the serving-side mirror of Finagle/Envoy retry budgets).
- **per-destination circuit breaker** — ``breaker_threshold``
  consecutive connection failures open the circuit; while open, calls
  are refused locally (``BreakerOpenError``, an ``OSError`` so existing
  connection-failure handling applies). After ``breaker_open_s`` ONE
  half-open probe is let through: success closes the breaker, failure
  re-opens it.

Breaker state (0 closed / 1 open / 2 half-open), retry-budget tokens,
and fault-injection fire counts publish as the ``serve_breaker_state``,
``serve_retry_budget_tokens``, and ``serve_faults_injected_total``
gauges when a :class:`CallPolicy` is bound to a metrics registry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional

from . import faults

__all__ = ["DEADLINE_HEADER", "Deadline", "DeadlineExceeded",
           "AdmissionRefusedError", "BreakerOpenError", "backoff_s",
           "TokenBucket", "CircuitBreaker", "PolicyConfig", "CallPolicy"]

DEADLINE_HEADER = "X-Deadline-Ms"


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end budget is spent (-> 504, same mapping
    as an engine deadline eviction)."""


class AdmissionRefusedError(DeadlineExceeded):
    """Admission control: the deadline cannot be met at the current
    queue depth, so the request is refused before costing anything."""


class BreakerOpenError(ConnectionError):
    """The destination's circuit is open — refused locally, no socket
    touched (an OSError: callers' connection-failure paths apply)."""


class Deadline:
    """Absolute monotonic deadline (a value, not a thread): each hop
    derives the remaining budget at the moment it acts."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + max(float(seconds), 0.0))

    @classmethod
    def from_header(cls, headers) -> Optional["Deadline"]:
        """Parse ``X-Deadline-Ms`` (remaining milliseconds) from any
        mapping with ``.get``; None when absent or malformed — a bad
        header must not fail a request that never asked for a deadline."""
        raw = headers.get(DEADLINE_HEADER) if headers is not None else None
        if not raw:
            return None
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            return None
        return cls.after(ms / 1e3)

    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def header_value(self) -> str:
        """Remaining budget as the next hop should see it (floor 0 —
        the receiver answers 504 immediately)."""
        return str(max(int(self.remaining_ms()), 0))

    def clamp(self, timeout_s: Optional[float]) -> float:
        """Socket timeout bounded by the remaining budget; raises
        :class:`DeadlineExceeded` when nothing remains — the caller must
        not open a connection it cannot wait on."""
        rem = self.remaining_s()
        if rem <= 0.0:
            raise DeadlineExceeded(
                f"deadline exhausted ({rem * 1e3:.0f}ms remaining)")
        return rem if timeout_s is None else min(float(timeout_s), rem)


def backoff_s(attempt: int, base: float = 0.05, cap: float = 2.0,
              key: str = "") -> float:
    """Capped exponential backoff with deterministic jitter in
    [0.5, 1.0)x — reproducible under a fixed key (trace id), decorrelated
    across keys."""
    raw = min(float(cap), float(base) * (2.0 ** max(int(attempt) - 1, 0)))
    h = hashlib.blake2b(f"{key}:{attempt}".encode(), digest_size=8).digest()
    return raw * (0.5 + 0.5 * int.from_bytes(h, "big") / 2.0**64)


class TokenBucket:
    """Retry budget: replays spend a token each; tokens refill at
    ``refill_per_s`` up to ``capacity``. Exhausted budget = no replay —
    the failure surfaces instead of multiplying load on a sick fleet."""

    def __init__(self, capacity: float = 8.0, refill_per_s: float = 1.0):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._lock = threading.Lock()
        self._tokens = float(capacity)  # guarded by self._lock
        self._stamp = time.monotonic()  # guarded by self._lock

    def _refill_locked(self, now: float) -> None:
        dt = max(now - self._stamp, 0.0)
        self._stamp = now
        self._tokens = min(self.capacity,
                           self._tokens + dt * self.refill_per_s)

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked(time.monotonic())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked(time.monotonic())
            return self._tokens


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open -> (after
    open_for_s, ONE probe) -> half_open -> success closes / failure
    re-opens. Only connection-level outcomes feed it: an HTTP error
    status is a live, answering destination."""

    def __init__(self, threshold: int = 5, open_for_s: float = 2.0):
        self.threshold = max(1, int(threshold))
        self.open_for_s = float(open_for_s)
        self._lock = threading.Lock()
        self._state = CLOSED        # guarded by self._lock
        self._failures = 0          # guarded by self._lock
        self._opened_at = 0.0       # guarded by self._lock
        self._probing = False       # guarded by self._lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_code(self) -> int:
        """0 closed / 1 open / 2 half-open (the metrics gauge value)."""
        with self._lock:
            return _STATE_CODE[self._state]

    def allow(self) -> bool:
        """May a call proceed now? Transitions open -> half-open after
        the hold-off, granting exactly one in-flight probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at >= self.open_for_s:
                    self._state = HALF_OPEN
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: the single probe is already out
            return False

    def record(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self._state = CLOSED
                self._failures = 0
                self._probing = False
                return
            if self._state == HALF_OPEN:
                self._state = OPEN       # failed probe: back to open
                self._opened_at = time.monotonic()
                self._probing = False
                return
            self._failures += 1
            if self._failures >= self.threshold:
                self._state = OPEN
                self._opened_at = time.monotonic()


@dataclasses.dataclass
class PolicyConfig:
    """Outbound-call policy knobs (``policy:`` block of the serve
    config; configs/serve-sample.yaml documents each)."""

    max_attempts: int = 2           # tries per destination in call()
    base_backoff_s: float = 0.05    # first replay's nominal wait
    max_backoff_s: float = 2.0      # backoff growth cap
    breaker_threshold: int = 5      # consecutive failures to open
    breaker_open_s: float = 2.0     # hold-off before the half-open probe
    retry_budget: float = 8.0       # token-bucket capacity per replica
    retry_refill_per_s: float = 1.0  # budget refill rate

    @classmethod
    def from_yaml(cls, path: str) -> "PolicyConfig":
        from ..config import read_config_dict

        doc = read_config_dict(path) or {}
        block = doc.get("policy", doc if "max_attempts" in doc else {})
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(block).items() if k in known})


class _Dest:
    """Per-destination policy state (one per replica netloc)."""

    def __init__(self, cfg: PolicyConfig):
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_open_s)
        self.bucket = TokenBucket(cfg.retry_budget, cfg.retry_refill_per_s)


class CallPolicy:
    """Shared policy over many destinations: the router, fleet
    controller, and KV push consult the SAME breaker/budget for a
    replica, so one sick destination is recognized everywhere."""

    def __init__(self, cfg: Optional[PolicyConfig] = None, registry=None):
        self.cfg = cfg or PolicyConfig()
        self._lock = threading.Lock()
        self._dests: Dict[str, _Dest] = {}  # guarded by self._lock
        self._mg_breaker = None
        self._mg_tokens = None
        self._mg_faults = None
        self._mc_retries = None
        self._mc_deadline = None
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, reg) -> None:
        """Attach gauges/counters to a metrics registry (the router's or
        a replica's — whichever /metrics surface should carry them)."""
        self._mg_breaker = reg.gauge(
            "serve_breaker_state",
            "per-destination circuit state (0 closed, 1 open, 2 half-open)")
        self._mg_tokens = reg.gauge(
            "serve_retry_budget_tokens",
            "per-destination retry-budget tokens remaining")
        self._mg_faults = reg.gauge(
            "serve_faults_injected_total",
            "injected fault fires by point (serve/faults.py)")
        self._mc_retries = reg.counter(
            "serve_policy_retries_total",
            "budgeted replays granted, by destination")
        self._mc_deadline = reg.counter(
            "serve_policy_deadline_exhausted_total",
            "calls refused because the deadline budget was spent")

    @staticmethod
    def dest_key(url: str) -> str:
        p = urllib.parse.urlsplit(url)
        return p.netloc or url

    def _dest(self, url: str) -> _Dest:
        key = self.dest_key(url)
        with self._lock:
            d = self._dests.get(key)
            if d is None:
                d = self._dests[key] = _Dest(self.cfg)
            return d

    # -- primitive surface (the router's candidate loop uses these) ----------
    def allow(self, url: str) -> bool:
        return self._dest(url).breaker.allow()

    def record(self, url: str, ok: bool) -> None:
        self._dest(url).breaker.record(ok)

    def try_retry(self, url: str) -> bool:
        """Spend one retry-budget token for a replay onto ``url``."""
        granted = self._dest(url).bucket.try_take(1.0)
        if granted and self._mc_retries is not None:
            self._mc_retries.inc(dest=self.dest_key(url))
        return granted

    def tokens(self, url: str) -> float:
        return self._dest(url).bucket.tokens()

    def breaker_state(self, url: str) -> str:
        return self._dest(url).breaker.state

    def backoff(self, attempt: int, key: str = "") -> float:
        return backoff_s(attempt, base=self.cfg.base_backoff_s,
                         cap=self.cfg.max_backoff_s, key=key)

    def note_deadline_exhausted(self) -> None:
        if self._mc_deadline is not None:
            self._mc_deadline.inc()

    def publish(self) -> None:
        """Refresh the gauges (called from a poll loop, not per-call)."""
        if self._mg_breaker is None:
            return
        with self._lock:
            dests = list(self._dests.items())
        for key, d in dests:
            self._mg_breaker.set(d.breaker.state_code(), dest=key)
            self._mg_tokens.set(round(d.bucket.tokens(), 2), dest=key)
        for point, n in faults.counts().items():
            self._mg_faults.set(n, point=point)

    # -- one-destination call with the full policy ---------------------------
    def call(self, url: str, data: Optional[bytes] = None,
             headers: Optional[Dict[str, str]] = None,
             timeout: float = 30.0,
             deadline: Optional[Deadline] = None,
             method: Optional[str] = None,
             max_attempts: Optional[int] = None,
             backoff_key: str = "") -> bytes:
        """POST/GET ``url`` under the policy and return the body bytes.

        Per attempt: breaker gate, deadline-clamped socket timeout,
        ``X-Deadline-Ms`` stamped with the remaining budget. Connection
        failures replay (up to ``max_attempts`` total tries) only while
        the destination's retry budget grants tokens, waiting the capped
        jittered backoff in between. HTTP error statuses propagate
        immediately — the destination answered; retrying is the caller's
        semantic decision, not transport policy.
        """
        attempts = max_attempts if max_attempts is not None \
            else self.cfg.max_attempts
        attempts = max(1, int(attempts))
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            if attempt > 1:
                if not self.try_retry(url):
                    break
                delay = self.backoff(attempt - 1, key=backoff_key)
                if deadline is not None:
                    delay = min(delay, max(deadline.remaining_s(), 0.0))
                if delay > 0.0:
                    time.sleep(delay)
            if not self.allow(url):
                raise BreakerOpenError(
                    f"circuit open for {self.dest_key(url)}")
            hdrs = dict(headers or {})
            eff_timeout = float(timeout)
            if deadline is not None:
                try:
                    eff_timeout = deadline.clamp(eff_timeout)
                except DeadlineExceeded:
                    self.note_deadline_exhausted()
                    raise
                hdrs[DEADLINE_HEADER] = deadline.header_value()
            req = urllib.request.Request(url, data=data, headers=hdrs,
                                         method=method)
            try:
                with faults.urlopen(req, timeout=eff_timeout) as resp:
                    body = resp.read()
                self.record(url, True)
                return body
            except urllib.error.HTTPError:
                self.record(url, True)  # it answered; the circuit is fine
                raise
            except Exception as e:  # noqa: BLE001 - connection-level death
                self.record(url, False)
                last = e
        raise last if last is not None else BreakerOpenError(
            f"no attempt allowed for {self.dest_key(url)}")

    def call_json(self, url: str, payload: Optional[dict] = None,
                  **kwargs) -> dict:
        """:meth:`call` with a JSON request body and parsed JSON reply."""
        headers = dict(kwargs.pop("headers", None) or {})
        data = None
        if payload is not None:
            headers.setdefault("Content-Type", "application/json")
            data = json.dumps(payload).encode()
        body = self.call(url, data=data, headers=headers, **kwargs)
        return json.loads(body.decode() or "{}")
