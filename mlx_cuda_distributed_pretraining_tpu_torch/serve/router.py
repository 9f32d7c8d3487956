"""Prefix-affinity router: one HTTP front door over N engine replicas (the
JAX package's ``serve/router.py``, which is pure host code: either
package's router fronts either package's replicas).

A single batch engine is bounded by one accelerator; the router is the
horizontal-scale front door. It owns no model —
it forwards ``/generate`` / ``/v1/completions`` bodies to replica
servers (infer/server.py processes) and picks the replica so that
prefix-cache hits actually land where the cached blocks live:

- **prefix affinity** — the routing key is the first KV-block key of the
  prompt's byte sequence (``prefix_cache.chain_keys`` over raw bytes:
  the byte-fallback tokenizer is ~1 token/byte, so byte blocks track
  token blocks). Requests sharing a templated prefix hash to the same
  replica, whose prefix cache then serves the shared blocks.
- **session affinity** — a client-supplied ``"session"`` field
  overrides the prefix key, pinning a conversation (and its growing
  generated-KV chain) to one replica.
- **consistent hashing** — keys map onto a ring of virtual nodes, so
  adding/removing a replica remaps only ~1/N of the key space (cached
  prefixes elsewhere stay warm).
- **least-loaded fallback** — a replica whose known queue depth exceeds
  ``spill_depth`` spills new keys to the least-loaded replica instead of
  queueing behind the hot spot; with every replica saturated the router
  answers 429 with a ``Retry-After`` derived from the shallowest queue.
- **retry on replica death** — generation requests are idempotent
  (seeded sampling), so a connection failure marks the replica down and
  replays the request on the next candidate — as long as no response
  bytes have been forwarded yet. A background poller probes ``/metrics``
  for queue depth and revives replicas that answer again.
- **streaming** — ``"stream": true`` bodies are forwarded as-is and the
  replica's SSE byte stream is piped through unbuffered.

Stdlib only (http.server + urllib), same as the replica server.
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..obs.trace import TRACE_HEADER, Tracer, new_trace_id
from . import faults
from .policy import (
    DEADLINE_HEADER,
    CallPolicy,
    Deadline,
    DeadlineExceeded,
    PolicyConfig,
)
from .prefix_cache import chain_keys

__all__ = ["Router", "Replica", "serve_router"]


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


class _Ring:
    """Consistent-hash ring with virtual nodes (bounded remap on resize)."""

    def __init__(self, ids: List[str], vnodes: int = 64):
        points = []
        for rid in ids:
            for i in range(vnodes):
                points.append((_hash64(f"{rid}#{i}".encode()), rid))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._ids = [r for _, r in points]

    def lookup(self, key: bytes) -> Optional[str]:
        if not self._ids:
            return None
        i = bisect.bisect(self._hashes, _hash64(key)) % len(self._ids)
        return self._ids[i]


class Replica:
    """Router-side view of one engine replica (no model state here).

    Mutable fields are shared between the poller thread, the HTTP
    handler threads, and the fleet supervisor, so each instance carries
    its own ``lock``. Hold it only around field reads/writes — never
    across ``urlopen`` or any other blocking call — and never acquire
    ``Router._lock`` while holding it (the consistent order is router
    lock first, replica lock second)."""

    def __init__(self, rid: str, url: str, role: str = "any"):
        self.id = rid
        self.url = url.rstrip("/")
        self.role = role          # fleet pool: "prefill" | "decode" | "any"
        self.lock = threading.Lock()
        self.up = True            # guarded by self.lock
        #                           (optimistic until a probe/dispatch fails)
        # /metrics scrape slow; stats are old but the replica is NOT dead
        # (keep routing)
        self.stale = False        # guarded by self.lock
        # consecutive slow scrapes
        self.scrape_timeouts = 0  # guarded by self.lock
        # finishing in-flight, admitting nothing
        self.draining = False     # guarded by self.lock
        # freshly swapped weights, gated traffic
        self.canary = False       # guarded by self.lock
        self.queue_depth = 0      # guarded by self.lock
        self.occupancy = 0        # guarded by self.lock
        # router-side: requests currently forwarded
        self.inflight = 0         # guarded by self.lock
        self.kv_blocks_free: Optional[int] = None  # guarded by self.lock
        self.kv_num_blocks: Optional[int] = None  # guarded by self.lock
        self.kv_free_watermark: Optional[int] = None  # guarded by self.lock
        self.params_version = 0   # guarded by self.lock
        # responses fully delivered through us
        self.ok_count = 0         # guarded by self.lock
        # dead / broken-stream / http-error
        self.err_count = 0        # guarded by self.lock
        self.last_error: Optional[str] = None  # guarded by self.lock

    @property
    def load(self) -> int:
        """Dispatch-ordering load: replica queue + what we just sent it."""
        with self.lock:
            return self.queue_depth + self.inflight

    def _state_locked(self) -> str:
        """State label; caller holds ``self.lock``."""
        if not self.up:
            return "down"
        if self.draining:
            return "draining"
        if self.canary:
            return "canary"
        if self.stale:
            return "stale"
        return "active"

    @property
    def state(self) -> str:
        with self.lock:
            return self._state_locked()

    def snapshot(self) -> Dict[str, object]:
        with self.lock:
            return {"url": self.url, "up": self.up, "role": self.role,
                    "state": self._state_locked(),
                    "queue_depth": self.queue_depth,
                    "inflight": self.inflight,
                    "occupancy": self.occupancy,
                    "params_version": self.params_version,
                    "ok": self.ok_count, "err": self.err_count,
                    **({"kv_blocks_free": self.kv_blocks_free}
                       if self.kv_blocks_free is not None else {}),
                    **({"last_error": self.last_error}
                       if self.last_error else {})}


def _is_scrape_timeout(e: BaseException) -> bool:
    """A SLOW replica, not a dead one: socket timeouts (directly, or
    wrapped in URLError) mean the TCP connection worked but the reply
    was late — routing must keep going on last-known stats. Refused /
    reset connections are actual death."""
    if isinstance(e, TimeoutError):  # socket.timeout is an alias (3.10+)
        return True
    if isinstance(e, urllib.error.URLError):
        return isinstance(e.reason, TimeoutError)
    return False


class Router:
    def __init__(self, replica_urls: List[str], affinity: str = "prefix",
                 block_size: int = 32,
                 vnodes: int = 64, spill_depth: int = 8,
                 poll_interval_s: float = 0.5, retries: int = 1,
                 request_timeout_s: float = 600.0,
                 scrape_timeout_s: float = 2.0,
                 stale_down_after: int = 4,
                 first_byte_timeout_s: float = 30.0,
                 roles: Optional[List[str]] = None,
                 policy: Optional[PolicyConfig] = None,
                 trace: bool = False, trace_sample: float = 1.0,
                 trace_capacity: int = 16384):
        if not replica_urls:
            raise ValueError("router needs at least one replica URL")
        if affinity not in ("prefix", "none"):
            raise ValueError(f"unknown affinity {affinity!r} "
                             "(expected 'prefix' or 'none')")
        roles = roles or ["any"] * len(replica_urls)
        if len(roles) != len(replica_urls):
            raise ValueError(f"{len(roles)} roles for "
                             f"{len(replica_urls)} replicas")
        self.replicas: Dict[str, Replica] = {  # guarded by self._lock
            f"r{i}": Replica(f"r{i}", u, role=role)
            for i, (u, role) in enumerate(zip(replica_urls, roles))}
        self.affinity = affinity
        self.block_size = block_size
        self.spill_depth = spill_depth
        self.poll_interval_s = poll_interval_s
        self.retries = max(0, retries)
        self.request_timeout_s = request_timeout_s
        self.scrape_timeout_s = scrape_timeout_s
        # How long an accepted (non-streaming-committed) request may sit
        # with ZERO response bytes before the router gives up on this
        # replica and replays elsewhere (pre-first-byte failures are the
        # retryable kind — nothing reached the client yet).
        self.first_byte_timeout_s = first_byte_timeout_s
        # Consecutive slow scrapes tolerated before a stale replica is
        # finally declared down (it stopped proving liveness entirely).
        self.stale_down_after = max(1, stale_down_after)
        self._vnodes = vnodes
        self._ring = _Ring(sorted(self.replicas), vnodes=vnodes)
        self._published = set(self.replicas)  # ids currently on the ring
        self._next_rid = len(replica_urls)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        # Router-side spans ("route": full proxy time per request, keyed
        # by the trace id the router mints and forwards via X-Trace-Id).
        self.tracer = Tracer("router", capacity=trace_capacity,
                             sample=trace_sample, enabled=trace)
        from ..obs.metrics import MetricsRegistry

        self.metrics_registry = MetricsRegistry()
        reg = self.metrics_registry
        self._mc_requests = reg.counter(
            "serve_router_requests_total",
            "routed requests by replica and outcome")
        self._mc_retries = reg.counter(
            "serve_router_retries_total",
            "requests replayed on another replica after a failure")
        self._mg_up = reg.gauge(
            "serve_router_replica_up", "1 = replica answering, 0 = down")
        self._mg_depth = reg.gauge(
            "serve_router_replica_queue_depth",
            "last polled admission-queue depth per replica")
        self._mg_inflight = reg.gauge(
            "serve_router_replica_inflight",
            "requests currently forwarded to the replica")
        self._mg_stale = reg.gauge(
            "serve_router_replica_stale",
            "1 = last /metrics scrape timed out (routing on stale stats)")
        # Per-pool fleet gauges: the autoscaler's spawn/drain inputs.
        self._mg_pool_up = reg.gauge(
            "serve_router_pool_replicas_up", "live replicas per pool")
        self._mg_pool_depth = reg.gauge(
            "serve_router_pool_queue_depth",
            "summed admission-queue depth per pool")
        self._mg_pool_kv_free = reg.gauge(
            "serve_router_pool_kv_blocks_free",
            "minimum free KV blocks across the pool's live replicas")
        # Outbound-call policy (serve/policy.py): per-replica circuit breaker
        # + retry budget shared by dispatch, scrapes, and (via the fleet
        # controller) admin calls; its gauges land on this registry.
        self.policy = CallPolicy(policy, registry=self.metrics_registry)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Router":
        if self._poller is None:
            self._stop.clear()
            self.poll_once()  # synchronous first probe: mark dead replicas
            self._poller = threading.Thread(target=self._poll_loop,
                                            daemon=True, name="router-poll")
            self._poller.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
            self._poller = None

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.poll_once()

    def poll_once(self) -> None:
        """Probe every replica's /metrics for queue depth (and liveness —
        a down replica that answers again is revived here).

        Failure taxonomy matters: a scrape that TIMES OUT reached a
        replica that is merely slow (long prefill hogging the GIL, a
        stats hiccup) — marking it down would dump its queue onto the
        rest of the fleet and thrash the ring. Such a replica stays up
        with ``stale=True`` (routing continues on last-known stats) and
        is only declared down after ``stale_down_after`` consecutive
        silent scrapes. Connection-level failures (refused, reset, DNS)
        mean nobody is listening: down immediately."""
        for r in self._replica_list():
            try:
                # The scrape runs OUTSIDE the replica lock: a slow
                # replica must not stall every reader of its fields.
                # faults.urlopen is the injection choke point (the
                # scrape.timeout / http.* points land here too).
                with faults.urlopen(
                        urllib.request.Request(r.url + "/metrics"),
                        timeout=self.scrape_timeout_s) as resp:
                    m = json.loads(resp.read())
                parsed = {
                    "queue_depth": int(m.get("queue_depth", 0)),
                    "occupancy": int(m.get("batch_occupancy", 0)),
                    "role": m.get("role"),
                    "draining": bool(m.get("draining", False)),
                    "params_version": int(m.get("params_version", 0)),
                    "kv_blocks_free": (int(m["kv_blocks_free"])
                                       if "kv_blocks_free" in m else None),
                    "kv_num_blocks": (int(m["kv_num_blocks"])
                                      if "kv_num_blocks" in m else None),
                    "kv_free_watermark": (int(m["kv_free_watermark"])
                                          if "kv_free_watermark" in m
                                          else None),
                }
                with r.lock:
                    r.queue_depth = parsed["queue_depth"]
                    r.occupancy = parsed["occupancy"]
                    if parsed["role"] and r.role == "any":
                        # replica self-reports its pool
                        r.role = str(parsed["role"])
                    r.draining = parsed["draining"]
                    r.params_version = parsed["params_version"]
                    for kv_key in ("kv_blocks_free", "kv_num_blocks",
                                   "kv_free_watermark"):
                        if parsed[kv_key] is not None:
                            setattr(r, kv_key, parsed[kv_key])
                    r.up = True
                    r.stale = False
                    r.scrape_timeouts = 0
                    r.last_error = None
                # The poller is the breaker's recovery path: a replica
                # answering its scrape closes the circuit again.
                self.policy.record(r.url, True)
            except Exception as e:  # noqa: BLE001 - classified below
                timed_out = _is_scrape_timeout(e)
                with r.lock:
                    if timed_out:
                        r.scrape_timeouts += 1
                        r.stale = True
                        r.last_error = f"stale: {type(e).__name__}: {e}"
                        if r.scrape_timeouts >= self.stale_down_after:
                            r.up = False  # silent too long: stop routing
                    else:
                        r.up = False
                        r.stale = False
                        r.scrape_timeouts = 0
                        r.last_error = f"{type(e).__name__}: {e}"
                if not timed_out:
                    # Connection-level death feeds the breaker; a timeout
                    # does NOT — slow is not dead, and tripping the
                    # circuit on slowness would dump a healthy replica's
                    # queue onto the rest of the fleet.
                    self.policy.record(r.url, False)
            with r.lock:
                up, stale = r.up, r.stale
                depth, inflight = r.queue_depth, r.inflight
            self._mg_up.set(1.0 if up else 0.0, replica=r.id)
            self._mg_stale.set(1.0 if stale else 0.0, replica=r.id)
            self._mg_depth.set(depth, replica=r.id)
            self._mg_inflight.set(inflight, replica=r.id)
        self._refresh_ring()
        self._publish_pool_gauges()
        self.policy.publish()  # breaker/budget/fault gauges, once per poll

    def _publish_pool_gauges(self) -> None:
        rows = []
        for r in self._replica_list():
            with r.lock:
                rows.append((r.role, r.up and not r.draining,
                             r.queue_depth, r.kv_blocks_free))
        pools: Dict[str, list] = {}
        for role, live, depth, kv in rows:
            pools.setdefault(role, []).append((live, depth, kv))
        for pool, rs in pools.items():
            live = [x for x in rs if x[0]]
            self._mg_pool_up.set(len(live), pool=pool)
            self._mg_pool_depth.set(sum(d for _, d, _ in live), pool=pool)
            kv = [k for _, _, k in live if k is not None]
            if kv:
                self._mg_pool_kv_free.set(min(kv), pool=pool)

    # -- membership ----------------------------------------------------------
    def _replica_list(self) -> List[Replica]:
        """Stable copy of the replica set (the dict is lock-guarded; the
        Replica objects themselves carry their own locks)."""
        with self._lock:
            return list(self.replicas.values())

    def get_replica(self, rid: str) -> Replica:
        with self._lock:
            return self.replicas[rid]

    def _refresh_ring(self) -> None:
        """Rebuild the consistent-hash ring when the PUBLISHABLE set (up,
        not draining) changed — drain unpublishes a replica so new keys
        remap (~1/N of the space) while it finishes in-flight work."""
        want = set()
        for r in self._replica_list():
            with r.lock:
                if r.up and not r.draining:
                    want.add(r.id)
        with self._lock:
            if want != self._published:
                self._published = want
                self._ring = _Ring(sorted(want), vnodes=self._vnodes)

    def add_replica(self, url: str, role: str = "any") -> Replica:
        """Scale-up: register a freshly spawned replica and publish it."""
        with self._lock:
            rid = f"r{self._next_rid}"
            self._next_rid += 1
            r = Replica(rid, url, role=role)
            self.replicas[rid] = r
        self._refresh_ring()
        return r

    def remove_replica(self, rid: str) -> None:
        """Scale-down terminal step (after drain): forget the replica."""
        with self._lock:
            self.replicas.pop(rid, None)
        self._refresh_ring()

    def set_draining(self, rid: str, draining: bool = True) -> None:
        r = self.get_replica(rid)
        with r.lock:
            r.draining = draining
        self._refresh_ring()

    def set_canary(self, rid: str, canary: bool = True) -> None:
        r = self.get_replica(rid)
        with r.lock:
            r.canary = canary

    # -- routing -------------------------------------------------------------
    def routing_key(self, body: dict) -> Optional[bytes]:
        """Session id if the client pinned one, else the FIRST KV-block
        key of the prompt bytes (byte blocks ~ token blocks under the
        byte-fallback tokenizer): every prompt sharing the first
        ``block_size`` bytes — a templated system prefix — hashes to the
        same replica regardless of tail or length, landing where the
        cached blocks live."""
        session = body.get("session")
        if session:
            return f"session:{session}".encode()
        if self.affinity == "none":
            return None
        prompt = body.get("prompt")
        if isinstance(prompt, list) and prompt:
            prompt = prompt[0]
        if not isinstance(prompt, str) or not prompt:
            return None
        head = prompt.encode()[:self.block_size]
        if len(head) < self.block_size:
            return head  # short prompt: raw bytes still give a stable key
        return chain_keys(head, self.block_size)[0]

    def candidates(self, key: Optional[bytes],
                   role: Optional[str] = None) -> List[Replica]:
        """Dispatch order: the affinity target first (unless saturated),
        then every other live replica by ascending load. Draining
        replicas admit nothing. With ``role``, only that pool's replicas
        (plus role-"any" ones) qualify."""
        with self._lock:
            reps = list(self.replicas.values())
            ring = self._ring
        ranked = []
        for r in reps:
            with r.lock:
                if r.up and not r.draining \
                        and (role is None or r.role in (role, "any")):
                    ranked.append((r.queue_depth + r.inflight, r))
        if not ranked:
            return []
        ranked.sort(key=lambda t: (t[0], t[1].id))
        order = [r for _, r in ranked]
        primary = ring.lookup(key) if key is not None else None
        if primary is not None:
            for i, r in enumerate(order):
                if r.id != primary:
                    continue
                with r.lock:
                    depth = r.queue_depth
                if depth < self.spill_depth:
                    order.insert(0, order.pop(i))
                break
        return order

    # -- dispatch ------------------------------------------------------------
    def plan(self, path: str, body: dict, trace_id: str,
             deadline: Optional[Deadline] = None) -> List[Replica]:
        """The ordered candidate list one request should try. Subclasses
        (FleetRouter) override this with role-aware planning — canary
        gating, prefill handoff — so BOTH ``dispatch`` and the HTTP
        handler's retrying pipe go through the same routing brain."""
        return self.candidates(self.routing_key(body))

    def dispatch(self, path: str, body: dict,
                 trace_id: Optional[str] = None,
                 deadline: Optional[Deadline] = None):
        """Forward ``body`` to the best replica; returns the open HTTP
        response (caller reads/streams it) plus the replica. Connection
        failures mark the replica down and replay on the next candidate
        (idempotent: sampling is seeded); replica 429s propagate after
        every candidate rejected. ``trace_id`` (minted here when absent)
        rides the X-Trace-Id header so replica spans join this trace.
        ``deadline`` clamps every socket timeout to the request's
        remaining budget and forwards it via ``X-Deadline-Ms``."""
        if trace_id is None:
            trace_id = new_trace_id()
        return self._dispatch_to(self.plan(path, body, trace_id, deadline),
                                 path, body, trace_id, deadline=deadline)

    def _dispatch_to(self, cands: List[Replica], path: str, body: dict,
                     trace_id: Optional[str] = None,
                     deadline: Optional[Deadline] = None):
        """Try an ordered candidate list (the shared retry/backpressure
        machinery under both homogeneous and fleet dispatch).

        Per candidate: circuit-breaker gate (an open circuit skips the
        replica without a connection attempt), deadline-clamped socket
        timeout + ``X-Deadline-Ms``. A REPLAY after a connection failure
        additionally needs a retry-budget token for the next candidate
        and waits the capped jittered backoff — a saturation hop (429)
        does neither: the replica answered, immediate failover is free
        and correct."""
        if not cands:
            raise NoReplicaError("no live replica")
        if trace_id is None:
            trace_id = new_trace_id()
        data = json.dumps(body).encode()
        tried = 0
        replay = False  # previous candidate died at the connection level
        saturated: Optional[urllib.error.HTTPError] = None
        for r in cands:
            if tried > self.retries + 1:
                break
            if not self.policy.allow(r.url):
                self._mc_requests.inc(replica=r.id, outcome="breaker_open")
                continue
            if replay:
                if not self.policy.try_retry(r.url):
                    self._mc_requests.inc(replica=r.id,
                                          outcome="retry_budget")
                    continue
                delay = self.policy.backoff(tried, key=trace_id)
                if deadline is not None:
                    delay = min(delay, max(deadline.remaining_s(), 0.0))
                if delay > 0.0:
                    time.sleep(delay)
            tried += 1
            headers = {"Content-Type": "application/json",
                       TRACE_HEADER: trace_id}
            timeout = self.request_timeout_s
            if deadline is not None:
                try:
                    timeout = deadline.clamp(timeout)
                except DeadlineExceeded:
                    self.policy.note_deadline_exhausted()
                    raise
                headers[DEADLINE_HEADER] = deadline.header_value()
            req = urllib.request.Request(r.url + path, data=data,
                                         headers=headers)
            try:
                resp = faults.urlopen(req, timeout=timeout)
                self.policy.record(r.url, True)
                return resp, r
            except urllib.error.HTTPError as e:
                self.policy.record(r.url, True)  # it answered
                if e.code == 429:  # replica queue full: try the next one
                    saturated = e
                    self._mc_requests.inc(replica=r.id, outcome="saturated")
                    continue
                self._mc_requests.inc(replica=r.id, outcome="http_error")
                with r.lock:
                    r.err_count += 1
                raise
            except Exception as e:  # noqa: BLE001 - connection-level death
                self.policy.record(r.url, False)
                with r.lock:
                    r.up = False
                    r.last_error = f"{type(e).__name__}: {e}"
                    r.err_count += 1
                self._mg_up.set(0.0, replica=r.id)
                self._mc_requests.inc(replica=r.id, outcome="dead")
                self._mc_retries.inc()
                replay = True
                continue
        if saturated is not None:
            raise BackpressureError(self.retry_after())
        raise NoReplicaError("every replica failed or is down")

    def retry_after(self) -> int:
        """Seconds a 429'd client should wait: scaled to the shallowest
        queue across live replicas (capped — it is a hint, not a lease)."""
        depths = []
        for r in self._replica_list():
            with r.lock:
                if r.up:
                    depths.append(r.queue_depth)
        return max(1, min(30, min(depths, default=4) // 4 + 1))

    def replica_snapshots(self) -> Dict[str, Dict[str, object]]:
        """Point-in-time view of every replica (each snapshot is taken
        under that replica's own lock)."""
        return {r.id: r.snapshot() for r in self._replica_list()}

    def health(self) -> dict:
        snaps = self.replica_snapshots()
        ups = sum(1 for s in snaps.values() if s["up"])
        return {"status": "ok" if ups else "unavailable",
                "role": "router", "replicas_up": ups,
                "replicas": snaps,
                "affinity": self.affinity}


class NoReplicaError(Exception):
    """No live replica could take the request (-> 503)."""


class BackpressureError(Exception):
    """Every candidate replica is queue-full (-> 429 + Retry-After)."""

    def __init__(self, retry_after_s: int):
        super().__init__(f"all replicas saturated; retry in {retry_after_s}s")
        self.retry_after_s = retry_after_s


def make_router_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict,
                   headers: Optional[Dict[str, str]] = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parts = urllib.parse.urlsplit(self.path)
            path = parts.path.rstrip("/")
            if path in ("", "/healthz"):
                h = router.health()
                self._reply(200 if h["replicas_up"] else 503, h)
            elif path == "/metrics":
                # ?format=prom renders the router's own registry (request/
                # retry counters, breaker state, retry-budget tokens, fault
                # fires) as Prometheus text; the default JSON shape feeds
                # the fleet poller and stays unchanged.
                qs = urllib.parse.parse_qs(parts.query)
                if qs.get("format", [""])[0] == "prom":
                    from ..obs.prometheus import render_prometheus

                    router.policy.publish()  # fresh gauges at scrape time
                    body = render_prometheus(
                        router.metrics_registry.snapshot()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._reply(200, {
                    "role": "router",
                    "replicas": router.replica_snapshots(),
                })
            elif path == "/trace":
                # On-demand chrome-trace dump (?clear=1 drains the ring).
                clear = "clear" in urllib.parse.parse_qs(parts.query)
                self._reply(200, router.tracer.chrome_trace(clear=clear))
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            path = self.path.rstrip("/")
            if path not in ("/generate", "/v1/completions"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            # Honor a client-supplied trace id, else mint one; the replica
            # sees it via X-Trace-Id and the client gets it echoed back.
            trace_id = self.headers.get(TRACE_HEADER) or new_trace_id()
            # End-to-end budget: an upstream X-Deadline-Ms wins, else the
            # body's own deadline_s starts the clock at this hop.
            deadline = Deadline.from_header(self.headers)
            if deadline is None:
                try:
                    dl = float(body.get("deadline_s") or 0.0)
                except (TypeError, ValueError):
                    dl = 0.0
                if dl > 0.0:
                    deadline = Deadline.after(dl)
            try:
                cands = router.plan(path, body, trace_id, deadline)
                try:
                    self._dispatch_and_pipe(cands, path, body, trace_id,
                                            deadline)
                except NoReplicaError:
                    # The planned candidate set can go ENTIRELY dead
                    # mid-request (a fleet's decode pool, say) while the
                    # wider fleet still has capacity: re-plan ONCE
                    # against the updated liveness view — the fleet
                    # planner then degrades to the surviving pool — and
                    # charge the replay a retry-budget token.
                    fresh = router.plan(path, body, trace_id, deadline)
                    if not fresh \
                            or [c.id for c in fresh] == [c.id for c in cands] \
                            or not router.policy.try_retry(fresh[0].url):
                        raise
                    router._mc_retries.inc()
                    self._dispatch_and_pipe(fresh, path, body, trace_id,
                                            deadline)
            except BackpressureError as e:
                self._reply(429, {"error": str(e)},
                            headers={"Retry-After": str(e.retry_after_s)})
            except NoReplicaError as e:
                self._reply(503, {"error": str(e)})
            except TimeoutError as e:
                # DeadlineExceeded (budget spent before/while dispatching)
                # answers 504 immediately instead of burning a replica.
                self._reply(504, {"error": str(e) or "deadline exceeded"})
            except urllib.error.HTTPError as e:
                # Replica-side 4xx/5xx: pass status and body through.
                payload = e.read()
                self.send_response(e.code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        def _dispatch_and_pipe(self, cands, path, body, trace_id,
                               deadline) -> None:
            """Dispatch and forward, replaying on the next candidate as
            long as the failed replica produced ZERO response bytes — a
            pre-first-byte death is indistinguishable from a connection
            failure to the client, so it is just as retryable (sampling
            is seeded; a replayed request returns identical tokens)."""
            while True:
                t0 = time.perf_counter()
                resp, replica = router._dispatch_to(cands, path, body,
                                                    trace_id,
                                                    deadline=deadline)
                with replica.lock:
                    replica.inflight += 1
                try:
                    delivered = self._pipe(resp, replica, trace_id,
                                           deadline)
                finally:
                    with replica.lock:
                        replica.inflight -= 1
                    resp.close()
                    if router.tracer.enabled:
                        router.tracer.complete(
                            "route", time.perf_counter() - t0,
                            trace_id=trace_id, replica=replica.id,
                            path=path)
                if delivered:
                    return
                # Retry past the dead replica: only candidates after it
                # remain eligible, and the replay spends a retry-budget
                # token against the next one.
                idx = next((i for i, c in enumerate(cands)
                            if c.id == replica.id), None)
                cands = cands[idx + 1:] if idx is not None else []
                if not cands:
                    raise NoReplicaError(
                        "replica failed before first byte; no candidate "
                        "left to retry")
                if not router.policy.try_retry(cands[0].url):
                    self._reply(502, {"error": "replica failed before "
                                      "first byte; retry budget exhausted"})
                    return
                router._mc_retries.inc()

        @staticmethod
        def _set_read_timeout(resp, timeout_s) -> None:
            """Tighten the socket read timeout of an open response (the
            first-byte deadline). Best-effort: reaches through the
            http.client response to the raw socket; silently a no-op on
            exotic response objects."""
            try:
                resp.fp.raw._sock.settimeout(timeout_s)
            except AttributeError:
                pass

        def _pipe(self, resp, replica, trace_id=None, deadline=None) -> bool:
            """Forward the replica response verbatim — one buffered body
            for JSON, unbuffered chunks for SSE streams.

            Nothing is sent to the client until the replica's body bytes
            actually arrive (full body for sized responses, first chunk
            for streams, bounded by the first-byte deadline), so a
            replica dying BEFORE its first byte returns False — the
            caller replays on the next candidate. After the first byte
            is committed a failure is terminal (a replay would
            double-bill tokens): mark down, raise."""
            ctype = resp.headers.get("Content-Type", "application/json")
            clen = resp.headers.get("Content-Length")
            try:
                if clen is not None:
                    first = resp.read(int(clen))
                else:
                    fb = router.first_byte_timeout_s
                    if deadline is not None:
                        fb = min(fb, max(deadline.remaining_s(), 0.01))
                    self._set_read_timeout(resp, fb)
                    first = resp.read1(8192)
                    self._set_read_timeout(resp, router.request_timeout_s)
            except Exception as e:  # noqa: BLE001 - died with 0 bytes sent
                with replica.lock:
                    replica.up = False
                    replica.err_count += 1
                    replica.last_error = f"{type(e).__name__}: {e}"
                router.policy.record(replica.url, False)
                router._mg_up.set(0.0, replica=replica.id)
                router._mc_requests.inc(replica=replica.id,
                                        outcome="dead_prestream")
                return False
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype)
            if clen is not None:
                self.send_header("Content-Length", clen)
            if trace_id is not None:
                self.send_header(TRACE_HEADER, trace_id)
            self.end_headers()
            try:
                self.wfile.write(first)
                if clen is None:
                    self.wfile.flush()
                    # SSE: read1 returns whatever the replica has flushed
                    # (read(n) would block for a full buffer mid-stream).
                    while True:
                        chunk = resp.read1(8192)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                router._mc_requests.inc(replica=replica.id, outcome="ok")
                with replica.lock:
                    replica.ok_count += 1
            except Exception:  # noqa: BLE001 - replica died mid-stream
                # Bytes already left for the client: cannot retry (the
                # request would double-bill tokens); surface the break.
                with replica.lock:
                    replica.up = False
                    replica.err_count += 1
                router._mc_requests.inc(replica=replica.id,
                                        outcome="broken_stream")
                raise
            return True

    return Handler


def serve_router(router: Router, host: str = "127.0.0.1",
                 port: int = 0) -> ThreadingHTTPServer:
    """Start the router HTTP front door on a background thread; returns
    the server (stop with shutdown() + server_close(), then router.stop())."""
    router.start()
    httpd = ThreadingHTTPServer((host, port), make_router_handler(router))
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="serve-router")
    t.start()
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--replicas", dest="replica_urls", required=True,
                   help="comma-separated replica base URLs "
                        "(http://host:port of infer.server processes)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--affinity", choices=("prefix", "none"), default="prefix",
                   help="prefix = consistent-hash the first prompt block "
                        "(cache hits land where the blocks live); none = "
                        "pure least-loaded")
    p.add_argument("--block-size", type=int, default=32,
                   help="bytes per affinity block (match the replicas' KV "
                        "block size)")
    p.add_argument("--spill-depth", type=int, default=8,
                   help="replica queue depth beyond which new keys spill "
                        "to the least-loaded replica")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   help="seconds between replica /metrics probes")
    p.add_argument("--retries", type=int, default=1,
                   help="replays on another replica after a connection "
                        "failure (requests are idempotent: seeded sampling)")
    p.add_argument("--trace", action="store_true",
                   help="record route spans (dump via GET /trace; merge "
                        "with replica traces via obs.trace.merge_chrome_traces)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="fraction of requests traced (deterministic by "
                        "trace id, so router and replicas agree)")
    a = p.parse_args(argv)
    router = Router([u for u in a.replica_urls.split(",") if u],
                    affinity=a.affinity, block_size=a.block_size,
                    spill_depth=a.spill_depth,
                    poll_interval_s=a.poll_interval, retries=a.retries,
                    trace=a.trace, trace_sample=a.trace_sample)
    httpd = serve_router(router, a.host, a.port)
    print(f"router over {len(router.replica_snapshots())} replicas "
          f"on http://{a.host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
