"""Disaggregated serving fleet: prefill/decode pools, KV handoff routing,
autoscaling, and zero-downtime rolling weight swaps (the JAX package's
``serve/fleet.py``, which is pure host code: membership files, routing and
autoscale decisions are the same in both packages).

Prefill is compute-bound (one long matmul-heavy pass over the prompt);
decode is HBM-bandwidth-bound (one token per iteration, the whole KV
arena streamed per step). A homogeneous replica interleaves both, so a
long prompt arriving at a decode-heavy replica stalls every in-flight
stream by a prefill chunk's worth of compute. The fleet splits the two
phases across POOLS of replicas (DistServe/Splitwise):

- **FleetRouter** extends the prefix-affinity router with roles. A
  worthwhile request (prompt past ``handoff_min_prompt_bytes``) is first
  POSTed to a prefill replica's ``/prefill`` — prefill-only, no token
  sampled — which exports the prompt's KV block chain and pushes it to
  the chosen decode replica's ``/adopt_kv`` (serve/kv_transfer.py, keyed
  by prefix-cache content hashes so shared prefixes cross the wire at
  most once). The original request then dispatches to that decode
  replica, whose admission adopts the transferred chain as a prefix hit
  and recomputes only the final prompt token (the sampler needs its
  logits — greedy/seeded parity with local prefill is automatic). Any
  handoff failure falls back to decode-side prefill: correctness never
  depends on the transfer.
- **membership** — replicas stamp heartbeat files under a shared fleet
  directory (the ``gen_<g>_p<idx>.json`` convention and atomic writes of
  ``utils/json_files.py``, one generation per fleet epoch); the
  controller reaps members whose heartbeat went stale and adopts newly
  registered ones without a restart.
- **FleetController.autoscale_tick** — reads the per-pool queue-depth
  and KV-free-watermark gauges the router publishes from its ``/metrics``
  scrapes; sustained queueing or KV pressure spawns a replica into the
  hot pool (``spawn_fn``), sustained idleness drains one out: stop
  admitting (``/admin/drain`` → replica 503s new work), unpublish from
  the ring, wait for in-flight to finish, then ``stop_fn``.
- **FleetController.rolling_swap** — zero-downtime weight rollout: each
  replica in turn loads the new checkpoint (``/admin/swap_weights``:
  ``CheckpointManager.load_params`` then ``BatchEngine.swap_params``, a
  cutover between engine iterations, in-flight requests finish on the new
  weights), then serves
  as a CANARY taking ``canary_fraction`` of traffic (deterministic by
  trace id) until ``canary_requests`` complete with zero errors, and is
  promoted. A canary error halts the rollout with the rest of the fleet
  untouched. While a prefill and a decode replica serve different
  ``params_version``s, the router hands nothing off between them, and a
  decode replica adopts no push computed on other weights than its own.

A local fleet: replica servers (``infer.server --engine batch --role
prefill|decode --fleet-dir D --fleet-index i``), then ``python -m
mlx_cuda_distributed_pretraining_tpu_torch.serve.fleet --fleet-dir D
[--scope]``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional

from ..obs.trace import TRACE_HEADER, new_trace_id
from ..utils.json_files import atomic_write_json as _atomic_write_json
from ..utils.json_files import read_json as _read_json
from .policy import Deadline
from .router import Replica, Router, _hash64, serve_router

__all__ = ["FleetConfig", "FleetRouter", "FleetController",
           "register_replica", "start_heartbeat", "read_fleet",
           "fleet_generation"]


# -- membership (the elastic membership file conventions) --------------------

_MEMBER_RE = re.compile(r"gen_(\d+)_p(\d+)\.json$")


def _members_dir(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, "members")


def fleet_generation(fleet_dir: str) -> int:
    """Highest generation stamped in the fleet dir (0 = never launched)."""
    try:
        names = os.listdir(_members_dir(fleet_dir))
    except OSError:
        return 0
    best = 0
    for name in names:
        m = _MEMBER_RE.search(name)
        if m:
            best = max(best, int(m.group(1)))
    return best


def register_replica(fleet_dir: str, url: str, role: str = "any",
                     index: int = 0,
                     generation: Optional[int] = None) -> str:
    """Stamp one replica into the fleet's membership directory.

    Atomically writes ``members/gen_<g>_p<index>.json`` (the elastic
    membership convention — ``index`` must be unique across BOTH pools
    of a launch, like a process index). ``generation`` defaults to the
    current fleet epoch (or 1 for a fresh directory); a controller that
    relaunches the world registers into ``fleet_generation() + 1`` so
    stale members of the old epoch are invisible, not merely dead.
    Returns the member file path (heartbeats re-stamp it)."""
    if generation is None:
        generation = fleet_generation(fleet_dir) or 1
    path = os.path.join(_members_dir(fleet_dir),
                        f"gen_{generation}_p{index}.json")
    _atomic_write_json(path, {
        "generation": int(generation),
        "index": int(index),
        "url": url.rstrip("/"),
        "role": role,
        "pid": os.getpid(),
        "t": time.time(),
    })
    return path


def start_heartbeat(fleet_dir: str, url: str, role: str = "any",
                    index: int = 0, interval_s: float = 2.0,
                    generation: Optional[int] = None) -> threading.Event:
    """Register and keep re-stamping this replica's member file from a
    daemon thread. Returns the stop event (set it to end the heartbeat;
    server processes just let the daemon die with them). A replica whose
    stamp stops aging is dead to ``read_fleet`` after ``stale_after_s``
    — crash detection without a connection-level probe."""
    path = register_replica(fleet_dir, url, role=role, index=index,
                            generation=generation)
    rec = _read_json(path) or {}
    stop = threading.Event()

    def beat() -> None:
        while not stop.wait(interval_s):
            rec["t"] = time.time()
            try:
                _atomic_write_json(path, rec)
            except OSError:
                pass  # transient FS hiccup: next beat retries

    threading.Thread(target=beat, daemon=True,
                     name=f"fleet-heartbeat-p{index}").start()
    return stop


def read_fleet(fleet_dir: str, stale_after_s: float = 10.0,
               generation: Optional[int] = None) -> Dict[str, object]:
    """Current fleet view: the latest generation's members, each tagged
    ``alive`` by heartbeat freshness (wall-clock stamps — heartbeats
    cross processes, so monotonic clocks cannot compare)."""
    if generation is None:
        generation = fleet_generation(fleet_dir)
    members: List[Dict[str, object]] = []
    now = time.time()
    try:
        names = os.listdir(_members_dir(fleet_dir))
    except OSError:
        names = []
    for name in sorted(names):
        m = _MEMBER_RE.search(name)
        if not m or int(m.group(1)) != generation:
            continue
        rec = _read_json(os.path.join(_members_dir(fleet_dir), name))
        if rec is None:
            continue
        rec["alive"] = (now - float(rec.get("t", 0.0))) <= stale_after_s
        members.append(rec)
    members.sort(key=lambda r: int(r.get("index", 0)))
    return {"generation": generation, "members": members}


# -- configuration -----------------------------------------------------------


@dataclass
class FleetConfig:
    """Fleet shape + lifecycle policy (``fleet:`` block of the serve
    config; see configs/serve-sample.yaml)."""

    prefill_replicas: int = 1
    decode_replicas: int = 1
    # Fraction of traffic a freshly swapped (canary) replica receives,
    # deterministic by trace id so retries agree.
    canary_fraction: float = 0.25
    # Seconds a draining replica gets to finish in-flight work before
    # the controller gives up waiting and stops it anyway.
    drain_timeout_s: float = 30.0
    # Prompts shorter than this (bytes) skip the handoff — shipping KV
    # costs more than recomputing a tiny prefill decode-side.
    handoff_min_prompt_bytes: int = 64
    # Autoscaler policy, per pool.
    min_replicas_per_pool: int = 1
    max_replicas_per_pool: int = 4
    scale_up_queue_depth: int = 8       # summed pool depth that spawns
    scale_up_kv_free_frac: float = 0.05  # free-block watermark floor
    scale_down_idle_ticks: int = 5      # consecutive idle ticks to drain
    heartbeat_stale_s: float = 10.0

    @classmethod
    def from_yaml(cls, path: str) -> "FleetConfig":
        from ..config import read_config_dict

        doc = read_config_dict(path) or {}
        block = doc.get("fleet", doc if "prefill_replicas" in doc else {})
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in dict(block).items() if k in known})


# -- routing -----------------------------------------------------------------


class FleetRouter(Router):
    """Role-aware front door: prefill pool runs the prompt, decode pool
    runs the tokens, KV crosses between them once per unshared prefix."""

    def __init__(self, prefill_urls: List[str], decode_urls: List[str],
                 canary_fraction: float = 0.25,
                 handoff_min_prompt_bytes: int = 64,
                 prefill_timeout_s: float = 300.0, **kw):
        urls = list(prefill_urls) + list(decode_urls)
        roles = (["prefill"] * len(prefill_urls)
                 + ["decode"] * len(decode_urls))
        super().__init__(urls, roles=roles, **kw)
        self.canary_fraction = float(canary_fraction)
        self.handoff_min_prompt_bytes = int(handoff_min_prompt_bytes)
        self.prefill_timeout_s = float(prefill_timeout_s)
        reg = self.metrics_registry
        # JAX's help text, so the exposition's bytes stay JAX's; the port
        # adds the outcome "version_skew" (see _same_weights)
        self._mc_handoffs = reg.counter(
            "serve_fleet_handoffs_total",
            "prefill->decode KV handoffs by outcome "
            "(ok / failed / skipped)")

    # -- canary gating --------------------------------------------------------
    def _gate_canary(self, cands: List[Replica],
                     trace_id: str) -> List[Replica]:
        """Split traffic deterministically by trace id: a canary replica
        sees ``canary_fraction`` of requests (preferred for those, so the
        gate actually exercises it) and none of the rest — unless the
        whole pool is canary, in which case gating would mean an outage."""
        is_canary = {}
        for r in cands:
            with r.lock:
                is_canary[r.id] = r.canary
        canaries = [r for r in cands if is_canary[r.id]]
        if not canaries or len(canaries) == len(cands):
            return cands
        rest = [r for r in cands if not is_canary[r.id]]
        take = (_hash64(f"canary:{trace_id}".encode()) % 10_000
                < int(self.canary_fraction * 10_000))
        return canaries + rest if take else rest

    # -- handoff --------------------------------------------------------------
    def _worth_handoff(self, path: str, body: dict) -> bool:
        if path not in ("/generate", "/v1/completions"):
            return False
        prompt = body.get("prompt")
        if isinstance(prompt, list) and prompt:
            prompt = prompt[0]
        return (isinstance(prompt, str)
                and len(prompt.encode()) >= self.handoff_min_prompt_bytes)

    def _handoff(self, pre: Replica, dec: Replica, body: dict,
                 trace_id: str,
                 deadline: Optional[Deadline] = None) -> Optional[dict]:
        """Best-effort prefill + KV push ahead of the decode dispatch.
        Returns the prefill replica's summary, or None on any failure —
        the decode replica then prefills locally (slower, never wrong).
        The POST rides the shared outbound-call policy (breaker gate,
        deadline-clamped timeout + ``X-Deadline-Ms``), but with a single
        attempt: retrying a best-effort optimization wastes budget the
        decode dispatch may still need."""
        timeout_s = self.prefill_timeout_s
        if deadline is not None:
            # The replica-side wait must not outlive the caller's budget.
            timeout_s = min(timeout_s, max(deadline.remaining_s(), 0.01))
        payload = json.dumps({
            "prompt": body.get("prompt"),
            "transfer_to": dec.url,
            "timeout_s": timeout_s,
            **({"deadline_s": body["deadline_s"]}
               if "deadline_s" in body else {}),
        }).encode()
        with pre.lock:
            pre.inflight += 1
        try:
            raw = self.policy.call(
                pre.url + "/prefill", data=payload,
                headers={"Content-Type": "application/json",
                         TRACE_HEADER: trace_id},
                timeout=self.prefill_timeout_s, deadline=deadline,
                method="POST", max_attempts=1, backoff_key=trace_id)
            out = json.loads(raw)
            with pre.lock:
                pre.ok_count += 1
            self._mc_handoffs.inc(outcome="ok")
            return out
        except Exception as e:  # noqa: BLE001 - fallback path, not fatal
            with pre.lock:
                pre.err_count += 1
                pre.last_error = f"handoff: {type(e).__name__}: {e}"
            self._mc_handoffs.inc(outcome="failed")
            return None
        finally:
            with pre.lock:
                pre.inflight -= 1

    # -- dispatch -------------------------------------------------------------
    def plan(self, path: str, body: dict, trace_id: str,
             deadline: Optional[Deadline] = None) -> List[Replica]:
        """Fleet planning: pick the decode replica FIRST (affinity +
        canary gate — the transfer target must be the dispatch target,
        or the shipped KV lands on the wrong arena), run the prefill
        handoff against the least-loaded prefill replica, then hand the
        decode pool to the shared retry/backpressure machinery (both
        ``dispatch`` and the HTTP handler's retrying pipe call here)."""
        key = self.routing_key(body)
        decode = self._gate_canary(self.candidates(key, role="decode"),
                                   trace_id)
        if not decode:
            # Decode pool empty (all draining/down): degrade to the whole
            # live fleet rather than failing — prefill replicas CAN serve
            # end-to-end, they are just worse at decode.
            return self.candidates(key)
        if self._worth_handoff(path, body):
            pre = [r for r in self.candidates(key, role="prefill")
                   if r.role == "prefill"]
            if not pre:
                self._mc_handoffs.inc(outcome="skipped")
            elif not self._same_weights(pre[0], decode[0]):
                self._mc_handoffs.inc(outcome="version_skew")
            else:
                self._handoff(pre[0], decode[0], body, trace_id,
                              deadline=deadline)
        return decode

    @staticmethod
    def _same_weights(pre: Replica, dec: Replica) -> bool:
        """Whether the two replicas serve the same ``params_version``.
        Within a rolling swap one has swapped and the other not, and KV
        pushed across would be computed on the other weights: in a swapped
        decode replica it would stay in the prefix cache after the rollout
        and serve later requests that share its prefix. So the decode
        replica prefills locally instead. (JAX's router hands off across
        the swap; the receiver's ``X-Params-Version`` check covers a swap
        that lands while a push is in flight.)"""
        with pre.lock:
            pv = pre.params_version
        with dec.lock:
            dv = dec.params_version
        return pv == dv


# -- lifecycle control -------------------------------------------------------


class FleetController:
    """Autoscaling + lifecycle over a FleetRouter: spawn/drain replicas
    from pool pressure, reap dead heartbeats, roll weight swaps through
    the fleet with canary gating and zero failed requests."""

    def __init__(self, router: Router, cfg: Optional[FleetConfig] = None,
                 spawn_fn: Optional[Callable[[str], Optional[str]]] = None,
                 stop_fn: Optional[Callable[[str], None]] = None,
                 fleet_dir: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None,
                 scope=None):
        self.router = router
        self.cfg = cfg or FleetConfig()
        self.spawn_fn = spawn_fn    # role -> url of a fresh replica
        self.stop_fn = stop_fn      # url -> None (terminate the process)
        self.fleet_dir = fleet_dir
        self._log = log or (lambda m: None)
        self._idle_ticks: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the scope collector (obs/scope.py): one per fleet, lifecycle
        # tied to the controller's — start() and stop() drive both.
        self.scope = scope

    # -- pool pressure --------------------------------------------------------
    def pool_stats(self) -> Dict[str, Dict[str, object]]:
        """Per-pool pressure view from the router's last /metrics scrape
        (the same numbers its pool gauges publish): live replica count,
        summed queue depth, and the worst free-KV-block watermark seen
        since the previous scrape, as a fraction of the arena."""
        pools: Dict[str, Dict[str, object]] = {}
        for r in self.router._replica_list():
            with r.lock:
                live = r.up and not r.draining
                depth = r.queue_depth
                load = r.queue_depth + r.inflight
                free = (r.kv_free_watermark
                        if r.kv_free_watermark is not None
                        else r.kv_blocks_free)
                num_blocks = r.kv_num_blocks
            p = pools.setdefault(r.role, {
                "live": 0, "queue_depth": 0, "load": 0,
                "kv_free_frac": None, "replicas": [],
                "live_replicas": []})
            p["replicas"].append(r)
            if not live:
                continue
            p["live_replicas"].append(r)
            p["live"] += 1
            p["queue_depth"] += depth
            p["load"] += load
            if free is not None and num_blocks:
                frac = free / num_blocks
                cur = p["kv_free_frac"]
                p["kv_free_frac"] = frac if cur is None else min(cur, frac)
        return pools

    def autoscale_tick(self) -> List[str]:
        """One policy step per pool; returns the actions taken.

        Scale UP on pressure: summed queue depth at/over
        ``scale_up_queue_depth``, or the free-KV watermark under
        ``scale_up_kv_free_frac`` (decode replicas die by arena
        exhaustion — preemption thrash — long before their queue shows
        it). Scale DOWN only after ``scale_down_idle_ticks`` consecutive
        ticks with zero queued and zero in-flight work, and never below
        ``min_replicas_per_pool``; the victim drains fully (in-flight
        finishes) before ``stop_fn`` sees it."""
        cfg, actions = self.cfg, []
        for pool, p in self.pool_stats().items():
            if pool not in ("prefill", "decode"):
                continue
            live = int(p["live"])
            kv_frac = p["kv_free_frac"]
            pressure = (p["queue_depth"] >= cfg.scale_up_queue_depth
                        or (kv_frac is not None
                            and kv_frac < cfg.scale_up_kv_free_frac))
            idle = p["queue_depth"] == 0 and p["load"] == 0 and live > 0
            if pressure:
                self._idle_ticks[pool] = 0
                if live < cfg.max_replicas_per_pool and self.spawn_fn:
                    url = self.spawn_fn(pool)
                    if url:
                        r = self.router.add_replica(url, role=pool)
                        actions.append(f"spawn {pool} {r.id} {url}")
                        self._log(f"[fleet] scale-up {pool}: {url} "
                                  f"(depth={p['queue_depth']}, "
                                  f"kv_free={kv_frac})")
            elif idle and live > cfg.min_replicas_per_pool:
                self._idle_ticks[pool] = self._idle_ticks.get(pool, 0) + 1
                if self._idle_ticks[pool] >= cfg.scale_down_idle_ticks:
                    self._idle_ticks[pool] = 0
                    victim = max(p["live_replicas"], key=lambda r: r.id)
                    if self.drain_replica(victim.id):
                        if self.stop_fn:
                            self.stop_fn(victim.url)
                        self.router.remove_replica(victim.id)
                        actions.append(f"drain {pool} {victim.id}")
                        self._log(f"[fleet] scale-down {pool}: "
                                  f"{victim.url} drained")
            else:
                self._idle_ticks[pool] = 0
        return actions

    # -- drain ----------------------------------------------------------------
    def drain_replica(self, rid: str,
                      timeout_s: Optional[float] = None) -> bool:
        """Graceful drain: unpublish from the ring (new keys remap), tell
        the replica to stop admitting (``/admin/drain`` → it 503s fresh
        work), then wait for its queue, batch, and our in-flight count to
        hit zero. True = fully drained within the timeout."""
        r = self.router.get_replica(rid)
        self.router.set_draining(rid, True)
        try:
            # Admin calls share the outbound-call policy (breaker +
            # fault choke point) with dispatch: a replica the breaker
            # already knows is dead is skipped, not re-probed.
            self.router.policy.call(
                r.url + "/admin/drain", data=b"{}",
                headers={"Content-Type": "application/json"},
                timeout=5.0, method="POST", max_attempts=1)
        except Exception as e:  # noqa: BLE001 - maybe already dead
            with r.lock:
                r.last_error = f"drain: {type(e).__name__}: {e}"
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.cfg.drain_timeout_s)
        while time.monotonic() < deadline:
            try:
                m = self.router.policy.call_json(
                    r.url + "/metrics", timeout=2.0, max_attempts=1)
                busy = (int(m.get("queue_depth", 0))
                        + int(m.get("batch_occupancy", 0)))
            except Exception:  # noqa: BLE001 - gone = drained
                busy = 0
            with r.lock:
                inflight = r.inflight
            if busy == 0 and inflight == 0:
                return True
            time.sleep(0.05)
        return False

    # -- rolling weight swap --------------------------------------------------
    def rolling_swap(self, model_path: Optional[str] = None,
                     run_dir: Optional[str] = None,
                     canary_requests: int = 4,
                     canary_timeout_s: float = 60.0,
                     roles: tuple = ("decode", "prefill")) -> dict:
        """Roll a new checkpoint through the fleet, one replica at a
        time, with zero failed requests.

        Per replica: POST ``/admin/swap_weights`` (the engine reshards
        the checkpoint into its live mesh and cuts over between
        iterations — nothing is drained, in-flight requests finish on
        the new weights), mark it CANARY so the router steers only
        ``canary_fraction`` of traffic at it, and watch the router-side
        delivery counters: ``canary_requests`` completions with zero new
        errors promotes it; any error halts the rollout with every
        remaining replica still on the old weights. Decode pools roll
        first by default — they serve the tokens users see, so a bad
        checkpoint is caught at the canary before prefill ever swaps."""
        body = json.dumps({k: v for k, v in
                           (("model_path", model_path),
                            ("run_dir", run_dir)) if v}).encode()
        out: Dict[str, list] = {"swapped": [], "failed": []}
        order = []
        for role in roles:
            for r in sorted(self.router._replica_list(),
                            key=lambda x: x.id):
                with r.lock:
                    up = r.up
                if r.role == role and up:
                    order.append(r)
        for r in order:
            with r.lock:
                ok0, err0 = r.ok_count, r.err_count
            try:
                # Through the shared policy choke point (single attempt:
                # a swap is not idempotent transport — a failure halts
                # the rollout instead of being silently replayed).
                swapped = json.loads(self.router.policy.call(
                    r.url + "/admin/swap_weights", data=body,
                    headers={"Content-Type": "application/json"},
                    timeout=600.0, method="POST", max_attempts=1))
            except Exception as e:  # noqa: BLE001 - halt the rollout
                with r.lock:
                    r.last_error = f"swap: {type(e).__name__}: {e}"
                out["failed"].append({"replica": r.id, "error": str(e)})
                self._log(f"[fleet] swap halted at {r.id}: {e}")
                return out
            with r.lock:
                # now, not at the next scrape: the handoff gate
                # (FleetRouter._same_weights) must see the window open
                r.params_version = int(swapped.get("params_version",
                                                   r.params_version))
            self.router.set_canary(r.id, True)
            deadline = time.monotonic() + canary_timeout_s
            try:
                while time.monotonic() < deadline:
                    with r.lock:
                        oks, errs = r.ok_count, r.err_count
                    if errs > err0 or oks - ok0 >= canary_requests:
                        break
                    time.sleep(0.02)
            finally:
                self.router.set_canary(r.id, False)
            with r.lock:
                oks, errs = r.ok_count, r.err_count
            if errs > err0:
                out["failed"].append({
                    "replica": r.id,
                    "error": f"canary saw {errs - err0} errors"})
                self._log(f"[fleet] swap halted: canary {r.id} errored")
                return out
            out["swapped"].append({
                "replica": r.id, "canary_ok": oks - ok0,
                "params_version": int(swapped.get("params_version", 0))})
            self._log(f"[fleet] {r.id} promoted "
                      f"(params_version={swapped.get('params_version')})")
        return out

    # -- membership sync ------------------------------------------------------
    def sync_membership(self) -> List[str]:
        """Reconcile the router against the fleet directory: adopt newly
        registered live members (scale-up without a router restart) and
        mark members whose heartbeat went stale as down — crash
        detection that beats waiting for ``stale_down_after`` silent
        scrapes when a whole host vanished."""
        if not self.fleet_dir:
            return []
        actions = []
        view = read_fleet(self.fleet_dir,
                          stale_after_s=self.cfg.heartbeat_stale_s)
        known = {r.url: r for r in self.router._replica_list()}
        for m in view["members"]:
            url, role = str(m.get("url", "")), str(m.get("role", "any"))
            if not url:
                continue
            if m["alive"] and url not in known:
                r = self.router.add_replica(url, role=role)
                actions.append(f"adopt {r.id} {url}")
                self._log(f"[fleet] adopted {role} member {url}")
            elif not m["alive"] and url in known:
                r = known[url]
                with r.lock:
                    was_up = r.up
                    if was_up:
                        r.up = False
                        r.last_error = "heartbeat stale"
                if was_up:
                    actions.append(f"reap {r.id}")
                    self._log(f"[fleet] reaped {url} (heartbeat stale)")
        if actions:
            self.router._refresh_ring()
        return actions

    # -- control loop ---------------------------------------------------------
    def tick(self) -> List[str]:
        return self.sync_membership() + self.autoscale_tick()

    def start(self, interval_s: float = 1.0) -> "FleetController":
        if self._thread is None:
            self._stop.clear()

            def loop() -> None:
                while not self._stop.wait(interval_s):
                    try:
                        self.tick()
                    except Exception as e:  # noqa: BLE001 - keep ticking
                        self._log(f"[fleet] tick error: "
                                  f"{type(e).__name__}: {e}")

            self._thread = threading.Thread(target=loop, daemon=True,
                                            name="fleet-controller")
            self._thread.start()
        if self.scope is not None:
            self.scope.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.scope is not None:
            self.scope.stop()


# -- CLI ---------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prefill", default="",
                   help="comma-separated prefill-pool replica URLs")
    p.add_argument("--decode", default="",
                   help="comma-separated decode-pool replica URLs")
    p.add_argument("--fleet-dir", default=None,
                   help="membership directory: replicas registered there "
                        "(server --fleet-dir) are adopted live; stale "
                        "heartbeats are reaped")
    p.add_argument("--config", default=None,
                   help="yaml with a fleet: block (FleetConfig keys)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--canary-fraction", type=float, default=None,
                   help="override fleet.canary_fraction")
    p.add_argument("--trace", action="store_true",
                   help="record route spans (merge with replica traces "
                        "via obs.trace.merge_chrome_traces)")
    p.add_argument("--scope", action="store_true",
                   help="start a scope collector for this fleet "
                        "(scrapes every member + the router, evaluates "
                        "--alerts-config, serves GET /alerts)")
    p.add_argument("--alerts-config", default=None,
                   help="alerts.yaml for --scope (default: "
                        "configs/alerts.yaml when present)")
    p.add_argument("--scope-port", type=int, default=None,
                   help="port for the collector's /alerts + /metrics "
                        "surface (default: router port + 100)")
    p.add_argument("--run-dir", default=None,
                   help="directory for --scope evidence: events.jsonl, "
                        "scope_tsdb/, bundles/ (default: <fleet-dir>/scope "
                        "or ./scope_run)")
    a = p.parse_args(argv)
    cfg = FleetConfig.from_yaml(a.config) if a.config else FleetConfig()
    if a.canary_fraction is not None:
        cfg.canary_fraction = a.canary_fraction
    prefill = [u for u in a.prefill.split(",") if u]
    decode = [u for u in a.decode.split(",") if u]
    if not prefill and not decode and a.fleet_dir:
        # Discover the initial fleet from membership stamps.
        for m in read_fleet(a.fleet_dir,
                            stale_after_s=cfg.heartbeat_stale_s)["members"]:
            (prefill if m.get("role") == "prefill"
             else decode).append(str(m["url"]))
    if not prefill and not decode:
        p.error("need --prefill/--decode URLs or a --fleet-dir with "
                "registered members")
    router = FleetRouter(prefill, decode,
                         canary_fraction=cfg.canary_fraction,
                         handoff_min_prompt_bytes=cfg.handoff_min_prompt_bytes,
                         trace=a.trace)
    scope = None
    if a.scope:
        try:
            from ..obs.scope import Collector, ScopeConfig

            alerts_path = a.alerts_config
            if alerts_path is None and os.path.isfile(
                    os.path.join("configs", "alerts.yaml")):
                alerts_path = os.path.join("configs", "alerts.yaml")
            run_dir = a.run_dir or (os.path.join(a.fleet_dir, "scope")
                                    if a.fleet_dir else "scope_run")
            scope_port = (a.scope_port if a.scope_port is not None
                          else a.port + 100)
            scope = Collector(ScopeConfig(
                targets=[{"name": "router", "role": "router",
                          "url": f"http://{a.host}:{a.port}"}],
                fleet_dir=a.fleet_dir, run_dir=run_dir,
                alerts_path=alerts_path, port=scope_port), log=print)
            print(f"scope: /alerts on port {scope.server.port}"
                  if scope.server else "scope: collector started")
        except Exception as e:  # noqa: BLE001 - observability is optional
            print(f"scope: disabled ({type(e).__name__}: {e})")
    controller = FleetController(router, cfg, fleet_dir=a.fleet_dir,
                                 log=print, scope=scope)
    httpd = serve_router(router, a.host, a.port)
    controller.start()
    print(f"fleet router: {len(prefill)} prefill + {len(decode)} decode "
          f"on http://{a.host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        controller.stop()
        router.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
