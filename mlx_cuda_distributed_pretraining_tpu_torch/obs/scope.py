"""The scope collector: the fleet-wide SLO control plane (the JAX
package's ``obs/scope.py``; its TSDB, events and bundle layout are the
same, so either package's collector can watch the other's processes).

One Collector watches a whole deployment: it discovers targets from the
fleet-dir membership (serve/fleet.py) plus static config, scrapes every
``/metrics`` endpoint each round *through the serve CallPolicy* (per-
destination circuit breakers and a deadline per scrape, so one sick
replica can never wedge the round), appends every sample into the
scope TSDB (obs/tsdb.py), and evaluates the declarative alert rules
(obs/alerts.py).  Alert transitions are appended as ``alert`` events to
the run's events.jsonl, exposed on ``GET /alerts`` and as a
``graftscope_alerts_firing{rule}`` gauge (the JAX package's metric
names), and mapped through the rule's ``actions:`` list to capture hooks:

  trace    SIGUSR2 to every local heartbeat pid (the trainer captures a
           Chrome trace of its next steps on SIGUSR2)
  profile  an injected ``obs/profiler.py`` ProfileCapture (a
           ``torch.profiler`` session) when the owner runs in the
           trainer process; falls back to the SIGUSR2 path otherwise
  bundle   debug-bundle: snapshot /metrics, /trace, /snapshot from every
           member plus heartbeat files and the events.jsonl tail into
           run_dir/bundles/<alert>_<ts>/ for postmortem

Determinism: the clock is injectable (``now_fn``) and every public
entry point takes an explicit ``now`` — the chaos drill drives a logical
clock and scripted targets and asserts a bit-identical alert timeline
across runs.  Targets are scraped in sorted-name order and rules are
evaluated in config order for the same reason.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import events as ev
from .alerts import RuleEngine, load_rules
from .metrics import MetricsRegistry
from .prometheus import MetricsServer
from .tsdb import TSDB
from ..serve.policy import CallPolicy, Deadline, PolicyConfig

TSDB_DIRNAME = "scope_tsdb"
BUNDLES_DIRNAME = "bundles"

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')
_JSON_KEY = re.compile(r"[^a-zA-Z0-9_]")


def parse_prom_text(body: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus text exposition → [(name, labels, value)] samples."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in body.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(_PROM_LABEL.findall(raw_labels)) if raw_labels else {}
        out.append((name, labels, value))
    return out


def parse_json_metrics(doc: Any) -> List[Tuple[str, Dict[str, str], float]]:
    """Flat JSON /metrics (serve engine) → numeric top-level samples."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    if not isinstance(doc, dict):
        return out
    for k, v in doc.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out.append((_JSON_KEY.sub("_", str(k)), {}, float(v)))
    return out


class ScopeConfig:
    """The ``scope:`` config block (serve-sample.yaml / model config)."""

    def __init__(self,
                 interval_s: float = 5.0,
                 targets: Optional[List[Any]] = None,
                 fleet_dir: Optional[str] = None,
                 run_dir: Optional[str] = None,
                 tsdb_dir: Optional[str] = None,
                 alerts_path: Optional[str] = None,
                 rules: Optional[List[Dict[str, Any]]] = None,
                 port: Optional[int] = None,
                 scrape_timeout_s: float = 2.0,
                 stale_after_s: float = 10.0,
                 max_points: int = 4096,
                 events_tail_lines: int = 200) -> None:
        self.interval_s = float(interval_s)
        self.targets = list(targets or [])
        self.fleet_dir = fleet_dir
        self.run_dir = run_dir
        self.tsdb_dir = tsdb_dir or (
            os.path.join(run_dir, TSDB_DIRNAME) if run_dir else None)
        self.alerts_path = alerts_path
        self.rules = rules
        self.port = port
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.stale_after_s = float(stale_after_s)
        self.max_points = int(max_points)
        self.events_tail_lines = int(events_tail_lines)

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "ScopeConfig":
        known = {k: v for k, v in (doc or {}).items()
                 if k in ("interval_s", "targets", "fleet_dir", "run_dir",
                          "tsdb_dir", "alerts_path", "rules", "port",
                          "scrape_timeout_s", "stale_after_s", "max_points",
                          "events_tail_lines")}
        return cls(**known)

    @classmethod
    def from_yaml(cls, path: str) -> "ScopeConfig":
        from ..config import read_config_dict

        doc = read_config_dict(path) or {}
        return cls.from_dict(doc.get("scope", {}) or {})


def _target_entry(t: Any) -> Dict[str, str]:
    if isinstance(t, str):
        name = t.split("//", 1)[-1].replace(":", "_").replace("/", "_")
        return {"name": name, "url": t.rstrip("/"), "role": "static"}
    return {"name": str(t.get("name") or t.get("url", "?")),
            "url": str(t.get("url", "")).rstrip("/"),
            "role": str(t.get("role", "static"))}


class Collector:
    """Scrape → store → evaluate → act, one round at a time.

    The collection loop runs on a single daemon thread; HTTP readers
    (``GET /alerts``) only ever see immutable snapshot dicts handed over
    under ``self._lock``.
    """

    def __init__(self, cfg: ScopeConfig,
                 policy: Optional[CallPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 now_fn: Callable[[], float] = time.time,
                 log: Callable[[str], None] = lambda s: None,
                 profile_capture: Any = None,
                 action_hooks: Optional[Dict[str, Callable]] = None) -> None:
        self.cfg = cfg
        self.now_fn = now_fn
        self.log = log
        self.db = TSDB(cfg.tsdb_dir, max_points=cfg.max_points)
        rules = list(cfg.rules or [])
        if cfg.alerts_path:
            rules = load_rules(cfg.alerts_path)
        self.engine = RuleEngine(rules, self.db)
        self.registry = registry or MetricsRegistry()
        # Scrapes ride the serving fleet's call policy semantics: one
        # attempt per round (the next round IS the retry), deadline per
        # scrape, breaker per destination.
        self.policy = policy or CallPolicy(PolicyConfig(max_attempts=1))
        self.profile_capture = profile_capture
        self._mg_up = self.registry.gauge(
            "graftscope_scrape_up", "1 when the last scrape succeeded")
        self._mg_scrape_ms = self.registry.gauge(
            "graftscope_scrape_ms", "last scrape duration per target")
        self._mc_samples = self.registry.counter(
            "graftscope_samples_total", "samples appended to the tsdb")
        self._mc_errors = self.registry.counter(
            "graftscope_scrape_errors_total", "failed scrapes by target")
        self._mc_rounds = self.registry.counter(
            "graftscope_rounds_total", "completed collection rounds")
        self._mg_firing = self.registry.gauge(
            "graftscope_alerts_firing", "1 while the rule is firing")
        self.events: Optional[ev.EventLog] = None
        if cfg.run_dir:
            os.makedirs(cfg.run_dir, exist_ok=True)
            self.events = ev.EventLog(ev.events_path(cfg.run_dir),
                                      now=now_fn)
        self._hooks: Dict[str, Callable] = {
            "trace": self._act_trace,
            "profile": self._act_profile,
            "bundle": self._act_bundle,
        }
        self._hooks.update(action_hooks or {})
        self._lock = threading.Lock()
        self._alerts_snapshot: Dict[str, Any] = {"alerts": [],
                                                 "timeline": []}  # guarded by self._lock
        self._timeline: List[Dict[str, Any]] = []  # guarded by self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.server: Optional[MetricsServer] = None
        if cfg.port is not None:
            self.server = MetricsServer(
                self.registry, port=int(cfg.port),
                extra_routes={"/alerts": self._alerts_route})

    # ------------------------------------------------------- discovery

    def targets(self) -> List[Dict[str, str]]:
        """Static targets + live fleet membership, sorted by name."""
        out = [_target_entry(t) for t in self.cfg.targets]
        if self.cfg.fleet_dir:
            try:
                from ..serve.fleet import read_fleet

                view = read_fleet(self.cfg.fleet_dir,
                                  stale_after_s=self.cfg.stale_after_s)
                for m in view.get("members", []):
                    url = str(m.get("url", "")).rstrip("/")
                    if not url or not m.get("alive", True):
                        continue
                    out.append({
                        "name": "%s%s" % (m.get("role", "replica"),
                                          m.get("index", 0)),
                        "url": url,
                        "role": str(m.get("role", "replica")),
                    })
            except Exception:
                pass
        seen = set()
        uniq = []
        for t in sorted(out, key=lambda d: d["name"]):
            if t["url"] in seen:
                continue
            seen.add(t["url"])
            uniq.append(t)
        return uniq

    # --------------------------------------------------------- scraping

    def _fetch(self, url: str) -> bytes:
        deadline = Deadline(time.monotonic() + self.cfg.scrape_timeout_s)
        return self.policy.call(url, timeout=self.cfg.scrape_timeout_s,
                                deadline=deadline, max_attempts=1,
                                method="GET")

    def scrape_target(self, target: Dict[str, str],
                      now: float) -> int:
        """Scrape one member; returns samples stored (0 on failure).

        ``?format=prom`` makes every surface answer its richest format:
        MetricsServer and the router return text exposition, the serve
        engine's JSON endpoint ignores the query — the body's first
        byte tells the parser which it got.
        """
        name = target["name"]
        t0 = time.monotonic()
        try:
            body = self._fetch(target["url"] + "/metrics?format=prom")
        except Exception:
            self._mg_up.set(0, instance=name)
            self._mc_errors.inc(instance=name)
            return 0
        finally:
            self._mg_scrape_ms.set(
                round((time.monotonic() - t0) * 1000.0, 3), instance=name)
        text = body.decode("utf-8", "replace").lstrip()
        if text.startswith("{"):
            try:
                samples = parse_json_metrics(json.loads(text))
            except ValueError:
                samples = []
        else:
            samples = parse_prom_text(text)
        for mname, labels, value in samples:
            labels = dict(labels)
            labels["instance"] = name
            self.db.append(mname, labels, now, value)
        self._mg_up.set(1, instance=name)
        if samples:
            self._mc_samples.inc(len(samples))
        return len(samples)

    # ------------------------------------------------------- collection

    def collect_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full round: scrape all targets, evaluate rules, act."""
        if now is None:
            now = self.now_fn()
        targets = self.targets()
        up = 0
        for t in targets:
            if self.scrape_target(t, now) > 0:
                up += 1
        transitions = self.engine.evaluate(now)
        if transitions:
            with self._lock:
                self._timeline.extend(transitions)
        for tr in transitions:
            if self.events is not None:
                self.events.append("alert", rule=tr["rule"],
                                   from_state=tr["from"],
                                   to_state=tr["to"], value=tr["value"])
            self.log("scope: alert %s %s -> %s (value=%s)"
                     % (tr["rule"], tr["from"], tr["to"], tr["value"]))
        for st in self.engine.states:
            self._mg_firing.set(1 if st.state == "firing" else 0,
                                rule=st.rule["name"])
        # Capture actions run AFTER the gauges update so a bundle's own
        # /metrics snapshots already show the alert firing.
        fired = [tr for tr in transitions if tr["to"] == "firing"]
        for tr in fired:
            st = next(s for s in self.engine.states
                      if s.rule["name"] == tr["rule"])
            for action in st.rule.get("actions", []):
                hook = self._hooks.get(action)
                if hook is None:
                    continue
                try:
                    hook(st.snapshot(), now, targets)
                except Exception:
                    # Capture is best-effort evidence; never let it take
                    # down the control loop.
                    pass
        self._mc_rounds.inc()
        snap = self.engine.snapshot()
        snap["t"] = now
        with self._lock:
            snap["timeline"] = list(self._timeline[-256:])
            self._alerts_snapshot = snap
        return {"t": now, "targets": len(targets), "up": up,
                "transitions": transitions}

    # ---------------------------------------------------------- actions

    def _heartbeat_pids(self) -> List[int]:
        pids = []
        if not self.cfg.run_dir:
            return pids
        try:
            names = os.listdir(self.cfg.run_dir)
        except OSError:
            return pids
        for fname in names:
            if "heartbeat" not in fname or not fname.endswith(".json"):
                continue
            hb = ev.read_heartbeat(os.path.join(self.cfg.run_dir, fname))
            pid = (hb or {}).get("pid")
            if isinstance(pid, int) and pid > 0:
                pids.append(pid)
        return sorted(set(pids))

    def _act_trace(self, alert: Dict[str, Any], now: float,
                   targets: List[Dict[str, str]]) -> None:
        """SIGUSR2 every local heartbeat pid — the trainer's handler
        captures a chrome trace of the next steps."""
        for pid in self._heartbeat_pids():
            try:
                os.kill(pid, signal.SIGUSR2)
            except (OSError, AttributeError):
                pass

    def _act_profile(self, alert: Dict[str, Any], now: float,
                     targets: List[Dict[str, str]]) -> None:
        """In-process ProfileCapture when the owner wired one (trainer
        sidecar); otherwise the SIGUSR2 path doubles as the capture."""
        pc = self.profile_capture
        if pc is not None:
            try:
                pc.start(int(now))
                return
            except Exception:
                pass
        self._act_trace(alert, now, targets)

    def _act_bundle(self, alert: Dict[str, Any], now: float,
                    targets: List[Dict[str, str]]) -> None:
        self.collect_bundle(alert, now, targets)

    def collect_bundle(self, alert: Dict[str, Any], now: float,
                       targets: Optional[List[Dict[str, str]]] = None,
                       ) -> Optional[str]:
        """Snapshot evidence from every member into
        ``run_dir/bundles/<alert>_<ts>/``; returns the bundle dir."""
        if not self.cfg.run_dir:
            return None
        if targets is None:
            targets = self.targets()
        bdir = os.path.join(self.cfg.run_dir, BUNDLES_DIRNAME,
                            "%s_%d" % (alert.get("rule", "alert"), int(now)))
        os.makedirs(bdir, exist_ok=True)
        with open(os.path.join(bdir, "alert.json"), "w") as fh:
            json.dump({"alert": alert, "t": now,
                       "members": [t["name"] for t in targets]},
                      fh, indent=2, sort_keys=True)
        for t in targets:
            tdir = os.path.join(bdir, t["name"])
            os.makedirs(tdir, exist_ok=True)
            for path, fname in (("/metrics?format=prom", "metrics.txt"),
                                ("/trace", "trace.json"),
                                ("/snapshot", "snapshot.json")):
                try:
                    body = self._fetch(t["url"] + path)
                except Exception:
                    continue
                with open(os.path.join(tdir, fname), "wb") as fh:
                    fh.write(body)
        # Local run-dir evidence: heartbeats + the events tail.
        try:
            for fname in os.listdir(self.cfg.run_dir):
                if "heartbeat" in fname and fname.endswith(".json"):
                    shutil.copy2(os.path.join(self.cfg.run_dir, fname),
                                 os.path.join(bdir, fname))
        except OSError:
            pass
        epath = ev.events_path(self.cfg.run_dir)
        if os.path.exists(epath):
            try:
                with open(epath, "rb") as fh:
                    lines = fh.read().splitlines(keepends=True)
                with open(os.path.join(bdir, "events_tail.jsonl"),
                          "wb") as fh:
                    fh.writelines(lines[-self.cfg.events_tail_lines:])
            except OSError:
                pass
        if self.events is not None:
            self.events.append("bundle", rule=alert.get("rule"),
                               dir=os.path.relpath(bdir, self.cfg.run_dir))
        return bdir

    # ------------------------------------------------------- http + loop

    def _alerts_route(self) -> Tuple[bytes, str]:
        with self._lock:
            snap = self._alerts_snapshot
        return ((json.dumps(snap, sort_keys=True) + "\n").encode(),
                "application/json")

    def alerts(self) -> Dict[str, Any]:
        with self._lock:
            return self._alerts_snapshot

    def start(self, interval_s: Optional[float] = None) -> None:
        """Start the collection loop on a daemon thread (idempotent)."""
        if self._thread is not None:
            return
        interval = float(interval_s if interval_s is not None
                         else self.cfg.interval_s)

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.collect_once()
                except Exception:
                    pass
                self._stop.wait(interval)

        self._thread = threading.Thread(
            target=loop, name="scope-collector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.server is not None:
            self.server.shutdown()
            self.server = None


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone collector: ``python -m ...obs.scope --fleet-dir ...``."""
    import argparse

    p = argparse.ArgumentParser(description="scope fleet collector")
    p.add_argument("--target", action="append", default=[],
                   help="static target base URL (repeatable)")
    p.add_argument("--fleet-dir", default=None,
                   help="fleet membership dir (serve/fleet.py)")
    p.add_argument("--run-dir", default=None,
                   help="run dir for events.jsonl, tsdb and bundles")
    p.add_argument("--alerts-config", default=None,
                   help="alerts.yaml with the rule set")
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--port", type=int, default=None,
                   help="serve GET /alerts and /metrics on this port")
    args = p.parse_args(argv)
    cfg = ScopeConfig(interval_s=args.interval, targets=args.target,
                      fleet_dir=args.fleet_dir, run_dir=args.run_dir,
                      alerts_path=args.alerts_config, port=args.port)
    collector = Collector(cfg, log=print)
    if collector.server is not None:
        print("scope: /alerts on port %d" % collector.server.port)
    collector.start()
    try:
        while True:
            time.sleep(3600.0)
    except KeyboardInterrupt:
        collector.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
