"""WebSocket stats hub for multi-worker training runs.

The JAX package's ``obs/stats_server.py``: an asyncio WebSocket hub with a
client registry, initial-state sync of server info / per-worker stats /
aggregated stats / history, broadcast on update, a 1000-entry ring history
and periodic JSON persistence. ``websockets`` is optional and imported only
by :meth:`StatsServer.serve`. ``--http-port`` also serves the live
dashboard page (``obs/dashboard.py``).

Protocol (JSON messages):
  worker -> server: {"type": "register", "worker_id", "capabilities"}
                    {"type": "metrics",  "worker_id", "step", "data": {...}}
                    {"type": "heartbeat","worker_id"}
  server -> client: {"type": "initial_state", "server": {...},
                     "workers": {...}, "aggregated": {...}, "history": [...]}
                    {"type": "update", "workers": {...}, "aggregated": {...}}
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional, Set

HISTORY_LIMIT = 1000  # ring size
# Drop a worker entirely once it has been silent this long (vs the 60s
# "alive" window used for alive_workers): long multi-restart runs rotate
# worker ids, and without eviction num_workers grows forever.
WORKER_TTL_S = 600.0


class StatsState:
    """Pure state container so aggregation logic is testable without IO."""

    def __init__(self, history_limit: int = HISTORY_LIMIT,
                 worker_ttl_s: float = WORKER_TTL_S):
        self.started = time.time()
        self.workers: Dict[str, Dict[str, Any]] = {}
        self.history: deque = deque(maxlen=history_limit)
        self.worker_ttl_s = float(worker_ttl_s)

    def evict_stale(self, now: Optional[float] = None) -> int:
        """Forget workers silent past the TTL; returns how many were
        evicted. TTL <= 0 disables eviction."""
        if self.worker_ttl_s <= 0:
            return 0
        now = time.time() if now is None else now
        stale = [wid for wid, w in self.workers.items()
                 if now - w.get("last_seen", 0) > self.worker_ttl_s]
        for wid in stale:
            del self.workers[wid]
        return len(stale)

    def handle(self, msg: Dict[str, Any]) -> bool:
        """Apply one worker message; returns True when state changed in a
        way worth broadcasting."""
        mtype = msg.get("type")
        wid = str(msg.get("worker_id", "unknown"))
        now = time.time()
        if mtype == "register":
            self.workers[wid] = {
                "capabilities": msg.get("capabilities", {}),
                "registered_at": now,
                "last_seen": now,
                "metrics": {},
            }
            return True
        if mtype == "heartbeat":
            if wid in self.workers:
                self.workers[wid]["last_seen"] = now
            else:
                self.workers[wid] = {"capabilities": {}, "registered_at": now,
                                     "last_seen": now, "metrics": {}}
            return False
        if mtype == "metrics":
            w = self.workers.setdefault(
                wid, {"capabilities": {}, "registered_at": now, "metrics": {}})
            w["last_seen"] = now
            w["metrics"] = dict(msg.get("data", {}))
            w["step"] = msg.get("step")
            entry = {"t": now, "worker_id": wid, "step": msg.get("step"),
                     **{k: v for k, v in msg.get("data", {}).items()
                        if isinstance(v, (int, float))}}
            self.history.append(entry)
            return True
        return False

    def aggregated(self) -> Dict[str, Any]:
        """Cross-worker aggregate: mean loss, summed throughput, max step
        Serving engines (serve/engine.py) report through the same
        protocol; their gauges aggregate under ``serve_*`` keys ONLY when
        present, so training-only runs keep the original shape."""
        losses, toks = [], 0.0
        max_step = 0
        alive = 0
        queue_depth, occupancy, serve_workers = 0, 0, 0
        data_waits = []
        mfus = []
        now = time.time()
        self.evict_stale(now)
        for w in self.workers.values():
            m = w.get("metrics", {})
            if now - w.get("last_seen", 0) < 60:
                alive += 1
            if isinstance(m.get("loss"), (int, float)):
                losses.append(float(m["loss"]))
            if isinstance(m.get("tok/s"), (int, float)):
                toks += float(m["tok/s"])
            if isinstance(w.get("step"), int):
                max_step = max(max_step, w["step"])
            if isinstance(m.get("batch_occupancy"), (int, float)):
                serve_workers += 1
                occupancy += int(m["batch_occupancy"])
                queue_depth += int(m.get("queue_depth", 0) or 0)
            if isinstance(m.get("data_wait_frac"), (int, float)):
                data_waits.append(float(m["data_wait_frac"]))
            if isinstance(m.get("mfu"), (int, float)):
                mfus.append(float(m["mfu"]))
        agg = {
            "num_workers": len(self.workers),
            "alive_workers": alive,
            "mean_loss": sum(losses) / len(losses) if losses else None,
            "total_tok_s": toks,
            "max_step": max_step,
        }
        if serve_workers:
            agg["serve_engines"] = serve_workers
            agg["serve_occupancy"] = occupancy
            agg["serve_queue_depth"] = queue_depth
        if data_waits:
            # Input-pipeline health across trainers: fraction of wall clock
            # the step loop spent waiting for data (device_prefetch.py).
            agg["mean_data_wait_frac"] = sum(data_waits) / len(data_waits)
        if mfus:
            # Hardware efficiency across trainers (obs/flops.py); workers on
            # undetectable chips report mfu=unknown and are excluded.
            agg["mean_mfu"] = sum(mfus) / len(mfus)
        return agg

    def snapshot(self) -> Dict[str, Any]:
        return {
            "type": "initial_state",
            "server": {"started": self.started, "uptime_s": time.time() - self.started},
            "workers": self.workers,
            "aggregated": self.aggregated(),
            "history": list(self.history)[-50:],  # the last 50
        }

    def update_msg(self) -> Dict[str, Any]:
        return {"type": "update", "workers": self.workers,
                "aggregated": self.aggregated()}


class StatsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 persist_path: Optional[str] = None, persist_interval: float = 30.0,
                 worker_ttl_s: float = WORKER_TTL_S):
        self.host = host
        self.port = port
        self.state = StatsState(worker_ttl_s=worker_ttl_s)
        self.persist_path = persist_path
        self.persist_interval = persist_interval
        self._clients: Set[Any] = set()
        self._server = None
        self._stop = asyncio.Event()

    async def _broadcast(self, msg: Dict[str, Any]) -> None:
        if not self._clients:
            return
        data = json.dumps(msg)
        dead = []
        for ws in self._clients:
            try:
                await ws.send(data)
            except Exception:
                dead.append(ws)
        for ws in dead:
            self._clients.discard(ws)

    async def _handler(self, ws) -> None:
        self._clients.add(ws)
        try:
            await ws.send(json.dumps(self.state.snapshot()))
            async for raw in ws:
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                if self.state.handle(msg):
                    await self._broadcast(self.state.update_msg())
        except Exception:
            pass
        finally:
            self._clients.discard(ws)

    async def _persist_loop(self) -> None:
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(), self.persist_interval)
            except asyncio.TimeoutError:
                pass
            if self.persist_path:
                self.persist()

    def persist(self) -> None:
        # Temp + rename: a crash mid-dump must never truncate the previous
        # good snapshot (same atomic-write ethos as checkpoint manifests).
        if not self.persist_path:
            return
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"workers": self.state.workers,
                       "aggregated": self.state.aggregated(),
                       "history": list(self.state.history)}, f, indent=2)
        os.replace(tmp, self.persist_path)

    async def serve(self) -> None:
        import websockets  # deferred: optional dependency

        async with websockets.serve(self._handler, self.host, self.port) as server:
            self._server = server
            persist = asyncio.create_task(self._persist_loop())
            await self._stop.wait()
            persist.cancel()
        if self.persist_path:
            self.persist()

    def stop(self) -> None:
        self._stop.set()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Training stats WebSocket hub")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--persist", default=None, help="JSON persistence path")
    parser.add_argument("--http-port", type=int, default=0,
                        help="also serve the live dashboard page on this port")
    parser.add_argument("--worker-ttl", type=float, default=WORKER_TTL_S,
                        help="forget workers silent this many seconds "
                             "(0 disables eviction)")
    a = parser.parse_args(argv)
    server = StatsServer(a.host, a.port, a.persist, worker_ttl_s=a.worker_ttl)
    httpd = None
    if a.http_port:
        from .dashboard import serve_dashboard

        httpd = serve_dashboard(a.host, a.http_port, ws_port=a.port)
        print(f"dashboard: http://{a.host}:{a.http_port}/ (ws on :{a.port})")
    try:
        asyncio.run(server.serve())
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        if httpd is not None:
            httpd.shutdown()


if __name__ == "__main__":
    main()
