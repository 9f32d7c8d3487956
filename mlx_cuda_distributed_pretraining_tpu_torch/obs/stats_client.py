"""Stats client: background-thread WebSocket publisher with reconnect,
offline buffering and heartbeats (the JAX package's ``obs/stats_client.py``;
it speaks the same protocol to either package's :mod:`.stats_server`).

``websockets`` is optional: without it the client keeps its messages in the
bounded offline buffer and sends nothing.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

BUFFER_LIMIT = 1000  # offline buffer size


class StatsClient:
    """Fire-and-forget metrics publisher. All network work happens on a
    daemon thread; the training loop only does a queue put."""

    def __init__(self, url: str, worker_id: str, heartbeat_interval: float = 10.0,
                 reconnect_delay: float = 2.0):
        self.url = url
        self.worker_id = worker_id
        self.heartbeat_interval = heartbeat_interval
        self.reconnect_delay = reconnect_delay
        self._outbox: "queue.Queue[Optional[str]]" = queue.Queue()
        self._buffer: deque = deque(maxlen=BUFFER_LIMIT)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.connected = False
        self.sent = 0

    # -- public API ----------------------------------------------------------
    def start(self) -> "StatsClient":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def register(self, capabilities: Optional[Dict[str, Any]] = None) -> None:
        self._enqueue({"type": "register", "worker_id": self.worker_id,
                       "capabilities": capabilities or {}})

    def log_metrics(self, step: int, data: Dict[str, Any]) -> None:
        self._enqueue({"type": "metrics", "worker_id": self.worker_id,
                       "step": step, "data": data})

    def close(self) -> None:
        self._stop.set()
        self._outbox.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- internals -----------------------------------------------------------
    def _enqueue(self, msg: Dict[str, Any]) -> None:
        self._outbox.put(json.dumps(msg))

    def _run(self) -> None:
        asyncio.run(self._loop())

    async def _loop(self) -> None:
        try:
            import websockets  # deferred: optional dependency
        except ImportError:
            # No transport available: keep draining the outbox into the
            # bounded ring so callers' messages are retained (and memory
            # stays capped) exactly as in the server-down case.
            while True:
                item = await asyncio.get_running_loop().run_in_executor(
                    None, self._outbox.get)
                if item is None:
                    return
                self._buffer.append(item)
        while not self._stop.is_set():
            try:
                async with websockets.connect(self.url, open_timeout=5) as ws:
                    self.connected = True
                    # flush anything buffered while offline
                    while self._buffer:
                        await ws.send(self._buffer.popleft())
                        self.sent += 1
                    await self._pump(ws)
            except Exception:
                self.connected = False
                # Keep the offline buffer bounded: drain pending outbox
                # messages into the ring so memory can't grow unboundedly
                # while the server is down (1000-message cap).
                try:
                    while True:
                        item = self._outbox.get_nowait()
                        if item is not None:
                            self._buffer.append(item)
                except queue.Empty:
                    pass
                if self._stop.is_set():
                    return
                await asyncio.sleep(self.reconnect_delay)

    async def _pump(self, ws) -> None:
        last_beat = time.monotonic()
        loop = asyncio.get_running_loop()
        while not self._stop.is_set():
            timeout = max(0.1, self.heartbeat_interval - (time.monotonic() - last_beat))
            try:
                item = await loop.run_in_executor(None, self._outbox.get, True, timeout)
            except queue.Empty:
                item = "__beat__"
            if item is None:
                return
            if item == "__beat__" or time.monotonic() - last_beat >= self.heartbeat_interval:
                await ws.send(json.dumps({"type": "heartbeat", "worker_id": self.worker_id}))
                last_beat = time.monotonic()
            if item != "__beat__":
                try:
                    await ws.send(item)
                    self.sent += 1
                except Exception:
                    self._buffer.append(item)  # keep for the reconnect flush
                    raise
