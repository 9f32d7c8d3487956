"""Device-side input prefetcher: the host-to-device copy off the step loop
(the JAX package's ``data/device_prefetch.py``).

A worker thread pulls host batches from any loader with the
``generate_batch(step)`` surface (``data/memory.py``, ``data/streaming.py``,
``data/token_shards.py``) and keeps up to ``depth`` of them on the device
ahead of the step loop. On ``cuda`` each batch is copied into pinned host
buffers, the host-to-device copy is issued on a dedicated
``torch.cuda.Stream`` and an event is recorded behind it; the worker waits
for that event before it fills the pinned buffers again (a buffer refilled
while its copy still reads it would put the next batch's rows into this
one). :meth:`DevicePrefetcher.get` makes the current stream wait on the
event and calls ``record_stream`` on every tensor it hands out, so the
caching allocator does not give their memory to the copy stream while the
compute stream still reads it. A failure to pin or to copy raises at
``get()``: nothing falls back to a synchronous pageable copy. On the CPU the
batch stays a tensor view of the loader's numpy arrays and nothing is
pinned.

Checkpoint contract: :meth:`state_dict` is the position of the last batch
the trainer CONSUMED through ``get()``, not the last one fetched: batches
waiting in the queue have not been trained on. Stream-stateful loaders
(``stream_stateful``: ``StreamingDataManager``) are snapshot after each
fetch and the consumed batch's snapshot is reported; loaders whose batch
is a function of the step delegate live.

``depth <= 0`` is the synchronous mode: no worker thread, each ``get()``
fetches and copies inline through the same code.

Not ported: a device mesh (ROADMAP queue 1 item 10), the group mode of
``system.steps_per_dispatch``, and the metrics registry (item 9).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class DevicePrefetcher:
    """Serves device-resident batches for data steps ``start_step``,
    ``start_step + 1``, ...: ``get()`` returns ``(batch, tokens, waits)``,
    the trainer's ``generate_batch(step - 1)`` convention."""

    def __init__(self, loader: Any, device="cpu", depth: int = 2, start_step: int = 0,
                 total_steps: Optional[int] = None, mesh: Any = None):
        if mesh is not None:
            raise NotImplementedError(
                "DevicePrefetcher over a device mesh is not ported "
                "(ROADMAP queue 1 item 10: multi-GPU)")
        self.loader = loader
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"DevicePrefetcher runs on cuda or cpu, not {self.device}")
        self.depth = int(depth)
        self.total_steps = total_steps  # None: run until StopIteration

        self._stateful = bool(getattr(loader, "stream_stateful", False))
        # Taken before the worker fetches anything: a checkpoint before the
        # first get() must not see the worker's position.
        self._initial_state = loader.state_dict() if self._stateful else None
        self._consumed_state: Optional[Dict[str, Any]] = None

        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pinned: Dict[str, torch.Tensor] = {}  # the worker's host buffers
        self._cursor = int(start_step) + 1  # next trainer step to feed
        self._done = False
        # Once an end or error item is consumed the worker has exited: repeat
        # that outcome instead of blocking on the queue.
        self._terminal: Optional[Dict[str, Any]] = None

        self._queue: Optional[queue.Queue] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Synchronous mode copies inside get(), so h2d_wait_s is time the
        # step loop waited; with the worker it overlaps the step, and any
        # stall shows in data_wait_s (items are queued after their copy).
        self.h2d_blocks_consumer = self.depth <= 0
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(
                target=self._worker, daemon=True, name="device-prefetch")
            self._thread.start()

    # -- producer ------------------------------------------------------------
    def _produce_one(self) -> Dict[str, Any]:
        """Fetch the next host batch, copy it to the device and advance the
        cursor. Errors become items, raised at the consumer's ``get()``."""
        if self._done or (
                self.total_steps is not None and self._cursor > self.total_steps):
            self._done = True
            return {"kind": "end"}
        step = self._cursor
        t0 = time.perf_counter()
        try:
            host = self.loader.generate_batch(step - 1)
            snapshot = self.loader.state_dict() if self._stateful else None
        except StopIteration:
            self._done = True
            return {"kind": "end"}
        except Exception as exc:  # a loader error (e.g. the streaming producer's)
            self._done = True
            return {"kind": "error", "error": exc}
        fetch_s = time.perf_counter() - t0
        tokens = int(host["mask"].sum())  # non-pad targets, counted on the host
        t0 = time.perf_counter()
        try:
            batch, event = self._transfer(host)
        except Exception as exc:  # pinning or the copy failed: no silent fallback
            self._done = True
            return {"kind": "error", "error": exc}
        h2d_s = time.perf_counter() - t0
        self._cursor = step + 1
        return {"kind": "batch", "batch": batch, "event": event, "tokens": tokens,
                "snapshot": snapshot, "fetch_s": fetch_s, "h2d_s": h2d_s}

    def _transfer(self, host: Dict[str, np.ndarray]):
        """``(device batch, copy event)``: on ``cuda`` through the pinned
        buffers and the copy stream, on the CPU views of the arrays."""
        if not self._cuda:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}, None
        pinned = {}
        for k, v in host.items():
            src = torch.from_numpy(np.asarray(v))
            buf = self._pinned.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                self._pinned[k] = buf
            buf.copy_(src)
            pinned[k] = buf
        with torch.cuda.stream(self._copy_stream):
            batch = {k: b.to(self.device, non_blocking=True) for k, b in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        # The pinned buffers are refilled by the next fetch: only once this
        # copy has read them. (The wait is this thread's, not the step loop's.)
        event.synchronize()
        return batch, event

    def _worker(self) -> None:
        while not self._stop_evt.is_set():
            item = self._produce_one()
            while not self._stop_evt.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if item["kind"] in ("end", "error"):
                return

    # -- consumer ------------------------------------------------------------
    def get(self):
        """The next batch on the device: ``(batch, tokens, waits)``.

        ``tokens`` is the batch's non-pad target count. ``waits`` has
        ``data_wait_s`` (how long this call waited for the batch) and
        ``h2d_wait_s`` (the item's host-to-device copy: overlapped with the
        step when the worker runs, on the step loop's path in synchronous
        mode). Raises StopIteration at the end of the stream and re-raises
        the loader's or the copy's error."""
        if self._terminal is not None:
            item = self._terminal
            data_wait = 0.0
        elif self._queue is None:
            item = self._produce_one()
            data_wait = item.get("fetch_s", 0.0)
        else:
            t0 = time.perf_counter()
            item = self._queue.get()
            data_wait = time.perf_counter() - t0
        if item["kind"] == "error":
            self._terminal = item
            raise item["error"]
        if item["kind"] == "end":
            self._terminal = item
            raise StopIteration("stream exhausted")
        if item["snapshot"] is not None:
            self._consumed_state = item["snapshot"]
        batch = item["batch"]
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item["event"])
            for t in batch.values():
                t.record_stream(stream)
        return batch, item["tokens"], {"data_wait_s": data_wait,
                                       "h2d_wait_s": item["h2d_s"]}

    # -- loader surface ------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The loader position as the trainer CONSUMED it, stamped with the
        world it was taken under (``process_count``, ``process_index``)."""
        if self._stateful:
            state = (dict(self._consumed_state) if self._consumed_state is not None
                     else dict(self._initial_state))
        else:
            state = self.loader.state_dict()
        if isinstance(state, dict):
            for key in ("process_count", "process_index"):
                stamp = getattr(self.loader, key, None)
                if stamp is not None:
                    state.setdefault(key, int(stamp))
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.loader.load_state_dict(state)

    def stop(self) -> None:
        """Stop the worker thread. The loader is left running: the trainer
        owns it (validation may still read it)."""
        self._stop_evt.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
