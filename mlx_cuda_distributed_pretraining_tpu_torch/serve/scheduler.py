"""Continuous-batching scheduler: admission queue + iteration-level state.

Pure host-side logic (no tensors) so policy is unit-testable without a
device. The engine drives it once per iteration:

1. ``expire(now)``    — evict queued AND running requests past their
   deadline (evicted running requests free their slot immediately:
   iteration-level leave);
2. ``admit(pool)``    — FIFO: bind queued requests to free slots. A
   request that can NEVER fit the pool (prompt + budget > slot capacity)
   is rejected at submit time instead of poisoning the queue head. With
   a paged pool, admission additionally requires enough free BLOCKS for
   the prompt (``pool.allocate(need_tokens)`` returns None otherwise) —
   the queue head waits rather than being skipped, preserving FIFO;
3. the engine then runs ONE prefill chunk for the oldest admitted
   still-prefilling request (prefill interleaves with decode instead of
   stalling it) and ONE batched decode step for every decoding slot;
4. ``finish(req)``    — release the slot, resolve the waiter.

Queue depth is bounded: ``submit`` past ``max_queue`` raises
``QueueFullError`` which the HTTP front end maps to 429.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

# Request lifecycle states
QUEUED = "queued"      # accepted, waiting for a slot
PREFILL = "prefill"    # slot bound, prompt being written chunk by chunk
DECODE = "decode"      # in the batched decode step
DONE = "done"          # resolved (result or error set)


class QueueFullError(Exception):
    """Admission queue at max depth — the HTTP layer returns 429."""


class AdmissionRefusedError(TimeoutError):
    """Admission control: the deadline cannot be met at the current queue
    depth, so the request is refused before costing anything. A
    TimeoutError, so every deadline -> 504 mapping covers it."""


class Request:
    """One in-flight generation request (host-side state + waiter)."""

    _ids = itertools.count()

    def __init__(self, prompt_ids: List[int], max_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 stop_ids: Optional[List[int]] = None):
        self.id = next(Request._ids)
        self.prompt_ids = list(prompt_ids)
        self.max_tokens = int(max_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.stop_ids = set(stop_ids or ())
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + deadline_s
                         if deadline_s else None)
        self.state = QUEUED
        self.slot: Optional[int] = None
        self.prefilled = 0          # prompt tokens written so far
        self.last_token: Optional[int] = None  # fed to the next decode step
        self.generator = None       # per-request torch.Generator (engine-owned)
        self.tokens: List[int] = []
        self.logprobs: List[float] = []
        self.cached_tokens = 0      # prompt tokens adopted from the prefix cache
        self.first_token_at: Optional[float] = None  # TTFT marker
        self.admitted_at: Optional[float] = None  # slot bound (queue_wait end)
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.result: Optional[dict] = None
        self.stream_q: Optional[Any] = None  # queue.Queue when streaming (SSE)
        self.trace_id: Optional[str] = None  # propagated via X-Trace-Id
        # the open decode span (the engine's tracer aggregates decode ticks)
        self._decode_t0: Optional[float] = None
        self._decode_ticks = 0
        self._done = threading.Event()

    # -- waiter --------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def resolve(self, result: Optional[dict] = None,
                error: Optional[str] = None) -> None:
        self.state = DONE
        self.result = result
        self.error = error
        if self.stream_q is not None:
            self.stream_q.put(None)  # end of stream
        self._done.set()

    @property
    def position(self) -> int:
        """Next cache write position: the tokens durably written for this
        request (prompt progress, then prompt + generated-and-fed)."""
        if self.state == PREFILL:
            return self.prefilled
        return len(self.prompt_ids) + max(len(self.tokens) - 1, 0)

    def prefill_source(self) -> List[int]:
        """Tokens to (re)write during prefill: the prompt, plus — after a
        paged-pool preemption released this request's blocks mid-decode —
        everything it had already generated. Recompute-on-resume: the
        re-prefill replays the full sequence so the next sampled token
        continues the chain exactly (greedy output is unchanged by
        preemption)."""
        return self.prompt_ids + self.tokens


class Scheduler:
    def __init__(self, max_queue: int = 32):
        self.max_queue = max_queue
        self.queue: Deque[Request] = deque()  # guarded by self.lock
        self.running: Dict[int, Request] = {}  # guarded by self.lock
        self.lock = threading.Lock()
        # monotonically increasing counters (metrics)
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0
        self.completed = 0
        self.preempted = 0
        # deadline-unmeetable refusals at submit (admission control)
        self.refused = 0
        # EWMA of admit->finish service time, warmed over the first few
        # completions — the queue-wait estimator admission control uses.
        self._ewma_service_s = 0.0
        self._ewma_n = 0
        # Decode batch width (the engine sets this): queued requests
        # drain roughly `concurrency` at a time, so the wait estimate
        # divides by it instead of assuming serial service.
        self.concurrency = 1

    EWMA_ALPHA = 0.2
    EWMA_WARMUP = 4  # completions before the estimator gates admission

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> Request:
        with self.lock:
            if req.deadline is not None and self._ewma_n >= self.EWMA_WARMUP:
                # Refuse a request whose deadline cannot be met at the
                # current queue depth — a clean immediate 504 beats
                # queueing work that will only be evicted after burning
                # prefill compute. The estimator stays silent until
                # warmed, so a fresh engine admits everything (already-
                # expired deadlines then take the eviction path).
                wait_est = (len(self.queue) * self._ewma_service_s
                            / max(self.concurrency, 1))
                if time.monotonic() + wait_est > req.deadline:
                    self.refused += 1
                    raise AdmissionRefusedError(
                        f"deadline unmeetable: ~{wait_est:.2f}s queue wait "
                        f"({len(self.queue)} ahead) exceeds the remaining "
                        "budget")
            if len(self.queue) >= self.max_queue:
                self.rejected += 1
                raise QueueFullError(
                    f"queue full ({self.max_queue} requests waiting)")
            self.queue.append(req)
        return req

    def admit(self, pool) -> List[Request]:
        """Bind FIFO-queued requests to free slots; returns the newly
        admitted requests (now in PREFILL state, nothing written yet).
        Admission is gated on the pool's ACTUAL capacity: a paged pool
        may refuse (None) even with a free batch row when the block arena
        cannot cover the prompt — the head then waits in FIFO order."""
        out: List[Request] = []
        with self.lock:
            while self.queue and pool.num_free > 0:
                req = self.queue[0]
                source = req.prefill_source()
                slot = pool.allocate(len(source), token_ids=source)
                if slot is None:
                    break
                self.queue.popleft()
                req.slot = slot
                req.state = PREFILL
                # A prefix-caching pool may have ADOPTED cached blocks for
                # a leading chunk of the prompt: lengths[slot] is the
                # already-valid KV extent, so prefill resumes there
                # instead of position 0 (0 on non-caching pools).
                req.prefilled = pool.lengths[slot]
                req.cached_tokens = max(req.cached_tokens, req.prefilled)
                req.admitted_at = time.monotonic()
                self.running[slot] = req
                self.admitted += 1
                out.append(req)
        return out

    # -- iteration-level views ----------------------------------------------
    def prefilling(self) -> List[Request]:
        with self.lock:
            return sorted((r for r in self.running.values()
                           if r.state == PREFILL), key=lambda r: r.id)

    def decoding(self) -> List[Request]:
        with self.lock:
            return sorted((r for r in self.running.values()
                           if r.state == DECODE), key=lambda r: r.slot)

    def counters(self) -> Dict[str, int]:
        """Consistent snapshot of the monotonic counters + queue depth,
        taken under the scheduler lock. The engine's metrics paths read
        this instead of the raw attributes — those are guarded, and the
        HTTP threads calling ``/metrics`` race the engine otherwise."""
        with self.lock:
            return {"admitted": self.admitted, "rejected": self.rejected,
                    "evicted": self.evicted, "completed": self.completed,
                    "preempted": self.preempted, "refused": self.refused,
                    "queue_depth": len(self.queue)}

    # -- leave ---------------------------------------------------------------
    def queue_depth(self) -> int:
        with self.lock:
            return len(self.queue)

    def expire(self, pool, now: Optional[float] = None) -> List[Request]:
        """Evict queued and running requests whose deadline has passed.
        Running requests leave the batch mid-flight (slot freed this
        iteration); each evicted request is resolved with an error and
        whatever tokens it had already generated."""
        now = time.monotonic() if now is None else now
        evicted: List[Request] = []
        with self.lock:
            still = deque()
            for r in self.queue:
                if r.deadline is not None and now > r.deadline:
                    evicted.append(r)
                else:
                    still.append(r)
            self.queue = still
            for slot, r in list(self.running.items()):
                if r.deadline is not None and now > r.deadline:
                    del self.running[slot]
                    pool.free(slot)
                    evicted.append(r)
            self.evicted += len(evicted)
        for r in evicted:
            r.finish_reason = "deadline"
            r.resolve(error="deadline exceeded")
        return evicted

    def preempt(self, pool, req: Request) -> None:
        """Release a running request's row/blocks and put it BACK at the
        head of the queue (recompute-on-resume, vLLM-style): when the
        block arena is exhausted mid-decode, the youngest request yields
        its memory so older ones keep advancing. Its generated tokens are
        kept; re-admission re-prefills ``prefill_source()`` and the
        sampling chain continues where it left off."""
        with self.lock:
            if req.slot is not None and req.slot in self.running:
                del self.running[req.slot]
                pool.free(req.slot)
            req.slot = None
            req.state = QUEUED
            req.prefilled = 0
            self.queue.appendleft(req)
            self.preempted += 1

    def finish(self, pool, req: Request, reason: str) -> None:
        """Normal completion: release the slot and mark the finish reason
        (the engine resolves the result dict — it owns detokenization)."""
        with self.lock:
            if req.slot is not None and req.slot in self.running:
                del self.running[req.slot]
                pool.free(req.slot)
            self.completed += 1
            # Feed the admission estimator: slot-bound -> finished is the
            # service time a queued request waits (per concurrency lane).
            if req.admitted_at is not None:
                dur = max(time.monotonic() - req.admitted_at, 0.0)
                if self._ewma_n == 0:
                    self._ewma_service_s = dur
                else:
                    self._ewma_service_s += self.EWMA_ALPHA \
                        * (dur - self._ewma_service_s)
                self._ewma_n += 1
        req.finish_reason = reason

    def drain(self, pool, error: str = "engine stopped") -> None:
        """Resolve everything (engine shutdown)."""
        with self.lock:
            pending = list(self.queue) + list(self.running.values())
            self.queue.clear()
            self.running.clear()
        pool.reset()
        for r in pending:
            if r.state != DONE:
                r.resolve(error=error)
