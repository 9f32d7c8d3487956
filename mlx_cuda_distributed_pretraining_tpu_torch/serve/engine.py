"""The continuous-batching engine thread.

``BatchEngine`` owns the model params, the paged KV pool and the scheduler,
and runs one iteration loop on a background thread:

    evict expired -> admit queued -> one prefill chunk -> one batched
    decode step (all decoding rows advance one token)

Requests join and leave the batch at iteration granularity (Orca-style
continuous batching). The engine thread is the only thread that launches
device work: HTTP handler threads only tokenize and enqueue, then wait on the
request. Kept from the JAX engine: the prefix cache, chunked prefill,
deadlines, recompute-on-resume preemption and token streaming (``submit(...,
stream=True)``). Not ported yet: speculative
decoding, weight quantization, serving meshes, tracing, Prometheus and stats
publishing, KV transfer and weight swaps. ``metrics()`` returns a plain dict.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import batch_step
from .kv_pool import PagedKVPool
from .scheduler import DECODE, DONE, PREFILL, QueueFullError, Request, Scheduler

__all__ = ["BatchEngine", "EngineConfig", "QueueFullError"]


@dataclasses.dataclass
class EngineConfig:
    """Pool/queue knobs (the JAX package's configs/serve-sample.yaml
    documents each)."""

    num_slots: int = 8          # decode batch width = max concurrent requests
    max_len: int = 2048         # per-request KV length bound
    max_queue: int = 32         # admission queue depth; beyond -> 429
    prefill_chunk: int = 256    # prompt tokens written per iteration
    block_size: int = 32        # tokens per KV block (power of two)
    num_blocks: int = 0         # KV arena size; 0 = num_slots * max_len worth
    prefix_cache: bool = True   # content-hash block reuse (off = oracle)
    prefix_min_hit_blocks: int = 1  # shortest cached chain worth adopting
    default_deadline_s: Optional[float] = None  # per-request unless overridden


class BatchEngine:
    """Serves ``params`` (a nested dict of tensors, all on one device — the
    engine runs there) through the paged KV pool."""

    RATE_WINDOW_S = 1.0  # decode tok/s window behind metrics()["tok/s"]

    def __init__(self, params, args, tokenizer,
                 cfg: Optional[EngineConfig] = None):
        self.params = params
        self.args = args
        self.tokenizer = tokenizer
        self.cfg = cfg or EngineConfig()
        self.device = params["tok_embeddings"]["weight"].device
        if self.cfg.max_len > args.max_position_embeddings:
            raise ValueError(
                f"max_len {self.cfg.max_len} exceeds the model's "
                f"max_position_embeddings {args.max_position_embeddings}")
        self.pool = PagedKVPool(
            args, self.cfg.num_slots, self.cfg.max_len,
            block_size=self.cfg.block_size, num_blocks=self.cfg.num_blocks,
            device=self.device, dtype=params["tok_embeddings"]["weight"].dtype,
            prefix_cache=self.cfg.prefix_cache,
            min_hit_blocks=self.cfg.prefix_min_hit_blocks)
        self.scheduler = Scheduler(max_queue=self.cfg.max_queue)
        self.scheduler.concurrency = self.cfg.num_slots
        self.chunk = max(1, min(self.cfg.prefill_chunk, self.cfg.max_len))
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Engine-thread counters (read racily by metrics(), like the JAX
        # engine's): loop iterations and the device steps they ran.
        self.iterations = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self._win_t0 = time.monotonic()
        self._win_tokens = 0
        self._tok_s = 0.0
        self._ttft_ms_sum = 0.0
        self._ttft_count = 0

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "BatchEngine":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="batch-engine")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self.scheduler.drain(self.pool)

    # -- submission ------------------------------------------------------------
    def submit(self, prompt: str, max_tokens: int = 64,
               temperature: float = 0.0, seed: int = 0,
               deadline_s: Optional[float] = None,
               stream: bool = False) -> Request:
        """Tokenize and enqueue; raises QueueFullError (-> 429) past the
        queue bound, ValueError when the request can never fit a row. With
        ``stream=True`` the request carries a ``stream_q`` that the engine
        puts each emitted token id into, then None at the end."""
        ids = [self.tokenizer.bos_id] + self.tokenizer.tokenize(prompt)
        return self._submit_ids(ids, max_tokens, temperature, seed, deadline_s,
                                stream=stream)

    def _submit_ids(self, ids: List[int], max_tokens: int,
                    temperature: float, seed: int,
                    deadline_s: Optional[float] = None,
                    stream: bool = False) -> Request:
        P = len(ids)
        padded = batch_step.round_up(max(P, 1), self.chunk)
        if padded > self.pool.max_len or P > self.pool.capacity:
            raise ValueError(
                f"prompt of {P} tokens cannot fit a {self.pool.max_len}-"
                f"token sequence (chunked prefill pads to {padded})")
        max_tokens = max(1, min(int(max_tokens), self.pool.capacity - P))
        req = Request(ids, max_tokens, temperature=temperature, seed=seed,
                      deadline_s=(deadline_s if deadline_s is not None
                                  else self.cfg.default_deadline_s),
                      stop_ids=[self.tokenizer.eos_id])
        if stream:
            req.stream_q = queue.Queue()
        self.scheduler.submit(req)
        self._wake.set()
        return req

    # Grace past the engine deadline before the caller forces eviction.
    WAIT_GRACE_S = 5.0

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None) -> dict:
        """Blocking convenience for the HTTP front end; the wait follows the
        request's own deadline plus a short grace."""
        req = self.submit(prompt, max_tokens, temperature, seed, deadline_s)
        if timeout is None:
            eff = deadline_s if deadline_s is not None \
                else self.cfg.default_deadline_s
            timeout = eff + self.WAIT_GRACE_S if eff is not None else 600.0
        if not req.wait(timeout):
            req.deadline = 0.0  # force eviction next iteration
            self._wake.set()
            req.wait(timeout=30.0)
        if req.error is not None:
            raise TimeoutError(req.error)
        return dict(req.result or {})

    # -- metrics ---------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        pool = self.pool
        snap: Dict[str, Any] = {
            "iterations": self.iterations,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "batch_occupancy": pool.num_used,
            "num_slots": pool.num_slots,
            **self.scheduler.counters(),
            "kv_backend": "paged",
            "kv_blocks_used": pool.blocks_in_use,
            "kv_blocks_free": pool.free_blocks,
            "kv_num_blocks": pool.num_blocks,
            "kv_free_watermark": pool._watermark,
            "kv_fragmentation": round(pool.fragmentation(), 4),
            "prefix_cache": pool.prefix is not None,
            "tok/s": round(self._tok_s, 2),
            "device": str(self.device),
        }
        if pool.prefix is not None:
            snap.update(pool.prefix.stats())
        if self._ttft_count:
            snap["ttft_ms_mean"] = round(self._ttft_ms_sum / self._ttft_count, 3)
        return snap

    def _update_rate(self) -> None:
        now = time.monotonic()
        dt = now - self._win_t0
        if dt >= self.RATE_WINDOW_S:
            self._tok_s = self._win_tokens / dt
            self._win_t0, self._win_tokens = now, 0

    # -- the iteration loop ----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self._iteration()
            except Exception as e:  # noqa: BLE001 - engine must not die silently
                # Fail every in-flight request loudly and keep serving.
                traceback.print_exc()
                self.scheduler.drain(
                    self.pool, error=f"engine error: {type(e).__name__}: {e}")
                busy = False
            if not busy:
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    def _iteration(self) -> bool:
        self.iterations += 1
        sched = self.scheduler
        sched.expire(self.pool)
        sched.admit(self.pool)
        busy = False
        pre = sched.prefilling()
        if pre:
            self._prefill_chunk(pre[0])
            busy = True
        dec = sched.decoding()
        if dec:
            self._decode(dec)
            busy = True
        self._update_rate()
        return busy

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)

    def _generator(self, req: Request) -> Optional[torch.Generator]:
        """The request's own generator (seeded from its ``seed`` on first
        use, then carried across steps and preemptions); None when greedy."""
        if req.temperature <= 0.0:
            return None
        if req.generator is None:
            req.generator = torch.Generator(device=self.device)
            req.generator.manual_seed(req.seed)
        return req.generator

    def _attend(self, n: int) -> int:
        """Attend bucket for ``n`` positions, aligned to block bounds (the
        gather reads whole blocks)."""
        pool = self.pool
        b = batch_step.attend_bucket(n, pool.max_len)
        return min(batch_step.round_up(b, pool.block_size), pool.max_len)

    def _register_prefix(self, req: Request) -> None:
        """Publish every newly FILLED block of this request into the prefix
        cache (content-hash keys chained from the sequence head)."""
        if self.pool.prefix is not None and req.slot is not None:
            self.pool.register_upto(req.slot, req.prefill_source())

    def _prefill_chunk(self, req: Request) -> None:
        pool, C = self.pool, self.chunk
        source = req.prefill_source()
        P = len(source)
        start = req.prefilled
        n = min(C, P - start)
        final = start + n >= P
        toks = np.zeros(C, np.int64)
        toks[:n] = source[start:start + n]
        last_logits = batch_step.paged_prefill_step(
            self.params, pool.cache, self._to_device(toks),
            self._to_device(pool.tables[req.slot]), start, max(n - 1, 0),
            self.args, self._attend(start + C), pool.block_size,
            with_logits=final)
        self.prefill_chunks += 1
        req.prefilled = start + n
        pool.lengths[req.slot] = min(start + n, P)
        self._register_prefix(req)
        if not final:
            return
        pool.lengths[req.slot] = P
        tok, lp = batch_step.sample_token(last_logits, req.temperature,
                                          self._generator(req))
        if req.first_token_at is None:  # kept across preemption re-prefill
            req.first_token_at = time.monotonic()
        self._emit(req, tok, lp)

    def _grow_or_preempt(self, dec: List[Request]) -> List[Request]:
        """Map the block each decoding row's next position needs. On arena
        exhaustion, preempt the YOUNGEST decoding request (recompute-on-
        resume) and retry, so the oldest requests always make progress."""
        pool, sched = self.pool, self.scheduler
        active = sorted(dec, key=lambda r: r.id)  # oldest first
        i = 0
        while i < len(active):
            r = active[i]
            if pool.ensure_capacity(r.slot, pool.lengths[r.slot] + 1):
                i += 1
                continue
            sched.preempt(pool, active.pop())
        return active

    def _decode(self, dec: List[Request]) -> None:
        pool = self.pool
        dec = self._grow_or_preempt(dec)
        if not dec:
            return
        B = pool.num_slots
        # Masked rows (free, or admitted and still prefilling) ride the step
        # as token 0 at position 0 with an all-zero table row, so their
        # writes land in the junk block. A prefilling row's own table must
        # not be used: its first block may already hold its prompt's KV, or
        # be a prefix-cache block shared with other requests.
        tokens = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        tables = np.zeros_like(pool.tables)
        temps = [0.0] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        for r in dec:
            tokens[r.slot] = r.last_token
            pos[r.slot] = pool.lengths[r.slot]
            tables[r.slot] = pool.tables[r.slot]
            temps[r.slot] = r.temperature
            gens[r.slot] = self._generator(r)
        bucket = self._attend(int(max(pos[r.slot] for r in dec)) + 1)
        logits = batch_step.paged_decode_step(
            self.params, pool.cache, self._to_device(tokens),
            self._to_device(pos), self._to_device(tables), self.args,
            bucket, pool.block_size)
        self.decode_steps += 1
        tok, lp = batch_step.sample_rows(logits, temps, gens)
        for r in dec:
            s = r.slot
            p0 = pool.lengths[s]
            self._emit(r, tok[s], lp[s])
            if r.state != DONE:
                pool.lengths[s] = p0 + 1
                self._register_prefix(r)

    def _emit(self, req: Request, tok: int, lp: float) -> None:
        """Account one sampled token (stop tokens are never appended)."""
        if tok in req.stop_ids:
            self._finish(req, "stop")
            return
        req.tokens.append(tok)
        req.logprobs.append(lp)
        req.last_token = tok
        if req.stream_q is not None:
            req.stream_q.put(tok)
        self._win_tokens += 1
        if len(req.tokens) >= req.max_tokens:
            self._finish(req, "length")
        elif req.state == PREFILL:
            req.state = DECODE

    def _finish(self, req: Request, reason: str) -> None:
        self.scheduler.finish(self.pool, req, reason)
        done = time.monotonic()
        dt = max(done - req.submitted_at, 1e-9)
        ttft_ms = ((req.first_token_at - req.submitted_at) * 1e3
                   if req.first_token_at else None)
        comp: Dict[str, float] = {}
        if req.admitted_at is not None:
            comp["queue_ms"] = (req.admitted_at - req.submitted_at) * 1e3
            if req.first_token_at is not None:
                comp["prefill_ms"] = (req.first_token_at
                                      - req.admitted_at) * 1e3
                comp["decode_ms"] = (done - req.first_token_at) * 1e3
        if ttft_ms is not None:
            self._ttft_ms_sum += ttft_ms
            self._ttft_count += 1
        req.resolve(result={
            "text": self.tokenizer.detokenize(req.tokens),
            "tokens": len(req.tokens),
            "token_ids": list(req.tokens),
            "logprobs": list(req.logprobs),
            "engine": "batch",
            "finish_reason": reason,
            "generation_tps": len(req.tokens) / dt,
            "mean_logprob": (float(np.mean(req.logprobs))
                             if req.logprobs else 0.0),
            "prompt_tokens": len(req.prompt_ids),
            "prefix_cached_tokens": req.cached_tokens,
            "stopped_on_token": reason == "stop",
            **({"ttft_ms": round(ttft_ms, 3)} if ttft_ms is not None else {}),
            **{k: round(v, 3) for k, v in comp.items()},
        })
