"""The continuous-batching engine thread.

``BatchEngine`` owns the model params, the KV pool (paged or slotted) and
the scheduler, and runs one iteration loop on a background thread:

    run queued tasks -> evict expired -> admit queued -> one prefill chunk
    -> one batched decode step (all decoding rows advance, by one token or,
    with speculation, by every accepted draft plus one)

Requests join and leave the batch at iteration granularity (Orca-style
continuous batching). The engine thread is the only thread that launches
device work or touches the pool's bookkeeping: HTTP handler threads only
tokenize and enqueue, and cross-thread work (KV export/adopt, weight
swaps) rides :meth:`BatchEngine.call_in_loop`. Ported from the JAX engine:
both pools and the int8 KV quartet (``kv_quant``), the prefix cache,
chunked prefill, deadlines, recompute-on-resume preemption, token
streaming (``submit(..., stream=True)``), in-batch prompt-lookup
speculation on the paged pool with its degradation rung, weight-only
int8/int4 (``weight_dtype``), hot weight swaps, KV export/adopt/quarantine
and the serving fault points (``serve/faults.py``: ``engine.swap_fail``,
``arena.exhaust``). ``metrics()`` returns a plain dict.

Not ported yet, and refused when a config sets them (``EngineConfig``):
the span tracer, stats publishing and the Prometheus exposition (ROADMAP
queue 1 item 9); fleet roles, serving meshes and prefill-only handoff
requests (item 10).
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

from . import batch_step, faults
from .kv_pool import PagedKVPool, SlotKVPool
from .scheduler import DECODE, DONE, PREFILL, QueueFullError, Request, Scheduler

__all__ = ["BatchEngine", "EngineConfig", "QueueFullError"]

# EngineConfig knobs that ask for something not ported, with their default
# and the ROADMAP queue 1 item that ports them.
_UNPORTED = {
    "trace": (False, "item 9: tracing"),
    "stats_url": (None, "item 9: stats publishing"),
    "metrics_port": (0, "item 9: the Prometheus exposition"),
    "role": ("any", "item 10: the serving fleet"),
}


def _parse_mesh(spec) -> Optional[Dict[str, int]]:
    if isinstance(spec, str):
        return {k.strip(): int(v) for k, v in
                (part.split("=") for part in spec.split(",") if part.strip())}
    return spec


@dataclasses.dataclass
class EngineConfig:
    """Pool/queue knobs (``configs/serve-sample.yaml`` documents each)."""

    num_slots: int = 8          # decode batch width = max concurrent requests
    max_len: int = 2048         # per-request KV length bound
    max_queue: int = 32         # admission queue depth; beyond -> 429
    prefill_chunk: int = 256    # prompt tokens written per iteration
    kv_quant: bool = False      # int8 KV quartet in the pool
    weight_dtype: str = "fp"    # weight-only quant: "fp" | "int8" | "int4"
    kv_backend: str = "paged"   # "paged" (block tables) | "slotted"
    block_size: int = 32        # paged: tokens per KV block (power of two)
    num_blocks: int = 0         # paged: KV arena size; 0 = num_slots * max_len worth
    spec_draft_len: int = 0     # paged: drafts verified per decode step; 0 off
    spec_max_ngram: int = 3     # paged: prompt-lookup suffix n-gram bound
    # Degradation rung 1: below this free-block fraction the next decode
    # step runs without speculation (drafts map blocks for speculative
    # positions; under pressure certainty beats speed).
    spec_off_kv_free_frac: float = 0.05
    prefix_cache: bool = True   # paged: content-hash block reuse (off = oracle)
    prefix_min_hit_blocks: int = 1  # shortest cached chain worth adopting
    default_deadline_s: Optional[float] = None  # per-request unless overridden
    worker_id: str = "serve-engine"  # label of the engine's fault points
    # Read so that no knob of the JAX config is dropped silently: set to
    # anything but the default, these raise (see _UNPORTED). Their JAX
    # companions (trace_sample, trace_capacity, stats_interval_s) change
    # nothing while these are off, and are not read.
    trace: bool = False
    stats_url: Optional[str] = None
    role: str = "any"
    metrics_port: int = 0
    mesh: Optional[Dict[str, int]] = None  # only a single-device (all-ones) mesh

    def __post_init__(self):
        for name, (default, item) in _UNPORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not ported "
                    f"(ROADMAP queue 1 {item})")
        self.mesh = _parse_mesh(self.mesh)
        if self.mesh and any(int(n) != 1 for n in self.mesh.values()):
            raise NotImplementedError(
                f"a serving mesh {self.mesh} is not ported (ROADMAP queue 1 "
                "item 10: multi-GPU); the engine serves on one device")

    @classmethod
    def from_yaml(cls, path: str) -> "EngineConfig":
        """The ``serve:`` section of a serving config (JAX's
        ``configs/serve-sample.yaml``), with its nested ``prefix_cache`` and
        ``trace`` blocks and ``serving.mesh`` / ``serving.weight_dtype``.
        JSON files read without PyYAML."""
        from ..config import read_config_dict

        doc = read_config_dict(path) or {}
        serve = dict(doc.get("serve", doc))
        pc = serve.get("prefix_cache")
        if isinstance(pc, dict):
            serve["prefix_cache"] = bool(pc.get("enabled", True))
            if "min_hit_blocks" in pc:
                serve["prefix_min_hit_blocks"] = int(pc["min_hit_blocks"])
        tr = serve.get("trace")
        if isinstance(tr, dict):
            serve["trace"] = bool(tr.get("enabled", True))
        serving = doc.get("serving")
        if isinstance(serving, dict):
            for key in ("mesh", "weight_dtype"):
                if key in serving:
                    serve.setdefault(key, serving[key])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in serve.items() if k in known})


class BatchEngine:
    """Serves ``params`` (a nested dict of tensors, all on one device; the
    engine runs there) through the KV pool ``cfg.kv_backend`` names."""

    RATE_WINDOW_S = 1.0  # decode tok/s window behind metrics()["tok/s"]

    def __init__(self, params, args, tokenizer,
                 cfg: Optional[EngineConfig] = None):
        from ..models.quantize import (check_weight_dtype, quantize_weights,
                                       weight_dtype_of, weight_plane_bytes)

        self.args = args
        self.tokenizer = tokenizer
        self.cfg = cfg = cfg or EngineConfig()
        self.device = params["tok_embeddings"]["weight"].device
        if cfg.max_len > args.max_position_embeddings:
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's "
                f"max_position_embeddings {args.max_position_embeddings}")
        # Weight-only quantization: params that arrive quantized (quantize-on-
        # load) win over the knob; fp params with weight_dtype set are
        # quantized here, on their device.
        wd = check_weight_dtype(cfg.weight_dtype)
        have = weight_dtype_of(params)
        if have != "fp":
            wd = have
        elif wd != "fp":
            params = quantize_weights(params, wd)
        self.params = params
        self.weight_dtype = wd
        self._weight_bytes = weight_plane_bytes(params)
        dtype = params["tok_embeddings"]["weight"].dtype
        if cfg.kv_backend == "paged":
            self.pool = PagedKVPool(
                args, cfg.num_slots, cfg.max_len, block_size=cfg.block_size,
                num_blocks=cfg.num_blocks, device=self.device, dtype=dtype,
                quantize=cfg.kv_quant, prefix_cache=cfg.prefix_cache,
                min_hit_blocks=cfg.prefix_min_hit_blocks)
        elif cfg.kv_backend == "slotted":
            if cfg.spec_draft_len:
                raise ValueError(
                    "spec_draft_len requires kv_backend='paged' (in-batch "
                    "speculation commits through block tables)")
            self.pool = SlotKVPool(args, cfg.num_slots, cfg.max_len,
                                   device=self.device, dtype=dtype,
                                   quantize=cfg.kv_quant)
        else:
            raise ValueError(f"unknown kv_backend {cfg.kv_backend!r} "
                             "(expected 'paged' or 'slotted')")
        self.draft_len = (max(0, int(cfg.spec_draft_len))
                          if cfg.kv_backend == "paged" else 0)
        self.scheduler = Scheduler(max_queue=cfg.max_queue)
        self.scheduler.concurrency = cfg.num_slots
        self.chunk = max(1, min(cfg.prefill_chunk, cfg.max_len))
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Cross-thread work the loop runs between iterations (the engine
        # thread is the only writer of the pool's bookkeeping and params).
        self._tasks: "queue.Queue" = queue.Queue()
        # Engine-thread counters (read racily by metrics(), like the JAX
        # engine's): loop iterations and the device steps they ran.
        self.iterations = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.params_version = 0  # bumps on every applied weight swap
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_off_steps = 0  # decode steps run unspeculated under pressure
        self._kv_transfer = dict.fromkeys(("exported", "adopted", "reused"), 0)
        self._kv_failures: Dict[str, int] = {}
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
        self._drain_tasks()  # stragglers run inline; nobody left to race

    # -- engine-thread task queue ----------------------------------------------
    def _drain_tasks(self) -> None:
        while True:
            try:
                fn, box, done = self._tasks.get_nowait()
            except queue.Empty:
                return
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001 - delivered to the caller
                box["error"] = e
            done.set()

    def call_in_loop(self, fn, timeout: float = 120.0):
        """Run ``fn`` on the engine thread between iterations and return its
        result (its exception re-raises here). Runs inline when the loop is
        not running."""
        t = self._thread
        if t is None or not t.is_alive():
            return fn()
        done = threading.Event()
        box: Dict[str, Any] = {}
        self._tasks.put((fn, box, done))
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError("engine-loop task timed out")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    # -- weight swap and KV handoff --------------------------------------------
    def swap_params(self, new_params) -> int:
        """Swap the serving weights between two iterations: requests that
        straddle the cutover decode their remaining tokens on the new
        weights; nothing is evicted. A quantized engine quantizes an fp tree
        into its own dtype first, so the resident weights never change
        dtype. Moves the tree to the engine's device on the calling thread.
        Returns the new ``params_version``."""
        from ..models.quantize import (quantize_weights, weight_dtype_of,
                                       weight_plane_bytes)
        from ..utils.tree import tree_map

        if faults.take("engine.swap_fail", self.cfg.worker_id) is not None:
            # before any cutover: a failed swap leaves the weights untouched
            raise RuntimeError("injected swap failure")
        placed = tree_map(lambda t: t.to(self.device), new_params)
        if self.weight_dtype != "fp" and weight_dtype_of(placed) == "fp":
            placed = quantize_weights(placed, self.weight_dtype)
        nbytes = weight_plane_bytes(placed)

        def cutover():
            self.params = placed
            self.params_version += 1
            self._weight_bytes = nbytes
            return self.params_version

        return self.call_in_loop(cutover)

    def _paged_with_prefix(self, what: str):
        pool = self.pool
        if pool.kind != "paged" or pool.prefix is None:
            raise ValueError(f"KV {what} needs kv_backend='paged' with "
                             "prefix_cache=True")
        return pool

    def export_kv(self, token_ids: List[int]):
        """The cached KV chain covering ``token_ids`` as a
        ``kv_transfer.KVTransferPayload``: pinned on the engine thread, read
        on this one, released on the engine thread."""
        from .kv_transfer import build_payload

        pool = self._paged_with_prefix("export")
        export = self.call_in_loop(lambda: pool.export_blocks(token_ids))
        try:
            payload = build_payload(export, token_ids, pool.block_size,
                                    pool.quantize)
        finally:
            self.call_in_loop(lambda: pool.release_export(export))
        self._kv_transfer["exported"] += payload.num_blocks
        return payload

    def adopt_kv(self, payload) -> Dict[str, int]:
        """Install a transferred payload into this engine's arena: the block
        size, the quantization and the chain keys are checked before any
        byte lands. Returns the pool's adopt stats."""
        pool = self._paged_with_prefix("adopt")
        if payload.block_size != pool.block_size:
            raise ValueError(f"payload block_size {payload.block_size} != "
                             f"pool block_size {pool.block_size}")
        if bool(payload.quantized) != bool(pool.quantize):
            raise ValueError("payload/pool KV quantization mismatch "
                             f"({payload.quantized} vs {pool.quantize})")
        payload.verify_keys()
        stats = self.call_in_loop(
            lambda: pool.adopt_blocks(payload.keys, payload.blocks))
        for kind in ("adopted", "reused"):
            self._kv_transfer[kind] += stats.get(kind, 0)
        return stats

    def quarantine_kv(self, keys, reason: str = "corrupt") -> int:
        """Degradation rung 2: unpublish a refused or corrupt transfer's chain
        keys from the prefix cache, so no later prompt adopts them; counts
        the failure under ``reason``. Returns the keys dropped."""
        self.note_kv_failure(reason)
        pool = self.pool
        if pool.kind != "paged" or pool.prefix is None:
            return 0
        return self.call_in_loop(lambda: pool.quarantine(list(keys)))

    def note_kv_failure(self, reason: str) -> None:
        """Count a KV-transfer failure with nothing local to quarantine."""
        self._kv_failures[reason] = self._kv_failures.get(reason, 0) + 1

    def warmup(self, prompt_ids: Optional[List[int]] = None) -> None:
        """Run one short request through prefill and decode before traffic
        arrives (allocations, kernel loads)."""
        running = self._thread is not None
        if not running:
            self.start()
        req = self._submit_ids(prompt_ids or [self.tokenizer.bos_id, 1],
                               max_tokens=2, temperature=0.0, seed=0)
        req.wait(timeout=300.0)
        if not running:
            self.stop()

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
        # A verify window writes up to draft_len positions past the last
        # committed token, so the budget reserves them.
        k = self.draft_len
        if padded > self.pool.max_len or P > self.pool.capacity - k:
            raise ValueError(
                f"prompt of {P} tokens cannot fit a {self.pool.max_len}-"
                f"token sequence (chunked prefill pads to {padded}"
                + (f", spec reserves {k}" if k else "") + ")")
        max_tokens = max(1, min(int(max_tokens), self.pool.capacity - P - k))
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
            "kv_backend": pool.kind,
            "kv_quant": bool(pool.quantize),
            "params_version": self.params_version,
            "weight_dtype": self.weight_dtype,
            "weight_bytes": int(self._weight_bytes),
            "kv_transfer_blocks": dict(self._kv_transfer),
            "kv_transfer_failures": dict(self._kv_failures),
            "tok/s": round(self._tok_s, 2),
            "device": str(self.device),
        }
        if pool.kind == "paged":
            snap.update({
                "kv_blocks_used": pool.blocks_in_use,
                "kv_blocks_free": pool.free_blocks,
                "kv_num_blocks": pool.num_blocks,
                "kv_free_watermark": pool._watermark,
                "kv_fragmentation": round(pool.fragmentation(), 4),
            })
        if self.draft_len:
            snap.update({
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_acceptance_rate": round(
                    self._spec_accepted / max(self._spec_proposed, 1), 4),
                "spec_off_steps": self._spec_off_steps,
            })
        fc = faults.counts()
        if fc:  # absent when nothing fired
            snap["faults_injected"] = fc
        prefix = getattr(pool, "prefix", None)
        snap["prefix_cache"] = prefix is not None
        if prefix is not None:
            snap.update(prefix.stats())
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
        self._drain_tasks()  # KV export/adopt and weight cutovers run here
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

    def _to_device(self, a) -> torch.Tensor:
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
        """Attend bucket for ``n`` positions, aligned to block bounds on the
        paged pool (the gather reads whole blocks)."""
        pool = self.pool
        b = batch_step.attend_bucket(n, pool.max_len)
        if pool.kind == "paged":
            b = min(batch_step.round_up(b, pool.block_size), pool.max_len)
        return b

    def _register_prefix(self, req: Request) -> None:
        """Publish every newly FILLED block of this request into the prefix
        cache (content-hash keys chained from the sequence head)."""
        if getattr(self.pool, "prefix", None) is not None and req.slot is not None:
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
        if pool.kind == "paged":
            last_logits = batch_step.paged_prefill_step(
                self.params, pool.cache, self._to_device(toks),
                self._to_device(pool.tables[req.slot]), start, max(n - 1, 0),
                self.args, self._attend(start + C), pool.block_size,
                with_logits=final)
        else:
            last_logits = batch_step.prefill_step(
                self.params, pool.cache, self._to_device(toks), req.slot, start,
                max(n - 1, 0), self.args, self._attend(start + C),
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

    def _decode(self, dec: List[Request]) -> None:
        if self.pool.kind == "paged":
            self._decode_paged(dec)
            return
        pool = self.pool
        B = pool.num_slots
        # Free and prefilling rows ride the step at the reserved junk
        # position with token 0; their outputs are discarded.
        tokens = np.zeros(B, np.int64)
        pos = np.full(B, pool.max_len - 1, np.int64)
        temps = [0.0] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        for r in dec:
            tokens[r.slot] = r.last_token
            pos[r.slot] = pool.lengths[r.slot]
            temps[r.slot] = r.temperature
            gens[r.slot] = self._generator(r)
        bucket = batch_step.attend_bucket(
            int(max(pos[r.slot] for r in dec)) + 1, pool.max_len)
        logits = batch_step.decode_step(self.params, pool.cache,
                                        self._to_device(tokens), self._to_device(pos),
                                        self.args, bucket)
        self.decode_steps += 1
        tok, lp = batch_step.sample_rows(logits, temps, gens)
        for r in dec:
            pool.lengths[r.slot] += 1
            self._emit(r, tok[r.slot], lp[r.slot])

    def _grow_or_preempt(self, dec: List[Request], S: int) -> List[Request]:
        """Map the blocks each decoding row's next verify window (``S``
        positions) needs. On arena exhaustion, preempt the YOUNGEST decoding
        request (recompute-on-resume) and retry, so the oldest requests
        always make progress."""
        pool, sched = self.pool, self.scheduler
        active = sorted(dec, key=lambda r: r.id)  # oldest first
        i = 0
        while i < len(active):
            r = active[i]
            # arena.exhaust: the preemption path without filling the arena
            forced = faults.take("arena.exhaust") is not None
            if not forced and pool.ensure_capacity(r.slot, pool.lengths[r.slot] + S):
                i += 1
                continue
            sched.preempt(pool, active.pop())
        return active

    def _effective_draft_len(self) -> int:
        """Drafts for the next decode step: ``draft_len``, or 0 while free
        blocks are under ``spec_off_kv_free_frac`` of the arena (degradation
        rung 1: a verify window maps ``draft_len`` extra positions a row,
        exactly what a pressed arena lacks)."""
        k = self.draft_len
        if not k:
            return 0
        pool = self.pool
        if pool.free_blocks < self.cfg.spec_off_kv_free_frac * max(pool.num_blocks, 1):
            self._spec_off_steps += 1
            return 0
        return k

    def _decode_paged(self, dec: List[Request]) -> None:
        from ..infer.generate import _prompt_lookup_draft

        pool = self.pool
        k = self._effective_draft_len()
        S = k + 1
        dec = self._grow_or_preempt(dec, S)
        if not dec:
            return
        B = pool.num_slots
        # Masked rows (free, or admitted and still prefilling) ride the step
        # as token 0 at position 0 with an all-zero table row, so their
        # writes land in the junk block. A prefilling row's own table must
        # not be used: its first block may already hold its prompt's KV, or
        # be a prefix-cache block shared with other requests.
        tokens = np.zeros((B, S), np.int64)
        pos = np.zeros(B, np.int64)
        tables = np.zeros_like(pool.tables)
        temps = [0.0] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        drafts: Dict[int, List[int]] = {}
        for r in dec:
            d = (_prompt_lookup_draft(r.prompt_ids + r.tokens, k,
                                      self.cfg.spec_max_ngram) if k else [])
            drafts[r.slot] = d
            tokens[r.slot] = [r.last_token] + d
            pos[r.slot] = pool.lengths[r.slot]
            tables[r.slot] = pool.tables[r.slot]
            temps[r.slot] = r.temperature
            gens[r.slot] = self._generator(r)
        bucket = self._attend(int(max(pos[r.slot] for r in dec)) + S)
        tok_dev = self._to_device(tokens)
        logits = batch_step.paged_decode_step(
            self.params, pool.cache, tok_dev, self._to_device(pos),
            self._to_device(tables), self.args, bucket, pool.block_size)
        self.decode_steps += 1
        preds, lp_preds, sampled = batch_step.verify_rows(
            logits, tok_dev, temps, gens, [r.slot for r in dec])
        for r in dec:
            s = r.slot
            p0 = pool.lengths[s]
            d = drafts[s]
            if r.temperature > 0.0:
                accept, lp_draft, alts, lp_alt, bonus, lp_bonus = sampled[s]
                m = 0
                while m < k and accept[m]:
                    m += 1
                if m < k:
                    emitted = d[:m] + [alts[m]]
                    lps = lp_draft[:m] + [lp_alt[m]]
                else:
                    emitted = d + [bonus]
                    lps = lp_draft[:k] + [lp_bonus]
            else:
                m = 0
                while m < k and d[m] == preds[s][m]:
                    m += 1
                # m accepted drafts + the model's own next token at m
                emitted = d[:m] + [preds[s][m]]
                lps = lp_preds[s][:m + 1]
            self._spec_proposed += k
            self._spec_accepted += m
            for t, lpv in zip(emitted, lps):
                self._emit(r, t, lpv)
                if r.state == DONE:
                    break
            if r.state != DONE:
                # Commit the accepted prefix only: the verify wrote S
                # positions, the length advances past the emitted ones, and
                # the next window overwrites the rejected tail.
                pool.lengths[s] = p0 + len(emitted)
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
