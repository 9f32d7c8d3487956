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
``arena.exhaust``). ``metrics()`` returns a plain dict with the JAX
engine's keys.

Telemetry, as in the JAX engine: a metrics registry (``obs/metrics.py``:
occupancy, queue depth, tok/s, requests by outcome, the TTFT histogram and
its components, the paged pool's, speculation's and the prefix cache's
counters), mirrored from the engine thread every ``stats_interval_s`` and
served as Prometheus text on ``metrics_port``; the stats hub at
``stats_url``; and with ``trace`` on, per-request spans (``obs/trace.py``:
``queue_wait``, ``prefill_chunk``, ``decode``, ``request``, and the
``kv_alloc`` / ``prefix_adopt`` / ``stream_emit`` markers), each keyed by
the request's trace id (the server's ``X-Trace-Id``, or one minted here).

Disaggregated serving (``serve/fleet.py``): ``role`` names the fleet pool
the engine serves ("prefill", "decode" or "any"; ``metrics()`` publishes
it), and ``submit(..., prefill_only=True)`` finishes a request once its
prompt KV is written and published, without sampling: the decode replica
that adopts the chain (``adopt_kv``) recomputes the last prompt token
and samples there.

Not ported yet, and refused when a config sets one: a serving mesh of more
than one device (ROADMAP queue 1 item 10).
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
    trace: bool = False         # span tracer (obs/trace.py); /trace dumps it
    trace_sample: float = 1.0   # fraction of requests traced (by trace id)
    trace_capacity: int = 16384  # span ring-buffer bound (oldest dropped)
    stats_url: Optional[str] = None  # ws://host:port of an obs stats hub
    stats_interval_s: float = 1.0  # registry mirror / stats publish period
    worker_id: str = "serve-engine"  # tracer service name, fault-point label
    metrics_port: int = 0       # Prometheus exposition (obs/prometheus.py); 0 off
    role: str = "any"           # fleet pool: "prefill" | "decode" | "any"
    mesh: Optional[Dict[str, int]] = None  # only a single-device (all-ones) mesh

    def __post_init__(self):
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
            if "sample" in tr:
                serve["trace_sample"] = float(tr["sample"])
            if "capacity" in tr:
                serve["trace_capacity"] = int(tr["capacity"])
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
        # the decode-throughput window and the last published snapshot
        self._win_t0 = time.monotonic()
        self._win_tokens = 0
        self._last_publish = 0.0
        self._metrics: Dict[str, Any] = {}
        self._stats = None
        self._metrics_server = None
        self._init_telemetry()

    def _init_telemetry(self) -> None:
        """The per-request span tracer and the metrics registry, with the
        JAX engine's metric names (a disabled tracer is free: ``span()``
        returns a shared null span and every call site checks
        ``enabled``)."""
        from ..obs.metrics import LATENCY_MS_BUCKETS, MetricsRegistry
        from ..obs.trace import Tracer

        cfg = self.cfg
        self.tracer = Tracer(cfg.worker_id, capacity=cfg.trace_capacity,
                             sample=cfg.trace_sample, enabled=cfg.trace)
        self.metrics_registry = reg = MetricsRegistry()
        self._mg_occupancy = reg.gauge("serve_batch_occupancy", "occupied decode slots")
        self._mg_queue = reg.gauge("serve_queue_depth", "admission queue depth")
        self._mg_tok_s = reg.gauge("serve_tok_s", "decode tokens/second (window)")
        self._mc_requests = reg.counter("serve_requests_total", "requests by outcome")
        self._mc_iterations = reg.counter("serve_iterations_total", "engine loop iterations")
        self._mh_ttft = reg.histogram("serve_ttft_ms", "time to first token (ms)",
                                      buckets=LATENCY_MS_BUCKETS)
        self._mh_ttft_component = reg.histogram(
            "serve_ttft_component_ms", "per-request latency by component (ms)",
            buckets=LATENCY_MS_BUCKETS)
        self._mg_blocks_used = reg.gauge("serve_kv_blocks_used",
                                         "paged KV blocks currently mapped")
        self._mg_blocks_free = reg.gauge("serve_kv_blocks_free", "paged KV blocks free")
        self._mg_free_watermark = reg.gauge(
            "serve_kv_free_block_watermark", "minimum free blocks over the publish window")
        self._mg_fragmentation = reg.gauge(
            "serve_kv_fragmentation", "fraction of mapped KV positions holding no live token")
        self._mc_spec = reg.counter(
            "serve_spec_tokens_total",
            "speculative draft tokens by outcome (proposed/accepted)")
        self._mg_spec_rate = reg.gauge(
            "serve_spec_acceptance_rate",
            "accepted/proposed draft tokens over the publish window")
        self._mc_prefix_hits = reg.counter(
            "serve_prefix_cache_hits_total", "admissions that adopted a cached block-chain")
        self._mc_prefix_misses = reg.counter(
            "serve_prefix_cache_misses_total", "admissions with no usable cached prefix")
        self._mc_prefix_evictions = reg.counter(
            "serve_prefix_cache_evictions_total",
            "cached KV blocks reclaimed by allocation pressure")
        self._mg_prefix_hit_rate = reg.gauge(
            "serve_prefix_cache_hit_rate",
            "prompt tokens served from cache / prompt tokens offered")
        self._mc_kv_transfer = reg.counter(
            "serve_kv_transfer_blocks_total",
            "KV blocks moved by the prefill->decode handoff, by kind "
            "(exported/adopted/reused)")
        self._mc_swaps = reg.counter("serve_weight_swaps_total",
                                     "weight swaps applied in place")
        self._mc_kv_fail = reg.counter(
            "serve_kv_transfer_failures_total",
            "refused/failed KV transfers by reason (corrupt/mismatch/push/adopt)")
        self._m_last = dict.fromkeys(
            ("admitted", "rejected", "evicted", "completed", "preempted",
             "iterations", "spec_proposed", "spec_accepted", "prefix_hits",
             "prefix_misses", "prefix_evictions"), 0)
        self._mg_mesh_devices = reg.gauge(
            "serve_mesh_devices", "devices in the serving mesh (1 = unsharded)")
        self._mg_mesh_axis = reg.gauge("serve_mesh_axis_size",
                                       "serving mesh axis size by name")
        self._mg_mesh_devices.set(1)
        self._mg_weight_bytes = reg.gauge("serve_weight_bytes",
                                          "bytes of resident model weights (as stored)")
        self._mg_weight_bytes.set(self._weight_bytes, weight_dtype=self.weight_dtype)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "BatchEngine":
        if self._thread is None:
            if self.cfg.stats_url:
                from ..obs.stats_client import StatsClient

                self._stats = StatsClient(self.cfg.stats_url, self.cfg.worker_id).start()
                self._stats.register({"role": "serve", "num_slots": self.cfg.num_slots,
                                      "max_len": self.cfg.max_len})
            if self.cfg.metrics_port and self._metrics_server is None:
                from ..obs.prometheus import start_metrics_server

                self._metrics_server = start_metrics_server(self.metrics_registry,
                                                            self.cfg.metrics_port)
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
        if self._stats is not None:
            self._stats.close()
            self._stats = None
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server = None

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
        weights; nothing is evicted. The prefix cache is emptied at the
        cutover (JAX's keeps its blocks: a later request sharing a cached
        prefix then decodes on KV of the old weights). A quantized engine
        quantizes an fp tree into its own dtype first, so the resident
        weights never change dtype. Moves the tree to the engine's device
        on the calling thread. Returns the new ``params_version``."""
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
            if self.pool.kind == "paged":
                self.pool.unpublish_all()
            self._weight_bytes = nbytes
            self._mc_swaps.inc()
            self._mg_weight_bytes.set(nbytes, weight_dtype=self.weight_dtype)
            return self.params_version

        return self.call_in_loop(cutover)

    def _paged_with_prefix(self, what: str):
        pool = self.pool
        if pool.kind != "paged" or pool.prefix is None:
            raise ValueError(f"KV {what} needs kv_backend='paged' with "
                             "prefix_cache=True")
        return pool

    def export_kv(self, token_ids: List[int], trace_id: Optional[str] = None):
        """The cached KV chain covering ``token_ids`` as a
        ``kv_transfer.KVTransferPayload``: pinned on the engine thread, read
        on this one, released on the engine thread."""
        from .kv_transfer import build_payload

        pool = self._paged_with_prefix("export")
        # the version is read with the pin, on the engine thread: a cutover
        # unpublishes every key, so what is published is the current weights'
        export, version = self.call_in_loop(
            lambda: (pool.export_blocks(token_ids), self.params_version))
        try:
            payload = build_payload(export, token_ids, pool.block_size,
                                    pool.quantize, params_version=version)
        finally:
            self.call_in_loop(lambda: pool.release_export(export))
        self._kv_transfer["exported"] += payload.num_blocks
        if payload.num_blocks:
            self._mc_kv_transfer.inc(payload.num_blocks, kind="exported")
        if self.tracer.enabled:
            self.tracer.instant("kv_export", trace_id=trace_id,
                                blocks=payload.num_blocks, bytes=payload.nbytes())
        return payload

    def adopt_kv(self, payload, trace_id: Optional[str] = None,
                 params_version: Optional[int] = None) -> Dict[str, int]:
        """Install a transferred payload into this engine's arena: the block
        size, the quantization and the chain keys are checked before any
        byte lands. KV that the sender computed on another ``params_version``
        than this engine serves (a rolling swap half done) is not adopted:
        every block counts as skipped, the failure as ``version_skew``, and
        the request prefills here. The version is compared on the engine
        thread, so no cutover falls between the check and the install.
        Returns the pool's adopt stats."""
        pool = self._paged_with_prefix("adopt")
        if payload.block_size != pool.block_size:
            raise ValueError(f"payload block_size {payload.block_size} != "
                             f"pool block_size {pool.block_size}")
        if bool(payload.quantized) != bool(pool.quantize):
            raise ValueError("payload/pool KV quantization mismatch "
                             f"({payload.quantized} vs {pool.quantize})")
        payload.verify_keys()

        def install():
            if params_version is not None and params_version != self.params_version:
                return None
            return pool.adopt_blocks(payload.keys, payload.blocks)

        stats = self.call_in_loop(install)
        if stats is None:
            self.note_kv_failure("version_skew")
            stats = {"adopted": 0, "reused": 0, "skipped": payload.num_blocks}
        for kind in ("adopted", "reused"):
            self._kv_transfer[kind] += stats.get(kind, 0)
            if stats.get(kind):
                self._mc_kv_transfer.inc(stats[kind], kind=kind)
        if self.tracer.enabled:
            self.tracer.instant("kv_adopt", trace_id=trace_id, **stats)
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
        self._mc_kv_fail.inc(reason=reason)

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
               stream: bool = False, trace_id: Optional[str] = None,
               prefill_only: bool = False) -> Request:
        """Tokenize and enqueue; raises QueueFullError (-> 429) past the
        queue bound, ValueError when the request can never fit a row. With
        ``stream=True`` the request carries a ``stream_q`` that the engine
        puts each emitted token id into, then None at the end. ``trace_id``
        keys this request's spans (one is minted when absent, so every
        result carries an id). ``prefill_only=True`` (the disaggregated
        handoff) finishes the request once its prompt KV is written and
        published: no token is sampled."""
        ids = [self.tokenizer.bos_id] + self.tokenizer.tokenize(prompt)
        return self._submit_ids(ids, max_tokens, temperature, seed, deadline_s,
                                stream=stream, trace_id=trace_id,
                                prefill_only=prefill_only)

    def _submit_ids(self, ids: List[int], max_tokens: int,
                    temperature: float, seed: int,
                    deadline_s: Optional[float] = None,
                    stream: bool = False, trace_id: Optional[str] = None,
                    prefill_only: bool = False) -> Request:
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
                      stop_ids=[self.tokenizer.eos_id],
                      prefill_only=prefill_only)
        if stream:
            req.stream_q = queue.Queue()
        from ..obs.trace import new_trace_id

        req.trace_id = trace_id or new_trace_id()
        self.scheduler.submit(req)
        self._wake.set()
        return req

    # Grace past the engine deadline before the caller forces eviction.
    WAIT_GRACE_S = 5.0

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None,
                 trace_id: Optional[str] = None) -> dict:
        """Blocking convenience for the HTTP front end; the wait follows the
        request's own deadline plus a short grace."""
        req = self.submit(prompt, max_tokens, temperature, seed, deadline_s,
                          trace_id=trace_id)
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
        """The JAX engine's keys (with the last publish's ``tok/s`` and the
        TTFT histogram's quantiles, sum and count), plus the port's device
        step counters."""
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
            "role": self.cfg.role,
            "params_version": self.params_version,
            "mesh": "1dev",
            "weight_dtype": self.weight_dtype,
            "weight_bytes": int(self._weight_bytes),
            "kv_transfer_blocks": dict(self._kv_transfer),
            "kv_transfer_failures": dict(self._kv_failures),
            "tok/s": 0.0,
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
        snap.update(self._metrics)
        return snap

    def _ttft_quantiles(self) -> Dict[str, float]:
        """p50/p95/p99 TTFT estimated from the bounded histogram, with its
        sum and count (a mean needs them)."""
        from ..obs.metrics import quantile_from_buckets

        snap = self.metrics_registry.snapshot().get("serve_ttft_ms")
        if not snap or not snap["series"]:
            return {}
        s = snap["series"][0]
        out: Dict[str, float] = {}
        for key, q in (("ttft_ms_p50", 0.5), ("ttft_ms_p95", 0.95),
                       ("ttft_ms_p99", 0.99)):
            v = quantile_from_buckets(s["buckets"], s["count"], q)
            if v is not None:
                out[key] = round(v, 1)
        if out:
            out["ttft_ms_sum"] = round(float(s["sum"]), 3)
            out["ttft_ms_count"] = int(s["count"])
        return out

    def _publish(self) -> None:
        """Every ``stats_interval_s``: the decode tok/s window, the TTFT
        quantiles, the registry's gauges and the scheduler's totals as
        counter increments, and the stats hub."""
        now = time.monotonic()
        if now - self._last_publish < self.cfg.stats_interval_s:
            return
        dt = max(now - self._win_t0, 1e-9)
        tok_s = self._win_tokens / dt
        self._win_t0, self._win_tokens = now, 0
        self._last_publish = now
        self._metrics = {"tok/s": round(tok_s, 2)}
        q = self._ttft_quantiles()
        if q:
            self._metrics.update(q)
            self._metrics["ttft_ms"] = q["ttft_ms_p50"]
        sched = self.scheduler.counters()
        pool = self.pool
        self._mg_occupancy.set(pool.num_used)
        self._mg_queue.set(sched["queue_depth"])
        self._mg_tok_s.set(tok_s)
        if pool.kind == "paged":
            self._mg_blocks_used.set(pool.blocks_in_use)
            self._mg_blocks_free.set(pool.free_blocks)
            self._mg_free_watermark.set(pool.read_watermark())
            self._mg_fragmentation.set(pool.fragmentation())
        prefix = getattr(pool, "prefix", None)
        cur = {"admitted": sched["admitted"], "rejected": sched["rejected"],
               "evicted": sched["evicted"], "completed": sched["completed"],
               "preempted": sched["preempted"], "iterations": self.iterations,
               "spec_proposed": self._spec_proposed,
               "spec_accepted": self._spec_accepted,
               "prefix_hits": prefix.hits if prefix else 0,
               "prefix_misses": prefix.misses if prefix else 0,
               "prefix_evictions": prefix.evictions if prefix else 0}
        last = self._m_last
        for k in ("admitted", "rejected", "evicted", "completed", "preempted"):
            if cur[k] > last[k]:
                self._mc_requests.inc(cur[k] - last[k], outcome=k)
        for k, kind in (("spec_proposed", "proposed"), ("spec_accepted", "accepted")):
            if cur[k] > last[k]:
                self._mc_spec.inc(cur[k] - last[k], kind=kind)
        dp = cur["spec_proposed"] - last["spec_proposed"]
        if dp > 0:
            self._mg_spec_rate.set((cur["spec_accepted"] - last["spec_accepted"]) / dp)
        for k, c in (("prefix_hits", self._mc_prefix_hits),
                     ("prefix_misses", self._mc_prefix_misses),
                     ("prefix_evictions", self._mc_prefix_evictions)):
            if cur[k] > last[k]:
                c.inc(cur[k] - last[k])
        if prefix is not None:
            self._mg_prefix_hit_rate.set(prefix.hit_rate())
        if cur["iterations"] > last["iterations"]:
            self._mc_iterations.inc(cur["iterations"] - last["iterations"])
        self._m_last = cur
        if self._stats is not None:
            self._stats.log_metrics(self.iterations, dict(
                self.metrics(), **{"tok/s": round(tok_s, 2)}))

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
        admitted = sched.admit(self.pool)
        if admitted and self.tracer.enabled:
            for r in admitted:
                # queue_wait closes at slot binding; the KV allocation and
                # any prefix-cache adoption happened inside admit()
                self.tracer.complete("queue_wait", r.admitted_at - r.submitted_at,
                                     trace_id=r.trace_id, end_mono=r.admitted_at,
                                     req=r.id)
                self.tracer.instant("kv_alloc", trace_id=r.trace_id, slot=r.slot,
                                    prompt_tokens=len(r.prompt_ids))
                if r.cached_tokens:
                    self.tracer.instant("prefix_adopt", trace_id=r.trace_id,
                                        cached_tokens=r.cached_tokens)
        busy = False
        pre = sched.prefilling()
        if pre:
            self._prefill_chunk(pre[0])
            busy = True
        dec = sched.decoding()
        if dec:
            self._decode(dec)
            busy = True
        self._publish()
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
        tr = self.tracer
        t0 = time.perf_counter() if tr.enabled else 0.0
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
        if tr.enabled:
            tr.complete("prefill_chunk", time.perf_counter() - t0,
                        trace_id=req.trace_id, req=req.id, start=start,
                        tokens=n, final=final)
        if not final:
            return
        pool.lengths[req.slot] = P
        if req.prefill_only:
            # The handoff's job was the prompt KV, written and published
            # block by block above; the adopting decode replica recomputes
            # the last prompt token's logits and samples there.
            if req.first_token_at is None:
                req.first_token_at = time.monotonic()
            self._finish(req, "prefill")
            return
        tok, lp = batch_step.sample_token(last_logits, req.temperature,
                                          self._generator(req))
        if req.first_token_at is None:  # kept across preemption re-prefill
            req.first_token_at = time.monotonic()
        self._emit(req, tok, lp)

    # Decode spans aggregate this many batched steps per request: one span
    # per token would swamp the ring at decode rates.
    DECODE_SPAN_TICKS = 8

    def _open_decode_spans(self, dec: List[Request]) -> None:
        now = time.perf_counter()
        for r in dec:
            if r._decode_t0 is None:
                r._decode_t0 = now

    def _tick_decode_spans(self, dec: List[Request]) -> None:
        for r in dec:
            r._decode_ticks += 1
            if r._decode_ticks >= self.DECODE_SPAN_TICKS and r.state != DONE:
                self._flush_decode_span(r)

    def _flush_decode_span(self, req: Request) -> None:
        if req._decode_t0 is not None and self.tracer.enabled:
            self.tracer.complete("decode", time.perf_counter() - req._decode_t0,
                                 trace_id=req.trace_id, req=req.id,
                                 ticks=req._decode_ticks)
        req._decode_t0 = None
        req._decode_ticks = 0

    def _decode(self, dec: List[Request]) -> None:
        if self.pool.kind == "paged":
            self._decode_paged(dec)
            return
        if self.tracer.enabled:
            self._open_decode_spans(dec)
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
        if self.tracer.enabled:
            self._tick_decode_spans(dec)

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
        if self.tracer.enabled:
            self._open_decode_spans(dec)
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
        if self.tracer.enabled:
            self._tick_decode_spans(dec)

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
            if self.tracer.enabled:
                self.tracer.instant("stream_emit", trace_id=req.trace_id,
                                    req=req.id, n=len(req.tokens))
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
        # the histograms record whether or not tracing is on
        if ttft_ms is not None:
            self._mh_ttft.observe(ttft_ms)
        for k, v in comp.items():
            self._mh_ttft_component.observe(v, component=k[:-3])
        if self.tracer.enabled:
            self._flush_decode_span(req)
            self.tracer.complete("request", done - req.submitted_at,
                                 trace_id=req.trace_id, end_mono=done, req=req.id,
                                 reason=reason, tokens=len(req.tokens))
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
            "trace_id": req.trace_id,
            **({"ttft_ms": round(ttft_ms, 3)} if ttft_ms is not None else {}),
            **{k: round(v, 3) for k, v in comp.items()},
        })
