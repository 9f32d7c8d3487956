"""Continuous-batching inference engine over a paged or slotted KV pool,
and the serving plane around it.

- ``kv_pool``      — the slotted pool, and the paged arena with its block
  tables, refcounts and KV export/adopt;
- ``prefix_cache`` — content-hash keys for full KV blocks + the LRU list;
- ``batch_step``   — the prefill and decode steps of both pools, sampling
  and speculative verification;
- ``kv_transfer``  — the GKV1 payload that moves KV blocks between engines,
  and its push over HTTP;
- ``faults``       — the serving fault points;
- ``scheduler``    — admission queue, deadlines, preemption;
- ``engine``       — the engine thread tying them together;
- ``policy``       — the outbound-call policy of every serving-plane call:
  ``X-Deadline-Ms`` deadlines, jittered backoff, retry budgets, breakers;
- ``router``       — the prefix-affinity front door over many replicas;
- ``fleet``        — disaggregated prefill/decode pools, KV handoff,
  membership, autoscaling, drain and rolling weight swaps.
"""

from . import faults
from .engine import BatchEngine, EngineConfig, QueueFullError
from .fleet import FleetConfig, FleetController, FleetRouter
from .kv_pool import KVExport, PagedKVPool, SlotKVPool
from .kv_transfer import KVTransferPayload
from .policy import (
    DEADLINE_HEADER,
    AdmissionRefusedError,
    BreakerOpenError,
    CallPolicy,
    Deadline,
    DeadlineExceeded,
    PolicyConfig,
)
from .prefix_cache import PrefixCache
from .router import Router, serve_router
from .scheduler import Request, Scheduler

__all__ = [
    "AdmissionRefusedError",
    "BatchEngine",
    "BreakerOpenError",
    "CallPolicy",
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "EngineConfig",
    "FleetConfig",
    "FleetController",
    "FleetRouter",
    "KVExport",
    "KVTransferPayload",
    "PagedKVPool",
    "PolicyConfig",
    "PrefixCache",
    "QueueFullError",
    "Request",
    "Router",
    "Scheduler",
    "SlotKVPool",
    "faults",
    "serve_router",
]
