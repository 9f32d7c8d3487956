"""Continuous-batching inference engine over a paged or slotted KV pool.

- ``kv_pool``      — the slotted pool, and the paged arena with its block
  tables, refcounts and KV export/adopt;
- ``prefix_cache`` — content-hash keys for full KV blocks + the LRU list;
- ``batch_step``   — the prefill and decode steps of both pools, sampling
  and speculative verification;
- ``kv_transfer``  — the GKV1 payload that moves KV blocks between engines;
- ``faults``       — the serving fault points;
- ``scheduler``    — admission queue, deadlines, preemption;
- ``engine``       — the engine thread tying them together.
"""

from .engine import BatchEngine, EngineConfig, QueueFullError
from .kv_pool import KVExport, PagedKVPool, SlotKVPool
from .prefix_cache import PrefixCache
from .scheduler import AdmissionRefusedError, Request, Scheduler

__all__ = [
    "AdmissionRefusedError",
    "BatchEngine",
    "EngineConfig",
    "KVExport",
    "PagedKVPool",
    "PrefixCache",
    "QueueFullError",
    "Request",
    "Scheduler",
    "SlotKVPool",
]
