"""Continuous-batching inference engine over a paged KV pool.

- ``kv_pool``      — the paged arena, block tables and refcounts;
- ``prefix_cache`` — content-hash keys for full KV blocks + the LRU list;
- ``batch_step``   — the paged prefill and decode steps and sampling;
- ``scheduler``    — admission queue, deadlines, preemption;
- ``engine``       — the engine thread tying them together.
"""

from .engine import BatchEngine, EngineConfig, QueueFullError
from .kv_pool import PagedKVPool
from .prefix_cache import PrefixCache
from .scheduler import AdmissionRefusedError, Request, Scheduler

__all__ = [
    "AdmissionRefusedError",
    "BatchEngine",
    "EngineConfig",
    "PagedKVPool",
    "PrefixCache",
    "QueueFullError",
    "Request",
    "Scheduler",
]
