"""The rendezvous half of the JAX package's ``parallel/elastic.py``:
joining the ranks of a run into a ``torch.distributed`` world, and a named
barrier that needs no device collective.

:func:`rendezvous` is ``init_process_group`` with the semantics a
preemptible fleet needs: a per-attempt timeout, bounded retry with
exponential backoff under an overall deadline, every failed attempt
logged, and a hard :class:`RendezvousError` when a coordinator was given
explicitly: a half-formed world must never fall through to N solo runs
that share one run dir. The rendezvous store (a ``TCPStore`` on the
coordinator's ``host:port``, hosted by rank 0; or, for ranks of one
machine, a ``FileStore`` at a ``file://`` path, which needs no port)
becomes the process group's default store, which owns it from then on,
and :func:`process_barrier` counts arrivals in it.

Generations, membership records and restart markers belong to the
multi-host supervisor (ROADMAP queue 1 item 10e).
"""

from __future__ import annotations

import os
import threading
import time
from datetime import timedelta
from typing import Callable, Dict, Optional

_BARRIERS: Dict[str, int] = {}


class RendezvousError(RuntimeError):
    """An explicitly configured rendezvous failed for good."""


class BarrierTimeoutError(RuntimeError):
    """A barrier timed out waiting on missing peers."""


def _split_address(address: str):
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not host:port")
    return host.strip("[]"), int(port)


def _connect_store(host: str, port: int, world_size: int, rank: int, timeout_s: float):
    """The rendezvous store within ``timeout_s``. The store's client bounds
    its connect but not the handshake after it, so a coordinator that
    accepts and never answers would hold a bare call forever: the call runs
    in a daemon thread, and an attempt that outlives the timeout raises
    ``TimeoutError`` (a store that connects later is dropped)."""
    import torch.distributed as dist

    box: dict = {}

    def connect():
        try:
            box["store"] = dist.TCPStore(
                host, port, world_size, is_master=(rank == 0),
                timeout=timedelta(seconds=max(1.0, float(timeout_s))), wait_for_workers=True)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller's thread
            box["error"] = e

    t = threading.Thread(target=connect, daemon=True, name="rendezvous-store")
    t.start()
    t.join(max(1.0, float(timeout_s)) + 1.0)
    if t.is_alive():
        raise TimeoutError(f"coordinator {host}:{port} accepted but did not answer "
                           f"within {timeout_s:g}s")
    if "error" in box:
        raise box["error"]
    return box["store"]


def _init_process_group(coordinator: str, world_size: int, rank: int, backend: str,
                        timeout_s: float) -> None:
    """One attempt: the store (rank 0 hosts it and waits for every rank),
    then the process group over it."""
    import torch.distributed as dist

    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], world_size)
        store.set_timeout(timedelta(seconds=max(1.0, float(timeout_s))))
    else:
        host, port = _split_address(coordinator)
        store = _connect_store(host, port, world_size, rank, timeout_s)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def rendezvous(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "gloo",
    timeout_s: float = 120.0,
    attempt_timeout_s: float = 30.0,
    backoff_base: float = 1.0,
    backoff_max: float = 15.0,
    log: Callable[[str], None] = print,
) -> bool:
    """Join the world; True when it has more than one rank.

    The coordinator, world size and rank come from the arguments, else
    from torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. With a coordinator (explicit mode) a failed attempt is
    retried with backoff until ``timeout_s`` elapses, each attempt capped
    at ``attempt_timeout_s`` (and the time left), then
    :class:`RendezvousError` is raised. With none, nothing is initialized
    and the run is single-process (logged)."""
    import torch.distributed as dist

    coordinator = coordinator_address
    if not coordinator and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not coordinator:
        log("[elastic] no coordinator configured; continuing single-process")
        return False

    n = int(num_processes if num_processes is not None else 1)
    rank = int(process_id if process_id is not None else 0)
    deadline = time.monotonic() + max(0.0, float(timeout_s))
    attempt = 0
    last_exc: Optional[BaseException] = None
    while True:
        attempt += 1
        remaining = deadline - time.monotonic()
        per_attempt = max(1.0, min(float(attempt_timeout_s), max(1.0, remaining)))
        try:
            _init_process_group(coordinator, n, rank, backend, per_attempt)
            log(f"[elastic] rendezvous ok: process {rank}/{n} via {coordinator} "
                f"({backend}, attempt {attempt})")
            return n > 1
        except (ValueError, RuntimeError, TimeoutError, OSError) as e:
            last_exc = e
            remaining = deadline - time.monotonic()
            log(f"[elastic] rendezvous attempt {attempt} failed "
                f"({type(e).__name__}: {e}); "
                f"{max(0.0, remaining):.1f}s left of {timeout_s:g}s budget")
            if remaining <= 0:
                break
            time.sleep(min(float(backoff_max), float(backoff_base) * (2.0 ** (attempt - 1)),
                           max(0.0, remaining)))
            if time.monotonic() >= deadline:
                break
    raise RendezvousError(
        f"could not rendezvous with coordinator {coordinator} as process "
        f"{rank}/{n} after {attempt} attempt(s) over {timeout_s:g}s: "
        f"{type(last_exc).__name__}: {last_exc}") from last_exc


def process_barrier(name: str, timeout_s: float = 120.0,
                    log: Callable[[str], None] = print) -> bool:
    """Block until every rank reaches the barrier ``name``, counted in the
    rendezvous store (no device collective, so it is safe before any
    device work). True at once outside a multi-rank world. A barrier whose
    peers do not all arrive within ``timeout_s`` raises
    :class:`BarrierTimeoutError`; any other store failure is logged and
    returns False."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _get_default_store

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return True
    store = _get_default_store()
    n = dist.get_world_size()
    _BARRIERS[name] = _BARRIERS.get(name, 0) + 1
    key = f"barrier/{name}/{_BARRIERS[name]}"
    try:
        if store.add(key, 1) == n:
            store.set(key + "/open", "1")
        store.wait([key + "/open"], timedelta(seconds=max(0.001, float(timeout_s))))
        return True
    except Exception as e:  # noqa: BLE001 - classified below
        if "timeout" in str(e).lower() or "timed out" in str(e).lower():
            raise BarrierTimeoutError(
                f"barrier {name!r}: not every one of {n} ranks arrived within "
                f"{timeout_s:g}s") from e
        log(f"[elastic] process barrier {name!r} failed ({type(e).__name__}: {e}); "
            "continuing without sync")
        return False
