"""The multi-rank launcher: every rank runs the same program, one device a
rank (the JAX package's ``parallel/launch.py``).

One rank of a world (each host runs one per device, or torchrun starts
them with ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``)::

    python -m mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch \\
        --config configs/model-config-1b-fsdp.yaml \\
        --coordinator host:port --num-processes N --process-id I [trainer flags]

All the ranks of one machine (they meet in a rendezvous file in a new
temporary directory: no port to collide with another launch)::

    python -m mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch \\
        --nproc-per-node N --config cfg.yaml [--device cpu] [trainer flags]

``--script file.py -- args`` runs a Python file in each rank instead of the
trainer, ``--module name -- args`` a module (as ``python -m``; the tp
serving mesh: ``--module mlx_cuda_distributed_pretraining_tpu_torch.infer.server
-- --engine batch --mesh tp=N ...``). The backend follows the device: NCCL on ``cuda`` (each rank takes
``cuda:LOCAL_RANK``), gloo on ``cpu``; ``--backend`` overrides it. A
failed NCCL rendezvous raises: nothing falls back to another backend or to
the CPU, and ``cuda`` with no GPU visible is an error.
"""

from __future__ import annotations

import argparse
import os
import runpy
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from .elastic import RendezvousError, process_barrier, rendezvous  # noqa: F401 - re-exported


def _local_rank(process_id: Optional[int]) -> int:
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return int(process_id or 0)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    rendezvous_timeout_s: float = 120.0,
    log=lambda m: print(m, file=sys.stderr),
    backend: Optional[str] = None,
    device: str = "cuda",
) -> bool:
    """Join the world (:func:`.elastic.rendezvous`); True when it has more
    than one rank. On ``cuda`` this rank's device is ``cuda:LOCAL_RANK``
    (the process id when ``LOCAL_RANK`` is unset) and the backend defaults
    to NCCL; on ``cpu`` to gloo."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the launcher runs ranks on cuda and no CUDA device is "
                               "visible; pass --device cpu to run gloo ranks on the CPU")
        torch.cuda.set_device(_local_rank(process_id) % torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    import torch.distributed as dist

    available = {"nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available()}
    if not available.get(backend, False):  # a build without it: no retry can help
        raise RuntimeError(f"torch.distributed has no {backend} backend in this build")
    return rendezvous(coordinator_address, num_processes, process_id,
                      backend=backend, timeout_s=rendezvous_timeout_s, log=log)


def _spawn_local(n: int, argv: List[str], timeout_s: Optional[float]) -> int:
    """Start ``n`` ranks of this launcher on this machine and wait for them;
    when one fails the rest are stopped. Returns the first non-zero exit
    code (0 when all succeed)."""
    rendezvous_dir = tempfile.mkdtemp(prefix="launch-")
    try:
        return _run_ranks(n, argv, timeout_s, "file://" + os.path.join(rendezvous_dir, "store"))
    finally:
        shutil.rmtree(rendezvous_dir, ignore_errors=True)


def _run_ranks(n: int, argv: List[str], timeout_s: Optional[float], coord: str) -> int:
    procs = []
    for i in range(n):
        env = dict(os.environ, LOCAL_RANK=str(i), RANK=str(i), WORLD_SIZE=str(n))
        cmd = [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch",
               "--coordinator", coord, "--num-processes", str(n), "--process-id", str(i),
               *argv]
        procs.append(subprocess.Popen(cmd, env=env))

    def stop_all(sig=signal.SIGTERM):
        for p in procs:
            if p.poll() is None:
                p.send_signal(sig)

    prev = signal.signal(signal.SIGTERM, lambda s, f: stop_all())
    deadline = None if not timeout_s else time.monotonic() + timeout_s
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [(i, p.returncode) for i, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed or (deadline is not None and time.monotonic() > deadline):
                rc = failed[0][1] if failed else 124
                print(f"[launch] rank {failed[0][0]} exited with {rc}; stopping the rest"
                      if failed else f"[launch] {timeout_s:g}s passed; stopping the ranks",
                      file=sys.stderr, flush=True)
                stop_all()
                break
            time.sleep(0.1)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return rc


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Multi-rank training launcher")
    parser.add_argument("--config", default=None)
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's store, or file://PATH for ranks "
                             "of one machine")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--rendezvous-timeout-s", type=float, default=120.0,
                        help="overall deadline for the rendezvous (retries with "
                             "backoff inside it)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: nccl on cuda, gloo on cpu")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--nproc-per-node", type=int, default=None,
                        help="start this many ranks on this machine and wait for them")
    parser.add_argument("--timeout-s", type=float, default=None,
                        help="with --nproc-per-node: stop the ranks after this long")
    parser.add_argument("--script", default=None,
                        help="run this Python file in each rank instead of the trainer")
    parser.add_argument("--module", default=None,
                        help="run this module (as python -m) in each rank instead "
                             "of the trainer")
    return parser


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args, extra = build_parser().parse_known_args(argv)
    if args.nproc_per_node is not None:
        child = list(argv)
        i = child.index("--nproc-per-node")
        del child[i:i + 2]
        rc = _spawn_local(args.nproc_per_node, child, args.timeout_s)
        if rc:
            sys.exit(rc)
        return 0
    if extra[:1] == ["--"]:
        extra = extra[1:]

    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           args.rendezvous_timeout_s, backend=args.backend,
                           device=args.device)
    import torch
    import torch.distributed as dist

    if os.environ.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    backend = dist.get_backend() if dist.is_initialized() else "none"
    print(f"[launch] rank {rank}/{world} backend {backend} device {args.device}",
          file=sys.stderr, flush=True)
    try:
        if args.script or args.module:
            sys.argv = [args.script or args.module, *extra]
            try:
                if args.script:
                    runpy.run_path(args.script, run_name="__main__")
                else:
                    runpy.run_module(args.module, run_name="__main__", alter_sys=True)
            except SystemExit as e:  # a module's main() ends in SystemExit
                if e.code not in (None, 0):
                    raise
            result = 0
        else:
            if not args.config:
                raise SystemExit("launch: --config (or --script) is required")
            from ..train.trainer import main as train_main

            result = train_main(["--config", args.config, "--runs-root", args.runs_root,
                                 "--device", args.device, *extra])
        # every rank is done before any tears its group down (rank 0 hosts
        # the store the others still talk to)
        process_barrier("launch_exit")
        return result
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
