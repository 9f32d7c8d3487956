"""The trainer, on one device or over the ranks of a mesh, and loading a
trained run for serving.

    python -m mlx_cuda_distributed_pretraining_tpu_torch.train.trainer \\
        --config configs/model-config-40m-adamw.yaml [--device cpu] \\
        [--auto-resume [--hang-timeout-s 900]]
    python -m mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch \\
        --nproc-per-node N --config cfg.yaml [trainer flags]

:class:`Trainer` follows the JAX trainer: seeded init, the
data loader (``data.streaming.build_data_manager``: the in-memory JSONL
loader, streaming JSONL / WebDataset tar shards, synthetic documents, the
HuggingFace hub stream, or pre-tokenized token shards, whose index gives
the vocabulary) behind the device prefetcher (``data.prefetch_depth``
batches copied ahead of the step loop through pinned buffers on a side
stream; a finite stream that runs dry ends the run), the bf16 forward
over fp32 master weights (flash attention on the CUDA kernels when the
config asks for it; an MoE model's experts on the grouped-GEMM kernels,
forward and backward; the named remat policies over the first
``system.gradient_checkpointing_ratio`` of the layers; the fused chunked
CE), the fp32 cross-entropy plus an MoE model's router losses, the
backward, the optimizer (every update rule of the JAX factory: the fused
AdamW, the chained AdamW / Adam / SGD / Lion and their EMA variants, Muon,
Shampoo, Adafactor, hybrid), the LR finder (``training.lr_finder``: a
momentum-SGD sweep whose suggestion the run adopts, skipped on resume, as
in JAX), the log line protocol (with routing stats for an MoE model, and
each window's summed ``data_wait_s`` and ``h2d_wait_s`` kept in
``Trainer.windows``), validation (pure cross-entropy) and early stopping
on it, greedy samples at each validation step (``logging.log_samples``,
through ``infer/generate.py``), and interval and ``final`` checkpoints in
the ``runs/`` layout both packages read. It runs on ``cuda`` unless the
caller asks for the CPU.

Checkpoints: interval saves write in the background
(``system.async_checkpointing``, default on) after the state is copied to
host memory; the final and preemption saves block. Each carries the data
position and the early-stopping state in ``step_<N>_state.json``.
Retention GC (``logging.retention``: ``keep_last``, ``keep_every``) runs
after each save. ``resume.checkpoint`` (a step tag, or ``latest`` for the
newest one that verifies) resumes a run in place, with
``resume.reset_optimizer``, ``resume.reset_training_state`` and
``resume.strict`` as in JAX. The saved data position is the one the step
loop consumed (the prefetcher's), in the JAX package's keys, so a
streaming run resumes exactly in either package. SIGTERM or SIGINT saves a
checkpoint
at the next step boundary, after the writes in flight, and ends the run;
a checkpoint write that failed raises out of :meth:`Trainer.train` once
the save in hand is written.

``model.architecture`` resolves through ``models/registry.py`` as in the
JAX trainer: an unknown name raises, and ``llama_standard`` /
``llama_flash`` force simple / flash attention.
``model.matmul_precision: int8`` trains: the MoE experts on the
``gmm_int8`` kernel, attention on int8-gridded q/k/v over the flash
kernels, both with a straight-through backward.

Telemetry, as in the JAX trainer (none of it changes a number the trainer
computes): a metrics registry (``obs/metrics.py``) that the checkpoint
manager and the prefetcher record into too, served as Prometheus text on
``logging.metrics_port``; ``<run_dir>/events.jsonl`` (``obs/events.py``),
replayed into the registry before the run and then appended to
(``run_start``, ``resume``, ``compile``, ``step_window``,
``checkpoint_save``, ``eval``, ``profiler``, ``profile_report``,
``trace_capture``, ``run_end``); ``<run_dir>/heartbeat.json`` at the start,
after every log window, save and validation, which the supervisor's hang
watchdog reads; the goodput ledger (``obs/flops.py``), whose window
breakdown rides the log line (``data_wait_s``, ``h2d_wait_s``,
``dispatch_s``, ``compile_s`` (the run's first step), ``ckpt_save_s``,
``eval_s``, ``other_s``, ``data_wait_frac``); with ``logging.trace``
enabled, a span per goodput booking (``obs/trace.py``), written to
``<run_dir>/trace.json`` at exit; SIGUSR2 records spans and a profile of
the next ``trace.capture_steps`` steps into ``trace_step<N>.json``;
``logging.profile_start`` / ``profile_stop`` capture those steps with
``torch.profiler`` (``obs/profiler.py``) into ``<run_dir>/profile/`` and
attribute them (``prof_summary.json``, and ``prof_*`` fields in later
``step_window`` events); ``logging.metrics.stats_url`` publishes each log
line to a stats hub; TensorBoard and W&B through the logger.
``--auto-resume`` runs the trainer under ``train/supervisor.py``.

The mesh (``parallel/``), as the JAX trainer builds it: ``system.mesh`` over
the ranks of the ``torch.distributed`` world (``parallel.launch``, one
device a rank), or with no mesh a pure-dp one over every rank of a
multi-rank world; one rank and no mesh is the one-device path. dp and fsdp
train, with ZeRO-1 (``system.zero_optimization_level``) and fsdp's
per-layer gather (``system.overlap_gather`` prefetches it): each rank holds
its blocks of the state and serves its own rows (the in-memory loader keeps
rows ``rank::world``; ``training.batch_size`` is per rank, the global batch
the ranks' batches in rank order, as with JAX's processes). The chief (rank
0) writes the run directory's logs, events, config and checkpoints (the
full state, gathered: the files are the one-device layout, and load on any
mesh); every rank of a mesh run writes its own data position,
``step_<N>_data_p<i>.json``, and a resume on another world size remaps the
positions (``data.streaming.remap_data_states``). The ranks agree on each
step boundary's stop (a signal, a dry stream) through a gloo group on the
host. tp trains too (``models/llama.py``'s Megatron collectives): the ranks
of one tp group read the same rows (the loader's position is the rank's
among the data axes, ``parallel.mesh.data_coords``) and one of them writes
the group's sidecar, ``step_<N>_data_p<data index>.json``. ep trains too
(``models/moe.py``'s expert-parallel dispatch): it is a data axis whose
ranks also split the expert banks. An sp or pp axis above 1 raises, naming
its ROADMAP item; so do ep beside tp and the LR finder over several
ranks.

A run directory (written by either trainer) holds ``config.yaml``, the
tokenizer under ``tokenizer/`` and ``checkpoints/step_<tag>_model.safetensors``
files; :func:`load_trained` reads the newest verified one into the port's
parameters.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import (
    CheckpointIntegrityError,
    CheckpointManager,
    StaleBackgroundWriteError,
    _atomic_json,
    shard_arrays,
)
from ..checkpoint.safetensors_io import load_safetensors
from ..config import Config, apply_overrides, read_config_dict
from ..data.device_prefetch import DevicePrefetcher
from ..data.streaming import build_data_manager
from ..models import llama
from ..models.llama import LlamaArgs
from ..models.registry import resolve_architecture
from ..obs.events import (
    EventLog,
    events_path,
    heartbeat_path,
    replay_into,
    write_heartbeat,
)
from ..obs.flops import GoodputLedger, model_flops_per_token, peak_flops_per_chip
from ..obs.flops import mfu as compute_mfu
from ..obs.logger import Logger
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer
from ..optim.factory import build_optimizer
from ..optim.schedules import build_schedule, schedule_value
from ..parallel.collectives import EXCHANGES
from ..parallel.elastic import process_barrier
from ..parallel.mesh import (
    AXIS_ORDER,
    build_mesh,
    data_coords,
    mesh_axis_sizes,
    refuse_unported_axes,
    world_rank,
    world_size,
)
from ..tokenizer import TokenizerManager
from ..utils.tree import tree_map
from .early_stopping import EarlyStoppingMonitor
from .lr_finder import run_lr_finder
from .train_step import (
    gather_state,
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
    shard_state,
)


def resolve_mesh(system_cfg, batch_size: int):
    """The run's mesh, as the JAX trainer builds it: ``system.mesh`` (or the
    legacy ``model_parallel``) over the ranks of the world; with none, a
    pure-dp mesh over every rank of a multi-rank world (whose per-rank batch
    it must divide, as JAX requires of its global batch); None for one rank
    and no mesh. An sp or pp axis above 1 raises, naming its ROADMAP item,
    and so does ep beside tp."""
    sizes = {k: int(v) for k, v in (system_cfg.mesh or {}).items()}
    if not sizes and system_cfg.model_parallel:
        sizes = {"dp": -1, "tp": max(1, int(system_cfg.model_parallel_size))}
    unknown = set(sizes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}")
    refuse_unported_axes(sizes)
    world = world_size()
    fixed = math.prod(v for v in sizes.values() if v > 0)
    if fixed > world:
        raise ValueError(f"mesh {sizes} needs {fixed} devices, have {world} (a rank a "
                         f"device): start the ranks with parallel.launch --nproc-per-node "
                         f"{fixed}")
    if not sizes:
        if world == 1:
            return None
        if batch_size % world:
            raise ValueError(f"training.batch_size {batch_size} does not divide over "
                             f"{world} ranks for the implicit dp mesh")
    refuse_unported_axes(mesh_axis_sizes(system_cfg, world))
    return build_mesh(system_cfg)


def kernel_launches() -> Dict[str, Any]:
    """The hand-written kernels' launch counters of this process (since it
    started, or the last ``reset_launches``), by kernel and by variant: a
    run in a process of its own (``parallel.launch``) reports its kernels
    in its ``run_end`` event."""
    from ..ops import flash_attention as fa
    from ..ops import grouped_matmul as gm

    out: Dict[str, Any] = {n: getattr(gm, n).launches for n in ("gmm", "tgmm", "gmm_int8")}
    for n in ("gmm", "tgmm"):
        fn = getattr(gm, n)
        out[n + "_by_variant"] = dict(fn.launches_by_variant)
        # "variant:T:K:N:block_t" (JSON keys)
        out[n + "_by_shape"] = {":".join(map(str, k)): v
                                for k, v in fn.launches_by_shape.items()}
    for n in fa.FLASH_KERNELS:
        out[n] = getattr(fa, n).launches
        out[n + "_by_variant"] = dict(getattr(fa, n).launches_by_variant)
    return out


def _meta_like(tree: Any) -> Any:
    """Full-shape ``meta`` stand-ins of a tensor tree (other leaves kept)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
                    if isinstance(x, torch.Tensor) else x, tree)


def load_into(live: Any, loaded: Any) -> Any:
    """Copy a loaded tree into the live one in place: tensors keep their
    device, dtype and ``requires_grad``; other leaves are replaced. A
    ``meta`` leaf (a key the file lacked, under a mesh's full-shape
    stand-ins) keeps the live value."""
    def one(a, b):
        if isinstance(b, torch.Tensor) and b.is_meta:
            return a
        return a.copy_(b) if isinstance(a, torch.Tensor) else b

    with torch.no_grad():
        return tree_map(one, live, loaded)


def routing_line(window: List[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> Tuple[Dict[str, Any], np.ndarray]:
    """A log window's routing stats from its steps' ``(moe_load [E],
    moe_dropped)``: the normalised balance entropy (1.0 uniform, 0.0 one
    expert takes all), dropped selections, and the busiest expert's share;
    the JAX trainer's arithmetic. Also each expert's share, for the
    registry's gauge. Reads the device once."""
    load = np.asarray(sum(m[0] for m in window).cpu(), np.float64)
    dropped = int(sum(m[1] for m in window))
    frac = load / max(load.sum(), 1.0)
    nz = frac[frac > 0]
    entropy = float(-(nz * np.log(nz)).sum() / math.log(max(len(load), 2)))
    return {"moe_entropy": entropy, "moe_drop": dropped,
            "moe_load_max": float(frac.max())}, frac


class Trainer:
    def __init__(self, config: Any, runs_root: str = "runs", quiet: bool = False,
                 device="cuda"):
        self.config: Config = config if isinstance(config, Config) else Config.from_yaml(config)
        cfg = self.config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer runs on cuda by default and no CUDA "
                               "device is visible; pass device='cpu' to train "
                               "on the CPU")
        self.mesh = resolve_mesh(cfg.system, cfg.training.batch_size)
        self.rank, self.world = world_rank(), world_size()
        self.is_chief = self.rank == 0
        # the loader's position among the data ranks (a tp group shares one)
        self.data_index, self.data_count = data_coords(self.mesh)
        self.data_writer = self.mesh is None or self.mesh.coord("tp") == 0
        # the ranks' stop decisions travel on the host (a gloo group), so
        # agreeing on one costs no device sync
        self._ctrl_group = None
        if self.world > 1:
            import torch.distributed as dist

            self._ctrl_group = dist.new_group(backend="gloo")

        # a step tag, 0 included: a --set override parses "0" as the number,
        # which JAX's bool() test reads as no resume at all
        tag = None if cfg.resume is None else cfg.resume.checkpoint
        resume = tag is not None and tag is not False and str(tag) != ""
        self.run_dir = os.path.join(runs_root, cfg.name)
        if resume:  # continue in the run's own directory
            os.makedirs(os.path.join(self.run_dir, "checkpoints"), exist_ok=True)
        elif self.is_chief:  # the chief's setup lands before any rank writes
            CheckpointManager.setup_run_directory(runs_root, cfg.name, cfg.overwrite)
        process_barrier("run_dir_setup")
        self.logger = Logger(self.run_dir, cfg, quiet=quiet or not self.is_chief,
                             write_files=self.is_chief)
        # One registry per Trainer: the checkpoint manager and the
        # prefetcher record into it, Prometheus and the stats hub read it.
        self.metrics = MetricsRegistry()
        # Integrity events (quarantine, GC, ledger rebuild) go to log.txt.
        self.checkpoints = CheckpointManager(
            self.run_dir, keep_last=cfg.logging.keep_last,
            keep_every=cfg.logging.keep_every, notify=self.logger.log,
            metrics=self.metrics)
        if self.is_chief:
            cfg.to_yaml(os.path.join(self.run_dir, "config.yaml"))
        self.tokenizer = TokenizerManager(cfg.data,
                                          run_dir=self.run_dir if self.is_chief else None)

        # model.architecture as the JAX trainer resolves it: an unknown name
        # raises, llama_standard / llama_flash force the attention
        self.arch = resolve_architecture(cfg.model.architecture)
        args = LlamaArgs.from_config(cfg.model, self._vocab_size())
        if self.arch.force_attention:
            args = dataclasses.replace(args, attention_type=self.arch.force_attention)
        self.model_args = args
        params = self.arch.init_params(
            args, torch.Generator().manual_seed(cfg.system.seed), device=self.device)
        self.n_params = llama.num_params(params)
        self.logger.log_model_summary(self.n_params, args)

        self.compute_dtype = (torch.bfloat16 if cfg.system.compute_dtype == "bfloat16"
                              else torch.float32)
        # model.remat_policy first, then system.remat, then the legacy
        # gradient_checkpointing bool, as in the JAX trainer
        remat = cfg.model.remat_policy or cfg.system.remat
        if remat is None and cfg.system.gradient_checkpointing:
            remat = "full"
        self.remat = llama.normalize_remat(remat)
        self.remat_ratio = float(cfg.system.gradient_checkpointing_ratio)
        kw = dict(compute_dtype=self.compute_dtype,
                  ce_chunk=int(cfg.system.fused_ce_chunk),
                  scan_layers=bool(cfg.system.scan_layers))
        # MoE steps carry the routing stats out beside the token count.
        self.moe_stats_experts = args.num_local_experts if args.is_moe else 0
        self.loss_fn = loss_fn = make_loss_fn(
            args, remat=self.remat, remat_ratio=self.remat_ratio,
            z_loss_weight=float(cfg.training.hyperparameters.get("z_loss") or 0.0),
            overlap=bool(cfg.system.overlap_gather),
            with_moe_stats=bool(self.moe_stats_experts), **kw)
        # Validation leaves out the router losses: val_loss stays pure
        # cross-entropy, comparable across dense and MoE runs.
        eval_loss_fn = make_loss_fn(args, include_aux=False, **kw)

        self.data = build_data_manager(cfg, self.tokenizer, cfg.training.batch_size,
                                       seq_len=cfg.data.max_context_size,
                                       seed=cfg.system.seed,
                                       process_index=self.data_index,
                                       process_count=self.data_count)
        # the position the step loop consumed, once train() runs
        self.prefetcher: Optional[DevicePrefetcher] = None
        if cfg.training.iters:
            self.total_steps = cfg.training.iters
        elif hasattr(self.data, "batches_per_epoch"):
            self.total_steps = (cfg.training.epochs or 1) * self.data.batches_per_epoch
        else:
            raise ValueError("streaming data sources require training.iters")
        self.schedule = build_schedule(cfg.training, max(self.total_steps, 1))
        self.optimizer = build_optimizer(cfg.training, max(self.total_steps, 1),
                                         schedule=self.schedule)
        self.accum_steps = cfg.training.gradient_accumulation_steps
        self.zero_level = int(cfg.system.zero_optimization_level or 0)
        # the full shapes, for the mesh's layout and the checkpoint loads
        self._params_like = _meta_like(params)
        self.train_step = self._build_train_step()
        self.eval_step = make_eval_step(eval_loss_fn, mesh=self.mesh,
                                        params_like=self._params_like)
        self.state = self._init_state(params)

        self.early_stopping = EarlyStoppingMonitor.from_config(cfg.training)
        self.start_step = 0
        self.total_tokens = 0
        self.eval_batches = 0  # validation batches run (each one a forward)
        self.windows: list = []  # one dict per log line
        self.val_history: Dict[str, list] = {"steps": [], "losses": []}
        self.flops_per_token = model_flops_per_token(
            cfg.model, self.n_params, cfg.data.max_context_size)
        self.peak_flops = (peak_flops_per_chip(torch.cuda.get_device_name(self.device))
                           if self.device.type == "cuda" else None)
        if self.mesh is not None:
            self.logger.log(f"mesh {self.mesh.shape} over {self.world} rank(s); "
                            f"zero_optimization_level {self.zero_level}")
        self._init_telemetry()
        if resume:
            self._resume()

    def _build_train_step(self):
        return make_train_step(
            self.loss_fn, self.optimizer, accum_steps=self.accum_steps,
            log_grad_norm=self.config.logging.log_gradient_norm,
            moe_stats_experts=self.moe_stats_experts, mesh=self.mesh,
            zero_level=self.zero_level, params_like=self._params_like)

    def _init_state(self, params):
        """The train state of full ``params`` (this rank's blocks of it
        under a mesh)."""
        state = init_train_state(params, self.optimizer)
        if self.mesh is None:
            return state
        return shard_state(state, self.train_step.shardings, self.mesh)

    def _full_state(self):
        """The full params and optimizer state (gathered from every rank's
        blocks under a mesh: a collective all ranks run), on the chief; the
        other ranks' leaves are None."""
        if self.mesh is None:
            return self.state
        return gather_state(self.state, self.train_step.shardings, self.mesh,
                            chief_only=True)

    def _agree(self, *flags: bool) -> List[bool]:
        """Each flag OR-ed over the ranks (the flags themselves on one)."""
        if self._ctrl_group is None:
            return [bool(f) for f in flags]
        import torch.distributed as dist

        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._ctrl_group)
        return [bool(v) for v in t.tolist()]

    def _init_telemetry(self) -> None:
        """The registry's metrics, the goodput ledger, the span tracer, the
        profiler, the stats client, ``events.jsonl`` (replayed into the
        registry first, so its counters survive restarts) and the
        heartbeat, as the JAX trainer sets them up."""
        from ..obs.profiler import ProfileCapture

        cfg = self.config
        self.stats_client = None
        if cfg.logging.stats_url:
            from ..obs.stats_client import StatsClient

            self.stats_client = StatsClient(cfg.logging.stats_url,
                                            worker_id=f"{cfg.name}-p{self.rank}").start()
            self.stats_client.register({"devices": 1})
        self.goodput = GoodputLedger()
        # Each goodput booking is mirrored by a span of the same duration,
        # so a window's span sums reconcile with its ledger fields.
        tcfg = dict(cfg.logging.trace or {})
        self.tracer = Tracer(f"trainer-p{self.rank}", capacity=int(tcfg.get("capacity", 65536)),
                             sample=float(tcfg.get("sample", 1.0)),
                             enabled=bool(tcfg.get("enabled", False)))
        self._trace_capture_steps = int(tcfg.get("capture_steps", 20))
        self._trace_request = 0  # bumped by SIGUSR2
        self._trace_until = 0    # the on-demand window's end step (exclusive)
        self._trace_owns_prof = False
        self._trace_prev_enabled = self.tracer.enabled
        # a rank other than the chief profiles into files of its own
        suffix = "" if self.is_chief else f"_p{self.rank}"
        self.profiler = ProfileCapture(
            os.path.join(self.run_dir, "profile" + suffix), log=self.logger.log,
            sync=self._sync, analytic_fn=self._prof_analytic,
            summary_path=os.path.join(self.run_dir, f"prof_summary{suffix}.json"),
            report=cfg.logging.profile_report_enabled,
            top_k=cfg.logging.profile_report_top_k,
            cuda=self.device.type == "cuda")
        # the last attribution's fractions, merged into later step_window events
        self._prof_fields: Dict[str, float] = {}
        self._compiled = False  # the first step books into compile_s
        self._metrics_server = None
        # events.jsonl is the chief's (one file a run); every rank beats its
        # own heartbeat (heartbeat_p<i>.json past rank 0)
        self.events: Optional[EventLog] = None
        if self.is_chief:
            replayed = replay_into(self.metrics, events_path(self.run_dir))
            if replayed:
                self.logger.log(f"telemetry: registry rebuilt from {replayed} events "
                                f"in {events_path(self.run_dir)}")
            self.events = EventLog(events_path(self.run_dir),
                                   max_bytes=cfg.logging.events_max_bytes)
        self._hb_path = heartbeat_path(self.run_dir, self.rank)
        self._hb_step = self.start_step
        m = self.metrics
        self._m_steps = m.counter(
            "train_steps_total", "optimizer steps completed over the run lifetime")
        self._m_toks = m.counter("train_tokens_total", "non-pad target tokens trained on")
        self._m_saves = m.counter("checkpoint_saves_total", "checkpoints written")
        self._m_evals = m.counter("eval_runs_total", "validation passes")
        self._m_goodput = m.counter(
            "goodput_seconds_total", "wall-clock seconds by goodput component")
        self._g_step = m.gauge("train_step", "current optimizer step")
        self._g_loss = m.gauge("train_loss", "last logged train loss")
        self._g_tok_s = m.gauge("train_tok_s", "global tokens/second over the last window")
        self._g_mfu = m.gauge("train_mfu", "model FLOPs utilization over the last window")
        self._g_grad_norm = m.gauge(
            "train_grad_norm", "global gradient norm over the last window")
        self._m_nonfinite = m.counter(
            "train_nonfinite_total", "logging windows whose loss came back NaN/Inf")
        self._g_prof = {
            "prof_compute_frac": m.gauge(
                "prof_compute_frac", "step time in compute ops (last attribution)"),
            "prof_comm_frac": m.gauge(
                "prof_comm_frac", "step time in EXPOSED collectives (not hidden "
                "under compute) from the last attribution"),
            "prof_overlap_frac": m.gauge(
                "prof_overlap_frac", "fraction of collective time overlapped with "
                "compute (1.0 = fully hidden) from the last attribution"),
            "prof_idle_frac": m.gauge(
                "prof_idle_frac", "step time with no device op running (last "
                "attribution)"),
        }
        if self.moe_stats_experts:
            self._m_moe_dropped = m.counter(
                "moe_dropped_tokens_total",
                "expert selections dropped by capacity limits (0 when dropless)")
            self._g_moe_load = m.gauge(
                "moe_expert_load_frac",
                "per-expert fraction of routed selections over the last window")
            self._g_moe_entropy = m.gauge(
                "moe_balance_entropy",
                "normalized routing entropy over the last window (1.0 = uniform)")

    # -- telemetry helpers -------------------------------------------------------
    def _book(self, component: str, dur_s: float, **args) -> None:
        """A goodput booking, mirrored by a span of the same duration when
        tracing is on (``seconds``: the span's ``dur`` is whole µs)."""
        self.goodput.add(component, dur_s)
        if self.tracer.enabled:
            self.tracer.complete(component[:-2], dur_s, seconds=dur_s, **args)

    def _touch_heartbeat(self, step: Optional[int] = None) -> None:
        if step is not None:
            self._hb_step = int(step)
        try:
            write_heartbeat(self._hb_path, self._hb_step, process_index=self.rank)
        except OSError:
            pass  # the heartbeat is advisory; never kill training over it

    def _prof_analytic(self) -> Dict[str, Any]:
        """The report's analytic join: the 6N matmul term and the attention
        residual of the trainer's FLOPs per token."""
        cfg = self.config
        matmul = 6.0 * float(self.n_params)
        return {"tokens_per_step": float(cfg.training.batch_size)
                * float(cfg.data.max_context_size),
                "matmul_flops_per_token": matmul,
                "attn_flops_per_token": max(0.0, float(self.flops_per_token) - matmul)}

    def _apply_profile_report(self, report, step: Optional[int]) -> None:
        """One attribution to the gauges, the event log and the run log."""
        if not report:
            return
        from ..obs.profile_report import prof_fields

        fields = prof_fields(report)
        self._prof_fields = fields
        for name, val in fields.items():
            self._g_prof[name].set(val)
        agg = report["aggregate"]
        self.logger.log(
            f"graftprof: steps={agg['n_steps']} "
            f"compute={fields['prof_compute_frac']:.3f} "
            f"comm_exposed={fields['prof_comm_frac']:.3f} "
            f"overlap={fields['prof_overlap_frac']:.3f} "
            f"idle={fields['prof_idle_frac']:.3f} "
            f"(summary: {self.profiler.summary_path})")
        if self.events is not None:
            ev = dict(fields)
            if step is not None:
                ev["step"] = int(step)
            self.events.append("profile_report", **ev)

    def _vocab_size(self) -> int:
        """The tokenizer's vocabulary; for ``token_shards`` the shard
        index's, as in the JAX trainer (the tokenizer then only samples)."""
        data = self.config.data
        if data.source == "token_shards":
            shard_dir = data.input_file or (data.streaming or {}).get("shard_dir")
            index = os.path.join(shard_dir or "", "index.json")
            if shard_dir and os.path.isfile(index):
                with open(index) as f:
                    return int(json.load(f).get("vocab_size", self.tokenizer.vocab_size))
        return self.tokenizer.vocab_size

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- validation and checkpoints ---------------------------------------------
    def validate(self, cap: int = 50) -> Optional[float]:
        """Token-weighted validation loss over at most ``cap`` batches. Its
        wall clock books into goodput as ``eval_s``; a pass that ran counts
        in the registry and ``events.jsonl``."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("eval"):
            result = self._validate_inner(cap)
        dt = time.perf_counter() - t0
        self._book("eval_s", dt)
        if result is not None:
            self._m_evals.inc()
            if self.events is not None:
                self.events.append("eval", loss=result, seconds=round(dt, 4))
        self._touch_heartbeat()
        return result

    def _validate_inner(self, cap: int) -> Optional[float]:
        if not self.data.has_validation_data:
            return None
        total_nll = total_toks = None
        for batch in self.data.iter_validation(cap):
            loss, toks = self.eval_step(self.state["params"], self._device_batch(batch))
            self.eval_batches += 1
            nll = loss * toks
            total_nll = nll if total_nll is None else total_nll + nll
            total_toks = toks if total_toks is None else total_toks + toks
        if total_nll is None or float(total_toks) == 0:
            return None
        return float(total_nll) / float(total_toks)

    def save_checkpoint(self, step, blocking: bool = True) -> None:
        """Save the state as ``step`` (a number or "final"); the training
        state carries the data position and the early-stopping state. With
        ``blocking=False`` the disk write runs in the background once the
        host copies exist. The save's cost to the loop books into goodput
        as ``ckpt_save_s`` and lands in ``events.jsonl``; the heartbeat is
        refreshed after it, so a long save never trips the watchdog."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("checkpoint_save"):
            self._save_checkpoint_inner(step, blocking)
        dt = time.perf_counter() - t0
        self._book("ckpt_save_s", dt, step=str(step))
        self._m_saves.inc()
        if self.events is not None:
            self.events.append("checkpoint_save", step=step, seconds=round(dt, 4),
                               blocking=bool(blocking))
        self._touch_heartbeat()

    def _save_checkpoint_inner(self, step, blocking: bool) -> None:
        # Under a mesh every rank takes part in gathering the full state;
        # then each rank writes its own data position (a sidecar), and the
        # chief, once every sidecar is on disk, writes the step (its
        # manifest lists the sidecars).
        full = self._full_state()
        if self.mesh is not None:
            if self.data_writer:  # one sidecar a data rank
                os.makedirs(self.checkpoints.checkpoint_dir, exist_ok=True)
                _atomic_json(os.path.join(self.checkpoints.checkpoint_dir,
                                          f"step_{step}_data_p{self.data_index}.json"),
                             self._data_state())
            process_barrier(f"checkpoint_{step}_sidecars")
        if not self.is_chief:
            return
        training_state = {"step": int(self.state["step"]),
                          "total_tokens": int(self.total_tokens),
                          **self._data_state(),
                          "validation": self.val_history,
                          "early_stopping": self.early_stopping.state_dict()}
        self.checkpoints.save(step, full["params"], full["opt_state"],
                              training_state,
                              metadata_extra={"total_tokens": int(self.total_tokens)},
                              blocking=blocking)
        self.checkpoints.update_ledger(validation=self.val_history,
                                       total_tokens=int(self.total_tokens))
        self.logger.log(f"Saved checkpoint at step {step}"
                        + ("" if blocking else " (async write)"))

    def _data_state(self) -> Dict[str, Any]:
        """The loader position as the step loop consumed it: the
        prefetcher's once it runs (batches in its queue were not trained
        on)."""
        if self.prefetcher is not None:
            return self.prefetcher.state_dict()
        return self.data.state_dict()

    # -- resume ----------------------------------------------------------------
    def _resolve_resume_tag(self) -> Optional[str]:
        """``resume.checkpoint`` as a VERIFIED step tag (the JAX trainer's
        rules). "latest" (or "") takes the newest step that verifies,
        quarantining the ones that fail. An explicit tag is verified too: a
        tag with files but no manifest loads unverified (a checkpoint from
        before manifests); one that fails its manifest raises under
        ``strict``, else is quarantined and the newest verified step is
        taken. None when nothing can be resumed."""
        rc = self.config.resume
        strict = bool(rc.strict)
        tag = str(rc.checkpoint)
        if tag in ("latest", ""):
            resolved = self.checkpoints.latest_complete_step()
            if resolved is None and strict:
                raise CheckpointIntegrityError(
                    f"resume.checkpoint={tag!r} with resume.strict: no "
                    f"verified checkpoint exists in {self.checkpoints.checkpoint_dir}")
            return resolved
        ok, reason = self.checkpoints.verify(tag)
        if ok:
            return tag
        if reason == "no manifest":
            if os.path.isfile(self.checkpoints.paths_for_step(tag)[0]):
                self.logger.log(f"resume: checkpoint {tag} has no integrity manifest "
                                f"(pre-manifest checkpoint); loading unverified")
                return tag
            if strict:
                raise CheckpointIntegrityError(
                    f"resume.checkpoint={tag} does not exist in "
                    f"{self.checkpoints.checkpoint_dir} and resume.strict is set")
            self.logger.log(f"WARNING: resume.checkpoint={tag} does not exist; falling "
                            f"back to the newest verified checkpoint")
            return self.checkpoints.latest_complete_step()
        if strict:
            raise CheckpointIntegrityError(
                f"resume.checkpoint={tag} failed verification ({reason}) "
                f"and resume.strict is set")
        self.logger.log(f"WARNING: resume.checkpoint={tag} failed verification "
                        f"({reason}); quarantining it and falling back to the newest "
                        f"verified checkpoint")
        self.checkpoints.quarantine_step(tag, reason)
        return self.checkpoints.latest_complete_step()

    def _resume_data_state(self, tag, tstate: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's data position (the JAX trainer's rules): on the world
        size that wrote it, its own sidecar (or the chief's training state of
        a one-rank run); on another, every old rank's position through
        ``data.streaming.remap_data_states``, so the new world skips and
        replays no document."""
        from ..data.streaming import remap_data_states

        pindex, pcount = self.data_index, self.data_count
        sidecars = self.checkpoints.data_sidecar_states(tag)
        if sidecars:
            old_world = len(sidecars)
            if old_world == pcount and pindex in sidecars:
                return sidecars[pindex]
            remapped = remap_data_states([sidecars[i] for i in sorted(sidecars)],
                                         pindex, pcount)
            self.logger.log(f"elastic: remapped data position from a {old_world}-host "
                            f"snapshot to {pcount} host(s); this is process {pindex}")
            return remapped
        old_world = int(tstate.get("process_count", 1) or 1)
        if old_world == pcount:
            return tstate
        snap = {k: tstate[k] for k in ("docs_consumed", "buf", "source", "hf")
                if k in tstate}
        snap["process_count"] = old_world
        snap["process_index"] = int(tstate.get("process_index", 0) or 0)
        remapped = remap_data_states([snap], pindex, pcount)
        self.logger.log(f"elastic: remapped data position from a {old_world}-host "
                        f"snapshot to {pcount} host(s); this is process {pindex}")
        return remapped

    def _resume(self) -> None:
        """Load ``resume.checkpoint`` into the live state in place (params,
        optimizer state unless ``reset_optimizer``, and unless
        ``reset_training_state`` the step, token count, validation history,
        data position and early-stopping state). Under a mesh the chief
        picks the step (quarantining what fails), every rank reads the full
        files and keeps its blocks, whatever world size wrote them."""
        rc = self.config.resume
        tag = self._resolve_resume_tag() if self.is_chief else None
        if self._ctrl_group is not None:
            import torch.distributed as dist

            box = [tag]
            dist.broadcast_object_list(box, src=0, group=self._ctrl_group)
            tag = box[0]
        if tag is None:
            self.logger.log("WARNING: no resumable checkpoint found; starting from scratch")
            return
        # The resume source survives retention GC for the whole run: until a
        # new checkpoint lands it is the only good state.
        self.checkpoints.protect_steps.add(str(tag))
        if self.mesh is None:
            like_p, like_o = self.state["params"], self.state["opt_state"]
        else:  # full-shape stand-ins; the loaded tensors are cut to this rank's blocks
            like_p = self._params_like
            like_o = self.optimizer.init(self._params_like)
        params, opt_state, tstate = self.checkpoints.load(
            tag, like_params=like_p, like_opt_state=None if rc.reset_optimizer else like_o,
            strict=bool(rc.strict))
        if self.mesh is not None:
            specs = self.train_step.shardings
            params = shard_arrays(params, specs["params"], self.mesh)
            if opt_state is not None:
                opt_state = shard_arrays(opt_state, specs["opt_state"], self.mesh)
        load_into(self.state["params"], params)
        if opt_state is not None:
            self.state["opt_state"] = load_into(self.state["opt_state"], opt_state)
        elif not rc.reset_optimizer:
            self.logger.log(f"WARNING: resuming step {tag} WITHOUT optimizer state "
                            f"(missing/unreadable) — moment statistics restart from "
                            f"zero; set resume.strict: true to fail instead")
        if not rc.reset_training_state:
            self.start_step = int(tstate.get("step", 0))
            self.state["step"] = self.start_step
            self.total_tokens = int(tstate.get("total_tokens", 0))
            self.val_history = tstate.get("validation", self.val_history)
            self.data.load_state_dict(self._resume_data_state(tag, tstate))
            self.early_stopping.load_state_dict(tstate.get("early_stopping", {}))
        self.logger.log(f"Resumed from checkpoint {tag} at step {self.start_step}")
        if self.events is not None:
            self.events.append("resume", tag=str(tag), step=self.start_step)

    # -- sample generation -----------------------------------------------------
    def generate_samples(self, step: int, prompts=None, max_new_tokens: int = 48) -> None:
        """Log greedy continuations of the first ``logging.log_samples_count``
        prompts, generated from fp32 copies of the parameters. A failure is
        logged and never stops training."""
        from ..infer.generate import generate_text

        prompts = prompts or ["Once upon a time"]
        count = int(self.config.logging.log_samples_count or 1)
        full = self._full_state()["params"]  # every rank gathers; the chief samples
        if not self.is_chief:
            return
        with torch.no_grad():
            params = tree_map(lambda t: t.detach().float().clone(), full)
        for prompt in prompts[:count]:
            try:
                text = generate_text(params, self.model_args, self.tokenizer, prompt,
                                     max_new_tokens=max_new_tokens, temperature=0.0)
                self.logger.log_sample(step, prompt, text)
            except Exception as e:  # noqa: BLE001 - sampling must never kill training
                self.logger.log(f"sample generation failed: {e}")
                return

    # -- LR finder -------------------------------------------------------------
    def maybe_run_lr_finder(self) -> Optional[float]:
        """With ``training.lr_finder.enabled`` on a fresh run: sweep momentum
        SGD over the first ``num_steps`` batches (``train/lr_finder.py``) on
        a copy of the parameters, then adopt the suggested LR: the schedule,
        the optimizer and the train step are rebuilt with it and the
        optimizer state starts afresh. Skipped on resume, as in JAX."""
        lf = dict(getattr(self.config.training, "_extras", {}).get("lr_finder") or {})
        if not lf.get("enabled") or self.start_step > 0:
            return None
        if self.world > 1:
            raise NotImplementedError(
                "training.lr_finder sweeps on one rank; over several it is not "
                "ported (ROADMAP queue 1 item 10f)")
        self.logger.log("Running LR finder sweep")
        suggested, _, _ = run_lr_finder(
            self.state["params"], self.loss_fn,
            lambda i: self._device_batch(self.data.generate_batch(i)),
            min_lr=float(lf.get("min_lr", 1e-7)), max_lr=float(lf.get("max_lr", 1.0)),
            num_steps=int(lf.get("num_steps", 100)), out_dir=self.run_dir)
        self.logger.log(f"LR finder suggestion: {suggested:.3e}; rebuilding optimizer with it")
        cfg = self.config
        cfg.training.hyperparameters["learning_rate"] = float(suggested)
        self.schedule = build_schedule(cfg.training, max(self.total_steps, 1))
        self.optimizer = build_optimizer(cfg.training, max(self.total_steps, 1),
                                         schedule=self.schedule)
        self.train_step = self._build_train_step()
        self.state = self._init_state(self._full_state()["params"])
        return suggested

    # -- the loop ------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        train_t0 = time.perf_counter()
        # run_start opens a fresh run's stream, before the step-0 eval event
        if self.events is not None and self.start_step == 0:
            self.events.append(
                "run_start", name=cfg.name, total_steps=self.total_steps,
                n_params=self.n_params, flops_per_token=self.flops_per_token,
                peak_flops=self.peak_flops, n_chips=self.world, device=str(self.device))
        self.maybe_run_lr_finder()
        log_int = max(1, cfg.logging.logging_interval)
        ckpt_int = cfg.logging.checkpoint_interval
        val_int = cfg.logging.validation_interval
        # the torch.profiler window [profile_start, profile_stop)
        prof_start = int(cfg.logging.profile_start or 0)
        prof_stop = int(cfg.logging.profile_stop or 0)

        def record_validation(step: int, v: Optional[float]) -> None:
            if v is not None:
                self.logger.log_validation(step, v)
                self.val_history["steps"].append(step)
                self.val_history["losses"].append(v)

        if val_int and self.start_step == 0:
            record_validation(0, self.validate())
        window_tokens, window_steps = 0, 0
        window_waits = {"data_wait_s": 0.0, "h2d_wait_s": 0.0}
        window_moe: list = []  # (moe_load, moe_dropped) device tensors per step
        last_loss = float("nan")
        # What was booked before the first window (the step-0 validation,
        # the LR finder) goes to the run totals, so each window's components
        # sum to its own wall time.
        self.goodput.close_window(time.perf_counter() - train_t0)
        if self.tracer.enabled:
            self.tracer.instant("goodput_flush", step=self.start_step)
        # The step loop's batches, copied to the device ahead of it
        # (data/device_prefetch.py); _data_state() reads the consumed
        # position through it.
        self.prefetcher = DevicePrefetcher(
            self.data, device=self.device, depth=int(cfg.data.prefetch_depth),
            start_step=self.start_step, total_steps=self.total_steps,
            mesh=self.mesh, metrics=self.metrics)
        # The Prometheus exposition stays up after train() returns (a
        # daemon thread), so a late scrape sees the final counters.
        if cfg.logging.metrics_port and self._metrics_server is None:
            from ..obs.prometheus import start_metrics_server

            port = int(cfg.logging.metrics_port) + self.rank  # one port a rank
            self._metrics_server = start_metrics_server(self.metrics, port,
                                                        process_index=self.rank)
            self.logger.log(
                f"telemetry: serving Prometheus metrics on :{port}/metrics"
                if self._metrics_server is not None else
                f"telemetry: metrics port {port} unavailable; exporter disabled")
        self._touch_heartbeat(self.start_step)

        # SIGTERM / SIGINT set a flag; the loop saves and ends at the next
        # step boundary. A second signal gets the previous handler. SIGUSR2
        # asks for an on-demand capture of the next steps.
        self.preempted = False
        prev_handlers: Dict[int, Any] = {}

        def on_signal(signum, frame):
            self.preempted = True
            signal.signal(signum, prev_handlers.get(signum, signal.SIG_DFL))

        def on_trace_signal(signum, frame):
            self._trace_request += 1

        try:
            for sig, handler in ((signal.SIGTERM, on_signal), (signal.SIGINT, on_signal),
                                 (signal.SIGUSR2, on_trace_signal)):
                prev = signal.signal(sig, handler)
                prev_handlers[sig] = prev if prev is not None else signal.SIG_DFL
        except ValueError:  # not the main thread: no signal hooks
            prev_handlers = {}

        self._sync()
        window_start = time.perf_counter()
        completed = False
        try:
            for step in range(self.start_step + 1, self.total_steps + 1):
                if prof_stop > prof_start:
                    if step >= prof_stop and self.profiler.active:
                        self._apply_profile_report(self.profiler.stop(step), step)
                        if self.events is not None:
                            self.events.append("profiler", action="stop", step=step)
                        self._touch_heartbeat()  # the trace's export is no hang
                    elif prof_start <= step < prof_stop and not self.profiler.active:
                        if self.profiler.start(step) and self.events is not None:
                            self.events.append("profiler", action="start", step=step)
                self._on_demand_capture(step)
                try:
                    batch, step_tokens, waits = self.prefetcher.get()
                    dry = False
                except StopIteration:  # a finite stream ran dry
                    dry = True
                if self.world > 1:  # one rank's dry stream stops them all
                    dry = self._agree(dry)[0]
                if dry:
                    self.logger.log(f"Data stream exhausted before step {step}; stopping")
                    break
                step_tokens *= self.data_count  # every data rank trains as many rows
                window_tokens += step_tokens
                self.total_tokens += step_tokens
                for k in window_waits:
                    window_waits[k] += waits[k]
                self._book("data_wait_s", waits["data_wait_s"], step=step)
                if self.prefetcher.h2d_blocks_consumer:
                    self._book("h2d_wait_s", waits["h2d_wait_s"], step=step)
                t_dispatch = time.perf_counter()
                if self.profiler.active:  # the report's step marker
                    with torch.profiler.record_function(f"TrainStep#{step}"):
                        self.state, metrics = self.train_step(self.state, batch)
                else:
                    self.state, metrics = self.train_step(self.state, batch)
                t_d = time.perf_counter() - t_dispatch
                if not self._compiled:
                    # The run's first step carries the one-time costs (kernel
                    # loads, allocator warm-up), as JAX's first dispatch
                    # carries its compile.
                    self._compiled = True
                    self._book("compile_s", t_d, step=step)
                    if self.events is not None:
                        self.events.append("compile", seconds=round(t_d, 4), step=step)
                else:
                    self._book("dispatch_s", t_d, step=step)
                window_steps += 1
                if "moe_load" in metrics:
                    window_moe.append((metrics["moe_load"], metrics["moe_dropped"]))
                if step % log_int == 0 or step == self.total_steps:
                    loss = float(metrics["loss"])
                    self._sync()
                    last_loss = loss
                    elapsed = max(time.perf_counter() - window_start, 1e-9)
                    gp = self.goodput.close_window(elapsed)
                    line, mfu_val = self._log_window(step, metrics, loss, elapsed, gp,
                                                     window_tokens, window_steps,
                                                     window_moe)
                    window_moe = []
                    # the window's summed waits, whatever the ledger booked
                    self.windows.append({"step": step, "steps": window_steps,
                                         "seconds": elapsed, **line, **window_waits})
                    window_tokens, window_steps = 0, 0
                    window_waits = dict.fromkeys(window_waits, 0.0)
                    window_start = time.perf_counter()
                stop_early = False
                if val_int and step % val_int == 0:
                    v = self.validate()
                    record_validation(step, v)
                    if v is not None and self.early_stopping.update(v):
                        self.logger.log(f"Early stopping triggered at step {step}")
                        stop_early = True
                if cfg.logging.log_samples and val_int and step % val_int == 0:
                    self.generate_samples(step)
                saved = bool(ckpt_int and step % ckpt_int == 0)
                if saved:  # interval saves overlap the disk write with training
                    self.save_checkpoint(step, blocking=not cfg.system.async_checkpointing)
                if self.world > 1:  # a signal to any rank stops every rank here
                    self.preempted = self._agree(self.preempted)[0]
                if self.preempted:
                    self.logger.log(f"Preemption signal received: saving checkpoint at "
                                    f"step {step} and exiting")
                    if not saved:
                        try:
                            self.save_checkpoint(step)  # drains the writes in flight
                        except StaleBackgroundWriteError as e:
                            self.logger.log(f"Preemption checkpoint: {e}")
                            raise
                    break
                if stop_early:
                    break
            completed = True
        finally:
            # The worker stops first; the consumed position the final
            # checkpoint needs stays on the prefetcher.
            self.prefetcher.stop()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            if not completed:
                # An error is on its way out: let the writes in flight land,
                # and log (not raise over it) any that failed.
                try:
                    self.checkpoints.wait()
                except RuntimeError as e:
                    self.logger.log(str(e))
            if self.profiler.active:  # the run ended inside a capture window
                self._apply_profile_report(self.profiler.stop(), int(self.state["step"]))
            # the spans (a run-long trace, or an on-demand window cut short)
            if self.tracer.enabled and self.tracer.stats()["recorded"]:
                try:
                    self.tracer.export(os.path.join(self.run_dir, "trace.json"))
                except OSError as e:
                    self.logger.log(f"trace export failed: {e}")
        self.checkpoints.wait()  # a failed background write raises here

        step = int(self.state["step"])
        if self.val_history["steps"] and self.val_history["steps"][-1] == step:
            final_val = self.val_history["losses"][-1]
        else:
            final_val = self.validate()
            record_validation(step, final_val)
        self.save_checkpoint("final")
        if hasattr(self.data, "stop"):
            self.data.stop()  # a streaming loader's producer thread
        if self.stats_client is not None:
            self.stats_client.close()
        mine = {"kernel_launches": kernel_launches(),
                "peak_device_mem_gb": (torch.cuda.max_memory_allocated(self.device) / 1e9
                                       if self.device.type == "cuda" else None),
                # this rank's query heads (its tp block of them)
                "attention_heads": (self.state["params"]["layers"][0]["attention"]["wq"]
                                    ["weight"].shape[-1] // self.model_args.head_dim
                                    if self.state["params"]["layers"] else None),
                # the ep exchanges (parallel/collectives.py), bytes sent
                "exchanges": dict(EXCHANGES),
                # this rank's experts a layer (its ep block of them)
                "experts": (self.state["params"]["layers"][0]["feed_forward"]["experts"]
                            ["w_gate"]["weight"].shape[0]
                            if self.model_args.is_moe and self.state["params"]["layers"]
                            else None)}
        by_rank = None
        if self._ctrl_group is not None:  # every rank's, in the chief's run_end
            import torch.distributed as dist

            by_rank = [None] * self.world
            dist.all_gather_object(by_rank, mine, group=self._ctrl_group)
        if self.events is not None:
            if self.moe_stats_experts:  # the run's global drops, as the registry counts them
                mine["moe_dropped_tokens_total"] = self._m_moe_dropped.value()
            self.events.append(
                "run_end", step=step, total_tokens=int(self.total_tokens),
                final_loss=last_loss, goodput_totals={
                    k: round(v, 4) for k, v in self.goodput.totals().items()},
                ranks=by_rank, **mine)
            self.events.close()
            self.events = None
        self.logger.log("Training complete")
        self.logger.close()
        return {"final_loss": last_loss, "final_val_loss": final_val, "steps": step}

    def _log_window(self, step: int, metrics, loss: float, elapsed: float,
                    gp: Dict[str, float], window_tokens: int, window_steps: int,
                    window_moe: list) -> Tuple[Dict[str, Any], Optional[float]]:
        """A closed window's log line (with its goodput breakdown, summing
        to ``elapsed``), the registry's counters and gauges, the
        ``step_window`` event, the stats hub, the tracer's marker and the
        heartbeat: one place, so they move in lockstep."""
        tok_s = window_tokens / elapsed
        mfu_val = compute_mfu(tok_s, self.flops_per_token, self.peak_flops, self.world)
        line = {"loss": loss, "ppl": float(math.exp(min(loss, 30.0))),
                "lr": schedule_value(self.schedule, step),
                "tok/s": tok_s, "toks": int(window_tokens),
                "mfu": mfu_val if mfu_val is not None else "unknown",
                "data_wait_s": gp["data_wait_s"], "h2d_wait_s": gp["h2d_wait_s"],
                "dispatch_s": gp["dispatch_s"], "compile_s": gp["compile_s"],
                "ckpt_save_s": gp["ckpt_save_s"], "eval_s": gp["eval_s"],
                "other_s": gp["other_s"],
                "data_wait_frac": min(gp["data_wait_s"] / elapsed, 1.0)}
        if "grad_norm" in metrics:
            line["grad_norm"] = float(metrics["grad_norm"])
            self._g_grad_norm.set(line["grad_norm"])
        if window_moe:
            routing, frac = routing_line(window_moe)
            line.update(routing)
            self._g_moe_entropy.set(routing["moe_entropy"])
            self._m_moe_dropped.inc(routing["moe_drop"])
            for e, f in enumerate(frac):
                self._g_moe_load.set(float(f), expert=str(e))
        if int(metrics["nonfinite"]):
            self.logger.log(f"WARNING: non-finite loss at step {step}")
            self._m_nonfinite.inc()
        self.logger.log_metrics(step, line)
        if self.stats_client is not None:
            self.stats_client.log_metrics(step, line)
        self._m_steps.inc(window_steps)
        self._m_toks.inc(window_tokens)
        self._g_step.set(step)
        self._g_loss.set(loss)
        self._g_tok_s.set(tok_s)
        if mfu_val is not None:
            self._g_mfu.set(mfu_val)
        for comp, secs in gp.items():
            if secs > 0:
                self._m_goodput.inc(secs, component=comp)
        if self.events is not None:
            ev = dict(step=step, steps=window_steps, toks=int(window_tokens),
                      loss=round(loss, 6), tok_s=round(tok_s, 2), mfu=mfu_val,
                      goodput={k: round(v, 6) for k, v in gp.items()})
            if "grad_norm" in line:
                ev["grad_norm"] = line["grad_norm"]
            ev.update(self._prof_fields)
            self.events.append("step_window", **ev)
        if self.tracer.enabled:
            self.tracer.instant("step_window", step=step, tok_s=round(tok_s, 2),
                                mfu=mfu_val if mfu_val is not None else "unknown")
        self._touch_heartbeat(step)
        return line, mfu_val

    def _on_demand_capture(self, step: int) -> None:
        """The SIGUSR2 window: spans (and a profile, when no other capture
        runs) for the next ``trace.capture_steps`` steps, written to
        ``trace_step<N>.json`` at its end."""
        if self._trace_until and step >= self._trace_until:
            self._trace_until = 0
            if self._trace_owns_prof and self.profiler.active:
                report = self.profiler.stop(step)
                self._trace_owns_prof = False
                self._apply_profile_report(report, step)
            out = os.path.join(self.run_dir, f"trace_step{step}.json")
            self.tracer.export(out)
            self.tracer.enabled = self._trace_prev_enabled
            self.logger.log(f"trace capture: spans written to {out}")
            if self.events is not None:
                self.events.append("trace_capture", action="stop", step=step, path=out)
        if self._trace_request and not self._trace_until:
            self._trace_request = 0
            self._trace_until = step + max(1, self._trace_capture_steps)
            self._trace_prev_enabled = self.tracer.enabled
            self.tracer.enabled = True
            if not self.profiler.active:
                # start() never raises; a refused start means spans only
                self._trace_owns_prof = self.profiler.start(step)
            self.logger.log(f"trace capture: recording steps [{step}, {self._trace_until})")
            if self.events is not None:
                self.events.append("trace_capture", action="start", step=step,
                                   until=self._trace_until)


# -- loading a run ------------------------------------------------------------------
def load_trained(run_name_or_dir: str, runs_root: str = "runs", device="cuda",
                 weight_dtype: str = "fp"):
    """Load a finished run for inference: ``(params, args, tokenizer,
    config)`` with params on ``device``. The step is the newest one whose
    manifest verifies (a read-only scan: a torn checkpoint is skipped, not
    quarantined, so a trainer on the same run is left alone); a run from
    before manifests serves its newest model file, as in JAX.
    ``weight_dtype`` "int8"/"int4" quantizes the linear weights on the host
    as they load (``models/quantize.py``; the fp file stays canonical), so
    no fp copy of them reaches the device."""
    from ..checkpoint.manager import _quantize_flat
    from ..convert import params_from_flat
    from ..models.quantize import check_weight_dtype

    run_dir = (run_name_or_dir if os.path.isdir(run_name_or_dir)
               else os.path.join(runs_root, run_name_or_dir))
    cfg = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    tok = TokenizerManager.from_run_dir(run_dir)
    args = LlamaArgs.from_config(cfg.model, tok.vocab_size)
    resolve_architecture(cfg.model.architecture)  # unknown names raise, as in JAX
    ckpts = CheckpointManager(run_dir)
    tag = ckpts.latest_complete_step(quarantine=False)
    if tag is None:
        raise FileNotFoundError(f"no verified checkpoints in {run_dir}")
    arrays, _ = load_safetensors(ckpts.paths_for_step(tag)[0])
    wd = check_weight_dtype(weight_dtype)
    if wd != "fp":
        arrays = _quantize_flat(arrays, wd)
    return params_from_flat(arrays, device), args, tok, cfg


def collect_overrides(args) -> Dict[str, Any]:
    """Dotted-path overrides from parsed CLI args (the supervisor resolves
    the run name through it too)."""
    overrides: Dict[str, Any] = {}
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        overrides[key] = value
    if args.iters is not None:
        overrides["training.hyperparameters.iters"] = args.iters
    if args.batch_size is not None:
        overrides["training.hyperparameters.batch_size"] = args.batch_size
    if args.learning_rate is not None:
        overrides["training.hyperparameters.learning_rate"] = args.learning_rate
    if args.run_name:
        overrides["name"] = args.run_name
    return overrides


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's CLI flags, with ``--device``."""
    parser = argparse.ArgumentParser(description="Train with the PyTorch port")
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="dotted config override, e.g. training.hyperparameters.batch_size=8")
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--auto-resume", action="store_true",
                        help="supervise training in a subprocess; on a crash, a "
                             "hang or preemption, restart it from the newest "
                             "VERIFIED checkpoint with exponential backoff")
    parser.add_argument("--max-crashes", type=int, default=3,
                        help="give up after this many consecutive crashes "
                             "without checkpoint progress (with --auto-resume)")
    parser.add_argument("--backoff-base", type=float, default=2.0,
                        help="first restart delay in seconds (doubles per "
                             "no-progress crash; with --auto-resume)")
    parser.add_argument("--backoff-max", type=float, default=60.0,
                        help="restart delay ceiling in seconds (with --auto-resume)")
    parser.add_argument("--hang-timeout-s", type=float, default=None,
                        help="with --auto-resume: stop and restart the trainer "
                             "when its heartbeat makes no progress for this many "
                             "seconds (overrides supervisor.hang_timeout_s; 0 "
                             "disables)")
    parser.add_argument("--scope", action="store_true",
                        help="with --auto-resume: start a scope collector "
                             "sidecar scraping the trainer's metrics port "
                             "(requires logging.metrics_port)")
    parser.add_argument("--alerts-config", default=None,
                        help="alerts.yaml for the --scope sidecar (default: "
                             "configs/alerts.yaml when present)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous store (or "
                             "system.distributed.coordinator_address, or "
                             "torchrun's MASTER_ADDR/MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--rendezvous-timeout-s", type=float, default=None,
                        help="overall rendezvous deadline; retries with backoff "
                             "inside it (default 120, or config "
                             "system.distributed.rendezvous_timeout_s)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: nccl on cuda, gloo on cpu")
    return parser


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if args.auto_resume:
        from .supervisor import supervise_from_args

        return supervise_from_args(args)
    raw = read_config_dict(args.config)
    cfg = Config.from_dict(apply_overrides(raw, collect_overrides(args)))
    # The rendezvous comes before the Trainer touches a device. An explicit
    # coordinator that does not answer raises: never N solo runs in one dir.
    dist_cfg = dict(getattr(cfg.system, "_extras", {}).get("distributed") or {})
    coordinator = args.coordinator or dist_cfg.get("coordinator_address")
    num_processes = (args.num_processes if args.num_processes is not None
                     else dist_cfg.get("num_processes"))
    if coordinator or os.environ.get("MASTER_ADDR"):
        from ..parallel.launch import initialize_distributed

        timeout = (args.rendezvous_timeout_s if args.rendezvous_timeout_s is not None
                   else float(dist_cfg.get("rendezvous_timeout_s") or 120.0))
        initialize_distributed(coordinator, num_processes, args.process_id,
                               rendezvous_timeout_s=timeout, backend=args.backend,
                               device=torch.device(args.device).type)
    elif (num_processes or 1) > world_size():
        raise ValueError(f"--num-processes {num_processes} needs a rendezvous: pass "
                         "--coordinator (or start the ranks with parallel.launch "
                         "or torchrun)")
    trainer = Trainer(cfg, runs_root=args.runs_root, device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main()
