"""The single-device trainer, and loading a trained run for serving.

    python -m mlx_cuda_distributed_pretraining_tpu_torch.train.trainer \\
        --config configs/model-config-40m-adamw.yaml [--device cpu]

:class:`Trainer` follows the JAX trainer on one device: seeded init, the
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
streaming run resumes exactly in either package (a checkpoint of several
processes, with per-host data sidecars, raises: ROADMAP queue 1 item 10;
a streaming loader refuses a position of another world size). SIGTERM or
SIGINT saves a checkpoint
at the next step boundary, after the writes in flight, and ends the run;
a checkpoint write that failed raises out of :meth:`Trainer.train` once
the save in hand is written.

``model.architecture`` resolves through ``models/registry.py`` as in the
JAX trainer: an unknown name raises, and ``llama_standard`` /
``llama_flash`` force simple / flash attention.

Not ported (they raise, naming the ROADMAP item): a ``system.mesh`` or
``model_parallel`` that needs more than one device (expert, data, tensor,
sequence and pipeline parallelism). ``model.matmul_precision: int8``
trains: the MoE experts on the ``gmm_int8`` kernel, attention on int8-gridded
q/k/v over the flash kernels, both with a straight-through backward. The telemetry
keys (``logging.metrics_port``, ``tensorboard``, ``wandb``, ``trace``,
``events``) and the log line's goodput fields (item 9) are read by
nothing here: they change no number the trainer computes, writes or
logs, so a run with them set trains as one without.

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
)
from ..checkpoint.safetensors_io import load_safetensors
from ..config import Config, apply_overrides, read_config_dict
from ..data.device_prefetch import DevicePrefetcher
from ..data.streaming import build_data_manager
from ..models import llama
from ..models.llama import LlamaArgs
from ..models.registry import resolve_architecture
from ..obs.flops import mfu as compute_mfu
from ..obs.flops import model_flops_per_token, peak_flops_per_chip
from ..obs.logger import Logger
from ..optim.factory import build_optimizer
from ..optim.schedules import build_schedule, schedule_value
from ..tokenizer import TokenizerManager
from ..utils.tree import tree_map
from .early_stopping import EarlyStoppingMonitor
from .lr_finder import run_lr_finder
from .train_step import init_train_state, make_eval_step, make_loss_fn, make_train_step

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")  # the JAX package's order


def refuse_multi_device(system_cfg) -> None:
    """Raise unless ``system.mesh`` (or the legacy ``model_parallel``) fits
    one device: the fixed axes must multiply to 1, so that an axis of -1
    (``dp: -1``) resolves to 1, as the JAX package's ``mesh_axis_sizes``
    resolves it on one device."""
    sizes = {k: int(v) for k, v in (system_cfg.mesh or {}).items()}
    if not sizes and system_cfg.model_parallel:
        sizes = {"dp": -1, "tp": max(1, int(system_cfg.model_parallel_size))}
    unknown = set(sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {MESH_AXES}")
    needed = int(np.prod([v for v in sizes.values() if v > 0]))
    if needed > 1:
        raise NotImplementedError(
            f"system mesh {sizes} needs {needed} devices; the port trains on one "
            "(ROADMAP queue 1 item 10: multi-GPU)")


def load_into(live: Any, loaded: Any) -> Any:
    """Copy a loaded tree into the live one in place: tensors keep their
    device, dtype and ``requires_grad``; other leaves are replaced."""
    with torch.no_grad():
        return tree_map(lambda a, b: a.copy_(b) if isinstance(a, torch.Tensor) else b,
                        live, loaded)


def routing_line(window: List[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, Any]:
    """A log window's routing stats from its steps' ``(moe_load [E],
    moe_dropped)``: the normalised balance entropy (1.0 uniform, 0.0 one
    expert takes all), dropped selections, and the busiest expert's share;
    the JAX trainer's arithmetic. Reads the device once."""
    load = np.asarray(sum(m[0] for m in window).cpu(), np.float64)
    dropped = int(sum(m[1] for m in window))
    frac = load / max(load.sum(), 1.0)
    nz = frac[frac > 0]
    entropy = float(-(nz * np.log(nz)).sum() / math.log(max(len(load), 2)))
    return {"moe_entropy": entropy, "moe_drop": dropped,
            "moe_load_max": float(frac.max())}


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
        refuse_multi_device(cfg.system)

        resume = cfg.resume is not None and bool(cfg.resume.checkpoint)
        if resume:  # continue in the run's own directory
            self.run_dir = os.path.join(runs_root, cfg.name)
            os.makedirs(os.path.join(self.run_dir, "checkpoints"), exist_ok=True)
        else:
            self.run_dir = CheckpointManager.setup_run_directory(
                runs_root, cfg.name, cfg.overwrite)
        self.logger = Logger(self.run_dir, quiet=quiet)
        # Integrity events (quarantine, GC, ledger rebuild) go to log.txt.
        self.checkpoints = CheckpointManager(
            self.run_dir, keep_last=cfg.logging.keep_last,
            keep_every=cfg.logging.keep_every, notify=self.logger.log)
        cfg.to_yaml(os.path.join(self.run_dir, "config.yaml"))
        self.tokenizer = TokenizerManager(cfg.data, run_dir=self.run_dir)

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
                                       seed=cfg.system.seed)
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
        self.train_step = make_train_step(
            loss_fn, self.optimizer, accum_steps=self.accum_steps,
            log_grad_norm=cfg.logging.log_gradient_norm,
            moe_stats_experts=self.moe_stats_experts)
        self.eval_step = make_eval_step(eval_loss_fn)
        self.state = init_train_state(params, self.optimizer)

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
        if resume:
            self._resume()

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
        """Token-weighted validation loss over at most ``cap`` batches."""
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
        host copies exist."""
        training_state = {"step": int(self.state["step"]),
                          "total_tokens": int(self.total_tokens),
                          **self._data_state(),
                          "validation": self.val_history,
                          "early_stopping": self.early_stopping.state_dict()}
        self.checkpoints.save(step, self.state["params"], self.state["opt_state"],
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

    def _resume(self) -> None:
        """Load ``resume.checkpoint`` into the live state in place (params,
        optimizer state unless ``reset_optimizer``, and unless
        ``reset_training_state`` the step, token count, validation history,
        data position and early-stopping state)."""
        rc = self.config.resume
        tag = self._resolve_resume_tag()
        if tag is None:
            self.logger.log("WARNING: no resumable checkpoint found; starting from scratch")
            return
        # The resume source survives retention GC for the whole run: until a
        # new checkpoint lands it is the only good state.
        self.checkpoints.protect_steps.add(str(tag))
        params, opt_state, tstate = self.checkpoints.load(
            tag, like_params=self.state["params"],
            like_opt_state=None if rc.reset_optimizer else self.state["opt_state"],
            strict=bool(rc.strict))
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
            if self.checkpoints.data_sidecar_states(tag):
                raise NotImplementedError(
                    f"checkpoint {tag} holds per-host data positions; reading them "
                    "is not ported (ROADMAP queue 1 item 10: multi-GPU)")
            self.data.load_state_dict(tstate)
            self.early_stopping.load_state_dict(tstate.get("early_stopping", {}))
        self.logger.log(f"Resumed from checkpoint {tag} at step {self.start_step}")

    # -- sample generation -----------------------------------------------------
    def generate_samples(self, step: int, prompts=None, max_new_tokens: int = 48) -> None:
        """Log greedy continuations of the first ``logging.log_samples_count``
        prompts, generated from fp32 copies of the parameters. A failure is
        logged and never stops training."""
        from ..infer.generate import generate_text

        prompts = prompts or ["Once upon a time"]
        count = int(self.config.logging.log_samples_count or 1)
        with torch.no_grad():
            params = tree_map(lambda t: t.detach().float().clone(), self.state["params"])
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
        self.train_step = make_train_step(
            self.loss_fn, self.optimizer, accum_steps=self.accum_steps,
            log_grad_norm=cfg.logging.log_gradient_norm,
            moe_stats_experts=self.moe_stats_experts)
        self.state = init_train_state(self.state["params"], self.optimizer)
        return suggested

    # -- the loop ------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        self.maybe_run_lr_finder()
        log_int = max(1, cfg.logging.logging_interval)
        ckpt_int = cfg.logging.checkpoint_interval
        val_int = cfg.logging.validation_interval

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
        # The step loop's batches, copied to the device ahead of it
        # (data/device_prefetch.py); _data_state() reads the consumed
        # position through it.
        self.prefetcher = DevicePrefetcher(
            self.data, device=self.device, depth=int(cfg.data.prefetch_depth),
            start_step=self.start_step, total_steps=self.total_steps)

        # SIGTERM / SIGINT set a flag; the loop saves and ends at the next
        # step boundary. A second signal gets the previous handler.
        self.preempted = False
        prev_handlers: Dict[int, Any] = {}

        def on_signal(signum, frame):
            self.preempted = True
            signal.signal(signum, prev_handlers.get(signum, signal.SIG_DFL))

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev = signal.signal(sig, on_signal)
                prev_handlers[sig] = prev if prev is not None else signal.SIG_DFL
        except ValueError:  # not the main thread: no signal hooks
            prev_handlers = {}

        self._sync()
        window_start = time.perf_counter()
        completed = False
        try:
            for step in range(self.start_step + 1, self.total_steps + 1):
                try:
                    batch, step_tokens, waits = self.prefetcher.get()
                except StopIteration:  # a finite stream ran dry
                    self.logger.log(f"Data stream exhausted before step {step}; stopping")
                    break
                window_tokens += step_tokens
                self.total_tokens += step_tokens
                for k in window_waits:
                    window_waits[k] += waits[k]
                self.state, metrics = self.train_step(self.state, batch)
                window_steps += 1
                if "moe_load" in metrics:
                    window_moe.append((metrics["moe_load"], metrics["moe_dropped"]))
                if step % log_int == 0 or step == self.total_steps:
                    loss = float(metrics["loss"])
                    self._sync()
                    last_loss = loss
                    elapsed = max(time.perf_counter() - window_start, 1e-9)
                    tok_s = window_tokens / elapsed
                    mfu_val = compute_mfu(tok_s, self.flops_per_token, self.peak_flops, 1)
                    line = {"loss": loss, "ppl": float(math.exp(min(loss, 30.0))),
                            "lr": schedule_value(self.schedule, step),
                            "tok/s": tok_s, "toks": int(window_tokens),
                            "mfu": mfu_val if mfu_val is not None else "unknown"}
                    if "grad_norm" in metrics:
                        line["grad_norm"] = float(metrics["grad_norm"])
                    if window_moe:
                        line.update(routing_line(window_moe))
                        window_moe = []
                    if int(metrics["nonfinite"]):
                        self.logger.log(f"WARNING: non-finite loss at step {step}")
                    self.logger.log_metrics(step, line)
                    self.windows.append({"step": step, "steps": window_steps,
                                         "seconds": elapsed, **window_waits, **line})
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
                if window_steps == 0:  # validation and saves stay out of the windows
                    self._sync()
                    window_start = time.perf_counter()
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
        self.logger.log("Training complete")
        self.logger.close()
        return {"final_loss": last_loss, "final_val_loss": final_val, "steps": step}


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


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="Train with the PyTorch port")
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="dotted config override, e.g. training.hyperparameters.batch_size=8")
    args = parser.parse_args(argv)
    overrides = {}
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        overrides[key] = value
    if args.iters is not None:
        overrides["training.hyperparameters.iters"] = args.iters
    raw = read_config_dict(args.config)
    trainer = Trainer(Config.from_dict(apply_overrides(raw, overrides)),
                      runs_root=args.runs_root, device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main()
