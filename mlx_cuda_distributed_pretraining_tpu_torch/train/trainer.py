"""The single-device trainer, and loading a trained run for serving.

    python -m mlx_cuda_distributed_pretraining_tpu_torch.train.trainer \\
        --config configs/model-config-40m-adamw.yaml [--device cpu]

:class:`Trainer` follows the JAX trainer on one device: seeded init, the
data manager, the bf16 forward over fp32 master weights (flash attention
on the CUDA kernels when the config asks for it; an MoE model's experts on
the grouped-GEMM kernels, forward and backward), the fp32 cross-entropy
plus an MoE model's router losses, the backward, clip + fused AdamW, the
log line protocol (with routing stats for an MoE model), validation (pure
cross-entropy), and interval and ``final`` checkpoints in the ``runs/``
layout both packages read. It runs on ``cuda`` unless the caller asks for
the CPU.

``model.architecture`` resolves through ``models/registry.py`` as in the
JAX trainer: an unknown name raises, and ``llama_standard`` /
``llama_flash`` force simple / flash attention.

Not ported (they raise, naming the ROADMAP item): a ``system.mesh`` or
``model_parallel`` that needs more than one device (expert, data, tensor,
sequence and pipeline parallelism), int8 grouped GEMMs, remat /
scan_layers / fused CE, optimizers other than adam/adamw, streaming data,
resume, and the switches that change what the JAX trainer does
(``training.early_stopping``, ``training.lr_finder``, checkpoint
``logging.retention``, ``logging.log_samples``). The telemetry keys
(``logging.metrics_port``, ``tensorboard``, ``wandb``, ``trace``,
``events``) are read by nothing here: they change no number the trainer
computes, writes or logs, so a run with them set trains as one without.

A run directory (written by either trainer) holds ``config.yaml``, the
tokenizer under ``tokenizer/`` and ``checkpoints/step_<tag>_model.safetensors``
files; :func:`load_trained` reads them into the port's parameters.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..config import Config, apply_overrides, read_config_dict
from ..data.memory import DataManager
from ..models import llama
from ..models.llama import LlamaArgs
from ..models.registry import resolve_architecture
from ..obs.flops import mfu as compute_mfu
from ..ops.flash_attention import check_matmul_precision
from ..obs.flops import model_flops_per_token, peak_flops_per_chip
from ..obs.logger import Logger
from ..optim.factory import build_optimizer
from ..optim.schedules import build_schedule, schedule_value
from ..tokenizer import TokenizerManager
from .train_step import init_train_state, make_eval_step, make_train_step

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


def refuse_unported_switches(cfg: Config) -> None:
    """Raise on a switch that changes what the JAX trainer does (it stops
    early, adopts another LR, deletes checkpoints or generates samples) and
    that the port has no code for: running as if it were off would give
    another run than the one configured."""
    training = getattr(cfg.training, "_extras", {})
    logging = getattr(cfg.logging, "_extras", {})
    if dict(training.get("early_stopping") or {}).get("enabled"):
        raise NotImplementedError(
            "training.early_stopping is not ported (ROADMAP queue 1 item 2: resume "
            "and the loop features whose state rides a checkpoint)")
    if dict(training.get("lr_finder") or {}).get("enabled"):
        raise NotImplementedError(
            "training.lr_finder is not ported (ROADMAP queue 1 item 4: the other "
            "optimizers and the LR finder)")
    retention = dict(cfg.logging.retention or {})
    if retention.get("keep_last") or retention.get("keep_every"):
        raise NotImplementedError(
            "logging.retention (checkpoint GC) is not ported (ROADMAP queue 1 item 2: "
            "resume, async save, retention GC)")
    if logging.get("log_samples"):
        raise NotImplementedError(
            "logging.log_samples is not ported (ROADMAP queue 1 item 7: the locked "
            "generation path and its samplers)")


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
        if cfg.resume is not None and cfg.resume.checkpoint:
            raise NotImplementedError("resume is not ported (ROADMAP queue 1: "
                                      "resume, async save, GC)")
        if cfg.data.source != "jsonl" or cfg.data.streaming:
            raise NotImplementedError(
                f"data source {cfg.data.source!r} is not ported (ROADMAP queue 1: "
                "streaming, token shards, native/ and device prefetch)")
        refuse_multi_device(cfg.system)
        refuse_unported_switches(cfg)

        self.run_dir = CheckpointManager.setup_run_directory(
            runs_root, cfg.name, cfg.overwrite)
        self.checkpoints = CheckpointManager(self.run_dir)
        self.logger = Logger(self.run_dir, quiet=quiet)
        cfg.to_yaml(os.path.join(self.run_dir, "config.yaml"))
        self.tokenizer = TokenizerManager(cfg.data, run_dir=self.run_dir)

        # model.architecture as the JAX trainer resolves it: an unknown name
        # raises, llama_standard / llama_flash force the attention
        self.arch = resolve_architecture(cfg.model.architecture)
        args = LlamaArgs.from_config(cfg.model, self.tokenizer.vocab_size)
        if self.arch.force_attention:
            args = dataclasses.replace(args, attention_type=self.arch.force_attention)
        if args.is_moe and args.moe_impl == "grouped" \
                and check_matmul_precision(args.matmul_precision) == "int8":
            raise NotImplementedError(
                "matmul_precision int8 in the grouped GEMM is not ported "
                "(ROADMAP queue 1 item 8: speculation and quantization)")
        self.model_args = args
        params = self.arch.init_params(
            args, torch.Generator().manual_seed(cfg.system.seed), device=self.device)
        self.n_params = llama.num_params(params)
        self.logger.log_model_summary(self.n_params, args)

        self.compute_dtype = (torch.bfloat16 if cfg.system.compute_dtype == "bfloat16"
                              else torch.float32)
        remat = cfg.model.remat_policy or cfg.system.remat
        if remat is None and cfg.system.gradient_checkpointing:
            remat = "full"
        kw = dict(compute_dtype=self.compute_dtype,
                  ce_chunk=int(cfg.system.fused_ce_chunk),
                  scan_layers=bool(cfg.system.scan_layers))
        z_loss = float(cfg.training.hyperparameters.get("z_loss") or 0.0)
        # MoE steps carry the routing stats out beside the token count.
        self.moe_stats_experts = args.num_local_experts if args.is_moe else 0

        def loss_fn(params, batch):
            return llama.loss_fn(params, batch, args, remat=remat,
                                 z_loss_weight=z_loss,
                                 overlap=bool(cfg.system.overlap_gather),
                                 with_moe_stats=bool(self.moe_stats_experts), **kw)

        # Validation leaves out the router losses: val_loss stays pure
        # cross-entropy, comparable across dense and MoE runs.
        def eval_loss_fn(params, batch):
            return llama.loss_fn(params, batch, args, include_aux=False, **kw)

        self.data = DataManager(cfg.data, self.tokenizer, cfg.training.batch_size,
                                seq_len=cfg.data.max_context_size,
                                seed=cfg.system.seed)
        if cfg.training.iters:
            self.total_steps = cfg.training.iters
        else:
            self.total_steps = (cfg.training.epochs or 1) * self.data.batches_per_epoch
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

        self.total_tokens = 0
        self.eval_batches = 0  # validation batches run (each one a forward)
        self.windows: list = []  # one dict per log line
        self.val_history: Dict[str, list] = {"steps": [], "losses": []}
        self.flops_per_token = model_flops_per_token(
            cfg.model, self.n_params, cfg.data.max_context_size)
        self.peak_flops = (peak_flops_per_chip(torch.cuda.get_device_name(self.device))
                           if self.device.type == "cuda" else None)

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

    def save_checkpoint(self, step) -> None:
        training_state = {"step": int(self.state["step"]),
                          "total_tokens": int(self.total_tokens),
                          **self.data.state_dict(),
                          "validation": self.val_history}
        self.checkpoints.save(step, self.state["params"], self.state["opt_state"],
                              training_state,
                              metadata_extra={"total_tokens": int(self.total_tokens)})
        self.checkpoints.update_ledger(validation=self.val_history,
                                       total_tokens=int(self.total_tokens))
        self.logger.log(f"Saved checkpoint at step {step}")

    # -- the loop ------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        log_int = max(1, cfg.logging.logging_interval)
        ckpt_int = cfg.logging.checkpoint_interval
        val_int = cfg.logging.validation_interval

        def record_validation(step: int, v: Optional[float]) -> None:
            if v is not None:
                self.logger.log_validation(step, v)
                self.val_history["steps"].append(step)
                self.val_history["losses"].append(v)

        if val_int:
            record_validation(0, self.validate())
        window_tokens, window_steps = 0, 0
        window_moe: list = []  # (moe_load, moe_dropped) device tensors per step
        last_loss = float("nan")
        self._sync()
        window_start = time.perf_counter()
        for step in range(1, self.total_steps + 1):
            batch = self.data.generate_batch(step - 1)
            step_tokens = int(batch["mask"].sum())
            window_tokens += step_tokens
            self.total_tokens += step_tokens
            self.state, metrics = self.train_step(self.state, self._device_batch(batch))
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
                                     "seconds": elapsed, **line})
                window_tokens, window_steps = 0, 0
                window_start = time.perf_counter()
            if val_int and step % val_int == 0:
                record_validation(step, self.validate())
            if ckpt_int and step % ckpt_int == 0:
                self.save_checkpoint(step)
            if window_steps == 0:  # validation and saves stay out of the windows
                self._sync()
                window_start = time.perf_counter()

        step = int(self.state["step"])
        if self.val_history["steps"] and self.val_history["steps"][-1] == step:
            final_val = self.val_history["losses"][-1]
        else:
            final_val = self.validate()
            record_validation(step, final_val)
        self.save_checkpoint("final")
        self.logger.log("Training complete")
        self.logger.close()
        return {"final_loss": last_loss, "final_val_loss": final_val, "steps": step}


# -- loading a run ------------------------------------------------------------------
def _step_sort_key(tag: str) -> Tuple[int, int]:
    """Newest first: "final" outranks any numeric step, numeric steps
    descend, unknown tags come last."""
    if tag == "final":
        return (0, 0)
    if tag.isdigit():
        return (1, -int(tag))
    return (2, 0)


def latest_model_path(run_dir: str) -> Optional[str]:
    """Path of the newest ``step_<tag>_model.safetensors`` under
    ``run_dir/checkpoints`` (None when there is none). Integrity manifests
    are not verified here."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    prefix, suffix = "step_", "_model.safetensors"
    tags = [f[len(prefix):-len(suffix)] for f in os.listdir(ckpt_dir)
            if f.startswith(prefix) and f.endswith(suffix)]
    if not tags:
        return None
    tag = min(tags, key=_step_sort_key)
    return os.path.join(ckpt_dir, f"{prefix}{tag}{suffix}")


def load_trained(run_name_or_dir: str, runs_root: str = "runs", device="cuda"):
    """Load a finished run for inference: ``(params, args, tokenizer,
    config)`` with params on ``device``."""
    from ..checkpoint.safetensors_io import load_safetensors
    from ..convert import params_from_flat

    run_dir = (run_name_or_dir if os.path.isdir(run_name_or_dir)
               else os.path.join(runs_root, run_name_or_dir))
    cfg = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    tok = TokenizerManager.from_run_dir(run_dir)
    args = LlamaArgs.from_config(cfg.model, tok.vocab_size)
    resolve_architecture(cfg.model.architecture)  # unknown names raise, as in JAX
    model_path = latest_model_path(run_dir)
    if model_path is None:
        raise FileNotFoundError(f"no model checkpoints in {run_dir}")
    arrays, _ = load_safetensors(model_path)
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
