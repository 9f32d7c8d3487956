"""Run logger: stderr + ``log.txt`` with the JAX trainer's line protocol,
plus optional TensorBoard and W&B.

The protocol is an API (``obs/plotting.py`` parses it)::

    Step <N>: loss=<f> | ppl=<f> | lr=<e> | tok/s=<f> | toks=<int> | ...
    Step <N> validation: val_loss=<f>
    Step <N> sample: '<prompt>' -> '<text>'

``logging.tensorboard`` writes scalars under ``<run_dir>/tensorboard``
through ``torch.utils.tensorboard`` and ``logging.wandb`` logs to W&B, each
only when its package imports, as in the JAX logger: a missing one logs a
line saying so and changes nothing else about the run.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional


class Logger:
    def __init__(self, run_dir: str, config: Optional[Any] = None, quiet: bool = False,
                 write_files: bool = True):
        """``write_files=False`` (a rank other than the chief) writes no
        ``log.txt``, TensorBoard or W&B: lines go to the console only,
        unless ``quiet``."""
        self.run_dir = run_dir
        self.quiet = quiet
        self.log_path = os.path.join(run_dir, "log.txt")
        os.makedirs(run_dir, exist_ok=True)
        self._file = open(self.log_path, "a", buffering=1) if write_files else None
        self._tb = None
        self._wandb = None
        log_cfg = getattr(config, "logging", None) if write_files else None
        if log_cfg is not None and getattr(log_cfg, "tensorboard", False):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tensorboard"))
            except ImportError:
                self.log("tensorboard requested but torch.utils.tensorboard unavailable")
        if log_cfg is not None and getattr(log_cfg, "wandb", False):
            try:
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=getattr(log_cfg, "wandb_project", None) or "tpu-pretrain",
                    entity=getattr(log_cfg, "wandb_entity", None),
                    name=os.path.basename(run_dir),
                    config=config.to_dict() if hasattr(config, "to_dict") else None)
            except Exception:
                self._wandb = None
                self.log("wandb requested but unavailable; continuing without it")

    def log(self, message: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {message}"
        if not self.quiet:
            print(line, file=sys.stderr)
        if self._file is not None:
            self._file.write(line + "\n")

    def _raw(self, line: str) -> None:
        if not self.quiet:
            print(line)
        if self._file is not None:
            self._file.write(line + "\n")

    def log_metrics(self, step: int, metrics: Dict[str, Any]) -> None:
        order = ["loss", "ppl", "lr", "grad_norm", "tok/s", "toks"]
        keys = [k for k in order if k in metrics] + [k for k in metrics if k not in order]
        parts = []
        for k in keys:
            v = metrics[k]
            if k == "lr":
                parts.append(f"lr={v:.3e}")
            elif k == "toks":
                parts.append(f"toks={int(v)}")
            elif isinstance(v, float):
                parts.append(f"{k}={v:.4f}")
            else:
                parts.append(f"{k}={v}")
        self._raw(f"Step {step}: " + " | ".join(parts))
        scalars = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k.replace("/", "_per_"), v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_validation(self, step: int, val_loss: float,
                       extra: Optional[Dict[str, float]] = None) -> None:
        tail = "".join(f" {k}={v:.4f}" for k, v in (extra or {}).items())
        self._raw(f"Step {step} validation: val_loss={val_loss:.4f}{tail}")
        if self._tb is not None:
            self._tb.add_scalar("val_loss", val_loss, step)
        if self._wandb is not None:
            self._wandb.log({"val_loss": val_loss}, step=step)

    def log_model_summary(self, n_params: int, args: Any) -> None:
        self.log(f"Model: {n_params:,} parameters ({n_params/1e6:.2f}M)")
        self.log(f"Model args: {args}")

    def log_sample(self, step: int, prompt: str, text: str) -> None:
        self._raw(f"Step {step} sample: {prompt!r} -> {text!r}")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        if self._file is not None:
            self._file.close()
