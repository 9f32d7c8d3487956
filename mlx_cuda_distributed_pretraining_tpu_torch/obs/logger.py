"""Run logger: stderr + ``log.txt`` with the JAX trainer's line protocol.

The protocol is an API (plotting and monitoring tools parse it)::

    Step <N>: loss=<f> | ppl=<f> | lr=<e> | tok/s=<f> | toks=<int> | ...
    Step <N> validation: val_loss=<f>
    Step <N> sample: '<prompt>' -> '<text>'

TensorBoard and W&B are not ported.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional


class Logger:
    def __init__(self, run_dir: str, quiet: bool = False):
        self.run_dir = run_dir
        self.quiet = quiet
        self.log_path = os.path.join(run_dir, "log.txt")
        os.makedirs(run_dir, exist_ok=True)
        self._file = open(self.log_path, "a", buffering=1)

    def log(self, message: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {message}"
        if not self.quiet:
            print(line, file=sys.stderr)
        self._file.write(line + "\n")

    def _raw(self, line: str) -> None:
        if not self.quiet:
            print(line)
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

    def log_validation(self, step: int, val_loss: float,
                       extra: Optional[Dict[str, float]] = None) -> None:
        tail = "".join(f" {k}={v:.4f}" for k, v in (extra or {}).items())
        self._raw(f"Step {step} validation: val_loss={val_loss:.4f}{tail}")

    def log_model_summary(self, n_params: int, args: Any) -> None:
        self.log(f"Model: {n_params:,} parameters ({n_params/1e6:.2f}M)")
        self.log(f"Model args: {args}")

    def log_sample(self, step: int, prompt: str, text: str) -> None:
        self._raw(f"Step {step} sample: {prompt!r} -> {text!r}")

    def close(self) -> None:
        self._file.close()
