"""Early stopping on the validation loss (the JAX package's
``train/early_stopping.py``); its state rides the checkpoint's
``step_<N>_state.json``."""

from __future__ import annotations

from typing import Any, Dict


class EarlyStoppingMonitor:
    def __init__(self, patience: int = 3, min_delta: float = 0.001, mode: str = "min",
                 metric: str = "val_loss", enabled: bool = True):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.metric = metric
        self.enabled = enabled
        self.best = None
        self.bad_count = 0
        self.should_stop = False

    @classmethod
    def from_config(cls, training_cfg: Any) -> "EarlyStoppingMonitor":
        es = dict(getattr(training_cfg, "early_stopping", None) or {})
        return cls(
            patience=int(es.get("patience", 3)),
            min_delta=float(es.get("min_delta", 0.001)),
            mode=str(es.get("mode", "min")),
            metric=str(es.get("metric", "val_loss")),
            enabled=bool(es.get("enabled", False)),
        )

    def update(self, value: float) -> bool:
        """Record a new metric value; returns True if training should stop."""
        if not self.enabled:
            return False
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best = value
            self.bad_count = 0
        else:
            self.bad_count += 1
            if self.bad_count >= self.patience:
                self.should_stop = True
        return self.should_stop

    def state_dict(self) -> Dict[str, Any]:
        return {"best": self.best, "bad_count": self.bad_count, "should_stop": self.should_stop}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.best = d.get("best")
        self.bad_count = int(d.get("bad_count", 0))
        self.should_stop = bool(d.get("should_stop", False))
