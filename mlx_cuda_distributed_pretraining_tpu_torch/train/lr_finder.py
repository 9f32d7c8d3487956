"""Learning-rate finder: an exponential LR sweep with a divergence stop
(the JAX package's ``train/lr_finder.py``).

The sweep runs ``num_steps`` updates from ``min_lr`` to ``max_lr`` on a
copy of the parameters (the caller's are left as they were), smooths the
losses, stops once the smoothed loss passes ``diverge_factor`` times its
best, and suggests the LR at the steepest descent of the smoothed curve
against log(lr). :func:`run_lr_finder` sweeps momentum SGD, as the trainer
does; :func:`run_lr_finder_for_optimizer` sweeps the configured optimizer
itself. Both write ``lr_finder.csv`` (and ``lr_finder.png`` where
matplotlib imports) to ``out_dir``.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..optim.base import tmap
from ..utils.tree import leaves_with_path


def _copy(params: Any) -> Any:
    return tmap(lambda p: p.detach().clone().requires_grad_(True), params)


def _loss_and_grads(loss_fn: Callable, params: Any, batch: Dict) -> torch.Tensor:
    leaves = [p for _, p in leaves_with_path(params)]
    for p in leaves:
        p.grad = None
    loss = loss_fn(params, batch)[0]
    loss.backward()
    return loss.detach()


def _sweep_step(loss_fn: Callable) -> Callable:
    """Momentum-SGD sweep step: ``trace = 0.9 trace + g``, ``p += -lr *
    trace`` (in fp32), in place; returns the loss."""

    def step(params, trace, batch, lr: float):
        loss = _loss_and_grads(loss_fn, params, batch)
        neg_lr = torch.tensor(-lr, dtype=torch.float32)
        with torch.no_grad():
            for (_, p), (_, t) in zip(leaves_with_path(params), leaves_with_path(trace)):
                t.copy_(0.9 * t + p.grad.float())
                p.copy_((p.float() + neg_lr.to(t.device) * t).to(p.dtype))
                p.grad = None
        return loss

    return step


def _record(smooth, loss, smoothing):
    return loss if smooth is None else smoothing * loss + (1 - smoothing) * smooth


def _write(out_dir: Optional[str], lrs, losses, suggested) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lr_finder.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["lr", "smoothed_loss"])
        w.writerows(zip(lrs, losses))
    _maybe_plot(lrs, losses, suggested, os.path.join(out_dir, "lr_finder.png"))


def run_lr_finder(params: Any, loss_fn: Callable, batch_iter: Callable[[int], Dict],
                  min_lr: float = 1e-7, max_lr: float = 1.0, num_steps: int = 100,
                  smoothing: float = 0.05, diverge_factor: float = 4.0,
                  out_dir: Optional[str] = None) -> Tuple[float, List[float], List[float]]:
    """``(suggested_lr, lrs, smoothed_losses)`` of a momentum-SGD sweep;
    ``loss_fn(params, batch)`` returns the loss first, ``batch_iter(i)``
    gives step i's batch."""
    gamma = (max_lr / min_lr) ** (1.0 / max(num_steps - 1, 1))
    params = _copy(params)
    trace = tmap(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    step = _sweep_step(loss_fn)
    lrs: List[float] = []
    losses: List[float] = []
    smooth, best, lr = None, math.inf, min_lr
    for i in range(num_steps):
        loss = float(step(params, trace, batch_iter(i), lr))
        smooth = _record(smooth, loss, smoothing)
        lrs.append(lr)
        losses.append(smooth)
        best = min(best, smooth)
        if not math.isfinite(smooth) or smooth > diverge_factor * best:
            break
        lr *= gamma
    suggested = suggest_lr(lrs, losses)
    _write(out_dir, lrs, losses, suggested)
    return suggested, lrs, losses


def run_lr_finder_for_optimizer(params: Any, loss_fn: Callable,
                                batch_iter: Callable[[int], Dict], training_cfg: Any,
                                optimizer_name: str, min_lr: float = 1e-7,
                                max_lr: float = 1.0, num_steps: int = 100,
                                smoothing: float = 0.05, diverge_factor: float = 4.0,
                                out_dir: Optional[str] = None
                                ) -> Tuple[float, List[float], List[float]]:
    """The sweep with the configured optimizer's own update: it is built on
    a schedule that gives step i exactly ``min_lr * gamma**i`` (fp32)."""
    from ..optim.factory import build_optimizer

    gamma = (max_lr / min_lr) ** (1.0 / max(num_steps - 1, 1))
    log_gamma = math.log(gamma)

    def sweep_schedule(count):
        # the schedule's counter is incremented before it is read, so step i
        # arrives as count i + 1
        i = torch.clamp(torch.tensor(count, dtype=torch.float32) - 1.0, min=0.0)
        return (torch.tensor(min_lr, dtype=torch.float32)
                * torch.exp(i * torch.tensor(log_gamma, dtype=torch.float32)))

    opt = build_optimizer(training_cfg, num_steps, name=optimizer_name,
                          schedule=sweep_schedule)
    params = _copy(params)
    state = opt.init(params)
    lrs: List[float] = []
    losses: List[float] = []
    smooth, best = None, math.inf
    for i in range(num_steps):
        loss = _loss_and_grads(loss_fn, params, batch_iter(i))
        grads = tmap(lambda p: p.grad, params)
        params, state = opt.fused_apply(grads, state, params)
        smooth = _record(smooth, float(loss), smoothing)
        lrs.append(min_lr * gamma ** i)
        losses.append(smooth)
        best = min(best, smooth)
        if not math.isfinite(smooth) or smooth > diverge_factor * best:
            break
    suggested = suggest_lr(lrs, losses)
    _write(out_dir, lrs, losses, suggested)
    return suggested, lrs, losses


def suggest_lr(lrs: List[float], losses: List[float]) -> float:
    """The LR at the steepest descent of loss against log(lr); best / 10
    when the curve never falls."""
    if len(lrs) < 4:
        return lrs[len(lrs) // 2] if lrs else 1e-3
    best_slope, best_idx = 0.0, None
    for i in range(1, len(lrs) - 1):
        dlog = math.log(lrs[i + 1]) - math.log(lrs[i - 1])
        slope = (losses[i + 1] - losses[i - 1]) / dlog if dlog else 0.0
        if slope < best_slope:
            best_slope, best_idx = slope, i
    if best_idx is not None:
        return lrs[best_idx]
    return lrs[losses.index(min(losses))] / 10.0


def _maybe_plot(lrs, losses, suggested, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(lrs, losses)
    ax.set_xscale("log")
    ax.axvline(suggested, color="tab:red", linestyle="--", label=f"suggested={suggested:.2e}")
    ax.set_xlabel("learning rate")
    ax.set_ylabel("smoothed loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
