"""Loss-curve plotting CLI over the ``log.txt`` line protocol.

The JAX package's ``obs/plotting.py``: parses ``Step N: loss=... | ...``
and ``Step N validation: val_loss=...`` lines (either package's
``log.txt``), EMA smoothing, a CSV dump, and a PNG when ``matplotlib``
imports (optional; without it only ``metrics.csv`` is written).
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from typing import Dict, List, Optional, Tuple

STEP_RE = re.compile(r"^Step (\d+): (.+)$")
VAL_RE = re.compile(r"^Step (\d+) validation: val_loss=([0-9.eE+-]+)")
# Values are numeric, nan/inf, or the literal ``unknown`` (emitted for
# ``mfu`` when the chip peak FLOPs are undetectable, e.g. CPU smoke runs).
KV_RE = re.compile(r"([\w/]+)=([0-9.eE+-]+|nan|inf|unknown)")


def parse_value(v: str) -> Optional[float]:
    """A KV_RE value as a float, or None for the non-numeric ``unknown``."""
    return None if v == "unknown" else float(v)


def parse_log(path: str) -> Tuple[List[int], Dict[str, List[Optional[float]]]]:
    """Parse metric lines: returns (steps, {metric: values aligned to steps}).
    Validation lines are folded in under ``val_loss`` (sparse: None between
    validations)."""
    steps: List[int] = []
    metrics: Dict[str, List[Optional[float]]] = {}
    val_points: List[Tuple[int, float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            vm = VAL_RE.match(line)
            if vm:
                val_points.append((int(vm.group(1)), float(vm.group(2))))
                continue
            m = STEP_RE.match(line)
            if not m:
                continue
            step = int(m.group(1))
            kvs = dict(KV_RE.findall(m.group(2)))
            if "loss" not in kvs:
                continue
            steps.append(step)
            for k in set(metrics) | set(kvs):
                metrics.setdefault(k, [None] * (len(steps) - 1))
                metrics[k].append(parse_value(kvs[k]) if k in kvs else None)
    if val_points:
        by_step = dict(val_points)
        metrics["val_loss"] = [by_step.get(s) for s in steps]
        # raw val series too: validation can land on steps with no metric line
        metrics["_val_steps"] = [s for s, _ in val_points]
        metrics["_val_losses"] = [v for _, v in val_points]
    return steps, metrics


def ema(values: List[Optional[float]], alpha: float = 0.1) -> List[Optional[float]]:
    """Exponential moving average, skipping gaps."""
    out: List[Optional[float]] = []
    acc: Optional[float] = None
    for v in values:
        if v is None:
            out.append(None)
            continue
        acc = v if acc is None else alpha * v + (1 - alpha) * acc
        out.append(acc)
    return out


def write_csv(path: str, steps: List[int], metrics: Dict[str, List[Optional[float]]]) -> str:
    keys = [k for k in metrics if not k.startswith("_")]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step"] + keys)
        for i, s in enumerate(steps):
            w.writerow([s] + [metrics[k][i] if i < len(metrics[k]) else None for k in keys])
    return path


def plot_run(
    run_dir: str,
    out_path: Optional[str] = None,
    smooth: float = 0.1,
    show: bool = False,
) -> Optional[str]:
    """Plot loss (+EMA) and val_loss; writes PNG when matplotlib is
    available, always writes metrics.csv. Returns the PNG path or None."""
    log_path = os.path.join(run_dir, "log.txt") if os.path.isdir(run_dir) else run_dir
    run_dir = os.path.dirname(log_path)
    steps, metrics = parse_log(log_path)
    if not steps:
        raise ValueError(f"no metric lines found in {log_path}")
    write_csv(os.path.join(run_dir, "metrics.csv"), steps, metrics)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(steps, metrics["loss"], alpha=0.3, label="train loss")
    if smooth:
        ax.plot(steps, ema(metrics["loss"], smooth), label=f"train loss (EMA {smooth})")
    if metrics.get("_val_steps"):
        ax.plot(metrics["_val_steps"], metrics["_val_losses"], "o-", label="val loss")
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_title(os.path.basename(run_dir) or log_path)
    ax.legend()
    ax.grid(alpha=0.3)
    out_path = out_path or os.path.join(run_dir, "loss_curve.png")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    if show:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot training curves from log.txt")
    parser.add_argument("run", help="run directory or log.txt path")
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--out", default=None)
    parser.add_argument("--smooth", type=float, default=0.1)
    a = parser.parse_args(argv)
    run = a.run
    if not os.path.exists(run):
        run = os.path.join(a.runs_root, run)
    out = plot_run(run, a.out, a.smooth)
    print(out or "matplotlib unavailable; wrote metrics.csv only")
    return out


if __name__ == "__main__":
    main()
