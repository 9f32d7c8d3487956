"""Live training monitor: attach to a running (or finished) run directory.

The JAX package's ``obs/monitor.py``: finds the latest run log, tails
``log.txt`` incrementally (either package's), regex-extracts
step/loss/val_loss/lr/tok-s with ``obs/plotting.py``'s patterns, prints a
status line per refresh with the fleet's heartbeats and the scope
collector's firing alerts, and optionally re-renders the loss plot
(``matplotlib`` when it imports).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

from .events import read_fleet_heartbeats
from .plotting import STEP_RE, VAL_RE, KV_RE, parse_value, plot_run


def fetch_alerts(url: Optional[str],
                 timeout: float = 2.0) -> Optional[Dict[str, object]]:
    """Best-effort ``GET /alerts`` from a scope collector.

    Returns the parsed document or None — absent collector, connection
    refused, bad JSON all read as "no alert data" (the monitor keeps its
    plain status line, same absent-key tolerance as mfu/ttft)."""
    if not url:
        return None
    import json
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + "/alerts",
                                    timeout=timeout) as resp:
            doc = json.loads(resp.read().decode("utf-8", "replace"))
        return doc if isinstance(doc, dict) else None
    except Exception:
        return None


def alerts_status(doc: Optional[Dict[str, object]]) -> str:
    """``alerts=2(rule-a,rule-b)`` from a /alerts document, or '' when
    the doc is absent/empty/malformed."""
    if not doc:
        return ""
    firing = [a.get("rule", "?") for a in doc.get("alerts", [])
              if isinstance(a, dict) and a.get("state") == "firing"]
    if not firing:
        return "alerts=0"
    return "alerts=%d(%s)" % (len(firing), ",".join(sorted(map(str, firing))))


def fleet_status(run_dir: str, now: Optional[float] = None) -> str:
    """One-line per-host heartbeat summary for a multi-host run:
    ``hosts p0:s12(0.4s) p1:s12(0.6s)`` — step and heartbeat age per
    process index. Empty string when the run writes no per-host
    heartbeats (single-host runs keep the plain status line)."""
    fleet = read_fleet_heartbeats(run_dir)
    if len(fleet) < 2:
        return ""
    now = time.time() if now is None else now
    bits = []
    for idx in sorted(fleet):
        hb = fleet[idx]
        age = max(0.0, now - float(hb.get("t", 0.0) or 0.0))
        step = hb.get("step")
        bits.append(f"p{idx}:s{step if step is not None else '?'}({age:.1f}s)")
    return "hosts " + " ".join(bits)


def find_latest_run(runs_root: str = "runs") -> Optional[str]:
    """Most recently modified run dir with a log.txt."""
    if not os.path.isdir(runs_root):
        return None
    best, best_t = None, -1.0
    for name in os.listdir(runs_root):
        log = os.path.join(runs_root, name, "log.txt")
        if os.path.isfile(log):
            t = os.path.getmtime(log)
            if t > best_t:
                best, best_t = os.path.join(runs_root, name), t
    return best


class LogTailer:
    """Incremental log.txt reader that accumulates parsed metrics."""

    def __init__(self, log_path: str):
        self.log_path = log_path
        self._pos = 0
        self.steps: List[int] = []
        self.latest: Dict[str, float] = {}
        self.val_steps: List[int] = []
        self.val_losses: List[float] = []
        self.other_lines: List[str] = []

    def poll(self) -> int:
        """Read newly appended lines; returns how many metric lines parsed."""
        if not os.path.isfile(self.log_path):
            return 0
        n = 0
        with open(self.log_path) as f:
            f.seek(self._pos)
            for line in f:
                if not line.endswith("\n"):
                    break  # partial write; re-read next poll
                self._pos += len(line)
                line = line.strip()
                vm = VAL_RE.match(line)
                if vm:
                    self.val_steps.append(int(vm.group(1)))
                    self.val_losses.append(float(vm.group(2)))
                    continue
                m = STEP_RE.match(line)
                if m:
                    self.steps.append(int(m.group(1)))
                    kvs = dict(KV_RE.findall(m.group(2)))
                    # parse_value maps the literal ``unknown`` (mfu on
                    # hosts with no detectable chip peak) to None; drop
                    # those so ``latest`` stays all-float.
                    self.latest = {
                        k: pv for k, v in kvs.items()
                        if (pv := parse_value(v)) is not None}
                    self.latest["step"] = self.steps[-1]
                    n += 1
                elif line:
                    self.other_lines.append(line)
        return n

    def status_line(self) -> str:
        if not self.latest:
            return "(no metric lines yet)"
        parts = [f"step {int(self.latest['step'])}"]
        for k in ("loss", "ppl", "lr", "tok/s", "mfu"):
            if k in self.latest:
                fmt = (".3e" if k == "lr" else ".0f" if k == "tok/s"
                       else ".3f" if k == "mfu" else ".4f")
                parts.append(f"{k}={self.latest[k]:{fmt}}")
        # MoE routing health (only present on MoE runs — models/moe.py tap).
        if "moe_entropy" in self.latest:
            parts.append(f"moe_ent={self.latest['moe_entropy']:.3f}")
        if "moe_drop" in self.latest:
            parts.append(f"moe_drop={int(self.latest['moe_drop'])}")
        # TTFT quantiles (only present when tailing a serving worker's
        # log — training lines simply lack the keys).
        if "ttft_ms_p50" in self.latest:
            t95 = (f"/{self.latest['ttft_ms_p95']:.0f}"
                   if "ttft_ms_p95" in self.latest else "")
            parts.append(f"ttft_ms={self.latest['ttft_ms_p50']:.0f}{t95}")
        if self.val_losses:
            parts.append(f"val_loss={self.val_losses[-1]:.4f}@{self.val_steps[-1]}")
        return " | ".join(parts)


def monitor(
    run_dir: str,
    interval: float = 5.0,
    max_iters: Optional[int] = None,
    plot_every: int = 0,
    on_status: Optional[Callable[[str], None]] = None,
    alerts_url: Optional[str] = None,
) -> LogTailer:
    """Poll loop. ``max_iters`` bounds iterations (None = until Ctrl-C)."""
    tailer = LogTailer(os.path.join(run_dir, "log.txt"))
    emit = on_status or (lambda s: print(s, flush=True))
    i = 0
    try:
        while max_iters is None or i < max_iters:
            if tailer.poll():
                line = tailer.status_line()
                fleet = fleet_status(run_dir)
                if fleet:
                    line = f"{line} | {fleet}"
                alerts = alerts_status(fetch_alerts(alerts_url))
                if alerts:
                    line = f"{line} | {alerts}"
                emit(line)
                if plot_every and len(tailer.steps) % plot_every == 0:
                    try:
                        plot_run(run_dir)
                    except (ValueError, OSError):
                        pass
            i += 1
            if max_iters is None or i < max_iters:
                time.sleep(interval)
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    return tailer


def main(argv=None):
    parser = argparse.ArgumentParser(description="Monitor a training run")
    parser.add_argument("run", nargs="?", default=None,
                        help="run name or dir (default: latest under runs/)")
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--plot-every", type=int, default=0,
                        help="re-render loss_curve.png every N metric lines")
    parser.add_argument("--alerts-url", default=None,
                        help="scope collector base URL; firing-alert "
                             "counts join the status line (absent-key "
                             "tolerant — no collector, no column)")
    a = parser.parse_args(argv)
    run_dir = a.run
    if run_dir is None:
        run_dir = find_latest_run(a.runs_root)
        if run_dir is None:
            parser.error(f"no runs found under {a.runs_root}/")
        print(f"monitoring {run_dir}")
    elif not os.path.isdir(run_dir):
        run_dir = os.path.join(a.runs_root, run_dir)
    monitor(run_dir, a.interval, plot_every=a.plot_every,
            alerts_url=a.alerts_url)


if __name__ == "__main__":
    main()
