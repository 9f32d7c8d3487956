"""Idempotent ``torch.profiler`` capture with attribution on stop (the JAX
package's ``obs/profiler.py`` over ``jax.profiler``).

The trainer's three capture paths (the ``logging.profile_start`` /
``profile_stop`` window, the SIGUSR2 on-demand capture, and the end-of-run
``finally``) all go through one :class:`ProfileCapture`:

- ``start()`` is a no-op (returns False) when a capture is already running,
  and never raises: one profiler session per process, and a capture request
  must not kill training. It synchronizes the device first (``sync``), so
  no earlier step's kernels land in the capture.
- ``stop()`` is a no-op (returns None) when nothing is running. Otherwise it
  synchronizes the device (the in-flight step must land inside the trace),
  stops the profiler, writes its Chrome trace to
  ``<dump_dir>/plugins/profile/<session>/<host>.pt.trace.json`` and, unless
  reporting is off, runs the attribution (``obs/profile_report.py``) over
  it, writes the JSON summary and returns the report.

Report generation is best-effort: a trace that yields nothing logs a line
and returns None; the trace file itself stays on disk.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Any, Callable, Dict, Optional

from .profile_report import generate_report, write_summary


class ProfileCapture:
    """One ``torch.profiler`` session per process, with attribution.

    Parameters:
      dump_dir      where the trace lands (``<run_dir>/profile``)
      log           line logger (``Trainer.logger.log``-shaped)
      sync          drains in-flight device work (``torch.cuda.synchronize``)
      analytic_fn   lazily builds the analytic join dict for the report
      summary_path  where stop() writes the JSON summary (None: skip)
      report        master switch (``logging.profile_report.enabled``)
      top_k         op-table rows in the generated report
      cuda          also record the CUDA activity (kernels, memcpys)
    """

    def __init__(self, dump_dir: str,
                 log: Optional[Callable[[str], None]] = None,
                 sync: Optional[Callable[[], None]] = None,
                 analytic_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 summary_path: Optional[str] = None,
                 report: bool = True, top_k: int = 12, cuda: bool = False):
        self.dump_dir = dump_dir
        self.active = False
        self._log = log or (lambda msg: None)
        self._sync = sync
        self._analytic_fn = analytic_fn
        self.summary_path = summary_path
        self.report_enabled = bool(report)
        self.top_k = int(top_k)
        self.cuda = bool(cuda)
        self.last_report: Optional[Dict[str, Any]] = None
        self.trace_path: Optional[str] = None
        self._prof = None

    def _drain(self, when: str) -> None:
        if self._sync is not None:
            try:
                self._sync()
            except Exception as e:  # noqa: BLE001 - sync is advisory
                self._log(f"profiler: device sync {when} failed ({e})")

    def start(self, step: Optional[int] = None) -> bool:
        """Begin a capture; False (logged, no exception) when one is
        already running or the profiler refuses to start."""
        if self.active:
            return False
        self._drain("before start")
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 - capture is best-effort
            self._log(f"profiler: unavailable ({e})")
            return False
        self._prof = prof
        self.active = True
        at = f" at step {step}" if step is not None else ""
        self._log(f"profiler: trace started{at}")
        return True

    def stop(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """End the capture and attribute it. Returns the report dict (None
        when idle, when reporting is off, or when the trace yields nothing
        attributable)."""
        if not self.active:
            return None
        self._drain("before stop")
        prof, self._prof = self._prof, None
        self.active = False
        session = os.path.join(self.dump_dir, "plugins", "profile",
                               time.strftime("%Y_%m_%d_%H_%M_%S"))
        try:
            prof.stop()
            os.makedirs(session, exist_ok=True)
            self.trace_path = os.path.join(
                session, f"{socket.gethostname()}.pt.trace.json")
            prof.export_chrome_trace(self.trace_path)
        except Exception as e:  # noqa: BLE001 - never kill training
            self._log(f"profiler: could not write the trace ({type(e).__name__}: {e})")
            return None
        self._log(f"profiler: trace written to {self.trace_path}")
        if not self.report_enabled:
            return None
        try:
            analytic = self._analytic_fn() if self._analytic_fn else None
            report = generate_report(self.dump_dir, analytic=analytic,
                                     top_k=self.top_k)
        except Exception as e:  # noqa: BLE001 - never kill training
            self._log(f"graftprof: report failed "
                      f"({type(e).__name__}: {e}); trace kept on disk")
            return None
        if report is None:
            self._log("graftprof: no attributable device ops in the trace")
            return None
        self.last_report = report
        if self.summary_path:
            try:
                write_summary(report, self.summary_path)
            except OSError as e:
                self._log(f"graftprof: could not write "
                          f"{self.summary_path}: {e}")
        return report
