"""Auto-resume supervisor on one host: restart a crashed, hung or
preempted trainer (the JAX package's ``train/supervisor.py``, without its
multi-host generations).

    python -m mlx_cuda_distributed_pretraining_tpu_torch.train.trainer \\
        --config run.json --auto-resume [--hang-timeout-s 900]

runs the port's trainer in a child process and restarts it after any
non-zero exit, resuming from the newest checkpoint that passes manifest
verification (``CheckpointManager.latest_complete_step``: a checkpoint
torn by the crash itself is quarantined, never resumed). The trainer's
resume makes a restart exact: the resumed run gives the uninterrupted
run's losses.

Crash loops: restarts back off exponentially (``backoff_base`` doubling up
to ``backoff_max``), and the supervisor gives up (:class:`CrashLoopError`)
after ``max_crashes_per_step`` consecutive crashes with NO checkpoint
progress between them, so a deterministic crash fails fast while a crash
that still advances checkpoints restarts indefinitely.

SIGTERM/SIGINT to the supervisor are forwarded to the child (which saves a
preemption checkpoint and exits); the supervisor then exits without
restarting.

Hang watchdog (``supervisor.hang_timeout_s``): the trainer writes
``<run_dir>/heartbeat.json`` at its start, after every log window, save and
validation (``obs/events.py``). If the heartbeat makes no progress for the
timeout while the child lives, the child is hung and no exit code will
come: the watchdog SIGTERMs it, SIGKILLs it after ``hang_kill_grace_s``,
and appends a ``fault`` event (kind ``hang``); the relaunch appends a
``restart`` event with the wall clock lost since the child's last
progress (``lost_s``, booked into the goodput ledger as
``restart_lost_s`` on replay). A hang counts as a crash even when the
SIGTERM lets the child exit 0.

Scope sidecar (``--scope``): a collector (``obs/scope.py``) beside the
supervisor scrapes the child's ``logging.metrics_port``, keeps the samples
in ``<run_dir>/scope_tsdb/`` and evaluates the alert rules (``--alerts-config``,
else the config's ``scope.alerts_path``, else ``configs/alerts.yaml`` when
present), writing its evidence into the run dir. It starts at the child's
first heartbeat, after the trainer has set up (on a fresh launch, wiped)
the run dir.

Not ported: several processes (``process_count > 1``: the multi-host
generations, ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint.manager import CheckpointManager
from ..obs.events import append_event, events_path, heartbeat_path, read_heartbeat


class CrashLoopError(RuntimeError):
    """The child kept crashing without making checkpoint progress."""


class Supervisor:
    """Restart loop around one training subprocess.

    ``build_cmd(resume_tag)`` returns the child argv for a launch that
    resumes from ``resume_tag`` (a verified step tag, or None for a fresh
    start): injected, so tests drive the loop with stub children and
    :func:`_trainer_cmd_builder` owns the real trainer command.
    """

    def __init__(
        self,
        build_cmd: Callable[[Optional[str]], List[str]],
        run_dir: str,
        max_crashes_per_step: int = 3,
        backoff_base: float = 2.0,
        backoff_max: float = 60.0,
        on_spawn: Optional[Callable[[subprocess.Popen], None]] = None,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr),
        env: Optional[Dict[str, str]] = None,
        hang_timeout_s: float = 0.0,
        hang_kill_grace_s: float = 20.0,
        process_count: int = 1,
    ):
        if int(process_count) > 1:
            raise NotImplementedError(
                f"a supervisor over {process_count} processes is not ported "
                "(ROADMAP queue 1 item 10: the multi-host supervisor)")
        self.build_cmd = build_cmd
        self.run_dir = run_dir
        self.max_crashes_per_step = int(max_crashes_per_step)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.on_spawn = on_spawn
        self.log = log
        self.env = env
        self.hang_timeout_s = float(hang_timeout_s or 0.0)
        self.hang_kill_grace_s = float(hang_kill_grace_s)
        self.heartbeat_file = heartbeat_path(run_dir)
        self.events_file = events_path(run_dir)
        self.restarts = 0
        self.hangs = 0  # written by the watchdog thread
        self._child: Optional[subprocess.Popen] = None
        self._shutdown_signal: Optional[int] = None
        self._hang_fired = False  # written by the watchdog thread
        # Wall clock of the last step progress of a dead child: the anchor of
        # the restart-lost time booked at the relaunch.
        self._restart_anchor: Optional[float] = None

    def _append_event(self, type: str, **fields) -> None:
        """Event-log appends must never take the supervisor down."""
        try:
            append_event(self.events_file, type, **fields)
        except OSError as e:
            self.log(f"supervisor: could not append {type} event ({e})")

    def _last_progress(self, floor: float) -> float:
        """Wall clock of the child's newest heartbeat, floored at ``floor``
        (the child's spawn time: a heartbeat left by a PREVIOUS child must
        not count against a freshly launched one)."""
        hb = read_heartbeat(self.heartbeat_file)
        if hb and isinstance(hb.get("t"), (int, float)):
            return max(float(floor), float(hb["t"]))
        return float(floor)

    def _stop_child(self, child: subprocess.Popen, why: str) -> None:
        """SIGTERM, then SIGKILL after ``hang_kill_grace_s`` (a stopped or
        wedged child never runs its SIGTERM handler)."""
        try:
            child.terminate()
            try:
                child.wait(timeout=self.hang_kill_grace_s)
            except subprocess.TimeoutExpired:
                self.log(f"supervisor: {why} child ignored SIGTERM; killing")
                child.kill()
        except OSError:
            pass

    def _watch_child(self, child: subprocess.Popen, spawned_at: float,
                     stop_evt: threading.Event) -> None:
        """Poll the heartbeat; stop the child once it has made no step
        progress for ``hang_timeout_s``."""
        poll = max(0.2, min(self.hang_timeout_s / 4.0, 10.0))
        while not stop_evt.wait(poll):
            if child.poll() is not None:
                return
            stalled = time.time() - self._last_progress(spawned_at)
            if stalled <= self.hang_timeout_s:
                continue
            self._hang_fired = True
            self.hangs += 1
            hb = read_heartbeat(self.heartbeat_file)
            self.log(f"supervisor: watchdog — no step progress for "
                     f"{stalled:.1f}s (hang_timeout_s={self.hang_timeout_s:g}); "
                     f"terminating hung child pid {child.pid}")
            self._append_event("fault", kind="hang", stalled_s=round(stalled, 3),
                               step=(hb or {}).get("step"), pid=child.pid)
            self._stop_child(child, "hung")
            return

    def latest_resumable(self) -> Optional[str]:
        """Newest verified step tag, or None. Runs the quarantining scan the
        child's resume would, so a corrupt newest checkpoint is set aside
        before the child launches. A scan OSError is retried and then
        RE-RAISED: it must never read as "no checkpoints", since a fresh
        launch would discard the run's recovery state."""
        attempts = 3
        for attempt in range(1, attempts + 1):
            try:
                return CheckpointManager(self.run_dir, notify=self.log).latest_complete_step()
            except OSError as e:
                if attempt == attempts:
                    raise
                delay = min(self.backoff_base * (2 ** (attempt - 1)), self.backoff_max)
                self.log(f"supervisor: checkpoint scan failed ({e}); "
                         f"retry {attempt}/{attempts - 1} in {delay:.1f}s")
                time.sleep(delay)
        return None  # unreachable

    def _forward_signal(self, signum, frame) -> None:
        self._shutdown_signal = signum
        child = self._child
        if child is not None and child.poll() is None:
            child.send_signal(signum)

    def run(self) -> int:
        """Drive the child to a zero exit. Returns the final exit code (0, or
        the child's after a forwarded shutdown signal); raises
        :class:`CrashLoopError` after ``max_crashes_per_step`` consecutive
        no-progress crashes."""
        prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev = signal.signal(sig, self._forward_signal)
                prev_handlers[sig] = prev if prev is not None else signal.SIG_DFL
        except (ValueError, OSError):  # not the main thread (tests)
            prev_handlers = {}

        crashes = 0
        tag_after_last_crash: Optional[str] = None
        try:
            while True:
                tag = self.latest_resumable()
                cmd = self.build_cmd(tag)
                self.log(f"supervisor: launching child "
                         f"(resume={tag if tag is not None else 'fresh'})")
                if self._restart_anchor is not None:
                    # everything between the dead child's last step progress
                    # and this relaunch
                    lost = max(0.0, time.time() - self._restart_anchor)
                    self._append_event("restart", lost_s=round(lost, 3), resume=tag,
                                       restarts=self.restarts)
                    self._restart_anchor = None
                # No watchdog is alive here: the previous one was joined.
                self._hang_fired = False
                self._child = subprocess.Popen(
                    cmd, env=dict(self.env) if self.env is not None else None)
                spawned_at = time.time()
                if self.on_spawn is not None:
                    self.on_spawn(self._child)
                watchdog = None
                stop_evt = threading.Event()
                if self.hang_timeout_s > 0:
                    watchdog = threading.Thread(
                        target=self._watch_child, args=(self._child, spawned_at, stop_evt),
                        name="hang-watchdog", daemon=True)
                    watchdog.start()
                rc = self._child.wait()
                stop_evt.set()
                if watchdog is not None:
                    # wait() may return while the watchdog is mid-termination
                    watchdog.join(timeout=self.hang_kill_grace_s + 10.0)
                hang = self._hang_fired
                if rc == 0 and not hang:
                    self.log("supervisor: child completed cleanly")
                    return 0
                if self._shutdown_signal is not None and not hang:
                    # a forwarded preemption: the child saved and exited
                    self.log(f"supervisor: shutdown signal {self._shutdown_signal} "
                             "forwarded; not restarting")
                    return rc
                # A crash (a hang too, even on rc 0: the run is not done).
                # Anchor the lost time at the child's last progress.
                self._restart_anchor = self._last_progress(spawned_at)
                new_tag = self.latest_resumable()
                if new_tag is not None and new_tag != tag_after_last_crash:
                    crashes = 1  # progress since the last crash: reset
                else:
                    crashes += 1
                tag_after_last_crash = new_tag
                self._append_event("postmortem", rc=rc, hang=hang, crashes=crashes,
                                   checkpoint=new_tag)
                if crashes >= self.max_crashes_per_step:
                    raise CrashLoopError(
                        f"giving up after {crashes} consecutive crashes with "
                        f"no checkpoint progress (stuck at "
                        f"{new_tag if new_tag is not None else 'no checkpoint'}, "
                        f"last exit code {rc})")
                delay = min(self.backoff_base * (2 ** (crashes - 1)), self.backoff_max)
                self.restarts += 1
                self.log(f"supervisor: child exited rc={rc}{' [hang]' if hang else ''} "
                         f"(crash {crashes}/{self.max_crashes_per_step} at "
                         f"checkpoint {new_tag}); restarting in {delay:.1f}s")
                time.sleep(delay)
        finally:
            self._child = None
            for sig, h in prev_handlers.items():
                try:
                    signal.signal(sig, h)
                except (ValueError, OSError):
                    pass


def _checkpoints_present(run_dir: str) -> bool:
    """Anything under ``<run_dir>/checkpoints`` (good steps, files from
    before manifests, ``quarantine/`` forensics) that a fresh start's
    overwrite would destroy."""
    try:
        return bool(os.listdir(os.path.join(run_dir, "checkpoints")))
    except OSError:
        return False


def _trainer_cmd_builder(args, run_dir: str) -> Callable[[Optional[str]], List[str]]:
    """The child argv for the port's trainer, rebuilt from the parsed
    supervisor args (``--auto-resume`` and the supervisor knobs never reach
    the child; ``--device`` does)."""
    base = [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.train.trainer",
            "--config", args.config, "--runs-root", args.runs_root,
            "--device", getattr(args, "device", "cuda")]
    for kv in args.set:
        base += ["--set", kv]
    if args.iters is not None:
        base += ["--iters", str(args.iters)]
    if args.batch_size is not None:
        base += ["--batch-size", str(args.batch_size)]
    if args.learning_rate is not None:
        base += ["--learning-rate", str(args.learning_rate)]
    if args.run_name:
        base += ["--run-name", args.run_name]

    def build(resume_tag: Optional[str]) -> List[str]:
        cmd = list(base)
        if resume_tag is not None:
            # the tag the SUPERVISOR verified, not "latest": deterministic
            # even if files change between the scan and the launch
            cmd += ["--set", f"resume.checkpoint={resume_tag}", "--set", "overwrite=false"]
        elif _checkpoints_present(run_dir):
            # Nothing verified to resume from, but the checkpoints dir holds
            # something: never overwrite it. Launch in resume mode; the
            # trainer starts from step 0 in place if it finds nothing either.
            cmd += ["--set", "resume.checkpoint=latest", "--set", "overwrite=false"]
        else:
            cmd += ["--set", "overwrite=true"]
        return cmd

    return build


def supervise_from_args(args) -> Dict[str, Any]:
    """The trainer CLI's ``--auto-resume``."""
    from ..config import apply_overrides, read_config_dict
    from .trainer import collect_overrides

    merged = apply_overrides(read_config_dict(args.config), collect_overrides(args))
    run_dir = os.path.join(args.runs_root, merged["name"])
    # the config's watchdog knobs; the CLI flag wins when given
    sup_cfg = merged.get("supervisor") or {}
    hang_timeout = float(sup_cfg.get("hang_timeout_s") or 0.0)
    if getattr(args, "hang_timeout_s", None) is not None:
        hang_timeout = float(args.hang_timeout_s)
    sup = Supervisor(
        _trainer_cmd_builder(args, run_dir), run_dir,
        max_crashes_per_step=args.max_crashes, backoff_base=args.backoff_base,
        backoff_max=args.backoff_max, hang_timeout_s=hang_timeout,
        hang_kill_grace_s=float(sup_cfg.get("hang_kill_grace_s") or 20.0),
        process_count=int(getattr(args, "num_processes", None) or 1))
    scope = _start_scope_sidecar(args, merged, run_dir)
    try:
        rc = sup.run()
    finally:
        if scope is not None:
            scope.stop()
    sup.log(f"supervisor: done: exit code {rc}, restarts {sup.restarts}, "
            f"hangs {sup.hangs}")
    return {"supervised": True, "exit_code": rc, "restarts": sup.restarts,
            "hangs": sup.hangs, "run_dir": run_dir}


class _ScopeSidecar:
    """The ``--scope`` collector, started once the child trainer has set up
    its run directory, i.e. at the first heartbeat written after the
    supervisor started. The collector keeps its TSDB and its events in the
    run directory, and a fresh launch's overwrite deletes that directory:
    a collector started before it (as JAX's sidecar is) loses every later
    sample and event."""

    def __init__(self, make_collector: Callable[[], Any], run_dir: str,
                 poll_s: float = 0.2):
        self._make = make_collector
        self._hb = heartbeat_path(run_dir)
        self._since = time.time()
        self._poll_s = poll_s
        self._stop = threading.Event()
        self.collector = None
        self._thread = threading.Thread(target=self._wait_and_start, daemon=True,
                                        name="scope-sidecar")
        self._thread.start()

    def _wait_and_start(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                fresh = os.path.getmtime(self._hb) >= self._since - 1.0
            except OSError:
                fresh = False
            if fresh:
                try:
                    self.collector = self._make()
                    self.collector.start()
                except Exception as e:  # noqa: BLE001 - never blocks training
                    print("scope: sidecar disabled (%s: %s)" % (type(e).__name__, e))
                return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self.collector is not None:
            self.collector.stop()


def _start_scope_sidecar(args, merged: Dict[str, Any], run_dir: str):
    """The ``--scope`` collector beside the supervisor, scraping the child
    trainer's metrics port. Best effort, as in JAX: a broken alerts config
    or no metrics port logs and returns None; observability never stops a
    training launch."""
    if not getattr(args, "scope", False):
        return None
    try:
        from ..obs.alerts import load_rules
        from ..obs.scope import Collector, ScopeConfig

        scope_cfg = merged.get("scope") or {}
        port = int(((merged.get("logging") or {}).get("metrics_port")) or 0)
        if not port:
            print("scope: logging.metrics_port is 0 — no trainer surface "
                  "to scrape; sidecar disabled")
            return None
        n_proc = int(getattr(args, "num_processes", None) or 1)
        targets = [{"name": "trainer%d" % i,
                    "url": "http://127.0.0.1:%d" % (port + i),
                    "role": "trainer"} for i in range(n_proc)]
        alerts_path = getattr(args, "alerts_config", None) \
            or scope_cfg.get("alerts_path")
        if alerts_path is None and os.path.isfile(
                os.path.join("configs", "alerts.yaml")):
            alerts_path = os.path.join("configs", "alerts.yaml")
        if alerts_path:
            load_rules(alerts_path)  # a broken rules file refuses now, not later
        cfg = ScopeConfig(
            interval_s=float(scope_cfg.get("interval_s", 5.0)),
            targets=targets,
            run_dir=run_dir,
            alerts_path=alerts_path,
            port=scope_cfg.get("port"),
            scrape_timeout_s=float(scope_cfg.get("scrape_timeout_s", 2.0)))
        sidecar = _ScopeSidecar(lambda: Collector(cfg, log=print), run_dir)
        print("scope: collector starts with the trainer (%d target(s), rules "
              "from %s)" % (len(targets), alerts_path or "<none>"))
        return sidecar
    except Exception as e:  # noqa: BLE001 - the sidecar never blocks training
        print("scope: sidecar disabled (%s: %s)" % (type(e).__name__, e))
        return None


def main(argv=None) -> Dict[str, Any]:
    """``python -m ...train.supervisor --config C``: the trainer's flags,
    with ``--auto-resume`` implied."""
    from .trainer import build_parser

    return supervise_from_args(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
