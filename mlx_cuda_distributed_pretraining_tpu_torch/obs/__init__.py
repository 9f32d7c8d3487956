"""Run logging, FLOPs and goodput accounting, metrics, events, spans,
profiling, the Prometheus exposition, the stats hub and its dashboard, the
log monitor, and the scope collector with its TSDB and alert rules (the
JAX package's ``obs/``; every module is stdlib or ``torch`` only)."""

from .events import EventLog, append_event, iter_events, replay_into
from .flops import (
    GoodputLedger,
    flops_per_token,
    mfu,
    model_flops_per_token,
    peak_flops_per_chip,
)
from .logger import Logger
from .metrics import LATENCY_MS_BUCKETS, MetricsRegistry, quantile_from_buckets
from .monitor import LogTailer, find_latest_run, monitor
from .plotting import ema, parse_log, plot_run, write_csv
from .prometheus import render_prometheus, start_metrics_server
from .stats_client import StatsClient
from .stats_server import StatsServer, StatsState
from .trace import TRACE_HEADER, Span, Tracer, merge_chrome_traces, new_trace_id

__all__ = [
    "Logger",
    "parse_log",
    "ema",
    "plot_run",
    "write_csv",
    "LogTailer",
    "find_latest_run",
    "monitor",
    "StatsClient",
    "StatsServer",
    "StatsState",
    "MetricsRegistry",
    "LATENCY_MS_BUCKETS",
    "quantile_from_buckets",
    "GoodputLedger",
    "flops_per_token",
    "model_flops_per_token",
    "peak_flops_per_chip",
    "mfu",
    "EventLog",
    "append_event",
    "iter_events",
    "replay_into",
    "render_prometheus",
    "start_metrics_server",
    "TRACE_HEADER",
    "Span",
    "Tracer",
    "merge_chrome_traces",
    "new_trace_id",
]
