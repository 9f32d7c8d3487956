"""Prometheus text exposition for the metrics registry — stdlib only (the
JAX package's ``obs/prometheus.py``: the same snapshot renders to the same
bytes).

``start_metrics_server(registry, port)`` serves text-format 0.0.4 on
``GET /metrics`` from a daemon thread (http.server.ThreadingHTTPServer;
the container has no prometheus_client and must not grow one). The
handler renders from ``registry.snapshot()`` so no request ever holds
the registry lock across IO. ``GET /healthz`` answers 200 for probes.

Counters are exposed with the conventional ``_total`` suffix only if the
registry name already carries it — names are passed through verbatim, so
what the trainer registers is what dashboards scrape.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: Dict[str, Any],
                      process_index: Optional[int] = None) -> str:
    """Registry snapshot (obs/metrics.py::MetricsRegistry.snapshot) →
    Prometheus text exposition format 0.0.4.

    ``process_index`` stamps a ``process_index`` gauge into the output so
    multi-host scrapes (one exporter per process on
    ``metrics_port + process_index``) disambiguate which host answered
    even when the scraper only recorded the target address."""
    lines = []
    for name in sorted(snapshot):
        if name.startswith("_"):
            continue
        m = snapshot[name]
        kind = m["kind"]
        lines.append(f"# HELP {name} {m.get('help') or name}")
        lines.append(f"# TYPE {name} {kind}")
        for s in m["series"]:
            labels = s.get("labels") or {}
            if kind == "histogram":
                for le, cum in s["buckets"]:
                    le_s = "+Inf" if le == "+Inf" else _fmt_value(le)
                    bl = dict(labels)
                    bl["le"] = le_s
                    lines.append(f"{name}_bucket{_fmt_labels(bl)} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(s['value'])}")
    dropped = snapshot.get("_dropped_series", 0)
    lines.append("# HELP telemetry_dropped_series_total label combinations "
                 "refused by the per-metric series bound")
    lines.append("# TYPE telemetry_dropped_series_total counter")
    lines.append(f"telemetry_dropped_series_total {dropped}")
    if process_index is not None:
        # the JAX package's wording, so both expositions stay byte-identical
        lines.append("# HELP process_index jax process index serving "
                     "this exposition")
        lines.append("# TYPE process_index gauge")
        lines.append(f"process_index {int(process_index)}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Background HTTP server bound to one registry. ``port`` is the bound
    port (useful when constructed with port 0 in tests).

    ``extra_routes`` adds read-only GET paths to the same listener without a
    second port: each value is a zero-arg callable returning
    ``(body_bytes, content_type)``."""

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0,
                 process_index: Optional[int] = None,
                 extra_routes: Optional[Dict[str, Any]] = None):
        self.registry = registry
        self.process_index = process_index
        self.extra_routes = dict(extra_routes or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                route = self.path.split("?")[0]
                if route == "/metrics":
                    body = render_prometheus(
                        outer.registry.snapshot(),
                        process_index=outer.process_index).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif route in ("/healthz", "/health"):
                    body = b"ok\n"
                    ctype = "text/plain; charset=utf-8"
                elif route == "/snapshot":
                    body = (json.dumps(outer.registry.snapshot()) + "\n").encode()
                    ctype = "application/json"
                elif route in outer.extra_routes:
                    try:
                        body, ctype = outer.extra_routes[route]()
                    except Exception:
                        self.send_error(500)
                        return
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


def start_metrics_server(registry, port: int, host: str = "0.0.0.0",
                         process_index: Optional[int] = None,
                         ) -> Optional[MetricsServer]:
    """Start the exporter, or return None (with no exception escaping) when
    the port is taken — telemetry must never kill training.

    A run of several processes starts one exporter per process (port
    offset by the process index) and passes that index so the exposition
    self-identifies."""
    try:
        return MetricsServer(registry, host=host, port=int(port),
                             process_index=process_index)
    except OSError:
        return None
