"""Run logging, FLOPs and goodput accounting, metrics, events, spans,
profiling, the Prometheus exposition and the stats hub (the JAX package's
``obs/``; ``tsdb``, ``alerts``, ``scope``, ``monitor`` and ``dashboard`` are
not ported: ROADMAP queue 1 item 9)."""
