"""Observability — the port of ``fast_tffm_tpu/obs/``: the metrics
registry, the JSONL sink and per-run telemetry (``telemetry``), spans
(``trace``), the watchdog and crash events (``health``), the memory
ledger and capacity planner (``memory``), SLO gauges and verdicts
(``slo``), the Prometheus text of ``GET /metrics`` (``prom``) and the
publish quality gate (``quality``). Off unless an entry point activates a
``RunTelemetry`` (``metrics_file``)."""
