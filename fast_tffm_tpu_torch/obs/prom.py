"""Prometheus text exposition of a registry snapshot — a copy of
``fast_tffm_tpu/obs/prom.py``: the body of a ScorerServer's
``GET /metrics``.

``serve/request_latency_ms`` renders as ``fm_serve_request_latency_ms``
(other characters fold to ``_``, everything is prefixed ``fm_``);
histograms render cumulative ``_bucket{le=...}`` series from the
registry's fixed bounds, ``+Inf``, ``_sum`` and ``_count``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

# Content-Type the HTTP front end serves this under.
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(name: str, prefix: str = "fm_") -> str:
    """A registry metric name as a legal Prometheus metric name."""
    return prefix + _NAME_BAD.sub("_", name)


def _num(v: float) -> str:
    """Exposition-format number: integers bare, floats via repr
    (shortest round-trip), non-finite as Prometheus spells them."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v.is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(v)


def prometheus_text(snapshot: Dict[str, Any],
                    prefix: str = "fm_") -> str:
    """One scrape body from a ``MetricsRegistry.snapshot()`` dict.
    Deterministic (sorted names) so the format can be pinned by
    tests."""
    lines = []
    for name, v in sorted((snapshot.get("counters") or {}).items()):
        m = metric_name(name, prefix)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_num(v)}")
    for name, v in sorted((snapshot.get("gauges") or {}).items()):
        m = metric_name(name, prefix)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_num(v)}")
    for name, s in sorted((snapshot.get("hists") or {}).items()):
        m = metric_name(name, prefix)
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for bound, count in zip(s["bounds"], s["counts"]):
            cum += int(count)
            lines.append(f'{m}_bucket{{le="{_num(bound)}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {int(s["count"])}')
        lines.append(f"{m}_sum {_num(s['sum'])}")
        lines.append(f"{m}_count {int(s['count'])}")
    return "\n".join(lines) + "\n"
