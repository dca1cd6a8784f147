"""Declarative SLOs over the metrics stream — a copy of
``fast_tffm_tpu/obs/slo.py``.

A config's ``[SLO]`` section (``slo_publish_staleness_seconds``,
``slo_p99_ms``, ``slo_min_auc``, ``slo_max_bad_fraction``; 0 = unset)
is stamped into a run's stream as ``slo/*`` gauges when train makes its
telemetry and when a ScorerServer starts, so the verdicts need nothing
but the JSONL. ``evaluate_slos`` / ``render_slo`` are pure functions over
a summary dict (the JAX package's ``attribution.summarize`` shape):
PASS/FAIL per configured objective, SKIP where the stream holds no
evidence.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

# Gauge-name prefix the spec is stamped under (one gauge per set knob).
SLO_GAUGE_PREFIX = "slo/"

# The [SLO] knob fields, in render order.
_FIELDS = ("publish_staleness_seconds", "p99_ms", "min_auc",
           "max_bad_fraction")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One run's declared objectives; 0 = that objective is unset."""

    publish_staleness_seconds: float = 0.0
    p99_ms: float = 0.0
    min_auc: float = 0.0
    max_bad_fraction: float = 0.0

    @classmethod
    def from_config(cls, cfg) -> "SloSpec":
        return cls(
            publish_staleness_seconds=float(
                getattr(cfg, "slo_publish_staleness_seconds", 0.0)),
            p99_ms=float(getattr(cfg, "slo_p99_ms", 0.0)),
            min_auc=float(getattr(cfg, "slo_min_auc", 0.0)),
            max_bad_fraction=float(
                getattr(cfg, "slo_max_bad_fraction", 0.0)))

    @classmethod
    def from_summary(cls, summary: Dict[str, Any]) -> "SloSpec":
        """Recover the spec a run stamped into its stream (the slo/*
        gauges). Merged multi-file summaries keep the chief's flat
        gauges, so a train + serve file pair folds into one spec."""
        g = summary.get("gauges", {})
        return cls(**{f: float(g.get(SLO_GAUGE_PREFIX + f, 0.0) or 0.0)
                      for f in _FIELDS})

    @property
    def empty(self) -> bool:
        return all(getattr(self, f) <= 0 for f in _FIELDS)

    def emit_gauges(self, reg) -> None:
        """Stamp the configured objectives into a metrics registry (or
        RunTelemetry — anything with ``set``). Unset objectives emit
        nothing: absence IS the unset marker at read time."""
        for f in _FIELDS:
            v = getattr(self, f)
            if v > 0:
                reg.set(SLO_GAUGE_PREFIX + f, float(v))


@dataclasses.dataclass(frozen=True)
class SloResult:
    """One objective's verdict row."""

    objective: str          # human label
    bound: str              # e.g. "<= 5"
    measured: Optional[float]
    status: str             # "PASS" | "FAIL" | "SKIP"
    detail: str


def measured_publish_staleness(summary: Dict[str, Any]
                               ) -> Optional[float]:
    """Age of the last successful publish at the final metrics flush
    (the same gauge the STALE PUBLISH verdict reads)."""
    return summary.get("gauges", {}).get(
        "stream/last_publish_age_seconds")


def measured_p99_ms(summary: Dict[str, Any]) -> Optional[float]:
    """Serving request-latency p99 from the merged histogram."""
    h = summary.get("hists", {}).get("serve/request_latency_ms")
    return None if not h else h.get("p99")


def measured_auc(summary: Dict[str, Any]) -> Optional[float]:
    """Latest model-quality AUC: the publish-gate quality sweep's
    gauge, falling back to the plain validation gauge for runs without
    the per-publish loop."""
    g = summary.get("gauges", {})
    auc = g.get("quality/auc")
    return auc if auc is not None else g.get("validation/auc")


def measured_bad_fraction(summary: Dict[str, Any]) -> Optional[float]:
    """Bad lines over the input stream's good lines. The denominator
    prefers ``train/examples`` (lines actually trained) over the raw
    pipeline counter: ``pipeline/examples`` also counts every
    validation sweep's batches — and a gated stream sweeps validation
    at EVERY publish, which would dilute the fraction and mask a real
    ``slo_max_bad_fraction`` violation on the training stream. A
    stream with no traffic has no denominator — SKIP, not a free
    pass."""
    c = summary.get("counters", {})
    bad = c.get("pipeline/bad_lines", 0.0) or 0.0
    good = (c.get("train/examples", 0.0)
            or c.get("pipeline/examples", 0.0) or 0.0)
    if good + bad <= 0:
        return None
    return bad / (good + bad)


def evaluate_slos(spec: SloSpec,
                  summary: Dict[str, Any]) -> List[SloResult]:
    """One result row per CONFIGURED objective (unset objectives don't
    render — an empty spec yields an empty list). NaN measurements
    FAIL: an undefined quality number must never pass a quality
    bound."""
    rows: List[SloResult] = []

    def row(objective, threshold, measured, minimum=False, unit=""):
        if threshold <= 0:
            return
        op = ">=" if minimum else "<="
        bound = f"{op} {threshold:g}{unit}"
        if measured is None:
            rows.append(SloResult(objective, bound, None, "SKIP",
                                  "no supporting data in the stream"))
            return
        m = float(measured)
        if math.isnan(m):
            ok = False
        elif minimum:
            ok = m >= threshold
        else:
            ok = m <= threshold
        rows.append(SloResult(
            objective, bound, m, "PASS" if ok else "FAIL",
            f"measured {m:g}{unit}"))

    row("publish staleness", spec.publish_staleness_seconds,
        measured_publish_staleness(summary), unit="s")
    row("serve latency p99", spec.p99_ms, measured_p99_ms(summary),
        unit="ms")
    row("validation AUC", spec.min_auc, measured_auc(summary),
        minimum=True)
    row("bad-line fraction", spec.max_bad_fraction,
        measured_bad_fraction(summary))
    return rows


def overall(results: List[SloResult]) -> str:
    """"PASS" when every configured objective passed (SKIPs noted but
    not failing — the table shows them), "FAIL" on any failure,
    "EMPTY" when nothing was configured."""
    if not results:
        return "EMPTY"
    return "FAIL" if any(r.status == "FAIL" for r in results) else "PASS"


def render_slo(spec: SloSpec, results: List[SloResult]) -> str:
    """The `fmstat slo` table body."""
    lines = []
    if not results:
        return ("no SLO objectives configured: set [SLO] knobs "
                "(slo_publish_staleness_seconds / slo_p99_ms / "
                "slo_min_auc / slo_max_bad_fraction) on the run, or "
                "pass --config <file>")
    lines.append(f"{'SLO':<24} {'bound':<12} {'measured':<12} verdict")
    for r in results:
        measured = "-" if r.measured is None else f"{r.measured:g}"
        lines.append(f"{r.objective:<24} {r.bound:<12} {measured:<12} "
                     f"{r.status}")
    n_fail = sum(1 for r in results if r.status == "FAIL")
    n_skip = sum(1 for r in results if r.status == "SKIP")
    lines.append("")
    lines.append(f"overall: {overall(results)} ({len(results)} "
                 f"objective(s), {n_fail} failed, {n_skip} skipped)")
    return "\n".join(lines)


def results_json(spec: SloSpec,
                 results: List[SloResult]) -> Dict[str, Any]:
    """The `fmstat slo --json` payload."""
    return {
        "spec": dataclasses.asdict(spec),
        "objectives": [dataclasses.asdict(r) for r in results],
        "overall": overall(results),
    }
