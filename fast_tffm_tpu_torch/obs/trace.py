"""Span timeline tracing over the telemetry JSONL stream — a copy of
``span`` and ``anatomy_on`` from ``fast_tffm_tpu/obs/trace.py``.

``span("train/step")`` brackets one stage of a run and emits a ``span``
event (wall-clock start, duration, thread name) into the active run's
sink. Off (no active run, or ``trace_spans`` unset) it costs one
module-global read and one attribute read and returns a shared
``contextlib.nullcontext``. On, it costs two clock reads and one
buffered emit. A span times host wall time between the calls it
brackets: it never synchronizes with the card, so a ``train/step`` span
measures the dispatch of a step, not its device time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional

from fast_tffm_tpu_torch.obs import telemetry as _telemetry

# Shared no-op context: nullcontext instances are stateless and
# reentrant, so every inactive span() returns this one object.
_NULL = contextlib.nullcontext()


def span(name: str, **fields):
    """Context manager timing one stage into the active run's stream.

    ``fields`` (step/epoch/path/...) land verbatim on the span event.
    Two field names are a cross-rank JOIN CONTRACT, not free-form
    annotations (obs/anatomy.py; README "Step anatomy"): ``step`` is
    the global step id and ``wid`` the lockstep window id — every rank
    stamps the same id onto the spans of the same barrier'd step/window
    (the collective protocol guarantees the sequences match), so
    ``fmtrace --anatomy`` can align per-rank clocks on the matched
    release edges and split a collective wait into straggler-wait vs
    transport. Producers gate the stamping on ``anatomy_on()``.

    Returns a shared no-op when no run is active or the run was not
    created with ``trace_spans`` — the default-off cost at every
    instrumented site is one module-global read."""
    tel = _telemetry.active()
    if tel is None or not getattr(tel, "trace_spans", False):
        return _NULL
    return _Span(tel.sink, name, fields or None)


def anatomy_on() -> bool:
    """Whether the active run wants step-anatomy join keys stamped
    (the ``anatomy`` config knob, default on). Same cost discipline as
    ``span()``: one module-global read + one attribute read, so hot
    producers may call it per window/step."""
    tel = _telemetry.active()
    return tel is not None and getattr(tel, "anatomy", False)


class _Span:
    """One live span: wall start at enter, duration at exit, emitted as
    a single buffered host-value event. ``perf_counter`` for the
    duration (monotonic), ``time.time`` for the start (the cross-
    process alignment fmtrace needs to line worker tracks up)."""

    __slots__ = ("_sink", "_name", "_fields", "_wall", "_t0")

    def __init__(self, sink, name: str,
                 fields: Optional[Dict[str, Any]]):
        self._sink = sink
        self._name = name
        self._fields = fields

    def __enter__(self) -> "_Span":
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        rec = {"name": self._name, "ts": self._wall, "dur": dur,
               "tid": threading.current_thread().name}
        if self._fields:
            rec.update(self._fields)
        if exc_type is not None:
            # A span cut by an exception is exactly the one forensics
            # wants flagged on the timeline.
            rec["error"] = exc_type.__name__
        self._sink.emit("span", rec)
        return False
