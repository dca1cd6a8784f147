"""Buffered JSONL event sink — a copy of ``JsonlSink`` and
``read_events`` from ``fast_tffm_tpu/obs/sink.py``.

Events buffer in host memory and reach disk only at ``flush()``, which
the flush-step cadence and the epoch barriers call, never a step.
Scalars whose value is a device tensor (a step's loss on the card) are
buffered as they are and fetched together in one
``torch.stack(...).cpu()`` at ``barrier()`` (``utils/fetch.fetch_floats``),
with the same 1024-entry cap as ``train.LOG_BUFFER_MAX``. A plain
``flush()`` reads no device value, so a mid-epoch flush cadence
(``metrics_flush_steps``) costs file I/O only.

Thread-safety: ``emit``/``flush``/``close`` serialize on one lock (span
events arrive from the prefetch and fetcher threads, health events from
the watchdog); ``add_scalar``/``barrier`` are for the loop's own thread.

The barrier drain is also where a non-finite loss is noticed: the values
are host floats right after the one fetch, so a ``health:
nonfinite_loss`` event costs no device traffic of its own. The last
``RING_EVENTS`` events are kept in a ring that a ``crash`` event embeds.
``metrics`` events carry the run metadata every time, so any line is
attributable to its run.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

# Buffered device-scalar cap (train.LOG_BUFFER_MAX's bound): a tiny
# cadence on a long epoch must not retain unbounded device scalars.
SCALAR_BUFFER_MAX = 1024

# Host-event buffer cap: hitting it forces a plain flush (file I/O only).
EVENT_BUFFER_MAX = 4096

# In-memory ring of recent events embedded in a crash event.
RING_EVENTS = 32


class JsonlSink:
    """Append-mode JSONL writer; see the module docstring."""

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self.meta = dict(meta or {})
        self._lock = threading.Lock()
        self._events: List[str] = []
        self._scalars: List[Tuple[str, int, Any]] = []
        self.recent: "collections.deque" = collections.deque(
            maxlen=RING_EVENTS)
        self._fh = open(path, "a", encoding="utf-8")
        self._closed = False
        self._fh_closed = False
        self.emit("run_start", {"meta": self.meta})

    def emit(self, event: str, fields: Optional[Dict[str, Any]] = None
             ) -> None:
        """Queue one host-value event (device tensors go through
        add_scalar). Buffered until flush(); thread-safe."""
        rec = {"event": event, "t": time.time()}
        if fields:
            rec.update(fields)
        line = json.dumps(rec, default=_json_default)
        overflow = False
        with self._lock:
            if self._fh_closed:
                # A late span from a daemon thread after run_end.
                return
            self._events.append(line)
            self.recent.append(rec)
            overflow = len(self._events) >= EVENT_BUFFER_MAX
        if overflow:
            self.flush()

    def recent_snapshot(self) -> List[Dict[str, Any]]:
        """A stable copy of the recent-event ring (under the lock: worker
        threads append concurrently)."""
        with self._lock:
            return list(self.recent)

    def emit_metrics(self, step: int, snapshot: Dict[str, Any]) -> None:
        """One metrics event per flush, run metadata included."""
        self.emit("metrics", {"step": int(step), "run": self.meta,
                              **snapshot})

    def add_scalar(self, name: str, step: int, value: Any) -> None:
        """Queue one scalar whose value may be a device tensor; it is
        not read here: barrier() fetches the whole buffer at once."""
        self._scalars.append((name, int(step), value))
        if len(self._scalars) >= SCALAR_BUFFER_MAX:
            self._drain_scalars()

    def flush(self) -> None:
        """Write buffered events to disk. Reads no device value: queued
        scalars stay queued until the next barrier()."""
        with self._lock:
            if self._fh_closed:
                self._events.clear()
                return
            events, self._events = self._events, []
            if events:
                self._fh.write("\n".join(events) + "\n")
            self._fh.flush()

    def _drain_scalars(self) -> None:
        if not self._scalars:
            return
        from fast_tffm_tpu_torch.utils.fetch import fetch_floats
        values = fetch_floats([v for _, _, v in self._scalars])
        rows = [(name, step, val) for (name, step, _), val
                in zip(self._scalars, values)]
        self._scalars.clear()
        bad: Dict[str, List[int]] = {}
        for name, step, val in rows:
            self.emit("scalar", {"name": name, "step": step, "value": val})
            # Only loss scalars raise a health event: a NaN validation
            # AUC is legitimate (a shard without positives or negatives).
            if "loss" in name and not math.isfinite(val):
                bad.setdefault(name, []).append(step)
        for name, steps in bad.items():
            self.emit("health", {
                "status": "nonfinite_loss",
                "name": name,
                "step_first": min(steps), "step_last": max(steps),
                "count": len(steps),
            })

    def barrier(self) -> None:
        """Epoch/shutdown barrier: fetch queued device scalars into
        scalar events, then flush everything to disk."""
        self._drain_scalars()
        self.flush()

    def discard_scalars(self) -> int:
        """Drop queued device scalars without fetching them (a recovery
        path whose scalars may never complete); returns how many."""
        n = len(self._scalars)
        self._scalars.clear()
        return n

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # Drain scalars before run_end, so run_end is the last event.
            self._drain_scalars()
            self.emit("run_end", {})
            self.flush()
        finally:
            with self._lock:
                self._fh_closed = True
                self._fh.close()


def _json_default(o: Any):
    """Numpy scalars and arrays in host-value events: coerce rather
    than crash a flush."""
    f = getattr(o, "item", None)
    if callable(f):
        try:
            return f()
        except Exception:  # noqa: BLE001 - fall through to tolist/str
            pass
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """Parse a metrics JSONL file; a torn final line (a crashed run) is
    skipped."""
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue
