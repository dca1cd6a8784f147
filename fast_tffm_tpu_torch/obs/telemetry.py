"""Per-run telemetry wiring — a copy of ``RunTelemetry``, the
active-run lookup, ``config_hash``, ``run_meta``, the ``anatomy/*``
gauges and ``make_telemetry`` from ``fast_tffm_tpu/obs/telemetry.py``.

An entry point (train, predict, a ScorerServer) makes a ``RunTelemetry`` from
the config (``make_telemetry``) and runs under ``activate(tel)``;
instrumented library code (the pipeline, the C++ parser's wrapper, the
checkpoint writer, the fetcher) calls ``active()`` and does nothing when
no run is active, so the off cost at every site is one module-global
read and no signature grows a telemetry parameter.

Across processes every worker writes its own shard: the chief
``metrics_file`` itself, worker p > 0 ``<metrics_file>.p<p>``, keyed by
the worker's original index, so one worker writes one file across every
elastic re-rank (and a ``--join`` process appends to the shard of the
slot it takes); the readers merge the shards (``tools/fmstat.py``).
A fleet's supervisor writes ``metrics_file`` and replica i
``<metrics_file>.r<i>`` (serve/fleet.py). On the card
``run_meta``'s ``backend`` is ``"gpu"`` (the JAX package's name for an
NVIDIA backend), ``"cpu"`` otherwise.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Any, Dict, Optional, Tuple

from fast_tffm_tpu_torch.obs.registry import MetricsRegistry
from fast_tffm_tpu_torch.obs.sink import JsonlSink

_ACTIVE: Optional["RunTelemetry"] = None


def active() -> Optional["RunTelemetry"]:
    """The run telemetry instrumented library code should feed, or None
    (the common, zero-cost case)."""
    return _ACTIVE


def push_active(tel: Optional["RunTelemetry"]):
    """Install ``tel`` as the process-wide active telemetry; returns
    the previous value for ``pop_active``. The non-contextmanager form
    exists for entry points whose try/finally spans hundreds of lines —
    re-indenting the whole train loop under a ``with`` would be worse
    than a push in setup and a pop in the existing finally."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tel
    return prev


def pop_active(prev: Optional["RunTelemetry"]) -> None:
    global _ACTIVE
    _ACTIVE = prev


@contextlib.contextmanager
def activate(tel: Optional["RunTelemetry"]):
    """Make ``tel`` the process-wide active telemetry for the body.
    None passes through (callers don't need their own conditional)."""
    if tel is None:
        yield None
        return
    prev = push_active(tel)
    try:
        yield tel
    finally:
        pop_active(prev)


def config_hash(cfg) -> str:
    """Stable short hash of the full config — two JSONL files with the
    same hash measured the same run shape."""
    import dataclasses
    d = dataclasses.asdict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:12]


def _git_rev() -> Optional[str]:
    import os
    import subprocess
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None  # telemetry must never block a run on git


def _backend(device) -> Tuple[str, int]:
    """(backend name, device count) for ``device`` (None: the card when
    there is one)."""
    import torch
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    if on_card:
        return "gpu", torch.cuda.device_count()
    return "cpu", 1


def run_meta(cfg, kind: str, process_index: Optional[int] = None,
             process_count: Optional[int] = None,
             device=None) -> Dict[str, Any]:
    """Run metadata stamped into every metrics event: config hash,
    backend, device and process topology, git rev. Without
    ``process_index`` / ``process_count`` this is the single process's
    view (0 of 1)."""
    import os
    backend, count = _backend(device)
    return {
        "kind": kind,
        "config_hash": config_hash(cfg) if cfg is not None else None,
        "backend": backend,
        "device_count": count,
        "process_index": 0 if process_index is None else int(process_index),
        "process_count": 1 if process_count is None else int(process_count),
        "git_rev": _git_rev(),
        "pid": os.getpid(),
        "start_time": time.time(),
    }


class RunTelemetry:
    """One run's registry + sink + flush cadence.

    ``maybe_flush(step)`` writes a metrics event every ``flush_steps``
    steps — host values only, zero device fetches. ``barrier_flush``
    (epoch boundaries, close) additionally bulk-fetches buffered device
    scalars, the only point device arrays are materialized.
    """

    def __init__(self, path: str, meta: Dict[str, Any],
                 flush_steps: int = 0, trace_spans: bool = False,
                 protocol_trace: bool = False,
                 watchdog_stall_seconds: float = 0.0,
                 anatomy: bool = True,
                 mem_pressure_fraction: float = 0.0):
        self.registry = MetricsRegistry()
        self.sink = JsonlSink(path, meta=meta)
        self.flush_steps = max(0, int(flush_steps))
        self._last_flush = time.perf_counter()
        self._closed = False
        # Span tracing (obs/trace.py): span() reads this flag through
        # active(), so the off cost at every site stays one global read.
        self.trace_spans = bool(trace_spans)
        # Collective-protocol tracing (parallel/liveness.py):
        # guarded_collective reads this through active() the same way.
        self.protocol_trace = bool(protocol_trace)
        # Step anatomy (obs/anatomy.py; README "Step anatomy"): gates
        # the window/step join-key stamping at the producers (train,
        # sharded) and the pre-aggregated anatomy/* phase gauges every
        # flush derives from host counters below — near-zero cost, and
        # NEVER a device fetch (pinned by tests/test_anatomy.py).
        self.anatomy = bool(anatomy)
        # HBM pressure threshold (obs/memory.py; README "Memory
        # observability"): fraction of device capacity at which a
        # flush emits health: hbm_pressure (once per episode). 0
        # disables; also inert when the backend reports no capacity.
        self.mem_pressure_fraction = float(mem_pressure_fraction or 0.0)
        # Compute-plane liveness (parallel/liveness.py): the train/
        # predict entry points attach their HeartbeatLease here so every
        # metrics flush carries per-worker liveness gauges (the fmstat
        # worker table) without the registry growing a liveness import.
        self.lease = None
        # Run-health watchdog (obs/health.py): a daemon thread fed by
        # heartbeat(); owns the stall/stack-dump forensics.
        self.watchdog = None
        if watchdog_stall_seconds and watchdog_stall_seconds > 0:
            from fast_tffm_tpu_torch.obs.health import Watchdog
            self.watchdog = Watchdog(
                self.sink, watchdog_stall_seconds,
                stacks_path=path + ".stacks").start()

    # -- registry passthroughs (the instrumented-site surface) ----------
    def count(self, name: str, n: float = 1.0) -> None:
        self.registry.count(name, n)

    def set(self, name: str, v: float) -> None:
        self.registry.set(name, v)

    def observe(self, name: str, v: float, bounds=None) -> None:
        self.registry.observe(name, v, bounds)

    def add_scalar(self, name: str, step: int, value) -> None:
        """Buffer one (possibly device-array) scalar for the next
        barrier; never fetches here."""
        self.sink.add_scalar(name, step, value)

    def heartbeat(self, step: Optional[int] = None) -> None:
        """Touch the watchdog's progress beat — the train/predict loops
        call this once per step. No watchdog configured: one attribute
        read and out."""
        w = self.watchdog
        if w is not None:
            w.beat(step)

    def record_crash(self, exc: BaseException, step: int = -1) -> None:
        """Write the stream's final forensic event before the sink
        closes: exception type/message, traceback tail, and the ring of
        recent in-memory events (obs/sink.RING_EVENTS) — the "what was
        it doing just before" answer for a crashed run."""
        from fast_tffm_tpu_torch.obs.health import format_crash
        recent = self.sink.recent_snapshot()
        self.sink.emit("crash", {
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": format_crash(exc),
            "step": int(step),
            "recent_events": recent,
        })
        self.sink.flush()

    # -- flush cadence --------------------------------------------------
    def flush_due(self, step: int) -> bool:
        return bool(self.flush_steps) and step % self.flush_steps == 0

    def maybe_flush(self, step: int) -> None:
        if self.flush_due(step):
            self._emit_metrics(step)
            self.sink.flush()

    def barrier_flush(self, step: int) -> None:
        from fast_tffm_tpu_torch.obs.trace import span
        self.heartbeat(step)  # a barrier IS progress — don't let a long
        # epoch-end fetch read as a stall
        with span("obs/barrier_flush", step=step):
            self._emit_metrics(step)
            self.sink.barrier()

    def _emit_metrics(self, step: int) -> None:
        now = time.perf_counter()
        self.registry.set("flush/window_seconds", now - self._last_flush)
        self._last_flush = now
        snap = self.registry.snapshot()
        lease = self.lease
        if lease is not None:
            # Per-worker liveness row (fmstat worker table): this
            # worker's own heartbeat age plus its share of the lockstep
            # work, as GAUGES — counters fold across processes at merge
            # time, gauges stay per-process (gauges_by_process).
            c = snap["counters"]
            age = lease.age()
            rows = {
                "worker/heartbeat_age_seconds":
                    round(age, 3) if age is not None else -1.0,
                "worker/windows": c.get("lockstep/windows", 0.0),
                "worker/examples": c.get("train/examples",
                                         c.get("predict/examples", 0.0)),
            }
            for k, v in rows.items():
                self.registry.set(k, v)
            snap["gauges"].update(rows)
        if self.anatomy:
            rows = anatomy_gauges(snap)
            for k, v in rows.items():
                self.registry.set(k, v)
            snap["gauges"].update(rows)
        # Device-memory ledger (obs/memory.py): per-owner bytes, live
        # total, peak watermark, capacity + utilization — pure host
        # arithmetic over registered owners, NEVER a device fetch
        # (pinned by tests/test_memory.py, same contract as anatomy).
        from fast_tffm_tpu_torch.obs import memory as _mem
        rows = _mem.ledger_gauges()
        if rows:
            for k, v in rows.items():
                self.registry.set(k, v)
            snap["gauges"].update(rows)
            _mem.maybe_emit_pressure(self)
        self.sink.emit_metrics(step, snap)

    def close(self, step: int = -1) -> None:
        if self._closed:
            return
        self._closed = True
        if self.watchdog is not None:
            # Stop BEFORE the final emit/close: a watchdog firing into
            # a closing sink would race the file handle.
            self.watchdog.stop()
        if step >= 0:
            self._emit_metrics(step)
        else:
            self.sink.emit_metrics(-1, self.registry.snapshot())
        self.sink.close()

    # -- shared instrumentation helpers ---------------------------------
    def pipeline_batch(self, batch, pad_id: int,
                       build_seconds: Optional[float] = None) -> None:
        """Per-DeviceBatch pipeline counters: examples/lines, padding
        waste, dedup hit rate inputs, build time. Runs on the pipeline
        (prefetch worker) thread; everything here is host numpy."""
        import numpy as np
        B, L = batch.local_idx.shape
        self.count("pipeline/batches")
        self.count("pipeline/examples", batch.num_real)
        self.count("pipeline/example_capacity", B)
        if batch.uniq_ids is None:
            # raw-ids mode (dedup=device): pad cells hold pad_id
            # directly; the unique set is computed on device, so no
            # dedup-rate numerator exists host-side.
            real = int((batch.local_idx != pad_id).sum())
        else:
            real_uniq = int((batch.uniq_ids != pad_id).sum())
            real = int(
                (np.asarray(batch.uniq_ids)[batch.local_idx]
                 != pad_id).sum())
            self.count("pipeline/uniq_rows", real_uniq)
        self.count("pipeline/feature_slots", B * L)
        self.count("pipeline/feature_nnz", real)
        if build_seconds is not None:
            self.count("pipeline/build_seconds", build_seconds)
            self.observe("pipeline/batch_build_seconds", build_seconds)

    def train_step(self, dt: float, n_examples: int,
                   h2d_bytes: int,
                   h2d_bytes_logical: Optional[int] = None) -> None:
        """Per-train-step host-side points: wall time between step
        dispatches (NOT a device sync — the honest measurable without a
        fetch), examples, H2D payload bytes.

        ``h2d_bytes`` sizes the arrays ACTUALLY dispatched (the wire
        encoder's output — under wire_format = packed that is the flat
        CSR payload, not the padded rectangles); ``h2d_bytes_logical``
        sizes the padded layout the legacy wire would have shipped, so
        the packed-vs-padded savings ratio is observable per run
        (fmstat's bytes-per-example row). Omitted = same as actual
        (the padded wire)."""
        self.observe("train/step_seconds", dt)
        self.count("train/steps")
        self.count("train/examples", n_examples)
        self.count("train/h2d_bytes", h2d_bytes)
        self.count("train/h2d_bytes_logical",
                   h2d_bytes if h2d_bytes_logical is None
                   else h2d_bytes_logical)


# The step-anatomy phase map (README "Step anatomy"): cumulative
# host-side seconds counters -> per-process anatomy/* gauges. Counters
# fold across processes at merge time; the SAME numbers re-emitted as
# gauges stay per-process (gauges_by_process), which is what the fmstat
# EFFICIENCY section and bench --multihost need to rank stragglers.
# Everything here is a float already sitting in the snapshot dict —
# deriving the gauges can never add a device fetch.
ANATOMY_PHASES = {
    "anatomy/input_wait_seconds": "train/input_wait_seconds",
    "anatomy/host_build_seconds": "pipeline/build_seconds",
    "anatomy/h2d_seconds": "train/h2d_seconds",
    "anatomy/flags_wait_seconds": "train/step_flags_seconds",
    "anatomy/dispatch_seconds": "train/dispatch_seconds",
    "anatomy/window_fill_seconds": "lockstep/window_fill_seconds",
    "anatomy/allgather_seconds": "lockstep/allgather_seconds",
    "anatomy/fetch_seconds": "lockstep/fetch_seconds",
}


def anatomy_gauges(snap: Dict[str, Any]) -> Dict[str, float]:
    """This process's anatomy/* gauge rows for one registry snapshot:
    the phase-seconds counters above, plus the step wall and example
    totals the EFFICIENCY math divides by. Phases that never ticked are
    omitted (a predict run has no train/ rows and vice versa)."""
    c = snap.get("counters") or {}
    rows = {g: float(c[src]) for g, src in ANATOMY_PHASES.items()
            if c.get(src)}
    h = (snap.get("hists") or {}).get("train/step_seconds")
    if h and h.get("count"):
        rows["anatomy/step_wall_seconds"] = float(h["sum"])
        rows["anatomy/steps"] = float(h["count"])
    ex = c.get("train/examples", c.get("predict/examples", 0.0))
    if ex:
        rows["anatomy/examples"] = float(ex)
    return rows


def resolve_metrics_path(cfg,
                         process_index: Optional[int] = None
                         ) -> Optional[str]:
    """The JSONL path this process should write, or None when metrics
    are off. ``metrics_file = auto`` follows the sibling-artifact
    convention (<model_file>.tb/, <model_file>.ckpt/):
    <model_file>.metrics.jsonl. Non-chief processes get a .p<i> shard
    suffix so P workers never interleave writes in one file.
    ``process_index`` (default 0, the single process) is the worker's
    original index, which stays the same across elastic re-ranks, so
    one worker writes one shard for the whole run."""
    path = getattr(cfg, "metrics_file", "") or ""
    if not path:
        return None
    if path == "auto":
        path = cfg.model_file + ".metrics.jsonl"
    p = int(process_index or 0)
    return path if p == 0 else f"{path}.p{p}"


def make_telemetry(cfg, kind: str,
                   process_index: Optional[int] = None,
                   process_count: Optional[int] = None,
                   device=None) -> Optional[RunTelemetry]:
    """The entry points' constructor: a RunTelemetry per the config's metrics
    knobs, or None (the default — metrics_file unset)."""
    path = resolve_metrics_path(cfg, process_index=process_index)
    if path is None:
        return None
    # getattr defaults: tests (and bench) build pared-down cfg objects
    # that predate the tracing/watchdog knobs.
    return RunTelemetry(
        path, meta=run_meta(cfg, kind, process_index=process_index,
                            process_count=process_count, device=device),
        flush_steps=cfg.metrics_flush_steps,
        trace_spans=getattr(cfg, "trace_spans", False),
        protocol_trace=getattr(cfg, "protocol_trace", False),
        watchdog_stall_seconds=getattr(cfg, "watchdog_stall_seconds",
                                       0.0),
        anatomy=getattr(cfg, "anatomy", True),
        mem_pressure_fraction=getattr(cfg, "mem_pressure_fraction",
                                      0.0))


def batch_payload_bytes(args: Dict[str, Any]) -> int:
    """Host-side H2D payload size for one batch's arg dict — the
    arrays ACTUALLY about to be dispatched, so callers must pass the
    wire encoder's output, not the padded batch layout (under
    wire_format = packed the two differ by the padding-waste factor,
    and sizing the padded dict here is exactly how train/h2d_bytes and
    fmstat's transfer-bound attribution would silently lie). No device
    interaction."""
    n = 0
    for v in args.values():
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            n += nb  # a plain int attribute on numpy arrays — no fetch
    return int(n)
