"""Run health — a copy of ``Watchdog``, ``format_crash`` and the
health-event emitters of ``fast_tffm_tpu/obs/health.py``.

``Watchdog`` is a daemon thread (``fmt-watchdog``) fed by a heartbeat
the train, predict and serve loops touch (``RunTelemetry.heartbeat``, a
tuple assignment). When no beat lands within ``stall_seconds`` it emits
one ``health: stalled`` event per episode, flushes the sink and appends
every thread's stack to ``<metrics_file>.stacks``; a resumed beat emits
``recovered``. Host-only: it never reads a device value. The clock is
injectable and ``check()`` callable, so the logic is tested under a
fake clock.

``emit_ckpt_fallback`` is the checkpoint walk-back's event.
``emit_worker_lost`` (parallel/liveness.py: the monitor tick, a failed
collective, the deadline and the elastic abandon) and
``emit_elastic_recovery`` (train.py, at each shrink and grow) are the
multi-process arms' events; each flushes, so a survivor's evidence is on
disk before it reforms.
"""

from __future__ import annotations

import faulthandler
import threading
import time
from typing import Callable, Optional

# Floor on the poll interval: a tiny stall_seconds must not turn the
# watchdog into a busy loop.
MIN_POLL_SECONDS = 0.05


class Watchdog:
    """Daemon-thread stall detector over a run's telemetry sink.

    ``beat(step)`` is the hot-path surface (one tuple assignment);
    ``check()`` evaluates the stall state once (the thread calls it
    every ``stall_seconds / 4``); ``start()``/``stop()`` manage the
    thread. Pass ``clock`` to run the logic under a fake clock."""

    def __init__(self, sink, stall_seconds: float, stacks_path: str,
                 clock: Callable[[], float] = time.monotonic):
        self.sink = sink
        self.stall_seconds = float(stall_seconds)
        self.stacks_path = stacks_path
        self._clock = clock
        # Armed from construction: a run wedged in SETUP (checkpoint
        # restore against dead storage, a hung distributed bring-up)
        # stalls before its first step — exactly when forensics are
        # scarcest.
        self._beat = (self._clock(), -1)
        self._stalled_at: Optional[float] = None  # beat time the
        # current stall episode was declared against (None = healthy)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_events = 0

    # -- hot path --------------------------------------------------------
    def beat(self, step: Optional[int] = None) -> None:
        """Record progress. Tuple assignment: atomic under the GIL, so
        the hot loop never takes a lock for the watchdog."""
        if step is None:
            step = self._beat[1]
        self._beat = (self._clock(), step)

    # -- detection -------------------------------------------------------
    def check(self) -> Optional[str]:
        """One stall evaluation; returns the status it emitted ("stalled"
        / "recovered") or None. The thread calls this on a timer; tests
        call it directly under a fake clock."""
        beat_t, beat_step = self._beat
        now = self._clock()
        if self._stalled_at is None:
            if now - beat_t <= self.stall_seconds:
                return None
          
            self._stalled_at = beat_t
            self.stall_events += 1
            self.sink.emit("health", {
                "status": "stalled",
                "stalled_seconds": now - beat_t,
                "last_step": beat_step,
                "stacks_file": self.stacks_path,
            })
            self._dump_stacks(now - beat_t, beat_step)
            # Straight to disk: a stalled run won't reach a barrier.
            self.sink.flush()
            return "stalled"
        if beat_t > self._stalled_at:  # progress resumed
            outage = beat_t - self._stalled_at
            self._stalled_at = None
            self.sink.emit("health", {
                "status": "recovered",
                "outage_seconds": outage,
                "last_step": beat_step,
            })
            self.sink.flush()
            return "recovered"
        return None

    def _dump_stacks(self, stalled_seconds: float, step: int) -> None:
        """All-thread stacks into the .stacks sidecar, appended with a
        header per episode. Never raises into the watchdog loop — a
        broken dump must not kill stall DETECTION."""
        try:
            with open(self.stacks_path, "a", encoding="utf-8") as fh:
                fh.write(f"\n==== stall after {stalled_seconds:.1f}s "
                         f"(last step {step}) at {time.time():.3f} "
                         f"====\n")
                fh.flush()
                faulthandler.dump_traceback(file=fh, all_threads=True)
        except Exception:  # noqa: BLE001 - a broken dump must not
            pass           # stop stall detection

    # -- thread lifecycle ------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is None:
            interval = max(MIN_POLL_SECONDS, self.stall_seconds / 4.0)

            def loop():
                while not self._stop.wait(interval):
                    try:
                        self.check()
                    except Exception:  # noqa: BLE001 - the daemon
                        pass           # outlives a bad check()
            self._thread = threading.Thread(target=loop, name="fmt-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        # Reaching an orderly stop() IS progress — the run made it
        # to its close path — so beat once and evaluate a final time.
        # A stall still open from the last poll (fired during a long
        # final save, or recovered inside the final interval) closes
        # out as recovered instead of branding a finished run
        # 'NOT recovered'. A crashed run's verdict is owned by its
        # crash event (CRASHED outranks STALLED), and a hard-killed
        # run never reaches stop() — neither is masked by this.
        try:
            self.beat()
            self.check()
        except Exception:  # noqa: BLE001 - best effort on a
            pass           # stopping run; the sink may be closing


def emit_ckpt_fallback(step: int, reason: str, quarantined: str) -> None:
    """The state-plane fallback event (checkpoint.quarantine_step): a
    ``health: ckpt_fallback`` record + ``checkpoint/quarantined_steps``
    counter on the active run telemetry, flushed straight to disk — the
    very next thing the run does is retry an OLDER checkpoint, and if
    that also fails the evidence must already be on disk. No-op without
    an active run (offline tools like fmckpt verify without emitting)."""
    from fast_tffm_tpu_torch.obs.telemetry import active
    tel = active()
    if tel is None:
        return
    tel.count("checkpoint/quarantined_steps")
    tel.sink.emit("health", {
        "status": "ckpt_fallback",
        "step": int(step),
        "reason": str(reason)[:300],
        "quarantined": quarantined,
    })
    tel.sink.flush()


def emit_worker_lost(lost, label: str,
                     timeout_seconds: Optional[float] = None,
                     error: Optional[str] = None) -> None:
    """The compute-plane diagnosis event (parallel/liveness.py): a
    ``health: worker_lost`` record naming exactly which peers stopped
    heartbeating (process id, host, lease age), flushed straight to
    disk — the survivors' very next move is to tear the distributed
    client down (elastic) or exit, so the evidence must already be
    durable. Counts ``cluster/workers_lost`` once per named peer.
    No-op without an active run (fake-clock unit tests install their
    own telemetry)."""
    from fast_tffm_tpu_torch.obs.telemetry import active
    tel = active()
    if tel is None:
        return
    fields = {
        "status": "worker_lost",
        "label": str(label),
        "lost": [{"process_index": i.process_index, "host": i.host,
                  "pid": i.pid, "age_seconds": i.age_seconds}
                 for i in lost],
    }
    if timeout_seconds is not None:
        fields["timeout_seconds"] = float(timeout_seconds)
    if error is not None:
        fields["error"] = str(error)[:300]
    # The same dead peer is diagnosed from several angles (the lease
    # monitor's episode, the failed collective's conversion, the
    # deadline escalation) — the counter must say how many WORKERS
    # were lost, not how many paths noticed, so it counts each process
    # id once per run (the events themselves all land for forensics).
    seen = getattr(tel, "_workers_lost_counted", None)
    if seen is None:
        seen = tel._workers_lost_counted = set()
    fresh = {i.process_index for i in lost} - seen
    if not lost:
        fresh = {-1} - seen  # unnamed diagnosis: count once
    if fresh:
        seen.update(fresh)
        tel.count("cluster/workers_lost", len(fresh))
    tel.sink.emit("health", fields)
    tel.sink.flush()


def emit_elastic_recovery(generation: int, members, lost,
                          joined=(), capacity=None,
                          kind: str = "shrink") -> None:
    """The elastic recovery success event — both directions: survivors
    reformed into cluster generation ``generation`` with ``members``
    (original process indices) after losing ``lost`` (shrink), or
    after admitting ``joined`` replacement workers (grow).
    ``capacity`` is the original cluster size: fmstat renders
    ``RECOVERED (gen N, M workers)`` when the LAST recovery restores
    full membership, DEGRADED otherwise."""
    from fast_tffm_tpu_torch.obs.telemetry import active
    tel = active()
    if tel is None:
        return
    tel.count("cluster/elastic_recoveries")
    if joined:
        tel.count("cluster/workers_joined", len(joined))
    fields = {
        "status": "elastic_recovered",
        "kind": str(kind),
        "generation": int(generation),
        "members": [int(m) for m in members],
        "lost": [int(p) for p in lost],
        "joined": [int(p) for p in joined],
    }
    if capacity is not None:
        fields["capacity"] = int(capacity)
    tel.sink.emit("health", fields)
    tel.sink.flush()


def format_crash(exc: BaseException, limit_chars: int = 8000) -> str:
    """The traceback text a crash event carries, tail-truncated (the
    frames nearest the raise are the forensic payload)."""
    import traceback
    text = "".join(traceback.format_exception(
        type(exc), exc, exc.__traceback__))
    return text[-limit_chars:]
