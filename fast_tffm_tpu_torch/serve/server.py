"""The long-lived scorer core — the port's counterpart of
``fast_tffm_tpu/serve/server.py``.

Request path: callers submit libsvm lines (the predict file format;
labels accepted and ignored). ``submit`` parses on the caller's thread
and enqueues one pending request; the single dispatcher thread
micro-batches concurrent requests — the first request in an admission
window waits at most ``serve_max_wait_ms`` for company, a window flushes
early at ``serve_max_batch`` examples — then pads the flush to the
nearest rung of the batch ladder (powers of two up to
``serve_max_batch``) and the width ladder (``bucket_ladder``), and
scores it through ``scoring.CompiledScorer``: one kernel launch per
flush on the card. Scores are byte-identical to batch predict of the
same lines: the kernel's sum order does not depend on the padding.

Startup loads the checkpoint step the ``published`` pointer names (or
``published-canary``, per ``serve_pointer``; ``fmckpt publish`` moves
them) and scores one batch at every [B rung x L rung] shape
(``_warmup``; with ``wire_format = packed`` also every flat rung of
each shape, ``wire.flat_rungs``), so the kernel library is built and
loaded, and the allocator warm, before the server reports ready. With
``warmup="background"`` (the ``serve`` entry point, and so every fleet
replica) the constructor returns once the step is loaded and the ladder
warms on a thread of its own: the front end binds at once and
``/healthz`` answers alive but not ready until the ladder is warm, so
the fleet's proxy routes around a warming replica and its supervisor
does not restart it. A warmup failure leaves the server alive and never
ready, and counts ``serve/warmup_errors``. A flush ships
through the scorer's wire encoder with the serve ladder
(``rect_fraction``): padded and packed-wide answers are equal to the
bit. FFM requests carry their fields.

Hot reload (serve/reload.py drives it): ``reload_step`` restores the
named step through the verified-restore path (an explicit step is
verified, never walked past), copies it to the device completely, then
swaps the (table, step) pair under one lock. Each flush captures the
pair once, so requests in flight across a swap drain on the old step
and say so: every response carries the step that scored it. The old
table is freed when its last flush drains. A failed reload counts
``serve/reload_failures`` and the old table keeps serving. Under
``serve_reload_mode = external`` the watcher only observes the pointer
and reloads come through ``external_reload`` (``POST /reload``), the
reload token the fleet supervisor hands each replica in turn.

``vocab_mode = admit``: requests parse under ``VocabMap.build_cfg``
(ids in the 2^30 hashed space), and each flush remaps through the slot
map it captured with its table. A load reads the step's vocab sidecar
(``checkpoint.load_vocab_map``) before the table and swaps the (table,
slot map, step) triple under the one lock; a missing or torn sidecar
fails the reload whole and the previous triple keeps serving. The
``serve/vocab_live_rows`` gauge holds the served map's live rows. Under
``vocab_mode = fixed`` a step carrying a sidecar is refused
(``refuse_fixed_mode_admit_step``).

``lookup = host`` is refused with the JAX package's ``ValueError``, as
its serving process refuses it: offload-scale tables are scored by
batch predict.

Telemetry (``metrics_file``, ``FM_METRICS_FILE`` for ``serve``): the
server keeps its own handle, never the process-global one, so a batch
predict in the same process writes its own stream. The registry behind
``/healthz`` is the stream's (a bare one when metrics are off), and
``metrics_text`` renders it for ``GET /metrics`` (obs/prom.py). The SLO
spec is stamped as ``slo/*`` gauges; the ``serve/flush``,
``serve/reload`` and ``serve/warmup`` spans, the ``serve/ready``,
``served_step``, ``published_step`` and ``reload_peak_bytes`` gauges,
the memory ledger's ``serve_table`` (and ``serve_reload_table`` while a
reload holds both) and the capacity pre-flight are the JAX package's. A
fleet replica's server writes the shard its supervisor names in
``FM_METRICS_FILE`` (``<metrics_file>.r<i>``, serve/fleet.py).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fast_tffm_tpu_torch.checkpoint import (load_vocab_map, read_pointer,
                                            refuse_fixed_mode_admit_step)
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import ParsedBlock, parse_lines
from fast_tffm_tpu_torch.data.pipeline import (_ladder_fit, make_device_batch,
                                               require_bounded_examples)
from fast_tffm_tpu_torch.models.fm import resolved_kernel
from fast_tffm_tpu_torch.obs import memory as obs_memory
from fast_tffm_tpu_torch.obs.memory import LEDGER, oom_guard
from fast_tffm_tpu_torch.obs.prom import prometheus_text
from fast_tffm_tpu_torch.obs.registry import MetricsRegistry
from fast_tffm_tpu_torch.obs.slo import SloSpec
from fast_tffm_tpu_torch.obs.telemetry import make_telemetry
from fast_tffm_tpu_torch.obs.trace import span
from fast_tffm_tpu_torch.ops import fm_kernel
from fast_tffm_tpu_torch.scoring import CompiledScorer
from fast_tffm_tpu_torch.serve.reload import ReloadWatcher
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.utils.ignored import log_ignored_keys
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.vocab.table import VocabMap
from fast_tffm_tpu_torch.wire import flat_rungs

# Request-latency histogram bounds, in milliseconds (/healthz p50/p99).
LATENCY_BUCKETS_MS = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
# Admission-queue depth histogram bounds.
DEPTH_BUCKETS = tuple(2 ** i for i in range(11))

_STOP = object()


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    """One request's response: transformed scores (sigmoid for logistic
    loss, raw for mse — what predict writes to .score files) plus the
    checkpoint step that scored them (these scores equal batch predict
    against that step byte for byte)."""
    scores: np.ndarray
    step: int


class _Pending:
    """One submitted request waiting for its flush."""

    __slots__ = ("block", "n", "t0", "_lock", "_event", "_scores",
                 "_step", "_error")

    def __init__(self, block: ParsedBlock):
        self.block = block
        self.n = block.batch_size
        self.t0 = time.perf_counter()
        # First completion wins: the dispatcher's _complete and a
        # failure path can race, and a delivered result must never be
        # clobbered into an error.
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._scores: Optional[np.ndarray] = None
        self._step = -1
        self._error: Optional[BaseException] = None

    def _complete(self, scores: np.ndarray, step: int) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._scores = scores
            self._step = step
            self._event.set()

    def _fail(self, error: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._error = error
            self._event.set()

    def result(self, timeout: Optional[float] = None) -> ScoreResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"score request ({self.n} examples) not completed "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return ScoreResult(scores=self._scores, step=self._step)


def batch_rung_ladder(serve_max_batch: int) -> Tuple[int, ...]:
    """Padded batch-width rungs: powers of two from 1 up to the first
    one that covers ``serve_max_batch``."""
    rungs: List[int] = [1]
    while rungs[-1] < serve_max_batch:
        rungs.append(rungs[-1] * 2)
    return tuple(rungs)


def _concat_blocks(blocks: Sequence[ParsedBlock]) -> ParsedBlock:
    """One CSR block over every request in a flush, in submit order."""
    if len(blocks) == 1:
        return blocks[0]
    poses = [np.zeros(1, dtype=np.int32)]
    base = 0
    for b in blocks:
        poses.append(b.poses[1:] + base)
        base += int(b.poses[-1])
    fields = None
    if blocks[0].fields is not None:
        fields = np.concatenate([b.fields for b in blocks])
    return ParsedBlock(
        labels=np.concatenate([b.labels for b in blocks]),
        poses=np.concatenate(poses).astype(np.int32),
        ids=np.concatenate([b.ids for b in blocks]),
        vals=np.concatenate([b.vals for b in blocks]),
        fields=fields)


class ScorerServer:
    """The long-lived scorer. Lifecycle:

        server = ScorerServer(cfg)        # loads the published step,
                                          # scores the shape ladder,
                                          # starts dispatch + reload
        res = server.score_lines(lines)   # or submit() for async
        server.close()                    # drains and stops

    ``device`` defaults to the card. ``watch=False`` skips the reload
    thread (tests drive ``reload_step`` directly). ``warmup`` is
    ``"sync"`` (the constructor returns warm) or ``"background"`` (it
    returns once the step is loaded; ``ready`` stays false until the
    ladder is warm)."""

    def __init__(self, cfg: FmConfig, logger=None, device=None,
                 watch: bool = True, warmup: str = "sync"):
        if warmup not in ("sync", "background"):
            raise ValueError(f"warmup must be sync or background, got "
                             f"{warmup!r}")
        if cfg.lookup != "device":
            raise ValueError(
                "serving requires lookup = device: the raw-gather "
                "scorer's pre-compiled shape ladder has no host-gather "
                "protocol (offload-scale tables belong behind the "
                "batch predict path)")
        # Every parsed example must fit the width ladder.
        require_bounded_examples(cfg, "online serving")
        self.cfg = cfg
        self.device = resolve_device(device)
        obs_memory.bind_device(self.device)
        # The plan includes the reload's old+new transient: a table that
        # fits alone but cannot hot-reload is refused at startup.
        obs_memory.preflight_capacity(cfg, "serve")
        self._logger = logger or get_logger(log_file=cfg.log_file or None)
        log_ignored_keys(cfg, self._logger)
        self._tel = make_telemetry(cfg, "serve", device=self.device)
        self._reg = (self._tel.registry if self._tel is not None
                     else MetricsRegistry())
        try:
            self._start(cfg, watch, warmup)
        except BaseException:
            # A failed startup closes the stream it opened and leaves
            # the ledger.
            if self._tel is not None:
                self._tel.close()
            LEDGER.release("serve_table")
            raise

    def _start(self, cfg: FmConfig, watch: bool, warmup: str) -> None:
        SloSpec.from_config(cfg).emit_gauges(self._reg)
        # Raw-ids flushes (no U axis), flat arrays on the serve ladder.
        self._scorer = CompiledScorer(cfg, self.device, dedup="device",
                                      serve_ladder=True)
        self._reg.set("wire/packed",
                      1.0 if self._scorer.wire.packed else 0.0)
        self._reg.set("wire/narrow",
                      1.0 if self._scorer.wire.narrow else 0.0)
        # Admit mode parses into the hashed id space; each flush remaps
        # through the slot map it captured with its table.
        self._admit = cfg.vocab_mode == "admit"
        self._build_cfg = VocabMap.build_cfg(cfg) if self._admit else cfg
        self._vocab_map: Optional[VocabMap] = None
        self._b_ladder = batch_rung_ladder(cfg.serve_max_batch)
        self._l_rungs = tuple(
            b for b in cfg.bucket_ladder
            if b <= _ladder_fit(max(1, cfg.max_features_per_example),
                                cfg.bucket_ladder))
        self.directory = os.path.abspath(cfg.model_file) + ".ckpt"
        # Guards the (table, slot map, served_step) triple: a flush
        # captures all three from the same swap.
        self._table_lock = threading.Lock()
        self._table = None
        self._served_step = -1
        self._published_step = -1
        self._reloading = threading.Event()
        # Readiness, split from liveness: the proxy routes on ready,
        # the supervisor restarts on alive (an answering /healthz).
        self._warmed = threading.Event()
        # The warmup thread and the dispatcher share the scorer and its
        # wire encoder: one scores at a time.
        self._score_lock = threading.Lock()
        self._reg.set("serve/ready", 0.0)
        # The published pointer IS the serving contract: an unpublished
        # directory is an operator error, not a wait.
        step = read_pointer(self.directory, cfg.serve_pointer)
        if step is None:
            raise FileNotFoundError(
                f"no published checkpoint pointer in {self.directory} — "
                "publish one with `python -m "
                "fast_tffm_tpu_torch.tools.fmckpt publish <model_file> "
                "<step>`")
        self._load_step(step)
        self.note_published(step)
        self._q: "queue.Queue" = queue.Queue()
        # Serializes enqueue against shutdown: a submit that passed the
        # closed gate always lands BEFORE the stop sentinel (the
        # dispatcher flushes it), and a submit after close() raises.
        self._submit_lock = threading.Lock()
        self._closed = False
        self._flushes = 0
        self._start_time = time.time()
        self._shed_depth = max(8, 2 * cfg.serve_max_batch)
        self._warmup_thread = None
        if warmup == "background":
            self._warmup_thread = threading.Thread(
                target=self._warmup_bg, name="fmt-serve-warmup",
                daemon=True)
            self._warmup_thread.start()
        else:
            self._warmup()
            self._mark_warmed()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="fmt-serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()
        self._watcher = None
        if watch:
            self._watcher = ReloadWatcher(
                self, poll_seconds=cfg.serve_poll_seconds,
                jitter=cfg.serve_poll_jitter, seed=cfg.serve_port,
                auto_reload=cfg.serve_reload_mode == "poll").start()
        self._logger.info(
            "serving checkpoint step %d from %s on %s (%d batch x %d "
            "width rungs %s, max_batch=%d, max_wait=%.1fms, "
            "wire=%s, reload=%s)",
            self._served_step, self.directory, self.device,
            len(self._b_ladder), len(self._l_rungs),
            "warmed" if warmup == "sync" else "warming in the background",
            cfg.serve_max_batch, cfg.serve_max_wait_ms,
            self._scorer.wire.describe(), cfg.serve_reload_mode)

    # -- model load / hot reload ------------------------------------------

    @property
    def served_step(self) -> int:
        with self._table_lock:
            return self._served_step

    @property
    def published_step(self) -> int:
        """Last pointer value observed (startup or a reload poll)."""
        return self._published_step

    def _load_step(self, step: int) -> None:
        """Verified restore of an explicit step (raises on integrity
        failure — never silently serves other bytes), copied to the
        device completely, then swapped in. Admit mode loads the step's
        slot map first: a missing or torn sidecar raises before the
        table is read. In-flight flushes keep the triple they captured,
        so the old table lives until they drain."""
        from fast_tffm_tpu_torch.predict import load_table
        # The reload transient: old and new tables are both held until
        # the swap. A reload that would exceed the card is refused here
        # (the counted-failure path: the old triple keeps serving).
        old_bytes = LEDGER.owners().get("serve_table", 0)
        new_bytes = obs_memory.table_bytes(self.cfg)
        if old_bytes:
            cap = obs_memory.device_capacity_bytes()
            if cap and LEDGER.live_bytes() + new_bytes > cap:
                raise RuntimeError(
                    f"hot reload of step {step} refused: old+new tables "
                    f"would exceed device capacity "
                    f"({LEDGER.live_bytes() + new_bytes:,} > {cap:,} "
                    f"bytes)\n{obs_memory.render_ledger()}")
            LEDGER.register("serve_reload_table", new_bytes)
        vmap = None
        try:
            if self._admit:
                vmap = load_vocab_map(self.cfg, self.directory, step)
            else:
                refuse_fixed_mode_admit_step(self.cfg, self.directory,
                                             step)
            with oom_guard("serve/reload"):
                table = load_table(self.cfg, self.device, step=step)
        finally:
            LEDGER.release("serve_reload_table")
        with self._table_lock:
            self._table = table
            self._vocab_map = vmap
            self._served_step = int(step)
        LEDGER.register("serve_table", int(table.nbytes))
        self._reg.set("serve/reload_peak_bytes",
                      float(old_bytes + int(table.nbytes)))
        self._reg.set("serve/served_step", float(step))
        if vmap is not None:
            self._reg.set("serve/vocab_live_rows", float(vmap.live_rows))

    def idle_beat(self) -> None:
        """Watchdog liveness of a traffic-idle server (the reload poll
        ticks it): no request is not a stall."""
        if self._tel is not None:
            self._tel.heartbeat()

    def note_published(self, step: int) -> None:
        """The pointer value last seen (``/healthz`` published_step, the
        ``serve/published_step`` gauge)."""
        self._published_step = int(step)
        self._reg.set("serve/published_step", float(step))

    def reload_step(self, step: int) -> bool:
        """Hot-swap to a newly published step; False (and a counted
        failure) when the step fails verification or restore — the
        previous table keeps serving and the next poll retries. The
        server reports ``ready: false`` while it loads."""
        self._reloading.set()
        self._reg.set("serve/ready", 0.0)
        try:
            with span("serve/reload", step=int(step)):
                self._load_step(step)
        except Exception as e:  # noqa: BLE001 - keep serving old state
            self._reg.count("serve/reload_failures")
            self._logger.warning(
                "hot reload of published step %d failed (%s: %s); "
                "continuing to serve step %d", step, type(e).__name__,
                e, self.served_step)
            return False
        finally:
            self._reloading.clear()
            self._reg.set("serve/ready", 1.0 if self.is_ready() else 0.0)
        self._reg.count("serve/reloads")
        self._logger.info("hot-reloaded published checkpoint step %d",
                          step)
        return True

    def external_reload(self, step: Optional[int] = None
                        ) -> Tuple[bool, int]:
        """The ``POST /reload`` control surface: the reload token the
        fleet supervisor's stagger protocol hands each replica in turn
        (``serve_reload_mode = external``). ``step=None`` resolves this
        server's pointer (``serve_pointer``). Synchronous: returns (ok,
        the step now serving) only after the swap or its counted
        failure; the step already served is a no-op."""
        if step is None:
            step = read_pointer(self.directory, self.cfg.serve_pointer)
            if step is None:
                return False, self.served_step
        step = int(step)
        self.note_published(step)
        if step == self.served_step:
            return True, step
        ok = self.reload_step(step)
        return ok, self.served_step

    # -- request path ----------------------------------------------------

    def _parse(self, lines: Sequence[str]) -> ParsedBlock:
        cfg = self._build_cfg
        # keep_empty: one score per request line, exactly the predict
        # alignment contract — a blank line scores as the model bias.
        return parse_lines(
            lines, cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
            field_aware=cfg.model_type == "ffm",
            field_num=cfg.field_num,
            max_features_per_example=cfg.max_features_per_example,
            keep_empty=True)

    def submit(self, lines: Sequence[str]) -> _Pending:
        """Parse (on the caller's thread) and enqueue; ``.result(timeout)``
        on the handle blocks for the flush. A malformed line raises
        ParseError HERE, to this caller only — one bad request never
        poisons a micro-batch of strangers."""
        if self._closed:
            raise RuntimeError("ScorerServer is closed")
        lines = list(lines)
        if len(lines) > self.cfg.serve_max_batch:
            raise ValueError(
                f"request of {len(lines)} lines exceeds serve_max_batch "
                f"= {self.cfg.serve_max_batch}; split the request or "
                "raise the knob")
        block = self._parse(lines)
        pending = _Pending(block)
        if pending.n == 0:
            # Nothing to score: complete inline so an empty request
            # can't wedge an admission window open.
            pending._complete(np.zeros(0, dtype=np.float64),
                              self.served_step)
            return pending
        self._reg.observe("serve/queue_depth", self._q.qsize(),
                          bounds=DEPTH_BUCKETS)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("ScorerServer is closed")
            self._q.put(pending)
        return pending

    def score_lines(self, lines: Sequence[str],
                    timeout: Optional[float] = None) -> ScoreResult:
        """Synchronous request: one transformed score per input line."""
        return self.submit(lines).result(timeout)

    # -- dispatcher ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        wait_s = self.cfg.serve_max_wait_ms / 1000.0
        max_batch = self.cfg.serve_max_batch
        carry: Optional[_Pending] = None
        stopping = False
        while not stopping:
            if carry is not None:
                first, carry = carry, None
            else:
                first = self._q.get()
                if first is _STOP:
                    break
            window = [first]
            n = first.n
            deadline = time.perf_counter() + wait_s
            while n < max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                if n + nxt.n > max_batch:
                    carry = nxt  # head of the NEXT window
                    break
                window.append(nxt)
                n += nxt.n
            self._flush(window, n)
            if stopping and carry is not None:
                # close() gated submit before queueing the sentinel, so
                # everything behind it is already flushed; a carry
                # captured in the same window still owes its scores.
                self._flush([carry], carry.n)
                carry = None

    def _flush(self, window: List[_Pending], n: int) -> None:
        reg = self._reg
        try:
            t0 = time.perf_counter()
            reg.observe("serve/queue_wait_ms",
                        (t0 - min(p.t0 for p in window)) * 1000.0,
                        bounds=LATENCY_BUCKETS_MS)
            block = _concat_blocks([p.block for p in window])
            rung = next(b for b in self._b_ladder if b >= n)
            with self._table_lock:
                table = self._table
                vmap = self._vocab_map
                step = self._served_step
            with span("serve/flush", examples=n, rung=rung):
                batch = make_device_batch(block, self._build_cfg,
                                          batch_size=rung)
                if vmap is not None:
                    batch = vmap.remap(batch)
                t_dev = time.perf_counter()
                reg.observe("serve/pad_ms", (t_dev - t0) * 1000.0,
                            bounds=LATENCY_BUCKETS_MS)
                with self._score_lock:
                    raw = self._scorer.score_batch(table, batch)[:n]
                    raw = raw.cpu().numpy()
                reg.observe("serve/device_ms",
                            (time.perf_counter() - t_dev) * 1000.0,
                            bounds=LATENCY_BUCKETS_MS)
            t_reply = time.perf_counter()
            vals = self._scorer.transform(raw)
            reg.count("serve/flushes")
            reg.count("serve/examples", n)
            reg.count("serve/padded_examples", rung - n)
            pos = 0
            done = time.perf_counter()
            for p in window:
                p._complete(vals[pos:pos + p.n], step)
                pos += p.n
                reg.count("serve/requests")
                reg.observe("serve/request_latency_ms",
                            (done - p.t0) * 1000.0,
                            bounds=LATENCY_BUCKETS_MS)
            reg.observe("serve/reply_ms",
                        (time.perf_counter() - t_reply) * 1000.0,
                        bounds=LATENCY_BUCKETS_MS)
        except BaseException as e:  # noqa: BLE001 - per-window failure
            # The window's callers get the error; the server keeps
            # serving (the next window may be fine).
            reg.count("serve/flush_errors")
            self._logger.exception("serve flush of %d example(s) failed",
                                   n)
            for p in window:
                p._fail(e)
        # Single writer: only the dispatcher thread counts flushes;
        # close() reads it after join().
        self._flushes += 1
        if self._tel is not None:
            try:
                self._tel.heartbeat()
                self._tel.maybe_flush(self._flushes)
            except Exception:  # noqa: BLE001 - a failed metrics write
                # must cost telemetry, never the dispatcher thread.
                self._logger.exception(
                    "serve telemetry flush failed; continuing")

    # -- warmup / teardown ----------------------------------------------

    def _warmup(self) -> None:
        """Score one all-real batch at every [B rung, L rung] shape a
        flush can pad to, and, on the packed wire, every flat rung a
        flush of that shape can encode to. Stops early (leaving the
        server not warmed) once ``close`` has begun."""
        cfg = self._build_cfg
        t0 = time.monotonic()
        with self._table_lock:
            table = self._table
            vmap = self._vocab_map
        with span("serve/warmup",
                  rungs=len(self._b_ladder) * len(self._l_rungs)):
            for B in self._b_ladder:
                for L in self._l_rungs:
                    if self._closed:
                        return
                    self._warm_shape(table, vmap, cfg, B, L)
        self._reg.set("serve/compiled_shapes",
                      float(len(self._b_ladder) * len(self._l_rungs)))
        self._logger.info(
            "warmed %d serve shapes (B rungs %s x L rungs %s, wire %s) "
            "in %.1fs", len(self._b_ladder) * len(self._l_rungs),
            list(self._b_ladder), list(self._l_rungs),
            self._scorer.wire.describe(), time.monotonic() - t0)

    def _warm_shape(self, table, vmap, cfg: FmConfig, B: int, L: int
                    ) -> None:
        """Score one all-real [B, L] batch (and its flat rungs on the
        packed wire)."""
        ids = np.arange(L, dtype=np.int64) % cfg.vocabulary_size
        block = ParsedBlock(
            labels=np.zeros(1, dtype=np.float32),
            poses=np.asarray([0, L], dtype=np.int32),
            ids=ids.astype(np.int32),
            vals=np.ones(L, dtype=np.float32),
            fields=(np.zeros(L, dtype=np.int32)
                    if cfg.model_type == "ffm" else None))
        batch = make_device_batch(block, cfg, batch_size=B)
        if vmap is not None:
            batch = vmap.remap(batch)
        with self._score_lock:
            self._scorer.score_batch(table, batch).cpu()
            if self._scorer.wire.packed:
                for P in flat_rungs(B, L):
                    self._scorer.score_packed_shape(table, B, L, P).cpu()

    def _mark_warmed(self) -> None:
        self._warmed.set()
        self._reg.set("serve/ready", 1.0 if self.is_ready() else 0.0)

    def _warmup_bg(self) -> None:
        """The background warmup thread: warm the ladder, then flip
        ready. A failure leaves the server alive and never ready
        (counted and logged): the fleet routes around it."""
        try:
            self._warmup()
        except Exception:  # noqa: BLE001 - surfaced as state
            self._reg.count("serve/warmup_errors")
            self._logger.exception(
                "serve warmup failed; the server stays not ready")
            return
        if not self._closed:
            self._mark_warmed()

    def is_ready(self) -> bool:
        """The proxy-facing readiness bit: warmed, not mid-reload, not
        shutting down, admission queue below the shed depth. Distinct
        from alive (an answering process) by design."""
        return (self._warmed.is_set() and not self._reloading.is_set()
                and not self._closed
                and self._q.qsize() < self._shed_depth)

    def stats(self) -> dict:
        """The /healthz payload: live counters + latency quantiles."""
        c = self._reg.snapshot()["counters"]
        lat = self._reg.histogram("serve/request_latency_ms",
                                  bounds=LATENCY_BUCKETS_MS)
        with self._table_lock:
            table_device = self._table.device
        return {
            "status": "ok",
            "alive": True,
            "ready": self.is_ready(),
            # The table's device: the card with its index ("cuda:0").
            "device": str(table_device),
            "kernel": resolved_kernel(self.device, self._scorer.spec),
            "wire": self._scorer.wire.describe(),
            "warmed": self._warmed.is_set(),
            "warmup_errors": int(c.get("serve/warmup_errors", 0)),
            "reloading": self._reloading.is_set(),
            "served_step": self.served_step,
            "published_step": self._published_step,
            "queue_depth": self._q.qsize(),
            "requests": int(c.get("serve/requests", 0)),
            "examples": int(c.get("serve/examples", 0)),
            "flushes": int(c.get("serve/flushes", 0)),
            "flush_errors": int(c.get("serve/flush_errors", 0)),
            "reloads": int(c.get("serve/reloads", 0)),
            "reload_failures": int(c.get("serve/reload_failures", 0)),
            # This process's fm_score launches: a fleet replica's are
            # its server's alone.
            "kernel_launches": fm_kernel.launches,
            "latency_p50_ms": lat.quantile(0.5),
            "latency_p99_ms": lat.quantile(0.99),
            "uptime_seconds": time.time() - self._start_time,
        }

    def metrics_text(self) -> str:
        """The ``GET /metrics`` body: this server's registry in the
        Prometheus text format (obs/prom.py), the snapshot /healthz
        reads."""
        return prometheus_text(self._reg.snapshot())

    def close(self) -> None:
        """Drain and stop: no new submissions, every queued request
        flushed, the warmup, dispatcher and reload threads joined, the
        stream closed with ``run_end``. Idempotent."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            # Under the lock: every pending already enqueued precedes
            # this sentinel, and no submit can enqueue after it.
            self._q.put(_STOP)
        if self._watcher is not None:
            self._watcher.stop()
        if self._warmup_thread is not None:
            self._warmup_thread.join()
        self._dispatcher.join()
        if self._tel is not None:
            self._tel.close(step=self._flushes)
        for owner in ("serve_table", "serve_reload_table", "wire_buffers"):
            LEDGER.release(owner)
        self._logger.info("scorer server closed after %d flushes",
                          self._flushes)
