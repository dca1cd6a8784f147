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

Startup loads ``<model_file>.npz`` and scores one batch at every
[B rung x L rung] shape (``_warmup``), so the kernel library is built
and loaded, and the allocator warm, before the first request.

Not ported yet: hot reload of a ``published`` checkpoint (the .npz holds
no step, so responses carry step -1), telemetry, SLO gauges, capacity
pre-flight, admit mode, background warmup (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import ParsedBlock, parse_lines
from fast_tffm_tpu_torch.data.pipeline import (_ladder_fit, make_device_batch,
                                               require_bounded_examples)
from fast_tffm_tpu_torch.models.fm import resolved_kernel
from fast_tffm_tpu_torch.obs.registry import MetricsRegistry
from fast_tffm_tpu_torch.scoring import CompiledScorer
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.utils.logging import get_logger

# Request-latency histogram bounds, in milliseconds (/healthz p50/p99).
LATENCY_BUCKETS_MS = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
# Admission-queue depth histogram bounds.
DEPTH_BUCKETS = tuple(2 ** i for i in range(11))

# The step a response reports: the .npz export carries none.
NPZ_STEP = -1

_STOP = object()


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    """One request's response: transformed scores (sigmoid for logistic
    loss, raw for mse — what predict writes to .score files) plus the
    step that scored them (-1: the .npz export carries no step)."""
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
    return ParsedBlock(
        labels=np.concatenate([b.labels for b in blocks]),
        poses=np.concatenate(poses).astype(np.int32),
        ids=np.concatenate([b.ids for b in blocks]),
        vals=np.concatenate([b.vals for b in blocks]))


class ScorerServer:
    """The long-lived scorer. Lifecycle:

        server = ScorerServer(cfg)        # loads the .npz table, scores
                                          # the shape ladder, starts the
                                          # dispatcher
        res = server.score_lines(lines)   # or submit() for async
        server.close()                    # drains and stops

    ``device`` defaults to the card."""

    def __init__(self, cfg: FmConfig, logger=None, device=None):
        # Every parsed example must fit the width ladder.
        require_bounded_examples(cfg, "online serving")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._logger = logger or get_logger(log_file=cfg.log_file or None)
        self._reg = MetricsRegistry()
        self._scorer = CompiledScorer(cfg, self.device)
        self._b_ladder = batch_rung_ladder(cfg.serve_max_batch)
        self._l_rungs = tuple(
            b for b in cfg.bucket_ladder
            if b <= _ladder_fit(max(1, cfg.max_features_per_example),
                                cfg.bucket_ladder))
        from fast_tffm_tpu_torch.predict import load_table
        self._table = load_table(cfg, self.device)
        self._q: "queue.Queue" = queue.Queue()
        # Serializes enqueue against shutdown: a submit that passed the
        # closed gate always lands BEFORE the stop sentinel (the
        # dispatcher flushes it), and a submit after close() raises.
        self._submit_lock = threading.Lock()
        self._closed = False
        self._flushes = 0
        self._start_time = time.time()
        self._shed_depth = max(8, 2 * cfg.serve_max_batch)
        self._warmup()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="fm-serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()
        self._logger.info(
            "serving %s on %s (%d batch x %d width rungs warmed, "
            "max_batch=%d, max_wait=%.1fms)",
            cfg.model_file + ".npz", self.device, len(self._b_ladder),
            len(self._l_rungs), cfg.serve_max_batch, cfg.serve_max_wait_ms)

    # -- request path ----------------------------------------------------

    def _parse(self, lines: Sequence[str]) -> ParsedBlock:
        cfg = self.cfg
        # keep_empty: one score per request line, exactly the predict
        # alignment contract — a blank line scores as the model bias.
        return parse_lines(
            lines, cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
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
            pending._complete(np.zeros(0, dtype=np.float64), NPZ_STEP)
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
            batch = make_device_batch(block, self.cfg, batch_size=rung)
            t_dev = time.perf_counter()
            reg.observe("serve/pad_ms", (t_dev - t0) * 1000.0,
                        bounds=LATENCY_BUCKETS_MS)
            raw = self._scorer.score_batch(self._table, batch)[:n]
            raw = raw.cpu().numpy()
            reg.observe("serve/device_ms",
                        (time.perf_counter() - t_dev) * 1000.0,
                        bounds=LATENCY_BUCKETS_MS)
            vals = self._scorer.transform(raw)
            reg.count("serve/flushes")
            reg.count("serve/examples", n)
            reg.count("serve/padded_examples", rung - n)
            pos = 0
            done = time.perf_counter()
            for p in window:
                p._complete(vals[pos:pos + p.n], NPZ_STEP)
                pos += p.n
                reg.count("serve/requests")
                reg.observe("serve/request_latency_ms",
                            (done - p.t0) * 1000.0,
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

    # -- warmup / teardown ----------------------------------------------

    def _warmup(self) -> None:
        """Score one all-real batch at every [B rung, L rung] shape a
        flush can pad to, before the first request."""
        cfg = self.cfg
        t0 = time.monotonic()
        for B in self._b_ladder:
            for L in self._l_rungs:
                ids = np.arange(L, dtype=np.int64) % cfg.vocabulary_size
                block = ParsedBlock(
                    labels=np.zeros(1, dtype=np.float32),
                    poses=np.asarray([0, L], dtype=np.int32),
                    ids=ids.astype(np.int32),
                    vals=np.ones(L, dtype=np.float32))
                batch = make_device_batch(block, cfg, batch_size=B)
                self._scorer.score_batch(self._table, batch).cpu()
        self._logger.info(
            "warmed %d serve shapes (B rungs %s x L rungs %s) in %.1fs",
            len(self._b_ladder) * len(self._l_rungs), list(self._b_ladder),
            list(self._l_rungs), time.monotonic() - t0)

    def is_ready(self) -> bool:
        """Not shutting down, admission queue below the shed depth (the
        constructor returns only after warmup)."""
        return not self._closed and self._q.qsize() < self._shed_depth

    def stats(self) -> dict:
        """The /healthz payload: live counters + latency quantiles."""
        c = self._reg.snapshot()["counters"]
        lat = self._reg.histogram("serve/request_latency_ms",
                                  bounds=LATENCY_BUCKETS_MS)
        return {
            "status": "ok",
            "alive": True,
            "ready": self.is_ready(),
            "device": str(self.device),
            "kernel": resolved_kernel(self.device),
            "served_step": NPZ_STEP,
            "queue_depth": self._q.qsize(),
            "requests": int(c.get("serve/requests", 0)),
            "examples": int(c.get("serve/examples", 0)),
            "flushes": int(c.get("serve/flushes", 0)),
            "flush_errors": int(c.get("serve/flush_errors", 0)),
            "latency_p50_ms": lat.quantile(0.5),
            "latency_p99_ms": lat.quantile(0.99),
            "uptime_seconds": time.time() - self._start_time,
        }

    def close(self) -> None:
        """Drain and stop: no new submissions, every queued request
        flushed, the dispatcher joined. Idempotent."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            # Under the lock: every pending already enqueued precedes
            # this sentinel, and no submit can enqueue after it.
            self._q.put(_STOP)
        self._dispatcher.join()
        self._logger.info("scorer server closed after %d flushes",
                          self._flushes)
