"""The scorer handle both inference surfaces share, the score-line
format, and the cross-file scoring sweep — the port's counterpart of
``fast_tffm_tpu/scoring.py``.

``CompiledScorer`` keeps the JAX name: batch predict (predict.py) and
the serving process (serve/server.py) score every batch through it, so
the two cannot pair a batch with another score path. A raw-ids batch
(``dedup = device``, and always in serving) has raw table rows in
``local_idx`` and the kernel reads them itself; a host-deduped batch
(``dedup = host``) has its rows gathered first. ``raw`` says which
batches the pipeline builds for this scorer. The scorer owns the
``WireEncoder`` (wire.py) every batch ships through: padded, or packed
and rebuilt on the device by ``packed_score_body``. With a lookup
``backend`` (lookup.py, ``lookup = host``) the table never comes to the
card: batches are host-deduped, the backend gathers each batch's rows
(a padded batch's shipped ``uniq_ids``, a packed batch's withheld
``host_uniq``) and the card scores the row block (``rows_score_body``,
``packed_rows_score_body``).

``format_scores`` is the one ``%.6f``-per-line formatter: predict writes
it to ``.score`` files and serving returns it as the response body, so
the same float64 scores give the same bytes on both surfaces.

``score_sweep`` is predict's continuous sweep: one ``batch_iterator``
over all files (``keep_empty``, batches cross file boundaries), tagged
by a ``FileMarks`` ledger; one ``ChunkedFetcher`` for the whole sweep,
so the copy of file N's scores to the host overlaps the scoring of
file N+1; ``ScoreDemux`` cuts the ordered scores back into per-file
arrays as each file's last example lands; the caller hands those to a
``ScoreWriter`` thread, so the disk write overlaps the rest.

The multi-process sweep (predict.py, ``dist_train``): each rank writes
its byte range's scores of each file as ``<out>.part<i>`` and then a
``.done`` marker; the chief's ``PartMerger`` thread concatenates a
file's parts in rank order as soon as all its markers exist (byte
ranges are contiguous, so rank order is line order) and deletes them;
``scrub_stale_parts`` first removes the parts a crashed earlier sweep
left in the same ``score_path``.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import os
import queue
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import (DeviceBatch, FileMarks,
                                               batch_iterator,
                                               gil_bound_iteration,
                                               prefetch)
from fast_tffm_tpu_torch.metrics import sigmoid
from fast_tffm_tpu_torch.models.fm import (ModelSpec, make_batch_scorer,
                                           packed_rows_score_body,
                                           packed_score_body,
                                           ships_raw_batches)
from fast_tffm_tpu_torch.obs.memory import oom_guard
from fast_tffm_tpu_torch.obs.telemetry import active
from fast_tffm_tpu_torch.obs.trace import span
from fast_tffm_tpu_torch.utils.fetch import ChunkedFetcher
from fast_tffm_tpu_torch.wire import (NARROW_VALUE_DTYPE, WireEncoder,
                                      resolve_wire)


class CompiledScorer:
    """Scores batches against a table on ``device``, or through a lookup
    ``backend`` (``table`` then unused: pass None). ``dedup`` overrides
    the config's resolution (the serving process forces ``"device"``:
    raw-ids flushes); ``serve_ladder`` buckets packed flat arrays to the
    serve ladder (``wire.rect_fraction_rungs``)."""

    def __init__(self, cfg: FmConfig, device: torch.device,
                 dedup: Optional[str] = None, serve_ladder: bool = False,
                 backend=None):
        spec = ModelSpec.from_config(cfg)
        if dedup is not None:
            spec = dataclasses.replace(spec, dedup=dedup)
        self.spec = spec
        self.device = torch.device(device)
        self.backend = backend
        # Whether the pipeline builds raw-ids batches for this scorer.
        self.raw = ships_raw_batches(spec, backend=backend)
        self._score = make_batch_scorer(spec, backend=backend)
        self.wire = resolve_wire(cfg, backend=backend)
        self.encoder = WireEncoder(self.wire, pad_id=cfg.pad_id,
                                   host_uniq=backend is not None,
                                   rect_fraction=serve_ladder)

    def score_batch(self, table: Optional[torch.Tensor],
                    batch: DeviceBatch) -> torch.Tensor:
        """Raw [B] scores, left on the device (callers fetch them). The
        one dispatch of predict, evaluate and serving, under
        ``oom_guard``: an out-of-memory error re-raises with the ledger."""
        with oom_guard("score/dispatch"):
            wb = self.encoder.encode_score(batch)
            args = self.encoder.device_put(wb, self.device)
            if not wb.packed:
                return self._score(table, args)
            if self.backend is not None:
                gathered = self.backend.gather(wb.host_uniq)
                return packed_rows_score_body(self.spec, wb.L, gathered,
                                              **args)
            return packed_score_body(self.spec, wb.L, table, **args)

    def score_packed_shape(self, table: torch.Tensor, B: int, L: int,
                           P: int) -> torch.Tensor:
        """Score an all-padding raw-ids batch at one (B, L, flat rung)
        shape through the packed body: the serving warmup walks every
        rung a flush can encode to (serve/server._warmup)."""
        if not self.wire.packed or not self.raw:
            raise ValueError("score_packed_shape warms the packed "
                             "raw-ids scorer only")
        vdt = NARROW_VALUE_DTYPE if self.wire.narrow else np.float32
        arrays = {"lengths": np.zeros(B, dtype=np.int32),
                  "flat_idx": np.full(P, self.spec.vocabulary_size,
                                      dtype=np.int32),
                  "flat_vals": np.zeros(P, dtype=vdt)}
        if self.spec.model_type == "ffm":
            arrays["flat_fields"] = np.zeros(P, dtype=np.int32)
        args = {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}
        return packed_score_body(self.spec, L, table, **args)

    def transform(self, raw: np.ndarray) -> np.ndarray:
        """What the score lines hold: sigmoid for logistic loss, the raw
        score for mse; float64 either way."""
        if self.spec.loss_type == "logistic":
            return sigmoid(raw)
        return np.asarray(raw, dtype=np.float64)


def format_scores(vals: Iterable[float]) -> str:
    """One ``%.6f`` line per score (the ``.score`` file format)."""
    return "".join(f"{v:.6f}\n" for v in vals)


class ScoreWriter:
    """Ordered score-file writer on a background thread
    (``fmt-score-writer``), so the next file's parse, score and fetch
    overlap the previous file's disk write. Submission order is write
    order, the queue holds at most 2 files' scores (the sweep's
    back-pressure), and ``close()`` writes everything and raises the
    first deferred write error: a return from predict means every score
    file is on disk."""

    def __init__(self, logger):
        self._logger = logger
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._sentinel = object()
        self._lock = threading.Lock()  # guards _error
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="fmt-score-writer",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is self._sentinel:
                return
            with self._lock:
                dead = self._error is not None
            if dead:
                continue  # keep unblocking producers; write no more
            out_path, vals, marker = job
            tel = active()
            try:
                t0 = time.perf_counter()
                with span("predict/write", path=os.path.basename(out_path)):
                    with open(out_path, "w") as fh:
                        fh.write(format_scores(vals))
                    if marker is not None:
                        # Only once the file is complete and closed: the
                        # chief's merge keys on the marker.
                        with open(marker, "w"):
                            pass
                if tel is not None:
                    tel.count("predict/write_seconds",
                              time.perf_counter() - t0)
                self._logger.info("wrote %d scores to %s", len(vals),
                                  out_path)
            except BaseException as e:  # raised by submit() / close()
                with self._lock:
                    if self._error is None:  # keep the first failure
                        self._error = e

    def submit(self, out_path: str, vals: np.ndarray,
               marker: Optional[str] = None) -> None:
        """Queue ``vals`` for ``out_path``; ``marker``, an empty file
        created once the scores are written (a part file's ``.done``)."""
        with self._lock:
            err = self._error
        if err is not None:
            raise err
        self._q.put((out_path, vals, marker))

    def close(self, raise_error: bool = True) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(self._sentinel)
            self._thread.join()
        if raise_error:
            with self._lock:
                err = self._error
            if err is not None:
                raise err


class ScoreDemux:
    """Cut an ordered score stream into per-file arrays by the
    pipeline's ``FileMarks`` ledger.

    ``consume(scores)`` appends the next in-order slice of the sweep's
    examples; whenever the ledger shows that file i+1 has started and
    the consumed count has reached its start, file i is complete and
    ``on_file(path, vals)`` gets its span. One batch can complete
    several small files. ``finalize()``, after every score has landed,
    cuts the rest: the last file ends at the consumed total, and empty
    files get zero-length arrays (a zero-line input owes a zero-line
    ``.score``). ``consume`` runs on the fetch worker and ``finalize``
    on the caller after the worker was joined: one writer at a time."""

    def __init__(self, marks: FileMarks,
                 on_file: Callable[[str, np.ndarray], None]):
        self._marks = marks
        self._on_file = on_file
        self._bufs: "collections.deque" = collections.deque()
        self._buf_start = 0   # sweep offset of the first buffered score
        self._consumed = 0    # total scores consumed so far
        self._next = 0        # index of the next file to cut

    def consume(self, scores: np.ndarray) -> None:
        if len(scores):
            self._bufs.append(scores)
            self._consumed += len(scores)
        self._cut_ready(self._marks.snapshot())

    def _cut_ready(self, starts) -> None:
        while (self._next + 1 < len(starts)
               and self._consumed >= starts[self._next + 1][1]):
            self._emit(starts[self._next][0], starts[self._next + 1][1])
            self._next += 1

    def _emit(self, path: str, end: int) -> None:
        n = end - self._buf_start
        take: List[np.ndarray] = []
        while n > 0:
            head = self._bufs[0]
            if len(head) <= n:
                take.append(self._bufs.popleft())
                n -= len(head)
            else:
                take.append(head[:n])
                self._bufs[0] = head[n:]
                n = 0
        self._buf_start = end
        vals = (np.concatenate(take) if take
                else np.zeros(0, dtype=np.float32))
        self._on_file(path, vals)

    def finalize(self) -> None:
        """Cut everything still open; call once every score has been
        consumed."""
        starts = self._marks.snapshot()
        self._cut_ready(starts)
        for i in range(self._next, len(starts)):
            end = (starts[i + 1][1] if i + 1 < len(starts)
                   else self._consumed)
            self._emit(starts[i][0], end)
        self._next = len(starts)
        if self._buf_start != self._consumed:
            raise AssertionError(
                f"score demux leak: {self._consumed - self._buf_start} "
                f"scores consumed but never assigned to a file (ledger "
                f"has {len(starts)} entries)")


# Bounds of the predict/fetch_depth histogram (the JAX package's).
DEPTH_BUCKETS = tuple(2 ** i for i in range(11))


def score_sweep(cfg: FmConfig, table: Optional[torch.Tensor],
                files: Sequence[str],
                on_file: Callable[[str, np.ndarray], None],
                scorer: Optional[CompiledScorer] = None,
                vocab=None) -> int:
    """One continuous scoring sweep over all ``files`` (keep_empty: one
    score per input line): per-file raw score arrays go to ``on_file``
    in file order as each file's last batch lands. Returns the number of
    examples scored. ``on_file`` runs on the fetch worker mid-sweep (on
    the caller's thread for the files cut at the end). ``table`` is
    None for a scorer with a backend. ``vocab`` (``vocab_mode =
    admit``): the step's slot map; the sweep builds in the hashed space
    and remaps through it, so it scores the rows training assigned."""
    scorer = scorer or CompiledScorer(cfg, table.device)
    marks = FileMarks()
    demux = ScoreDemux(marks, on_file)
    fetcher = ChunkedFetcher(lambda s, num_real: demux.consume(s[:num_real]))
    files = list(files)
    tel = active()
    if tel is not None:
        tel.set("wire/packed", 1.0 if scorer.wire.packed else 0.0)
        tel.set("wire/narrow", 1.0 if scorer.wire.narrow else 0.0)
    n_examples = 0
    try:
        with span("predict/sweep", files=len(files)):
            it = batch_iterator(cfg, files, training=False, epochs=1,
                                keep_empty=True, raw_ids=scorer.raw,
                                file_marks=marks, vocab=vocab)
            with torch.no_grad():
                for batch in prefetch(it, depth=cfg.prefetch_depth,
                                      gil_bound=gil_bound_iteration(
                                          cfg, keep_empty=True)):
                    fetcher.add(scorer.score_batch(table, batch),
                                batch.num_real)
                    n_examples += batch.num_real
                    if tel is not None:
                        tel.count("predict/batches")
                        tel.count("predict/examples", batch.num_real)
                        # The output-order buffer's depth: the D2H
                        # backlog.
                        tel.observe("predict/fetch_depth",
                                    fetcher.pending_depth,
                                    bounds=DEPTH_BUCKETS)
                        tel.heartbeat()
            fetcher.flush()
        # Every score is on the host and consumed: cut the tail files.
        demux.finalize()
    finally:
        fetcher.close()
    return n_examples


def scrub_stale_parts(out_paths: Sequence[str]) -> List[str]:
    """Remove the ``<out>.part*`` files (parts and ``.done`` markers,
    any rank) a crashed earlier multi-process sweep left into the same
    ``score_path``: the merger polls markers from its start, so a stale
    set would merge the old run's scores. The caller scrubs before any
    rank writes a part, and a barrier follows. Returns the removed
    paths."""
    removed: List[str] = []
    for out_path in out_paths:
        for stale in sorted(glob.glob(glob.escape(out_path) + ".part*")):
            os.remove(stale)
            removed.append(stale)
    return removed


# The merge thread polls the shared filesystem for part markers this
# often.
_MERGE_POLL_SECONDS = 0.05

# After the parts-done barrier every marker is durable: one still
# missing this long after is a fault, raised by name.
_MERGE_GRACE_SECONDS = 300.0


class PartMerger:
    """The multi-process chief's merge thread (``fmt-part-merger``): as
    each file's ``num_parts`` parts become complete (their ``.done``
    markers appear), it concatenates them in rank order into the final
    ``.score`` file, in file order, and deletes them, so the merge of
    file N overlaps the scoring of file N+1. ``finish()`` (after the
    parts-done barrier) waits out the rest, bounded per marker, and
    re-raises a merge error; ``stop()`` is the error path's teardown."""

    def __init__(self, out_paths: Sequence[str], num_parts: int, logger):
        self._outs = list(out_paths)
        self._P = num_parts
        self._logger = logger
        self._stop = threading.Event()
        self._done_barrier = threading.Event()
        self._error: Optional[BaseException] = None  # read after join
        self.merged: List[str] = []  # read after join
        self._thread = threading.Thread(target=self._run,
                                        name="fmt-part-merger", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for out_path in self._outs:
                if not self._wait_parts(out_path):
                    return
                self._merge_one(out_path)
        except BaseException as e:  # raised by finish()
            self._error = e

    def _wait_parts(self, out_path: str) -> bool:
        missing = [f"{out_path}.part{i}.done" for i in range(self._P)]
        deadline = None
        while True:
            missing = [m for m in missing if not os.path.exists(m)]
            if not missing:
                return True
            if self._stop.is_set():
                return False
            if self._done_barrier.is_set():
                if deadline is None:
                    deadline = time.monotonic() + _MERGE_GRACE_SECONDS
                elif time.monotonic() > deadline:
                    raise FileNotFoundError(
                        f"predict part marker(s) never appeared after "
                        f"the parts-done barrier: {missing[:3]}")
            self._stop.wait(_MERGE_POLL_SECONDS)

    def _merge_one(self, out_path: str) -> None:
        n = 0
        # Bounded chunks: a whole part read at once would hold a
        # multi-GB string on the chief for a billion-line predict.
        with span("predict/merge", path=os.path.basename(out_path)), \
                open(out_path, "wb") as out_fh:
            for i in range(self._P):
                with open(f"{out_path}.part{i}", "rb") as fh:
                    while True:
                        chunk = fh.read(8 << 20)
                        if not chunk:
                            break
                        n += chunk.count(b"\n")
                        out_fh.write(chunk)
        for i in range(self._P):
            os.remove(f"{out_path}.part{i}")
            os.remove(f"{out_path}.part{i}.done")
        self.merged.append(out_path)
        self._logger.info("wrote %d scores to %s (merged %d parts)", n,
                          out_path, self._P)

    def finish(self) -> List[str]:
        """After the parts-done barrier: join the thread, re-raise its
        error, and return the merged files in order."""
        self._done_barrier.set()
        self._thread.join()
        if self._error is not None:
            raise self._error
        if len(self.merged) != len(self._outs):
            raise RuntimeError(
                f"part merger finished {len(self.merged)}/"
                f"{len(self._outs)} files — merge thread exited early")
        return list(self.merged)

    def stop(self) -> None:
        """Error-path teardown: the thread exits at its next poll."""
        self._stop.set()
        self._thread.join(timeout=5.0)
