"""Append-only streaming source for ``run_mode = stream`` — the port of
``fast_tffm_tpu/data/stream.py``.

Shards ARRIVE in ``stream_dir`` (a directory, or a glob pattern): a feed
pipeline appends ``part-00017``, seals it, starts ``part-00018``. This
module puts that arrival process behind the pipeline's batch
abstraction:

- **Discovery**: ``stream_dir`` is polled every ``stream_poll_seconds``;
  new files join an ordered LEDGER in first-seen order (sorted within a
  poll) and are consumed strictly in ledger order, so the batches are
  the ones a single in-order pass over the final sealed corpus builds.
- **Hostile filesystem**: a growing file is tailed with its torn
  trailing line HELD BACK until more bytes arrive or the file is sealed
  (a ``<file>.done`` marker, or mtime-quiet — ``seal_policy``);
  truncation or rotation of a file being read is detected by (inode,
  size) and quarantined through the run's ``BadLineTracker`` instead of
  crashing; a deleted file is logged and skipped; every stat, open and
  read goes through ``utils/retry.py``; one poll reads at most
  ``MAX_POLL_BYTES``.
- **Durable position**: every emitted batch carries in ``stream_pos``
  the watermark payload (per-file byte and line offsets, sealed and
  dead flags, in ledger order) that holds AFTER its lines. The train
  loop adopts a batch's payload only once it has stepped it, and saves
  it beside the step (``watermark-<step>.json``, checkpoint.py), so a
  restore resumes the stream with no example skipped or repeated.
- **Routes**, as the epoch pipeline routes: the serial C++ builder
  (fed one chunk at a time by a single-thread feed, so the byte offset
  at which each batch closed is exact), the ring of ``host_threads``
  builders over complete line groups (positions from cut-time
  accounting), and the generic tolerant path (``bad_line_policy``
  skip/quarantine, or ``max_features_per_example = 0``).

- **Lockstep multi-worker** (``dist_train``): file ownership is by
  ledger index (``i % num_shards``); the ranks agree on the ledger and
  on STOP through the chief's discovery, broadcast over the tracker's
  ``ProcessMesh`` once per driver-loop iteration; the fixed unique
  bucket is the chief's probe of the sealed files present at startup
  (``probe_stream_uniq_bucket``), broadcast; the per-rank watermarks
  merge at every save (``exchange_watermarks``: entry i from its
  owner). Lockstep batches are fixed-shape (the serial C++ builder
  with its single-thread feed, or the generic path).

A ``STOP`` marker in the stream directory ends the run once every
sealed byte is consumed; until then the source reports IDLE.

``vocab_mode = admit``: ``StreamSource(..., vocab=...)`` builds under
``vocab.build_cfg(cfg)`` (ids in the 2^30 hashed space) and remaps each
batch to physical rows before it joins the ready deque, as the epoch
pipeline does.

With a run's telemetry active, the tracker counts
``stream/files_discovered``, ``files_sealed``, ``deleted_files`` and
``truncated_files``, the source feeds ``pipeline_batch`` for every
emitted batch and sets ``pipeline/host_threads``, and an idle poll beats
the watchdog and sets ``stream/watermark_lag_seconds``, as in the JAX
package. In lockstep each rank counts into its own shard: the chief
counts the discoveries it broadcasts, each rank the batches of its own
files, and the discovery broadcast and the watermark exchange are
``collective`` events of the protocol trace.
"""

from __future__ import annotations

import collections
import functools
import glob as globlib
import json
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import cparser
from fast_tffm_tpu_torch.data import pipeline as pl
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.data.parser import WHITESPACE, ParseError
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.retry import (RetryPolicy, open_with_retry,
                                             retry_io)

# What next_batch returns besides a DeviceBatch: IDLE = no batch right
# now (keep polling); DONE = the stream ended (STOP seen and every
# sealed byte consumed, or the caller's stop() asked for an exit).
IDLE = object()
DONE = object()

# Writer protocol markers: ``<file>.done`` seals one shard; ``STOP`` in
# the stream root declares the whole stream finished.
DONE_SUFFIX = ".done"
STOP_MARKER = "STOP"

# mtime-quiet window, in poll intervals: under seal_policy auto|quiet a
# file whose mtime is older than QUIET_POLLS x stream_poll_seconds is
# sealed.
QUIET_POLLS = 3

# Per-poll read budget: a resumed run facing a large sealed backlog
# streams it in bounded rounds instead of one bytes object.
MAX_POLL_BYTES = 64 << 20

WATERMARK_FORMAT = 1

# Lockstep bound on built but unstepped batches: once this many wait,
# each iteration's pump runs discovery alone (its collective) until the
# driver drains some, so a deep sealed backlog is not released into
# memory at MAX_POLL_BYTES an iteration.
LOCKSTEP_READY_CAP = 8


class _FileState:
    """One ledger entry: read plane (released/tail) + durable flags."""

    __slots__ = ("path", "ino", "released", "released_lines", "tail",
                 "sealed", "dead", "end", "resume_bytes",
                 "resume_lines", "late_warned")

    def __init__(self, path: str):
        self.path = path
        self.ino: Optional[int] = None
        self.released = 0          # bytes handed to the consumer
        self.released_lines = 0    # newlines released (error lineno)
        self.tail = b""            # read but held back (no newline yet)
        self.sealed = False
        self.dead = False          # truncated/rotated/deleted: frozen
        self.end: Optional[int] = None  # final byte size once sealed
        self.resume_bytes = 0      # watermark position restored from a
        self.resume_lines = 0      # checkpoint (bytes before it are
        # never re-read)
        self.late_warned = False

    @property
    def eof(self) -> bool:
        """Everything this file will ever hold has been released."""
        if self.dead:
            return True
        return (self.sealed and self.end is not None
                and self.released >= self.end)


class StreamTracker:
    """Discovery and read plane: owns the file ledger, tails the head
    file, decides seal/truncation/deletion, and releases
    newline-terminated byte chunks strictly in ledger order. The
    consumed positions (the watermark) live in ``StreamSource``; the
    tracker only knows how far it has READ. Single-threaded: every
    method runs on the thread that pumps the owning source (the
    prefetch thread, or the lockstep driver's main thread).

    ``shard_index`` / ``num_shards``: this rank owns (reads) the ledger
    entries ``i % num_shards == shard_index``. ``mesh`` (a
    parallel.sharded.ProcessMesh) makes the tracker LOCKSTEP: discovery
    is the chief's, broadcast over the mesh, so every rank appends the
    same ledger entries in the same order and agrees on STOP."""

    def __init__(self, pattern: str, poll_seconds: float,
                 seal_policy: str, retry: Optional[RetryPolicy] = None,
                 bad_lines: Optional[BadLineTracker] = None,
                 watermark: Optional[dict] = None,
                 shard_index: int = 0, num_shards: int = 1,
                 mesh=None, clock=time.monotonic):
        if os.path.isdir(pattern) or not globlib.has_magic(pattern):
            self.root = pattern
            self._glob = os.path.join(pattern, "*")
        else:
            self.root = os.path.dirname(pattern) or "."
            self._glob = pattern
        self.poll_seconds = float(poll_seconds)
        self.seal_policy = seal_policy
        self.retry = retry
        self.bad_lines = bad_lines
        self.shard_index = int(shard_index)
        self.num_shards = max(int(num_shards), 1)
        self.mesh = mesh
        self.lockstep = mesh is not None
        self._clock = clock
        self._log = get_logger()
        self.files: List[_FileState] = []
        self._by_path: Dict[str, int] = {}
        self.stop_seen = False
        self._last_fs_poll: Optional[float] = None
        # When released data first waited unconsumed (the watermark lag
        # gauge's origin; None: caught up).
        self._newest_unconsumed_since: Optional[float] = None
        if watermark:
            self._restore(watermark)

    def watermark_lag_seconds(self) -> float:
        """Seconds released data has waited unconsumed (0 when caught
        up): the ``stream/watermark_lag_seconds`` gauge, coarse by
        design (poll granularity)."""
        if self._newest_unconsumed_since is None:
            return 0.0
        return max(0.0, self._clock() - self._newest_unconsumed_since)

    @staticmethod
    def _tel():
        from fast_tffm_tpu_torch.obs.telemetry import active
        return active()

    def _count(self, name: str, n: float = 1.0) -> None:
        tel = self._tel()
        if tel is not None:
            tel.count(name, n)

    def _restore(self, payload: dict) -> None:
        for rec in payload.get("files", ()):
            fs = _FileState(str(rec["path"]))
            fs.resume_bytes = fs.released = int(rec.get("bytes", 0))
            fs.resume_lines = fs.released_lines = int(
                rec.get("lines", 0))
            fs.sealed = bool(rec.get("sealed", False))
            fs.dead = bool(rec.get("dead", False))
            end = rec.get("end")
            fs.end = int(end) if end is not None else None
            ino = rec.get("ino")
            # The persisted inode carries rotation detection across
            # restarts: a same-path rewrite while the run was down is
            # not resumed mid-file into unrelated content.
            fs.ino = int(ino) if ino is not None else None
            if fs.end is not None:
                fs.released = min(fs.released, fs.end)
                fs.resume_bytes = fs.released
            self._by_path[fs.path] = len(self.files)
            self.files.append(fs)

    def path(self, i: int) -> str:
        return self.files[i].path

    def owned(self, i: int) -> bool:
        return i % self.num_shards == self.shard_index

    @property
    def finished(self) -> bool:
        """STOP declared and every owned file fully released."""
        return self.stop_seen and all(
            fs.eof for i, fs in enumerate(self.files) if self.owned(i))

    def broadcast(self, obj, label: str):
        """The chief's ``obj`` on every rank of a lockstep tracker's mesh
        (identity otherwise)."""
        if not self.lockstep:
            return obj
        return self.mesh.broadcast_object(obj, label)

    # -- discovery --------------------------------------------------------
    def _discover_local(self) -> Tuple[List[str], bool]:
        """(new paths in sorted order, stop marker seen); at most one
        real glob per poll interval."""
        now = self._clock()
        if (self._last_fs_poll is not None
                and now - self._last_fs_poll < self.poll_seconds):
            return [], self.stop_seen
        self._last_fs_poll = now
        stop = os.path.exists(os.path.join(self.root, STOP_MARKER))
        try:
            hits = retry_io(globlib.glob, self._glob,
                            policy=self.retry, op="stream_discover")
        except OSError:
            self._log.warning("stream discovery failed on %s; will "
                              "retry next poll", self._glob,
                              exc_info=True)
            return [], stop
        new = []
        for p in sorted(hits):
            name = os.path.basename(p)
            if (name == STOP_MARKER or name.startswith(".")
                    or name.endswith(DONE_SUFFIX)):
                continue
            if not os.path.isfile(p):
                continue
            if p not in self._by_path:
                new.append(p)
        return new, stop

    def discover(self) -> None:
        """One discovery round. Lockstep: the chief's view is broadcast
        (the one collective the stream adds per driver-loop iteration;
        the caller keeps the cadence)."""
        if not self.lockstep:
            new, stop = self._discover_local()
        else:
            payload = None
            if self.mesh.rank == 0:
                new, stop = self._discover_local()
                payload = {"new": list(new), "stop": bool(stop)}
            payload = self.broadcast(payload, "stream/discovery")
            new, stop = payload["new"], bool(payload["stop"])
        for p in new:
            self._by_path[p] = len(self.files)
            self.files.append(_FileState(p))
            self._count("stream/files_discovered")
            self._log.info("stream: discovered shard %s (ledger index "
                           "%d)", p, self._by_path[p])
        if stop and not self.stop_seen:
            self.stop_seen = True
            self._log.info("stream: STOP marker seen; will finish once "
                           "every sealed byte is consumed")

    # -- the read plane ---------------------------------------------------
    def poll(self, read: bool = True) -> List[Tuple[int, bytes]]:
        """One service round: discovery, then tail the owned head
        file(s), releasing newline-terminated chunks in strict ledger
        order. Several sealed files can drain in one round; an unsealed
        head blocks everything behind it. ``read=False`` runs discovery
        alone (the lockstep cadence while enough batches wait)."""
        self.discover()
        if not read:
            return []
        out: List[Tuple[int, bytes]] = []
        budget = MAX_POLL_BYTES
        for i, fs in enumerate(self.files):
            if not self.owned(i) or fs.eof:
                continue
            chunk = self._service(fs, budget)
            if chunk:
                out.append((i, chunk))
                budget -= len(chunk)
            if budget <= 0:
                break  # bounded round: the backlog continues next poll
            if not fs.eof:
                break  # strict order: don't read past an open head
        if out and self._newest_unconsumed_since is None:
            self._newest_unconsumed_since = self._clock()
        return out

    def _mark_dead(self, fs: _FileState, why: str,
                   quarantine: bool) -> None:
        fs.dead = True
        fs.tail = b""
        fs.end = fs.released
        self._count("stream/truncated_files" if quarantine
                    else "stream/deleted_files")
        self._log.warning("stream: %s: %s; sealing at byte %d and "
                          "skipping the rest", fs.path, why,
                          fs.released)
        if self.bad_lines is not None and quarantine:
            # Truncation/rotation counts toward the max_bad_fraction
            # breaker like any other damaged input.
            self.bad_lines.record(fs.path, fs.released_lines + 1, "",
                                  f"stream file {why}")

    def _service(self, fs: _FileState, budget: int) -> bytes:
        """Tail one live file: read fresh bytes (at most ``budget``),
        hold back the torn trailing line, apply the seal decision.
        Returns the released chunk (possibly empty)."""
        try:
            st = retry_io(os.stat, fs.path, policy=self.retry,
                          op="stream_stat")
        except FileNotFoundError:
            self._mark_dead(fs, "deleted before it was fully consumed",
                            quarantine=False)
            return b""
        except OSError:
            self._log.warning("stream: stat of %s failed; retrying "
                              "next poll", fs.path, exc_info=True)
            return b""
        if fs.ino is None:
            fs.ino = st.st_ino
        elif st.st_ino != fs.ino:
            self._mark_dead(fs, "rotated (inode changed) mid-stream",
                            quarantine=True)
            return b""
        read_off = fs.released + len(fs.tail)
        if st.st_size < read_off:
            self._mark_dead(
                fs, f"truncated mid-stream ({st.st_size} bytes on disk "
                    f"< {read_off} already read)", quarantine=True)
            return b""
        limit = st.st_size
        if fs.sealed and fs.end is not None:
            if st.st_size > fs.end and not fs.late_warned:
                fs.late_warned = True
                self._log.warning(
                    "stream: %s grew after it was sealed (%d -> %d "
                    "bytes); late bytes are ignored — fix the writer "
                    "or use seal_policy = done", fs.path, fs.end,
                    st.st_size)
            if st.st_size < fs.end:
                # A sealed file that shrank below its recorded size
                # would never reach eof and wedge the stream.
                self._mark_dead(
                    fs, f"truncated after seal ({st.st_size} bytes on "
                        f"disk < sealed size {fs.end})", quarantine=True)
                return b""
            # A restored sealed file reads exactly up to its sealed
            # size: bytes appended after the seal never train.
            limit = min(limit, fs.end)
        limit = min(limit, read_off + max(budget, 0))
        if limit > read_off:
            try:
                fs.tail += self._read_range(fs.path, read_off, limit)
            except FileNotFoundError:
                self._mark_dead(
                    fs, "deleted before it was fully consumed",
                    quarantine=False)
                return b""
            except OSError:
                self._log.warning(
                    "stream: read of %s failed after retries; will "
                    "retry next poll", fs.path, exc_info=True)
                return b""
        if not fs.sealed and self._seal_due(fs, st):
            fs.sealed = True
            # The file's FULL size at seal time, re-stated: the .done
            # marker may have appeared, with the shard's final bytes,
            # after the stat above.
            try:
                fs.end = retry_io(os.stat, fs.path, policy=self.retry,
                                  op="stream_stat").st_size
            except OSError:
                fs.end = st.st_size
            self._count("stream/files_sealed")
            self._log.info("stream: sealed %s at %d bytes", fs.path,
                           fs.end)
        at_end = (fs.sealed and fs.end is not None
                  and fs.released + len(fs.tail) >= fs.end)
        if at_end:
            chunk = fs.tail
            fs.tail = b""
            fs.released += len(chunk)
            if chunk and not chunk.endswith(b"\n"):
                # A final line without its newline is terminated where
                # the epoch path's ``feed(tail + b"\n")`` would; the
                # consumer's position clamps at ``end``.
                chunk += b"\n"
            fs.released_lines += chunk.count(b"\n")
            return chunk
        # Not at the end yet: release whole lines only.
        cut = fs.tail.rfind(b"\n")
        if cut < 0:
            return b""  # torn trailing line: held back in full
        chunk, fs.tail = fs.tail[:cut + 1], fs.tail[cut + 1:]
        fs.released += len(chunk)
        fs.released_lines += chunk.count(b"\n")
        return chunk

    def _seal_due(self, fs: _FileState, st) -> bool:
        if self.stop_seen:
            return True  # the writer declared the stream finished
        if self.seal_policy in ("auto", "done") and os.path.exists(
                fs.path + DONE_SUFFIX):
            return True
        if self.seal_policy in ("auto", "quiet"):
            quiet = QUIET_POLLS * self.poll_seconds
            return time.time() - st.st_mtime >= quiet
        return False

    def _read_range(self, path: str, start: int, end: int) -> bytes:
        """[start, end) of ``path``, chunked, each read retried after a
        seek back (a partial buffered read advances the fd)."""
        fh = (open(path, "rb") if self.retry is None else
              open_with_retry(path, "rb", policy=self.retry,
                              op="stream_open"))
        parts = []
        with fh:
            pos = start
            while pos < end:
                want = min(4 << 20, end - pos)

                def attempt(p=pos, w=want):
                    fh.seek(p)
                    return fh.read(w)
                b = (attempt() if self.retry is None else
                     retry_io(attempt, policy=self.retry,
                              op="stream_read"))
                if not b:
                    break  # a racing writer shrank below the stat size
                parts.append(b)
                pos += len(b)
        return b"".join(parts)


class StreamSource:
    """Arrival-ordered DeviceBatch source over a StreamTracker.

    ``next_batch(block=...)`` returns a DeviceBatch, ``IDLE`` or
    ``DONE``; every batch carries ``stream_pos``, the watermark payload
    after its lines. The route (serial C++ builder, the ring of
    ``workers`` builders, or the generic tolerant path) is chosen once,
    here, by ``stream_workers``' predicate. ``raw_ids``: as
    ``batch_iterator``'s (True for the ``dedup = device`` step).
    ``fixed_shape`` / ``uniq_bucket``: the lockstep shape (host dedup,
    L at the ladder top, U the bucket; a batch whose unique rows would
    overflow the bucket closes early, the spill, and ``stats`` counts
    it). ``vocab``: the run's slot map (``vocab_mode = admit``);
    batches are built under ``vocab.build_cfg(cfg)`` and remapped
    before the ready deque."""

    def __init__(self, cfg: FmConfig, tracker: StreamTracker,
                 stop=None, raw_ids: bool = True, workers: int = 1,
                 bad_lines: Optional[BadLineTracker] = None, vocab=None,
                 fixed_shape: bool = False, uniq_bucket: int = 0):
        self._vocab = vocab
        # The BUILD-side config: every parser and builder below mods ids
        # into the hashed space under admit mode.
        cfg = cfg if vocab is None else vocab.build_cfg(cfg)
        self.cfg = cfg
        self.tracker = tracker
        self._stop_cb = stop or (lambda: False)
        self.B = cfg.batch_size
        self.raw_ids = raw_ids
        self.fixed_shape = fixed_shape
        self.uniq_bucket = uniq_bucket
        self.bad_lines = bad_lines
        self.stats = pl.SpillStats()
        # Arrival order by design: no shuffle window (cfg.shuffle has
        # no effect here), which also makes the watermark a per-file
        # prefix.
        self._emitter = pl._BatchEmitter(cfg, self.B, shuffle=False,
                                         seed=cfg.seed,
                                         fixed_shape=fixed_shape,
                                         uniq_bucket=uniq_bucket,
                                         stats=self.stats)
        self._ready: collections.deque = collections.deque()
        self._pos: Dict[int, Tuple[int, int]] = {}  # idx -> (bytes, lines)
        for i, fs in enumerate(tracker.files):
            if fs.resume_bytes or fs.resume_lines:
                self._pos[i] = (fs.resume_bytes, fs.resume_lines)
        self._flushed = False
        self._closed = False
        self._fast = pl._fast_path_eligible(cfg, ())
        self._workers = (max(int(workers), 1)
                         if self._fast and not fixed_shape else 1)
        self._ring = None
        if self._fast:
            if self._workers > 1:
                # Ring builders consume whole pre-cut groups and the
                # positions come from cut-time accounting, so their
                # threaded feed is safe.
                self._make_builder = functools.partial(
                    pl._make_builder, cfg, self.B, raw_ids, False,
                    pl._worker_feed_threads(self._workers))
                self._init_ring()
            else:
                # The serial builder NEEDS the single-thread feed: the
                # watermark is the exact byte offset at which each
                # batch closed (and a spill re-feeds from it), which a
                # threaded feed hides (it takes the whole chunk at once).
                self._bb = pl._make_builder(
                    cfg, self.B, raw_ids, False, 1,
                    uniq_bucket=uniq_bucket if fixed_shape else 0)
        else:
            self._pending: List[Tuple[str, int, int, int]] = []
            # (line, file_idx, abs_byte_end, abs_lineno)
            self._decoded: Dict[int, Tuple[int, int]] = {}
            # raw decode position per file (covers trailing blank
            # lines at the final flush)
        # Error provenance: (stream_lines_before, file_idx,
        # resume_line_offset) per file as it starts feeding.
        self._spans: List[Tuple[int, int, int]] = []
        self._stream_lines = 0

    # -- shared plumbing --------------------------------------------------
    def _snapshot(self) -> dict:
        files = []
        for i, fs in enumerate(self.tracker.files):
            b, l = self._pos.get(i, (0, 0))
            if fs.end is not None:
                b = min(b, fs.end)
            files.append({"path": fs.path, "bytes": int(b),
                          "lines": int(l), "sealed": bool(fs.sealed),
                          "dead": bool(fs.dead), "end": fs.end,
                          "ino": fs.ino})
        return {"format": WATERMARK_FORMAT, "files": files}

    def _advance(self, fi: int, nbytes: int, nlines: int) -> None:
        b, l = self._pos.get(fi, (self.tracker.files[fi].resume_bytes,
                                  self.tracker.files[fi].resume_lines))
        self._pos[fi] = (b + nbytes, l + nlines)

    def _remap(self, batch):
        return batch if self._vocab is None else self._vocab.remap(batch)

    def _emit(self, out, spilled: bool = False) -> None:
        for batch in self._emitter.emit_drain(out, spilled):
            batch = self._remap(batch)
            batch.stream_pos = self._snapshot()
            self._tel_batch(batch)
            self._ready.append(batch)

    def _tel_batch(self, batch) -> None:
        """Feed one emitted batch to the pipeline counters (after the
        remap: the padding counters read the physical pad_id)."""
        tel = StreamTracker._tel()
        if tel is not None:
            tel.pipeline_batch(batch, self.cfg.pad_id)

    def _note_file_start(self, fi: int) -> None:
        if not self._spans or self._spans[-1][1] != fi:
            fs = self.tracker.files[fi]
            self._spans.append((self._stream_lines, fi,
                                fs.resume_lines))

    def _attach_source(self, e: ParseError) -> ParseError:
        """Builder-stream "line N" -> file and absolute line number,
        through the span map and each file's resume offset (a resumed
        builder never saw the lines before the watermark)."""
        m = pl._LINE_MSG.match(str(e))
        if not m or not self._spans:
            return e
        n = int(m.group(1))
        owner = self._spans[0]
        for rec in self._spans:
            if rec[0] < n:
                owner = rec
            else:
                break
        base, fi, resume = owner
        return ParseError(f"{self.tracker.path(fi)} line "
                          f"{resume + (n - base)}: {m.group(2)}")

    # -- the pump ---------------------------------------------------------
    def _pump(self, read: bool = True) -> None:
        for fi, data in self.tracker.poll(read=read):
            if not self._fast:
                self._generic_feed(fi, data)
            elif self._ring is not None:
                self._scan_feed(fi, data)
            else:
                self._note_file_start(fi)
                self._serial_feed(fi, data)
        if self._ring is not None:
            self._ring_drive()
        if self.tracker.finished and not self._flushed:
            self._flush_final()

    def _flush_final(self) -> None:
        self._flushed = True
        if not self._fast:
            self._generic_flush(final=True)
        elif self._ring is not None:
            self._ring_flush()
        else:
            out = self._bb.finish()
            if out[0]:
                self._emit(out)

    # -- serial fast path -------------------------------------------------
    def _serial_feed(self, fi: int, data: bytes) -> None:
        off = 0
        while True:
            try:
                full, c = self._bb.feed(data, off)
            except ParseError as e:
                raise self._attach_source(e) from None
            nl = data.count(b"\n", off, off + c)
            self._advance(fi, c, nl)
            self._stream_lines += nl
            off += c
            if not full:
                return
            try:
                out = self._bb.finish()
            except ParseError as e:
                raise self._attach_source(e) from None
            # Under the fixed unique budget a batch that closed short is
            # the spill; its next line is still at data[off:] and
            # re-feeds on the next turn.
            self._emit(out, spilled=self.fixed_shape and out[0] < self.B)

    # -- the ring of builders (host_threads > 1) --------------------------
    def _init_ring(self) -> None:
        self._ring = pl._BuildRing(
            self._workers, depth=2 * self._workers,
            work=pl._fast_group_work,
            make_state=lambda: pl._FastWorkerState(self._make_builder))
        self._buf = b""
        self._buf_pos = 0
        self._segments: collections.deque = collections.deque()
        # [file_idx, remaining_length] per appended chunk, FIFO
        self._inflight: collections.deque = collections.deque()
        # (seq, positions) in submit order
        # Cut-side counters, apart from the emission-side watermark
        # (self._pos): groups are cut ahead of their build, and a
        # batch's watermark must never include a later group's lines.
        self._cut_pos: Dict[int, Tuple[int, int]] = dict(self._pos)
        tel = StreamTracker._tel()
        if tel is not None:
            tel.set("pipeline/host_threads", self._workers)

    def _scan_feed(self, fi: int, data: bytes) -> None:
        self._buf = self._buf[self._buf_pos:] + data
        self._buf_pos = 0
        self._segments.append([fi, len(data)])

    def _cut_positions(self, consumed: int) -> Dict[int, Tuple[int, int]]:
        """Advance the cut-side counters by ``consumed`` bytes off the
        buffer head; returns the ABSOLUTE (bytes, lines) per touched
        file after the cut, and records the error-span map in cut-line
        units (those of group.line_start)."""
        out: Dict[int, Tuple[int, int]] = {}
        taken = 0
        while taken < consumed:
            seg = self._segments[0]
            fi, seg_len = seg
            self._note_file_start(fi)
            n = min(seg_len, consumed - taken)
            nl = self._buf.count(b"\n", self._buf_pos + taken,
                                 self._buf_pos + taken + n)
            b, l = self._cut_pos.get(
                fi, (self.tracker.files[fi].resume_bytes,
                     self.tracker.files[fi].resume_lines))
            self._cut_pos[fi] = (b + n, l + nl)
            self._stream_lines += nl
            out[fi] = self._cut_pos[fi]
            taken += n
            if n == seg_len:
                self._segments.popleft()
            else:
                seg[1] -= n
        return out

    def _cut_one_group(self, consumed: int) -> None:
        blob = self._buf[self._buf_pos:self._buf_pos + consumed]
        line_start = self._stream_lines
        positions = self._cut_positions(consumed)
        self._buf_pos += consumed
        seq = self._ring.submit(
            pl._Group(blob, line_start, blob.count(b"\n")))
        self._inflight.append((seq, positions))

    def _ring_drive(self) -> None:
        """Cut complete groups (B example lines of released,
        newline-terminated bytes), submit them, and harvest every
        finished head; torn tails stay in the tracker and sub-B
        leftovers in this buffer."""
        while len(self._inflight) < self._ring.depth:
            found, consumed, _nl = cparser.scan_examples(
                self._buf, self.B, False, offset=self._buf_pos)
            if found < self.B:
                break
            self._cut_one_group(consumed)
        self._harvest(block=False)

    def _harvest(self, block: bool) -> None:
        while self._inflight:
            seq, positions = self._inflight[0]
            if not block and not self._ring.has(seq):
                return
            self._inflight.popleft()
            kind, payload = self._ring.wait(seq)
            if kind == "error":
                if isinstance(payload, ParseError):
                    raise self._attach_source(payload) from None
                raise payload
            self._pos.update(positions)
            self._emit(payload)

    def _ring_flush(self) -> None:
        while True:
            found, consumed, _nl = cparser.scan_examples(
                self._buf, self.B, False, offset=self._buf_pos)
            if not found:
                break
            self._cut_one_group(consumed)
            if found < self.B:
                break  # the final short group
        self._harvest(block=True)

    # -- generic tolerant path --------------------------------------------
    def _generic_feed(self, fi: int, data: bytes) -> None:
        # Decode positions continue from the per-file decode cursor,
        # not from _pos (which only advances at emission): a file
        # released across several polls would otherwise tag later
        # lines with offsets from its last emitted batch.
        b, l = self._decoded.get(
            fi, (self.tracker.files[fi].resume_bytes,
                 self.tracker.files[fi].resume_lines))
        for raw in data.split(b"\n")[:-1]:
            b += len(raw) + 1
            l += 1
            line = raw.decode("utf-8")
            if line.strip(WHITESPACE):
                self._pending.append((line, fi, b, l))
            self._stream_lines += 1
        fs = self.tracker.files[fi]
        if fs.end is not None:
            b = min(b, fs.end)
        self._decoded[fi] = (b, l)
        while len(self._pending) >= self.B:
            self._generic_flush(final=False)

    def _generic_flush(self, final: bool) -> None:
        take = self._pending[:self.B]
        if not take:
            if final:
                self._final_positions()
            return
        del self._pending[:self.B]
        lines = [t[0] for t in take]
        if self.bad_lines is None:
            try:
                block = pl._parse_block(lines, self.cfg)
            except ParseError as e:
                _, fi, _, ln = take[0]
                raise ParseError(
                    f"{self.tracker.path(fi)} near line {ln}: "
                    f"{pl._strip_line_prefix(str(e))}") from None
        else:
            bads: List[Tuple[int, str, str]] = []
            block = pl._salvage_block(lines, self.cfg, False, bads)
            self.bad_lines.count_ok(len(lines) - len(bads))
            for i, raw, msg in bads:
                _, fi, _, ln = take[i]
                self.bad_lines.record(self.tracker.path(fi), ln, raw,
                                      pl._strip_line_prefix(msg))
        if block.batch_size:
            out_batch = self._remap(pl.make_device_batch(
                block, self.cfg, self.B, raw_ids=self.raw_ids,
                dedup=cparser.dedup_ids_fast, fixed_shape=self.fixed_shape,
                uniq_bucket=self.uniq_bucket))
            # EVERY file the chunk touches advances: a batch spanning a
            # file boundary records the earlier files' final positions
            # too (files are consumed in ledger order, so each file's
            # last line in the chunk IS its consumed-through position).
            for _, fi, byte_end, line_end in take:
                self._pos[fi] = (byte_end, line_end)
            out_batch.stream_pos = self._snapshot()
            self.stats.count(out_batch.num_real, self.B, False,
                             num_uniq=pl._num_uniq(out_batch.uniq_ids,
                                                   self.cfg.pad_id))
            self._tel_batch(out_batch)
            self._ready.append(out_batch)
        if final:
            while self._pending:
                self._generic_flush(final=False)
            self._final_positions()

    def _final_positions(self) -> None:
        for fi, pos in self._decoded.items():
            self._pos[fi] = pos

    # -- the public surface -----------------------------------------------
    def next_batch(self, block: bool = False):
        """One batch, IDLE or DONE. ``block=True`` (the prefetch
        thread) sleeps between polls and returns DONE promptly once the
        caller's stop() (preemption) or close() asks.

        A LOCKSTEP tracker's source runs exactly one pump a call (one
        discovery collective), even with a batch queued or the rank
        drained, so every rank's collective sequence stays aligned; its
        read plane pauses while LOCKSTEP_READY_CAP batches wait.
        Preemption and the exit are the driver's flags all-gather, never
        decided here."""
        if self.tracker.lockstep:
            self._pump(read=len(self._ready) < LOCKSTEP_READY_CAP)
            if self._ready:
                return self._ready.popleft()
            return DONE if self._flushed else IDLE
        if self._stop_cb():
            return DONE
        if not block:
            if not self._ready and not self._flushed:
                self._pump()
            if self._ready:
                return self._ready.popleft()
            return DONE if self._flushed else IDLE
        while True:
            if self._ready:
                return self._ready.popleft()
            if self._flushed or self._stop_cb() or self._closed:
                return DONE
            self._pump()
            if self._ready or self._flushed:
                continue
            tel = StreamTracker._tel()
            if tel is not None:
                tel.heartbeat()
                tel.set("stream/watermark_lag_seconds",
                        self.tracker.watermark_lag_seconds())
            time.sleep(min(self.tracker.poll_seconds, 0.2))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._ring is not None:
            self._ring.close()


class StreamPrefetcher:
    """Build/compute overlap for a StreamSource: a producer thread
    (``fmt-stream-prefetch``) pulls ``next_batch(block=True)`` into a
    bounded queue; ``get(timeout)`` returns a batch, ``IDLE`` when none
    came within ``timeout`` — so the train loop's publish clock and
    preemption checks keep ticking on a quiet stream — or ``DONE``.
    Producer errors re-raise at the next get. ``close()`` closes the
    source first, which releases a producer parked in its poll loop,
    and joins the thread."""

    def __init__(self, source: StreamSource, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._source = source
        self._thread = threading.Thread(target=self._main,
                                        name="fmt-stream-prefetch",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _main(self) -> None:
        try:
            while not self._stop.is_set():
                b = self._source.next_batch(block=True)
                self._put(("done", None) if b is DONE else ("batch", b))
                if b is DONE:
                    return
        except BaseException as e:  # re-raised at the consumer's get
            self._put(("error", e))

    def get(self, timeout: float):
        """A DeviceBatch, IDLE (nothing within ``timeout``), or DONE."""
        try:
            kind, val = self._q.get(timeout=max(timeout, 0.01))
        except queue.Empty:
            return IDLE
        if kind == "error":
            raise val
        if kind == "done":
            return DONE
        return val

    def close(self) -> None:
        self._stop.set()
        self._source.close()
        self._thread.join(timeout=5.0)


def stream_workers(cfg: FmConfig, fixed_shape: bool = False) -> int:
    """The builder count the stream source will use: the resolved
    ``host_threads`` where the ring route exists (the C++ fast path: a
    strict bad-line policy and a bounded per-example cap; not the
    fixed-shape lockstep input, whose spill re-feed is serial), else
    1."""
    workers = pl.resolve_host_threads(cfg)
    if workers <= 1 or fixed_shape or not pl._fast_path_eligible(cfg, ()):
        return 1
    return workers


def probe_stream_uniq_bucket(cfg: FmConfig, tracker: StreamTracker) -> int:
    """The fixed unique-row bucket of lockstep stream input: the
    pipeline's probe (``probe_uniq_bucket``) over the SEALED files
    present at startup — a ``.done`` marker, a restored sealed flag, or
    under ``seal_policy`` auto|quiet an mtime past the quiet window —
    or ``min(1024, uniq_bucket_top)`` when there are none. The chief
    decides and broadcasts it: no rank probes bytes a writer may still
    be appending. Every rank calls it once, before the step loop (the
    discovery inside is collective in lockstep)."""
    tracker.discover()

    def decide() -> int:
        quiet_ok = tracker.seal_policy in ("auto", "quiet")
        quiet = QUIET_POLLS * tracker.poll_seconds
        candidates = []
        for fs in tracker.files:
            try:
                st = os.stat(fs.path)
            except OSError:
                continue
            # No tracker service has run yet, so fs.sealed alone would
            # leave every quiet-policy stream on the fallback bucket.
            if st.st_size > 0 and not fs.dead and (
                    fs.sealed or os.path.exists(fs.path + DONE_SUFFIX)
                    or (quiet_ok and time.time() - st.st_mtime >= quiet)):
                candidates.append(fs.path)
        if not candidates:
            return min(1 << 10, pl.uniq_bucket_top(cfg))
        return pl.probe_uniq_bucket(cfg, candidates)

    if not tracker.lockstep:
        return decide()
    val = {"bucket": decide()} if tracker.mesh.rank == 0 else None
    return int(tracker.broadcast(val, "stream/uniq_bucket")["bucket"])


def exchange_watermarks(local: dict, mesh) -> dict:
    """The merged watermark of a lockstep save point: every rank
    all-gathers its adopted payload (its length, then its bytes, under
    the deadline guard) and ``merge_watermark_payloads`` takes ledger
    entry i from its owner. Every rank returns the same payload, which
    the chief writes. Identity without a mesh of more than one rank."""
    if mesh is None or mesh.size <= 1:
        return local
    data = json.dumps(local).encode("utf-8")
    lens = mesh.all_gather_host(np.asarray([len(data)], np.int64),
                                "stream/watermark_len").reshape(-1)
    buf = np.zeros(max(int(lens.max()), 1), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    gathered = mesh.all_gather_host(buf, "stream/watermark_merge")
    payloads = [json.loads(gathered[r, :int(lens[r])].tobytes()
                           .decode("utf-8"))
                for r in range(len(lens))]
    return merge_watermark_payloads(payloads, mesh.size)


def merge_watermark_payloads(payloads: Sequence[dict],
                             num_shards: int) -> dict:
    """The pure merge behind ``exchange_watermarks``: ledger entry i
    comes from its owner's payload (``i % num_shards``), the only rank
    whose positions for that file advance. The loop runs over the
    LONGEST ledger: a rank that stepped only fillers lately ships a
    short, maybe empty, list, and iterating the chief's would drop an
    owner's later entries. An owner with no record of an entry yet
    (nothing of it stepped) takes it from any payload that has it: the
    zero position and the discovery flags. The ledger's order is the
    chief's, so index i names one file in every payload that has it."""
    merged = {"format": WATERMARK_FORMAT, "files": []}
    n_files = max(len(p.get("files", ())) for p in payloads)
    for i in range(n_files):
        owner_files = payloads[i % num_shards].get("files", ())
        if i < len(owner_files):
            merged["files"].append(owner_files[i])
            continue
        for p in payloads:
            files = p.get("files", ())
            if i < len(files):
                merged["files"].append(files[i])
                break
    return merged

