"""Host input pipeline: text files -> padded [B, L] batches.

The port of ``fast_tffm_tpu/data/pipeline.py`` (its telemetry aside):

- ``batch_iterator`` routes each input to one of three paths, by the
  JAX package's own predicate (``_fast_path_eligible``):
  - the chunked C++ fast path: raw file bytes stream into the port's
    C++ ``BatchBuilder`` (parse, hash, dedup and padded scatter in one
    native pass), serially (``_fast_batch_iterator``) or fanned out
    over ``host_threads`` builder threads (``_parallel_fast_batch_
    iterator``), with one bit-identical stream for any thread count;
  - the generic path (weight files, a tolerant ``bad_line_policy``,
    ``max_features_per_example = 0``): the ``queue_size`` reservoir
    shuffle over lines, block parse in C++ with a per-line Python
    salvage only for a failing block, and ``make_device_batch``;
  the stream is the JAX package's ``batch_iterator`` with the same
  arguments, array for array, ``raw_ids`` true or false;
- ``make_device_batch``, the plain padded batch of a parsed block, with
  the host-side unique pass when ``raw_ids`` is off (``_uniq_ladder``);
- ``plain_batch_iterator``, the fast path's stream built with the
  pure-Python parser and ``make_device_batch``: the plain version tests
  and ``chip_smoke.py`` hold the C++ stream against;
- ``prefetch``: one background thread, ``depth`` batches ahead.

Multi-process input (``dist_train``): each worker reads its byte range
of every file (``shard_byte_range``: a line belongs to the range its
first byte falls in), on every route; ``fixed_shape`` batches have one
L and one U (``uniq_bucket``, measured by ``probe_uniq_bucket``) on
every rank, and a batch whose unique ids would overflow the bucket
closes early (the spill: the serial C++ builder's budget close, the
generic path's ``UniqOverflow`` requeue; fixed-shape input never takes
the parallel plane), counted in
``SpillStats``; ``empty_batch`` is the filler of a rank whose shard ran
dry.

There is no Python fallback: when the C++ library cannot be built,
``batch_iterator`` raises (data/cparser.py). With a run's telemetry
active (obs/), ``batch_iterator`` times each built batch on the
producing side (``pipeline/build`` span, ``RunTelemetry.pipeline_batch``
counters), the build rings set ``pipeline/host_threads`` and
``pipeline/ring_occupancy`` and time their workers, a spill counts
``pipeline/spilled_batches``, and ``prefetch`` registers its window in
the memory ledger (``prefetch_batches``, host-resident), as in the JAX
package.

``vocab_mode = admit`` (vocab/table.py): ``batch_iterator`` and
``plain_batch_iterator`` take the run's ``vocab`` map, build every
batch under ``vocab.build_cfg(cfg)`` (ids mod into the 2^30 hashed
space, whose pad sentinel is 2^30) and remap it to physical rows on the
producing side, before a prefetch queue or the wire sees it. Without a
map the stream is the fixed mode's, unchanged.

Padding invariants, as in the JAX package: pad cells of ``vals`` hold
0.0; in raw-ids batches pad cells of ``local_idx`` hold ``pad_id ==
vocabulary_size`` (the table's dead zero row); in host-deduped batches
``uniq_ids`` pads with pad_id and ``local_idx``'s pad cells point at a
pad_id slot, so a pad slot adds exactly zero to a score and a gradient;
pad examples have weight 0.0 and no features. Field-aware (FFM)
batches carry ``fields``, 0 on pad cells, and every route (the serial
and parallel fast paths, the generic path, the plain stream, raw ids
and host dedup) slices and shuffles them with the rest of the batch.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import glob as globlib
import os
import queue
import random
import re
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import cparser
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.obs.memory import LEDGER
from fast_tffm_tpu_torch.obs.telemetry import active
from fast_tffm_tpu_torch.obs.trace import span
from fast_tffm_tpu_torch.data.parser import (WHITESPACE, ParsedBlock,
                                             ParseError, parse_lines)
from fast_tffm_tpu_torch.utils.retry import (RetryPolicy, open_with_retry,
                                             retry_io)

# (path, 1-based line number) of one input line.
Source = Tuple[str, int]


class UniqOverflow(ValueError):
    """A batch's unique-id count exceeds the fixed unique bucket; the
    caller must spill (emit a prefix of the batch and requeue the rest)."""


@dataclasses.dataclass
class SpillStats:
    """Spill accounting of fixed-U (multi-process) input: a batch whose
    unique ids exceed ``uniq_bucket`` closes early with fewer real
    examples — correct, but it costs throughput, so train logs these
    counts per epoch and feeds them to ``train.adapt_uniq_bucket``."""
    batches: int = 0            # batches emitted
    spilled_batches: int = 0    # closed early on the unique-row budget
    real_examples: int = 0      # non-padding examples emitted
    capacity: int = 0           # batches * batch_size
    max_uniq: int = 0           # the densest batch's unique-row count

    def count(self, num_real: int, batch_size: int,
              spilled: bool, num_uniq: int = 0) -> None:
        self.batches += 1
        self.spilled_batches += int(spilled)
        self.real_examples += num_real
        self.capacity += batch_size
        self.max_uniq = max(self.max_uniq, num_uniq)
        if spilled:
            # The one counting point for spills: the stream and the
            # epoch log line cannot drift.
            tel = active()
            if tel is not None:
                tel.count("pipeline/spilled_batches")

    @property
    def spill_fraction(self) -> float:
        return self.spilled_batches / self.batches if self.batches else 0.0

    @property
    def fill_fraction(self) -> float:
        return (self.real_examples / self.capacity if self.capacity
                else 1.0)

    def describe(self) -> str:
        return (f"{self.batches} batches, {self.real_examples} examples "
                f"(fill {self.fill_fraction:.1%}), "
                f"{self.spilled_batches} spilled "
                f"({self.spill_fraction:.1%})")


# Above this spilled-batch fraction an undersized uniq_bucket visibly
# degrades the pipeline, and train warns with the fix.
SPILL_WARN_FRACTION = 0.1


def require_bounded_examples(cfg: FmConfig, context: str) -> None:
    """Fixed-shape modes cap L at the ladder top; refuse up front a
    config whose examples could exceed it. max_features_per_example = 0
    means "unlimited", which can never be honored under a fixed L."""
    if not (0 < cfg.max_features_per_example <= cfg.bucket_ladder[-1]):
        raise ValueError(
            f"{context} needs 0 < max_features_per_example "
            f"({cfg.max_features_per_example}) <= bucket_ladder max "
            f"({cfg.bucket_ladder[-1]}) so over-long examples are "
            "truncated up front instead of faulting one worker mid-run")


def effective_L_cap(cfg: FmConfig) -> int:
    """The builder's row width: the ladder rung (a power of two past the
    top if needed) covering max_features_per_example."""
    return _ladder_fit(
        max(cfg.bucket_ladder[-1], cfg.max_features_per_example),
        cfg.bucket_ladder)


@dataclasses.dataclass
class DeviceBatch:
    """One padded batch of B examples with L feature slots each.

    Raw-ids mode (``dedup = device``): ``uniq_ids`` is None and
    ``local_idx`` holds raw table rows (pad cells = pad_id). Host-dedup
    mode: ``uniq_ids`` [U] holds the batch's unique rows (pad_id
    padding) and ``local_idx`` indexes it. ``fields`` only for a
    field-aware model (FFM)."""
    labels: np.ndarray       # f32 [B]
    weights: np.ndarray      # f32 [B]; 0.0 marks padded dummy examples
    local_idx: np.ndarray    # i32 [B, L]; raw row ids, or into uniq_ids
    vals: np.ndarray         # f32 [B, L]; 0.0 padding
    num_real: int = 0        # examples that are not padding
    uniq_ids: Optional[np.ndarray] = None  # i32 [U]; None = raw ids
    fields: Optional[np.ndarray] = None    # i32 [B, L]; 0 padding (FFM)
    # run_mode = stream: the watermark payload after this batch's lines
    # (data/stream.py); None for every other source.
    stream_pos: Optional[dict] = None
    # vocab_mode = admit only (vocab/table.py): the batch's distinct
    # hashed ids, attached by the remap and fed to the sketch only once
    # the batch is stepped (adopt-on-step, as stream_pos); the slot-map
    # generation the remap ran under and the hash-space originals, so
    # ensure_current can redo a remap a barrier made stale.
    vocab_obs: Optional[np.ndarray] = None
    vocab_gen: Optional[int] = None
    vocab_src: Optional[tuple] = None


class FileMarks:
    """Per-file example-offset ledger of a single-pass keep_empty sweep:
    the cross-file scorer's demux map (scoring.py).

    The pipeline appends ``(path, examples_before)`` as each file starts
    feeding, before any batch holding that file's first example is
    yielded; under ``keep_empty`` every line is one example, so file i's
    examples span ``[starts[i], starts[i+1])`` of the stream. Thread-safe:
    the producing side runs on the prefetch or scanner thread, the
    reading side on the fetch worker."""

    def __init__(self):
        self._lock = threading.Lock()
        self._starts: List[Tuple[str, int]] = []

    def start_file(self, path: str, examples_before: int) -> None:
        with self._lock:
            self._starts.append((path, int(examples_before)))

    def snapshot(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._starts)


def expand_files(patterns: Sequence[str]) -> List[str]:
    """File list with glob expansion, order-stable; a pattern that
    matches nothing is kept so that opening it fails loudly."""
    out: List[str] = []
    for p in patterns:
        hits = sorted(globlib.glob(p))
        if hits:
            out.extend(hits)
        else:
            out.append(p)
    return out


def expand_paired_files(patterns: Sequence[str],
                        sidecar_patterns: Sequence[str]
                        ) -> Tuple[List[str], List[str]]:
    """Expand a data-file pattern list and its line-parallel sidecar
    pattern list together, one pattern pair at a time, so that sidecars
    can never pair with the wrong files; a per-pattern count mismatch
    fails loudly with the pair named."""
    if len(sidecar_patterns) != len(patterns):
        raise ValueError(
            f"sidecar pattern list must pair 1:1 with its data pattern "
            f"list ({len(sidecar_patterns)} sidecar patterns vs "
            f"{len(patterns)} data patterns); write one sidecar "
            "pattern per data pattern")
    files: List[str] = []
    sidecars: List[str] = []
    for dp, sp in zip(patterns, sidecar_patterns):
        d = expand_files([dp])
        s = expand_files([sp])
        if len(d) != len(s):
            raise ValueError(
                f"sidecar pattern pair expands to mismatched counts: "
                f"{dp!r} -> {len(d)} data files but {sp!r} -> {len(s)} "
                "sidecars; every data file needs exactly one sidecar")
        files.extend(d)
        sidecars.extend(s)
    return files, sidecars


def _ladder_fit(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    # beyond the configured ladder: next power of two
    b = ladder[-1]
    while b < n:
        b *= 2
    return b


def _uniq_ladder(batch_size: int, max_l: int) -> List[int]:
    """Power-of-two ladder for the unique-row bucket; the top rung is the
    first power of two > B*L, so a padding slot exists even when every
    id is distinct."""
    cap = batch_size * max_l + 1
    out, b = [], 64
    while b < cap:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def first_occurrence_unique(ids: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The unique ids in order of first occurrence and each id's index
    into them: what ``cparser.dedup_ids_fast`` returns, in numpy."""
    uniq, first, inverse = np.unique(ids, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return (uniq[order].astype(np.int32),
            rank[inverse.reshape(-1)].astype(np.int32))


def make_device_batch(block: ParsedBlock, cfg: FmConfig,
                      batch_size: int = 0,
                      weights: Optional[np.ndarray] = None,
                      raw_ids: bool = True,
                      dedup: Callable = first_occurrence_unique,
                      fixed_shape: bool = False,
                      uniq_bucket: int = 0) -> DeviceBatch:
    """CSR block -> padded DeviceBatch: B = ``batch_size`` (or
    cfg.batch_size) examples, L = the smallest ``bucket_ladder`` rung
    that holds the longest example. ``raw_ids`` (the default: serving
    and the ``dedup = device`` step) keeps raw ids in ``local_idx``;
    otherwise the host unique pass (``dedup``; the generic path passes
    the C++ ``dedup_ids_fast``, equal array for array) fills
    ``uniq_ids`` to the smallest ``_uniq_ladder`` rung with a pad slot
    and ``local_idx`` indexes it. ``weights`` (a sidecar's, per real
    example) default to 1.0.

    ``fixed_shape`` (multi-process lockstep, host dedup only) pins L to
    the ladder top and U to ``uniq_bucket`` (or the ladder top), so
    every rank's batches have one shape; a block whose unique ids do not
    fit the bucket raises ``UniqOverflow`` (the spill protocol)."""
    B = batch_size or cfg.batch_size
    n_real = block.batch_size
    if n_real > B:
        raise ValueError(f"block of {n_real} examples exceeds batch_size {B}")
    if raw_ids and fixed_shape:
        raise ValueError("raw_ids (dedup=device) has no fixed-U protocol; "
                         "multi-process mode needs dedup=host")
    sizes = block.sizes
    max_l = int(sizes.max()) if n_real else 1
    ladder = cfg.bucket_ladder
    L = ladder[-1] if fixed_shape else _ladder_fit(max(max_l, 1), ladder)
    if max_l > L:
        raise ValueError(f"example with {max_l} features exceeds the fixed "
                         f"bucket {L}; raise bucket_ladder or "
                         "max_features_per_example")

    if raw_ids:
        uniq_ids, inverse, pad_slot = None, block.ids, cfg.pad_id
    else:
        uniq, inverse = dedup(block.ids)
        uladder = _uniq_ladder(B, L)
        if fixed_shape:
            U = uniq_bucket or uladder[-1]
            if len(uniq) + 1 > U:
                raise UniqOverflow(
                    f"{len(uniq)} unique ids exceed the fixed unique "
                    f"bucket {U} (one slot is reserved for padding)")
        else:
            U = _ladder_fit(len(uniq) + 1, uladder)
        uniq_ids = np.full(U, cfg.pad_id, dtype=np.int32)
        uniq_ids[:len(uniq)] = uniq
        pad_slot = U - 1  # always a pad_id slot by construction

    local_idx = np.full((B, L), pad_slot, dtype=np.int32)
    vals = np.zeros((B, L), dtype=np.float32)
    fields = (np.zeros((B, L), dtype=np.int32)
              if block.fields is not None else None)
    if n_real:
        # Vectorized CSR -> padded scatter.
        ex_sizes = np.diff(block.poses[:n_real + 1])
        rows = np.repeat(np.arange(n_real), ex_sizes)
        cols = np.arange(len(rows)) - np.repeat(block.poses[:n_real],
                                                ex_sizes)
        local_idx[rows, cols] = inverse
        vals[rows, cols] = block.vals
        if fields is not None:
            fields[rows, cols] = block.fields

    labels = np.zeros(B, dtype=np.float32)
    labels[:n_real] = block.labels
    w = np.zeros(B, dtype=np.float32)
    if weights is not None:
        w[:n_real] = np.asarray(weights, dtype=np.float32)[:n_real]
    else:
        w[:n_real] = 1.0
    return DeviceBatch(labels=labels, weights=w, local_idx=local_idx,
                       vals=vals, num_real=n_real, uniq_ids=uniq_ids,
                       fields=fields)


def epoch_file_order(files: List[str], shuffle: bool, seed: int,
                     epoch: int) -> List[str]:
    """Per-epoch file visit order: shuffled when shuffling is on, from a
    dedicated per-(seed, epoch) Random, never the stream's rng."""
    if not shuffle or len(files) < 2:
        return files
    out = list(files)
    random.Random(f"{seed}/{epoch}").shuffle(out)
    return out


def shard_byte_range(path: str, shard_index: int,
                     num_shards: int) -> Tuple[int, int]:
    """This shard's byte range of ``path``: worker i owns every line
    whose first byte falls in [size*i/N, size*(i+1)/N), so each worker
    reads ~1/N of every file."""
    size = os.path.getsize(path)
    return (size * shard_index // num_shards,
            size * (shard_index + 1) // num_shards)


def _iter_owned_chunks(path: str, start: int = 0, end: Optional[int] = None,
                       retry: Optional[RetryPolicy] = None,
                       chunk_bytes: int = 4 << 20) -> Iterator[bytes]:
    """Byte chunks that together hold exactly the lines owned by the
    byte range [start, end) of ``path`` (``end`` None: to EOF).
    Ownership is by a line's first byte: the line straddling ``start``
    belongs to the previous range (skipped by scanning from start-1 to
    the first newline; adjacent ranges agree on that newline, so every
    line is owned once), and the line straddling ``end`` is read to its
    end. Only the final chunk at EOF may lack a trailing newline.

    ``retry`` wraps the open and each chunk read in the transient-IO
    retry loop; every attempt seeks back to the chunk's start first, as
    a partial buffered read advances the position before it raises."""
    fh = (open(path, "rb") if retry is None else
          open_with_retry(path, "rb", policy=retry, op="data_open"))

    def read(n: int) -> bytes:
        if retry is None:
            return fh.read(n)
        pos0 = fh.tell()

        def attempt() -> bytes:
            fh.seek(pos0)
            return fh.read(n)
        return retry_io(attempt, policy=retry, op="data_read")

    with fh:
        pos = start
        if start > 0:
            fh.seek(start - 1)
            while True:  # skip to the byte after the first newline
                b = read(chunk_bytes)
                if not b:
                    return  # EOF before any owned line
                i = b.find(b"\n")
                if i >= 0:
                    pos = fh.tell() - len(b) + i + 1
                    fh.seek(pos)
                    break
        if end is not None and pos >= end:
            return  # the first owned line starts past the range
        while True:
            b = read(chunk_bytes)
            if not b:
                return
            if end is not None and pos + len(b) >= end:
                # The boundary falls in this chunk: emit through the
                # first newline at offset >= end-1 (the last owned
                # line's terminator) and stop.
                cut = b.find(b"\n", max(end - 1 - pos, 0))
                if cut >= 0:
                    yield b[:cut + 1]
                    return
            yield b
            pos += len(b)


def _iter_range_lines(path: str, start: int = 0, end: Optional[int] = None,
                      retry: Optional[RetryPolicy] = None
                      ) -> Iterator[str]:
    """Decoded lines owned by [start, end) of ``path``. Lines split on
    newlines before they are decoded, so a multibyte character across a
    chunk boundary survives; a final line without its newline still
    counts."""
    tail = b""
    for chunk in _iter_owned_chunks(path, start, end, retry=retry):
        parts = (tail + chunk if tail else chunk).split(b"\n")
        tail = parts.pop()
        for raw in parts:
            yield raw.decode("utf-8")
    if tail:
        yield tail.decode("utf-8")


def _owned_start_line_index(path: str, start: int,
                            retry: Optional[RetryPolicy] = None) -> int:
    """The 0-based line index of the first line owned by a byte range
    beginning at ``start``: the newline count before that line, by a
    memchr-speed scan. It aligns weight sidecars, and the line numbers
    of errors, with a byte-range shard. Memoized per file version
    (size, mtime and inode in the key)."""
    if start <= 0:
        return 0
    st = os.stat(path)
    return _owned_start_line_index_for(path, start, st.st_size,
                                       st.st_mtime_ns, st.st_ino, retry)


@functools.lru_cache(maxsize=512)
def _owned_start_line_index_for(path: str, start: int, _size: int,
                                _mtime_ns: int, _ino: int,
                                retry: Optional[RetryPolicy] = None
                                ) -> int:
    n = 0
    with (open(path, "rb") if retry is None else
          open_with_retry(path, "rb", policy=retry,
                          op="sidecar_align")) as fh:
        # Newlines strictly before start-1, then the boundary: the
        # newline at or after start-1 ends the previous owner's line.
        remaining = start - 1
        while remaining > 0:
            b = fh.read(min(4 << 20, remaining))
            if not b:
                return n
            n += b.count(b"\n")
            remaining -= len(b)
        while True:
            b = fh.read(4 << 20)
            if not b:
                return n  # EOF before a newline: nothing more is owned
            if b.find(b"\n") >= 0:
                return n + 1


def _shard_range(path: str, shard_index: int, num_shards: int,
                 retry: Optional[RetryPolicy]) -> Tuple[int, Optional[int],
                                                        int]:
    """(start, end, lines before start) of this shard of ``path``; the
    whole file, ``end`` None, for one shard."""
    if num_shards <= 1:
        return 0, None, 0
    start, end = shard_byte_range(path, shard_index, num_shards)
    return start, end, _owned_start_line_index(path, start, retry)


def _iter_lines(files: Sequence[str], weight_files: Sequence[str],
                keep_empty: bool = False,
                retry: Optional[RetryPolicy] = None,
                file_marks: Optional[FileMarks] = None,
                shard_index: int = 0, num_shards: int = 1
                ) -> Iterator[Tuple[str, float, Source]]:
    """``(line, weight, (path, lineno))`` for every example-producing
    line (every line under ``keep_empty``) of this shard's byte range of
    each file (``shard_byte_range``). Weight files are line-parallel
    sidecars, aligned with a shard by skipping the lines before its
    range: a missing weight line or a bad weight fails loudly instead
    of training with a wrong weight."""
    if weight_files:
        if len(weight_files) != len(files):
            raise ValueError(
                "weight sidecar list must pair 1:1 with its data files "
                f"after glob expansion ({len(weight_files)} sidecars vs "
                f"{len(files)} files)")
        for path, wpath in zip(files, weight_files):
            start, end, n_skip = _shard_range(path, shard_index,
                                              num_shards, retry)
            wfh = (open(wpath) if retry is None else
                   open_with_retry(wpath, policy=retry, op="sidecar_open"))
            with wfh:
                for i in range(n_skip):
                    if not wfh.readline():
                        raise ValueError(
                            f"weight file {wpath} is shorter than its "
                            f"data file {path}: ended at line {i} while "
                            f"skipping to this shard's start ({n_skip})")
                lineno = n_skip
                for line in _iter_range_lines(path, start, end,
                                              retry=retry):
                    wline = wfh.readline()
                    lineno += 1
                    if not wline:
                        raise ValueError(
                            f"weight file {wpath} is shorter than its "
                            f"data file {path}: no weight for data "
                            f"line {lineno}")
                    if not line.strip(WHITESPACE) and not keep_empty:
                        continue
                    try:
                        w = float(wline)
                    except ValueError:
                        raise ValueError(
                            f"bad weight {wline.strip()!r} at {wpath} "
                            f"line {lineno}") from None
                    yield line, w, (path, lineno)
        return
    yielded = 0
    for path in files:
        if file_marks is not None:
            # keep_empty: one example per line, so the count yielded is
            # the example offset.
            file_marks.start_file(path, yielded)
        start, end, base = _shard_range(path, shard_index, num_shards,
                                        retry)
        for lineno, line in enumerate(
                _iter_range_lines(path, start, end, retry=retry),
                base + 1):
            # strip() pinned to the libsvm separator set, as the C++
            # builder counts blank lines.
            if line.strip(WHITESPACE) or keep_empty:
                yielded += 1
                yield line, 1.0, (path, lineno)


# Both parsers prefix errors "line <block-relative index>: ..."; the
# pipeline puts the file and line number in its place.
_LINE_MSG = re.compile(r"^line (\d+): (.*)$", re.S)


def _strip_line_prefix(msg: str) -> str:
    m = _LINE_MSG.match(msg)
    return m.group(2) if m else msg


def _attach_block_source(e: ParseError,
                         provenance: Sequence[Source]) -> ParseError:
    """Rewrite a block-relative ParseError ("line 3: bad label ...")
    with the failing line's file and line number."""
    m = _LINE_MSG.match(str(e))
    if not m:
        return e
    i = int(m.group(1))
    if i >= len(provenance):
        return e
    path, lineno = provenance[i]
    return ParseError(f"{path} line {lineno}: {m.group(2)}")


def _attach_stream_source(e: ParseError, file_spans: Sequence[tuple]
                          ) -> ParseError:
    """Rewrite a builder-stream ParseError ("line N: ..." where N counts
    every line fed to the builder) with the owning file's path and line
    number; ``file_spans`` holds ``(lines_before, path)`` per file fed,
    or ``(lines_before, path, lines_before_range)`` for a byte-range
    shard of it. The span map is searched, not the current file
    assumed: a threaded builder reports an error when batch consumption
    reaches it, which can be while a later file is feeding."""
    m = _LINE_MSG.match(str(e))
    if not m or not file_spans:
        return e
    n = int(m.group(1))
    owner = file_spans[0]
    for span in file_spans:
        if span[0] < n:
            owner = span
        else:
            break
    base, path = owner[0], owner[1]
    offset = owner[2] if len(owner) > 2 else 0
    return ParseError(f"{path} line {n - base + offset}: {m.group(2)}")


def _host_cpus() -> int:
    """Usable host cores, cpuset-aware: the one counting rule behind the
    auto host_threads, the per-worker feed threads and prefetch's
    GIL-bound passthrough."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def resolve_host_threads(cfg: FmConfig) -> int:
    """The configured batch-build worker count: ``host_threads`` as set,
    or, for 0 (auto), min(4, host cores)."""
    if cfg.host_threads > 0:
        return cfg.host_threads
    return max(1, min(4, _host_cpus()))


def host_parallel_workers(cfg: FmConfig,
                          weight_files: Sequence[str] = (),
                          fixed_shape: bool = False) -> int:
    """The worker count the data plane actually uses for these inputs:
    ``resolve_host_threads`` where a parallel route exists (the C++
    fast path, or the tolerant generic path without weight files), else
    1 — the same predicate ``batch_iterator`` routes on. ``fixed_shape``
    input always takes a serial route: its spill composes batches in
    sequence (the serial builder's budget close, the generic path's
    requeue)."""
    workers = resolve_host_threads(cfg)
    if workers <= 1 or fixed_shape:
        return 1
    if _fast_path_eligible(cfg, weight_files):
        return workers
    if cfg.bad_line_policy != "error" and not weight_files:
        return workers
    return 1


def _worker_feed_threads(workers: int) -> int:
    """Feed parse threads per pool-worker builder: 2 when the host has
    cores to spare (the pool gives the main fan-out; this shortens one
    group's critical path), else 1."""
    return 2 if _host_cpus() >= 2 * workers else 1


def _make_builder(cfg: FmConfig, B: int, raw_ids: bool, keep_empty: bool,
                  num_threads: int = 0, uniq_bucket: int = 0
                  ) -> cparser.BatchBuilder:
    """The one BatchBuilder construction, shared by the serial fast path
    and the parallel plane's per-worker builders. ``uniq_bucket`` > 0
    (fixed-shape input, serial builder only) caps a batch's unique rows:
    the builder closes a batch early rather than exceed it (the spill)."""
    return cparser.BatchBuilder(
        B, effective_L_cap(cfg), cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        field_aware=cfg.model_type == "ffm", field_num=cfg.field_num,
        raw_ids=raw_ids, keep_empty=keep_empty,
        max_features_per_example=cfg.max_features_per_example,
        max_uniq=uniq_bucket, num_threads=num_threads)


class _BatchEmitter:
    """Builder output tuple -> DeviceBatch, plus the window-shuffle
    drain: one implementation shared by the serial fast path, the
    parallel ring's consumer and the plain stream. The same rng
    construction, the same draws per emitted batch and the same window
    make every ``host_threads`` setting give one stream."""

    def __init__(self, cfg: FmConfig, B: int, shuffle: bool,
                 seed: Optional[int], fixed_shape: bool = False,
                 uniq_bucket: int = 0,
                 stats: Optional[SpillStats] = None):
        self.cfg = cfg
        self.B = B
        self.shuffle = shuffle
        self.fixed_shape = fixed_shape
        self.uniq_bucket = uniq_bucket
        self.stats = stats
        self.pyrng = random.Random(cfg.seed if seed is None else seed)
        self.nprng = np.random.default_rng(self.pyrng.getrandbits(64))
        self.window: List[DeviceBatch] = []
        self.window_cap = (max(2, cfg.queue_size // B) if shuffle
                           else 1)

    def emit_drain(self, out, spilled: bool = False
                   ) -> Iterator[DeviceBatch]:
        """Emit one builder ``finish()`` tuple and drain it through the
        bounded shuffle window (a passthrough when shuffle is off).
        ``spilled``: the builder closed it early on the unique budget."""
        batch = self._emit(*out, spilled=spilled)
        if self.shuffle:
            self.window.append(batch)
            if len(self.window) >= self.window_cap:
                yield self.window.pop(
                    self.pyrng.randrange(len(self.window)))
        else:
            yield batch

    def flush_window(self) -> Iterator[DeviceBatch]:
        while self.window:
            yield self.window.pop(self.pyrng.randrange(len(self.window)))

    def _emit(self, n, labels, uniq, li, vals, fields, max_nnz,
              spilled: bool = False) -> DeviceBatch:
        cfg, B = self.cfg, self.B
        if self.stats is not None:
            self.stats.count(n, B, spilled,
                             num_uniq=_num_uniq(uniq, cfg.pad_id))
        L = (li.shape[1] if self.fixed_shape
             else _ladder_fit(max(max_nnz, 1), cfg.bucket_ladder))
        if L < li.shape[1]:
            li = np.ascontiguousarray(li[:, :L])
            vals = np.ascontiguousarray(vals[:, :L])
            if fields is not None:
                fields = np.ascontiguousarray(fields[:, :L])
        if uniq is None:  # raw-ids mode: li holds raw ids
            uniq_ids = None
        else:
            # The builder's uniq already holds the reserved pad slot
            # (index 0), so it is fitted as it is; a fixed shape takes
            # the bucket (the builder kept within it) or the ladder top.
            uladder = _uniq_ladder(B, L)
            if self.fixed_shape:
                U = self.uniq_bucket or uladder[-1]
            else:
                U = _ladder_fit(len(uniq), uladder)
            uniq_ids = np.full(U, cfg.pad_id, dtype=np.int32)
            uniq_ids[:len(uniq)] = uniq
        weights = np.zeros(B, np.float32)
        weights[:n] = 1.0
        labels[n:] = 0.0  # the C++ buffer may hold stale labels past n
        if self.shuffle and n > 1:
            # Only the real rows: the padding block stays at the tail.
            perm = np.concatenate([self.nprng.permutation(n),
                                   np.arange(n, B)])
            labels, weights = labels[perm], weights[perm]
            li, vals = li[perm], vals[perm]
            if fields is not None:
                fields = fields[perm]
        return DeviceBatch(labels=labels, weights=weights, local_idx=li,
                           vals=vals, num_real=n, uniq_ids=uniq_ids,
                           fields=fields)


class _BuildRing:
    """Bounded ordered ring between a pool of batch-build workers and the
    consuming iterator. ``submit(payload)`` assigns the next sequence
    number; workers take tasks in order, build outside the lock and post
    results by sequence; ``wait(seq)`` hands the consumer the stream in
    order. Workers are daemon threads named ``fmt-build-<i>`` (the JAX
    package's are ``fm-build-<i>``; a leak check of one package cannot
    see the other's); ``close()`` stops and joins them."""

    def __init__(self, workers: int, depth: int, work,
                 make_state=None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tasks: collections.deque = collections.deque()
        self._results: Dict[int, tuple] = {}
        self._next_seq = 0
        self._stop = False
        self._pool_error: Optional[BaseException] = None
        self._alive = 0
        self._started = 0
        self._work = work
        self._make_state = make_state
        self.depth = max(int(depth), 2)
        self.workers = int(workers)
        self._threads: List[threading.Thread] = []
        for i in range(self.workers):
            t = threading.Thread(target=self._worker_main,
                                 name=f"fmt-build-{i}", daemon=True)
            self._threads.append(t)
            t.start()

    def submit(self, payload) -> int:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._tasks.append((seq, payload))
            self._cv.notify_all()
            return seq

    def has(self, seq: int) -> bool:
        with self._lock:
            return seq in self._results

    def occupancy(self) -> int:
        """Finished results not yet taken (the ``pipeline/ring_occupancy``
        gauge: full = consumer-bound, empty = the build workers lag)."""
        with self._lock:
            return len(self._results)

    def wait(self, seq: int) -> tuple:
        """Block until ``seq``'s result is ready and take it: ("ok",
        value) or ("error", exception). Raises when the pool itself is
        unusable (a worker's state factory failed, or every worker
        exited), so the consumer never waits on a ring nobody fills."""
        with self._lock:
            while True:
                res = self._results.pop(seq, None)
                if res is not None:
                    return res
                if self._pool_error is not None:
                    raise self._pool_error
                if self._started >= self.workers and self._alive == 0:
                    raise RuntimeError(
                        "all batch-build workers exited; the host "
                        "data plane cannot make progress")
                self._cv.wait()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def _worker_main(self) -> None:
        try:
            state = (self._make_state()
                     if self._make_state is not None else None)
        except BaseException as e:  # builder creation failed: poison
            with self._lock:
                self._started += 1
                self._pool_error = e
                self._cv.notify_all()
            return
        with self._lock:
            self._started += 1
            self._alive += 1
        try:
            while True:
                with self._lock:
                    while not self._tasks and not self._stop:
                        self._cv.wait()
                    if self._stop:
                        return
                    seq, payload = self._tasks.popleft()
                tel = active()
                try:
                    if tel is None:
                        res = ("ok", self._work(state, payload))
                    else:
                        t0 = time.perf_counter()
                        with span("pipeline/build_worker"):
                            res = ("ok", self._work(state, payload))
                        tel.count("pipeline/worker_build_seconds",
                                  time.perf_counter() - t0)
                except BaseException as e:  # delivered at wait(seq)
                    res = ("error", e)
                with self._lock:
                    self._results[seq] = res
                    self._cv.notify_all()
        finally:
            with self._lock:
                self._alive -= 1
                self._cv.notify_all()


class _Group:
    """The raw bytes of exactly one batch's worth of example-producing
    lines (newline-terminated), and the count of stream lines before it
    and inside it (for error line numbers)."""

    __slots__ = ("blob", "line_start", "lines")

    def __init__(self, blob: bytes, line_start: int, lines: int):
        self.blob = blob
        self.line_start = line_start
        self.lines = lines


class _GroupScanner:
    """Cuts the byte stream of ``files`` into per-batch line groups for
    the parallel fast plane. Every group but the last holds exactly B
    example-producing lines by the builder's own counting rule
    (``cparser.scan_examples``), ends with a newline and splits no line,
    so a fresh builder fed one group gives the batch the serial builder
    gives at that stream position. ``file_spans`` mirrors the serial
    path's provenance map."""

    def __init__(self, files: Sequence[str], B: int, keep_empty: bool,
                 retry: Optional[RetryPolicy],
                 file_marks: Optional[FileMarks] = None,
                 shard_index: int = 0, num_shards: int = 1):
        self._si, self._ns = shard_index, num_shards
        self._files = list(files)
        self._fi = 0
        self._chunks: Optional[Iterator[bytes]] = None
        self._buf = b""
        self._pos = 0
        self._B = B
        self._keep_empty = keep_empty
        self._retry = retry
        self._file_marks = file_marks
        self.lines = 0  # stream lines consumed into groups so far
        self.file_spans: List[tuple] = []

    def next_group(self) -> Optional[_Group]:
        while True:
            found, consumed, nlines = cparser.scan_examples(
                self._buf, self._B, self._keep_empty, offset=self._pos)
            if found >= self._B:
                return self._cut(consumed, nlines)
            chunk = self._next_chunk()
            if chunk is None:
                g = self._cut(consumed, nlines) if found else None
                # Trailing blank lines (never example-producing) are
                # dropped; the serial builder skips them unseen.
                self._buf = b""
                self._pos = 0
                return g
            self._buf = self._buf[self._pos:] + chunk
            self._pos = 0

    def _cut(self, consumed: int, nlines: int) -> _Group:
        g = _Group(self._buf[self._pos:self._pos + consumed],
                   self.lines, nlines)
        self._pos += consumed
        self.lines += nlines
        return g

    def _next_chunk(self) -> Optional[bytes]:
        while True:
            if self._chunks is not None:
                chunk = next(self._chunks, None)
                if chunk is not None:
                    return chunk
                self._chunks = None
                # File exhausted: terminate a newline-less final line,
                # as the serial path's `feed(tail + b"\n")` does.
                tail = self._buf[self._pos:]
                if tail and not tail.endswith(b"\n"):
                    return b"\n"
            if self._fi >= len(self._files):
                return None
            path = self._files[self._fi]
            self._fi += 1
            # Lines before this file: those consumed into groups plus
            # the complete lines still buffered (all from earlier files).
            base = self.lines + self._buf.count(b"\n", self._pos)
            start, end, offset = _shard_range(path, self._si, self._ns,
                                              self._retry)
            self.file_spans.append((base, path, offset))
            if self._file_marks is not None:
                # keep_empty (the only file_marks mode): lines are
                # examples.
                self._file_marks.start_file(path, base)
            self._chunks = _iter_owned_chunks(path, start, end,
                                              retry=self._retry)


class _FastWorkerState:
    """Per-worker build state: one BatchBuilder owned by one pool thread,
    and a mirror of its line counter for rebasing builder-relative error
    line numbers onto the stream. Created inside the worker thread."""

    def __init__(self, make_builder):
        self._make_builder = make_builder
        self.bb = make_builder()
        self.fed = 0  # lines consumed by self.bb since creation

    def reset(self) -> None:
        # After a parse error the builder holds a half-built batch and
        # an unrecoverable line counter: a fresh builder restores both.
        self.bb = self._make_builder()
        self.fed = 0


def _fast_group_work(state: _FastWorkerState, group: _Group):
    """Build one group (one batch's lines) on a pool worker; returns the
    builder's ``finish()`` tuple. A ParseError is rebased here from
    builder-relative to stream-relative line numbers."""
    bb = state.bb
    fed_before = state.fed
    try:
        bb.feed(group.blob, 0)
        out = bb.finish()
    except ParseError as e:
        state.reset()
        m = _LINE_MSG.match(str(e))
        if m:
            k = int(m.group(1)) - fed_before
            raise ParseError(
                f"line {group.line_start + k}: {m.group(2)}") from None
        raise
    state.fed += group.lines
    return out


def _parallel_fast_batch_iterator(cfg: FmConfig, files: List[str], B: int,
                                  n_epochs: int, shuffle: bool,
                                  seed: Optional[int], raw_ids: bool,
                                  keep_empty: bool, workers: int,
                                  file_marks: Optional[FileMarks] = None,
                                  shard_index: int = 0, num_shards: int = 1
                                  ) -> Iterator[DeviceBatch]:
    """Parallel host data plane: parse, hash, dedup and pack fan out over
    ``workers`` pool threads, each owning its own C++ BatchBuilder, over
    the per-batch line groups of ``_GroupScanner``; batches come back in
    group order through ``_BuildRing``, and all shuffling happens in the
    shared ``_BatchEmitter`` on the consuming side. Groups are cut at
    the serial batches' boundaries and each meets a fresh-state builder,
    so the stream is bit-identical to ``host_threads = 1``. Closing the
    generator stops and joins the pool."""
    make_builder = functools.partial(_make_builder, cfg, B, raw_ids,
                                     keep_empty,
                                     _worker_feed_threads(workers))
    emitter = _BatchEmitter(cfg, B, shuffle, seed)
    retry = RetryPolicy.from_config(cfg)
    file_seed = cfg.seed if seed is None else seed
    ring = _BuildRing(workers, depth=2 * workers, work=_fast_group_work,
                      make_state=lambda: _FastWorkerState(make_builder))
    tel = active()
    if tel is not None:
        tel.set("pipeline/host_threads", workers)
    try:
        for epoch in range(n_epochs):
            scanner = _GroupScanner(
                epoch_file_order(files, shuffle, file_seed, epoch), B,
                keep_empty, retry, file_marks=file_marks,
                shard_index=shard_index, num_shards=num_shards)
            order: collections.deque = collections.deque()
            scan_done = False
            while True:
                while not scan_done and len(order) < ring.depth:
                    g = scanner.next_group()
                    if g is None:
                        scan_done = True
                        break
                    order.append(ring.submit(g))
                if not order:
                    break
                kind, payload = ring.wait(order.popleft())
                if tel is not None:
                    tel.set("pipeline/ring_occupancy", ring.occupancy())
                if kind == "error":
                    if isinstance(payload, ParseError):
                        raise _attach_stream_source(
                            payload, scanner.file_spans) from None
                    raise payload
                yield from emitter.emit_drain(payload)
            yield from emitter.flush_window()
    finally:
        ring.close()


def _fast_batch_iterator(cfg: FmConfig, bb: cparser.BatchBuilder,
                         files: List[str], B: int, n_epochs: int,
                         shuffle: bool, seed: Optional[int],
                         file_marks: Optional[FileMarks] = None,
                         shard_index: int = 0, num_shards: int = 1,
                         fixed_shape: bool = False, uniq_bucket: int = 0,
                         stats: Optional[SpillStats] = None
                         ) -> Iterator[DeviceBatch]:
    """Chunked C++ fast path: raw file bytes (this shard's byte ranges,
    ``shard_byte_range``) stream straight into the BatchBuilder; Python
    never touches a line. Shuffle is a window-of-batches pick plus a
    within-batch row permutation (``_BatchEmitter``), the mixing radius
    of a ``queue_size``-line shuffle queue at batch granularity. With a
    fixed ``uniq_bucket`` the builder caps each batch's unique rows: a
    too-dense batch closes early with fewer than B examples (the spill)
    and the shapes stay fixed."""
    emitter = _BatchEmitter(cfg, B, shuffle, seed, fixed_shape, uniq_bucket,
                            stats)
    tail = b""
    fed_lines = 0  # complete lines fed to the builder so far: mirrors
    # the builder's own line counter (a spilled line is fed again but
    # counted once on both sides)
    file_spans: List[tuple] = []  # (lines_before, path, range offset)

    def feed_all(data: bytes) -> Iterator[DeviceBatch]:
        nonlocal tail, fed_lines
        fed_lines += data.count(b"\n")
        off = 0
        while True:
            full, consumed = bb.feed(data, off)
            off += consumed
            if not full:
                break
            out = bb.finish()
            # "Full" at B examples, or at a line that would exceed the
            # unique budget: the latter closes the batch short.
            yield from emitter.emit_drain(out, spilled=out[0] < B)
        tail = data[off:]  # unconsumed partial line, fed again next chunk

    retry = RetryPolicy.from_config(cfg)
    file_seed = cfg.seed if seed is None else seed
    try:
        for epoch in range(n_epochs):
            for path in epoch_file_order(files, shuffle, file_seed, epoch):
                start, end, offset = _shard_range(path, shard_index,
                                                  num_shards, retry)
                tail = b""
                file_spans.append((fed_lines, path, offset))
                if file_marks is not None:
                    # keep_empty: lines fed before this file = examples.
                    file_marks.start_file(path, fed_lines)
                for chunk in _iter_owned_chunks(path, start, end,
                                                retry=retry):
                    yield from feed_all(tail + chunk if tail else chunk)
                if tail:  # final line missing its newline
                    yield from feed_all(tail + b"\n")
            out = bb.finish()
            if out[0]:  # short final batch of the epoch
                yield from emitter.emit_drain(out)
            yield from emitter.flush_window()
    except ParseError as e:
        raise _attach_stream_source(e, file_spans) from None


def _fast_path_eligible(cfg: FmConfig, weight_files: Sequence[str]) -> bool:
    """The one gate for the chunked C++ fast path: no weight sidecars
    (weights pair with lines in Python), a hard per-example cap (the
    builder writes fixed-stride rows; 0 means unlimited) and the strict
    bad-line policy (the streaming builder is all-or-nothing on a parse
    error; tolerance lives on the generic path)."""
    return (not weight_files and cfg.max_features_per_example > 0
            and cfg.bad_line_policy == "error")


def gil_bound_iteration(cfg: FmConfig, weight_files: Sequence[str] = (),
                        keep_empty: bool = False) -> bool:
    """Whether ``batch_iterator``'s iteration for these inputs is
    dominated by GIL-holding Python work — the generic path's per-line
    iteration under weight pairing, a tolerant policy or keep_empty — so
    that ``prefetch`` passes it through on a single core instead of
    threading it."""
    if weight_files or cfg.bad_line_policy != "error":
        return True
    return keep_empty and not _fast_path_eligible(cfg, weight_files)


def _remapped(vocab, it: Iterator[DeviceBatch],
              pad_id: Optional[int] = None) -> Iterator[DeviceBatch]:
    """``it``'s batches through ``vocab.remap`` (None: ``it`` as it
    is); closing this generator closes ``it``, so its build pool is
    joined at once. Given ``pad_id`` and with a run's telemetry active,
    each batch's build (the remap included) is a ``pipeline/build`` span
    and feeds ``pipeline_batch``, timed here on the producing side."""
    tel = active() if pad_id is not None else None
    if vocab is None and tel is None:
        yield from it
        return
    try:
        while True:
            t0 = time.perf_counter()
            with span("pipeline/build"):
                batch = next(it, None)
            if batch is None:
                return
            if vocab is not None:
                # Before pipeline_batch: the padding counters must see
                # the physical pad_id the remap writes.
                batch = vocab.remap(batch)
            if tel is not None:
                tel.pipeline_batch(batch, pad_id,
                                   build_seconds=time.perf_counter() - t0)
            yield batch
    finally:
        it.close()


def batch_iterator(cfg: FmConfig, files: Sequence[str],
                   training: bool = True,
                   weight_files: Sequence[str] = (),
                   shard_index: int = 0, num_shards: int = 1,
                   epochs: Optional[int] = None,
                   batch_size: Optional[int] = None,
                   seed: Optional[int] = None,
                   keep_empty: bool = False,
                   fixed_shape: bool = False,
                   uniq_bucket: int = 0,
                   stats: Optional[SpillStats] = None,
                   raw_ids: bool = True,
                   bad_lines: Optional[BadLineTracker] = None,
                   file_marks: Optional[FileMarks] = None,
                   vocab=None) -> Iterator[DeviceBatch]:
    """``_batch_iterator_impl``'s stream; with ``vocab`` (a
    vocab.VocabMap or VocabRuntime, ``vocab_mode = admit``) built under
    ``vocab.build_cfg(cfg)`` and remapped to physical rows batch by
    batch, here on the producing side."""
    return _remapped(vocab, _batch_iterator_impl(
        cfg if vocab is None else vocab.build_cfg(cfg), files,
        training=training, weight_files=weight_files,
        shard_index=shard_index, num_shards=num_shards, epochs=epochs,
        batch_size=batch_size, seed=seed, keep_empty=keep_empty,
        fixed_shape=fixed_shape, uniq_bucket=uniq_bucket, stats=stats,
        raw_ids=raw_ids, bad_lines=bad_lines, file_marks=file_marks),
        cfg.pad_id)


def _batch_iterator_impl(cfg: FmConfig, files: Sequence[str],
                         training: bool = True,
                         weight_files: Sequence[str] = (),
                         shard_index: int = 0, num_shards: int = 1,
                         epochs: Optional[int] = None,
                         batch_size: Optional[int] = None,
                         seed: Optional[int] = None,
                         keep_empty: bool = False,
                         fixed_shape: bool = False,
                         uniq_bucket: int = 0,
                         stats: Optional[SpillStats] = None,
                         raw_ids: bool = True,
                         bad_lines: Optional[BadLineTracker] = None,
                         file_marks: Optional[FileMarks] = None
                         ) -> Iterator[DeviceBatch]:
    """Epoch/shuffle/batch loop over text files: the JAX package's
    ``batch_iterator`` with the same arguments, array for array, on one
    shard. ``raw_ids`` defaults to True here (the port's main path is
    ``dedup = device``; the JAX package defaults to False).

    ``weight_files``: line-parallel sidecars, expanded pattern by
    pattern with ``files``. ``keep_empty``: blank (and, under a tolerant
    policy, bad) lines become zero-feature examples, so a sweep stays
    line-aligned. ``bad_lines``: the run-scoped tracker when the caller
    owns one; with a tolerant ``cfg.bad_line_policy`` and none given,
    one is made per iteration. ``file_marks``: the per-file offset
    ledger of a single in-order keep_empty pass.

    ``shard_index`` / ``num_shards``: this worker reads its byte range of
    every file (``shard_byte_range``). ``fixed_shape`` (multi-process
    lockstep; host dedup only) pins L to the ladder top and U to
    ``uniq_bucket`` (or ``cfg.uniq_bucket``, or the ladder top): a batch
    whose unique ids would overflow it closes early with fewer real
    examples and the rest opens the next batch (the spill), counted in
    ``stats`` (a ``SpillStats``)."""
    if raw_ids and fixed_shape:
        raise ValueError("raw_ids (dedup=device) has no fixed-U protocol; "
                         "multi-process mode needs dedup=host")
    uniq_bucket = uniq_bucket or cfg.uniq_bucket
    if weight_files:
        files, weight_files = expand_paired_files(files, weight_files)
    else:
        files = expand_files(files)
        weight_files = ()
    B = batch_size or cfg.batch_size
    n_epochs = epochs if epochs is not None else (cfg.epoch_num if training
                                                  else 1)
    shuffle = training and cfg.shuffle
    if file_marks is not None:
        if not keep_empty or shuffle or n_epochs != 1 or weight_files:
            raise ValueError(
                "file_marks requires keep_empty=True, a single epoch, "
                "no shuffle, and no weight sidecars (the per-file "
                "example-offset ledger is only meaningful for an "
                "in-order one-example-per-line pass)")
    workers = host_parallel_workers(cfg, weight_files, fixed_shape)
    shard = dict(shard_index=shard_index, num_shards=num_shards)
    shape = dict(shard, fixed_shape=fixed_shape, uniq_bucket=uniq_bucket,
                 stats=stats)
    if _fast_path_eligible(cfg, weight_files):
        if workers > 1:
            yield from _parallel_fast_batch_iterator(
                cfg, files, B, n_epochs, shuffle, seed, raw_ids,
                keep_empty, workers, file_marks=file_marks, **shard)
        else:
            bb = _make_builder(cfg, B, raw_ids, keep_empty,
                               uniq_bucket=uniq_bucket if fixed_shape
                               else 0)
            yield from _fast_batch_iterator(
                cfg, bb, files, B, n_epochs, shuffle, seed,
                file_marks=file_marks, **shape)
        return
    yield from _generic_batch_iterator(
        cfg, files, weight_files, B, n_epochs, shuffle, seed, keep_empty,
        raw_ids, bad_lines, file_marks, workers, **shape)


def _generic_batch_iterator(cfg: FmConfig, files: List[str],
                            weight_files: Sequence[str], B: int,
                            n_epochs: int, shuffle: bool,
                            seed: Optional[int], keep_empty: bool,
                            raw_ids: bool,
                            bad_lines: Optional[BadLineTracker],
                            file_marks: Optional[FileMarks],
                            workers: int, shard_index: int = 0,
                            num_shards: int = 1, fixed_shape: bool = False,
                            uniq_bucket: int = 0,
                            stats: Optional[SpillStats] = None
                            ) -> Iterator[DeviceBatch]:
    """The generic path: lines through a ``queue_size`` reservoir
    (shuffle on), B at a time into a C++ block parse and
    ``make_device_batch``. Under a tolerant policy each bad line is
    recorded in the tracker (whose breaker may raise) and dropped, or
    under ``keep_empty`` kept as a zero-feature example; with
    ``workers`` > 1 each chunk's parse and build runs on the pool, and
    batches come back in submit order. With ``fixed_shape`` a chunk
    whose unique ids overflow ``uniq_bucket`` spills: the longest
    prefix of examples that fits is emitted and the rest returns to the
    head of the queue, counted once by the tracker."""
    retry = RetryPolicy.from_config(cfg)
    rng = random.Random(cfg.seed if seed is None else seed)
    tracker = bad_lines
    own_tracker = False
    if tracker is None:
        tracker = BadLineTracker.from_config(cfg)
        own_tracker = tracker is not None

    def parse_chunk(chunk, precounted: int = 0):
        """One chunk of (line, weight, source) -> (surviving chunk,
        block, weights). ``precounted``: the chunk's first this-many
        items went through the tracker already (a spill's requeued
        tail), so they neither count nor record again."""
        lines = [c[0] for c in chunk]
        if tracker is None:
            try:
                block = _parse_block(lines, cfg, keep_empty)
            except ParseError as e:
                raise _attach_block_source(
                    e, [c[2] for c in chunk]) from None
        else:
            bads: List[Tuple[int, str, str]] = []
            block = _salvage_block(lines, cfg, keep_empty, bads)
            fresh = [b for b in bads if b[0] >= precounted]
            tracker.count_ok(len(lines) - precounted - len(fresh))
            for i, raw, msg in fresh:
                path, lineno = chunk[i][2]
                tracker.record(path, lineno, raw, _strip_line_prefix(msg))
            if bads and not keep_empty:
                badset = {i for i, _, _ in bads}
                chunk = [c for i, c in enumerate(chunk) if i not in badset]
        return chunk, block, np.array([c[1] for c in chunk],
                                      dtype=np.float32)

    def batch_of(block, w) -> DeviceBatch:
        return make_device_batch(block, cfg, B, weights=w, raw_ids=raw_ids,
                                 dedup=cparser.dedup_ids_fast,
                                 fixed_shape=fixed_shape,
                                 uniq_bucket=uniq_bucket)

    def build(chunk) -> Optional[DeviceBatch]:
        _, block, w = parse_chunk(chunk)
        if tracker is not None and block.batch_size == 0:
            return None  # every line of the chunk was bad
        return batch_of(block, w)

    def counted(batch: DeviceBatch, spilled: bool) -> DeviceBatch:
        if stats is not None:
            stats.count(batch.num_real, B, spilled,
                        num_uniq=_num_uniq(batch.uniq_ids, cfg.pad_id))
        return batch

    # The tolerant generic path fans out: a bad line drops from the
    # parsed block and never shifts the B-line chunk boundaries, so each
    # chunk is an independent task. The run-scoped tracker is locked, so
    # the breaker and the quarantine dedupe stay global; only the order
    # of quarantine records may interleave across workers.
    pool: Optional[_BuildRing] = None
    pool_order: collections.deque = collections.deque()
    if tracker is not None and workers > 1:
        pool = _BuildRing(workers, depth=2 * workers,
                          work=lambda _state, chunk: build(chunk))
        tel = active()
        if tel is not None:
            tel.set("pipeline/host_threads", workers)

    def pool_drain(limit: int) -> Iterator[DeviceBatch]:
        """Yield finished pool batches in submit order: every finished
        head, plus (blocking) enough to keep at most ``limit`` in flight
        (0 = drain everything)."""
        tel = active()
        while pool_order and (len(pool_order) > limit
                              or pool.has(pool_order[0])):
            kind, val = pool.wait(pool_order.popleft())
            if tel is not None:
                tel.set("pipeline/ring_occupancy", pool.occupancy())
            if kind == "error":
                raise val
            if val is not None:
                yield counted(val, False)

    file_seed = cfg.seed if seed is None else seed
    try:
        for epoch in range(n_epochs):
            pending: List[Tuple[str, float, Source]] = []
            buf: List[Tuple[str, float, Source]] = []
            # How many front items of ``pending`` went through the
            # tracker already (a spill's requeued tail).
            requeued = [0]

            def flush_batches(done: bool) -> Iterator[DeviceBatch]:
                while len(pending) >= B or (done and pending):
                    chunk = pending[:B]
                    del pending[:B]
                    k = min(requeued[0], len(chunk))
                    requeued[0] -= k
                    if pool is not None:
                        pool_order.append(pool.submit(chunk))
                        yield from pool_drain(pool.depth)
                        continue
                    chunk, block, w = parse_chunk(chunk, precounted=k)
                    if tracker is not None and block.batch_size == 0:
                        continue  # every line of the chunk was bad
                    try:
                        yield counted(batch_of(block, w), False)
                    except UniqOverflow:
                        # The spill: the longest prefix of examples
                        # that fits the budget; the tail reopens the
                        # queue.
                        m = _uniq_prefix_examples(block, uniq_bucket)
                        if m == 0:
                            raise ValueError(
                                "single example exceeds uniq_bucket "
                                f"{uniq_bucket}; raise it (or set 0 "
                                "for auto)") from None
                        pending[0:0] = chunk[m:]
                        if tracker is not None:
                            requeued[0] += len(chunk) - m
                        # The head's lines were validated above: parse
                        # them again without the tracker.
                        head = [c[0] for c in chunk[:m]]
                        head_block = (
                            _salvage_block(head, cfg, keep_empty, [])
                            if tracker is not None
                            else _parse_block(head, cfg, keep_empty))
                        yield counted(batch_of(head_block, w[:m]), True)

            for item in _iter_lines(
                    epoch_file_order(files, shuffle and not weight_files,
                                     file_seed, epoch),
                    weight_files, keep_empty=keep_empty, retry=retry,
                    file_marks=file_marks, shard_index=shard_index,
                    num_shards=num_shards):
                if shuffle:
                    buf.append(item)
                    if len(buf) >= max(cfg.queue_size, B):
                        j = rng.randrange(len(buf))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        pending.append(buf.pop())
                else:
                    pending.append(item)
                yield from flush_batches(False)
            if shuffle and buf:
                rng.shuffle(buf)
                pending.extend(buf)
            yield from flush_batches(True)
            if pool is not None:  # epoch barrier: ring fully drained
                yield from pool_drain(0)
    finally:
        if pool is not None:
            pool.close()
        if own_tracker:
            tracker.close()


def _num_uniq(uniq_ids: Optional[np.ndarray], pad_id: int) -> int:
    """Real unique rows of a host-deduped uniq array (pad_id slots are
    fill); 0 for a raw-ids batch. The one counting rule of both paths'
    SpillStats, which ``train.adapt_uniq_bucket`` compares."""
    if uniq_ids is None:
        return 0
    return int((uniq_ids != pad_id).sum())


def _uniq_prefix_examples(block: ParsedBlock, uniq_bucket: int) -> int:
    """The most leading examples whose id union fits the unique bucket
    (one slot reserved for padding): the generic path's spill point."""
    if block.batch_size == 0:
        return 0
    _, first_pos = np.unique(block.ids, return_index=True)
    # The example owning each first occurrence -> new uniques per example.
    ex = np.searchsorted(block.poses, first_pos, side="right") - 1
    cum = np.cumsum(np.bincount(ex, minlength=block.batch_size))
    return int(np.searchsorted(cum, uniq_bucket - 1, side="right"))


def probe_uniq_bucket(cfg: FmConfig, files: Sequence[str],
                      batch_size: Optional[int] = None) -> int:
    """The fixed unique-row bucket of multi-process input, measured from
    the data instead of the worst case (the ladder top, next_pow2(B*L)):
    one batch each from the head, middle and tail of the first, last
    and largest files is parsed (every process reads the same bytes, so
    all agree without a collective), and the result is the next power
    of two >= 2x the most unique ids seen (>= 64, > the per-example
    cap, <= the ladder top). A denser batch the probe missed spills."""
    B = batch_size or cfg.batch_size
    files = expand_files(files)
    top = _uniq_ladder(B, effective_L_cap(cfg))[-1]
    retry = RetryPolicy.from_config(cfg)
    # A tolerant policy must not die in the probe on a line the sweep
    # would skip: the density estimate ignores bad lines.
    tolerant = cfg.bad_line_policy != "error"
    cand = sorted({files[0], files[-1], max(files, key=os.path.getsize)})
    u_max = 0
    got_lines = False
    for path in cand:
        size = retry_io(os.path.getsize, path, policy=retry,
                        op="probe_stat")
        for start in sorted({0, size // 3, 2 * size // 3}):
            lines: List[str] = []
            for line in _iter_range_lines(path, start, size, retry=retry):
                if line.strip(WHITESPACE):
                    lines.append(line)
                if len(lines) >= B:
                    break
            if not lines:
                continue
            got_lines = True
            try:
                block = (_salvage_block(lines[:B], cfg, False, [])
                         if tolerant else _parse_block(lines[:B], cfg))
            except ParseError as e:
                raise ParseError(f"{path} (uniq-bucket probe near byte "
                                 f"{start}): "
                                 f"{_strip_line_prefix(str(e))}") from None
            u_max = max(u_max, len(np.unique(block.ids)))
    if not got_lines:
        return min(1 << 10, top)
    b = 64
    while b < 2 * (u_max + 2) or b <= cfg.max_features_per_example:
        b *= 2
    return min(b, top)


def uniq_bucket_top(cfg: FmConfig, batch_size: Optional[int] = None) -> int:
    """The worst-case unique bucket (the ladder top): the ceiling of
    train's epoch-boundary raise."""
    return _uniq_ladder(batch_size or cfg.batch_size,
                        effective_L_cap(cfg))[-1]


def empty_batch(cfg: FmConfig, batch_size: Optional[int] = None,
                uniq_bucket: int = 0) -> DeviceBatch:
    """An all-padding fixed-shape batch (num_real 0, zero weights): the
    filler a rank whose shard ran dry feeds while its peers finish;
    every term it adds to a loss, a gradient or a regularizer is zero.
    ``uniq_bucket`` must be the live batches'."""
    fields = (np.zeros(0, np.int32) if cfg.model_type == "ffm" else None)
    block = ParsedBlock(labels=np.zeros(0, np.float32),
                        poses=np.zeros(1, np.int32),
                        ids=np.zeros(0, np.int32),
                        vals=np.zeros(0, np.float32), fields=fields)
    return make_device_batch(block, cfg, batch_size or 0, raw_ids=False,
                             fixed_shape=True,
                             uniq_bucket=uniq_bucket or cfg.uniq_bucket)


def _salvage_block(lines: Sequence[str], cfg: FmConfig, keep_empty: bool,
                   bads: List[Tuple[int, str, str]]) -> ParsedBlock:
    """The one cfg -> ``parse_lines_salvage`` plumbing (tolerant block
    parse)."""
    return cparser.parse_lines_salvage(
        lines, cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        field_aware=cfg.model_type == "ffm", field_num=cfg.field_num,
        max_features_per_example=cfg.max_features_per_example,
        keep_empty=keep_empty, bad_lines=bads)


def _parse_block(lines: Sequence[str], cfg: FmConfig,
                 keep_empty: bool = False) -> ParsedBlock:
    """The strict block parse, in C++."""
    return cparser.parse_lines_fast(
        lines, cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
        field_aware=cfg.model_type == "ffm", field_num=cfg.field_num,
        max_features_per_example=cfg.max_features_per_example,
        keep_empty=keep_empty)


def plain_batch_iterator(cfg: FmConfig, files: Sequence[str],
                         training: bool = True,
                         epochs: Optional[int] = None,
                         batch_size: Optional[int] = None,
                         seed: Optional[int] = None,
                         keep_empty: bool = False,
                         vocab=None) -> Iterator[DeviceBatch]:
    """The fast path's raw-ids stream, built in plain Python: lines
    through the pure-Python ``parse_lines`` and ``make_device_batch``,
    B example-producing lines a batch across file boundaries, a short
    batch closing each epoch, shuffled by the same ``_BatchEmitter``.
    No C++ runs: this is the plain version the C++ stream is held to
    (tests, ``chip_smoke.py``). ``vocab``: as ``batch_iterator``'s."""
    return _remapped(vocab, _plain_batch_iterator_impl(
        cfg if vocab is None else vocab.build_cfg(cfg), files, training,
        epochs, batch_size, seed, keep_empty))


def _plain_batch_iterator_impl(cfg: FmConfig, files: Sequence[str],
                               training: bool, epochs: Optional[int],
                               batch_size: Optional[int],
                               seed: Optional[int], keep_empty: bool
                               ) -> Iterator[DeviceBatch]:
    files = expand_files(files)
    B = batch_size or cfg.batch_size
    n_epochs = epochs if epochs is not None else (cfg.epoch_num if training
                                                  else 1)
    shuffle = training and cfg.shuffle
    emitter = _BatchEmitter(cfg, B, shuffle, seed)
    file_seed = cfg.seed if seed is None else seed

    def build(lines: List[str], sources: List[Source]):
        try:
            block = parse_lines(
                lines, cfg.vocabulary_size,
                hash_feature_id=cfg.hash_feature_id,
                field_aware=cfg.model_type == "ffm",
                field_num=cfg.field_num,
                max_features_per_example=cfg.max_features_per_example,
                keep_empty=keep_empty)
        except ParseError as e:
            raise _attach_block_source(e, sources) from None
        b = make_device_batch(block, cfg, B)
        max_nnz = int(block.sizes.max()) if block.batch_size else 0
        return (b.num_real, b.labels, None, b.local_idx, b.vals, b.fields,
                max_nnz)

    for epoch in range(n_epochs):
        lines: List[str] = []
        sources: List[Source] = []
        for path in epoch_file_order(files, shuffle, file_seed, epoch):
            for lineno, line in enumerate(_iter_range_lines(path), 1):
                if not (keep_empty or line.strip(WHITESPACE)):
                    continue
                lines.append(line)
                sources.append((path, lineno))
                if len(lines) == B:
                    yield from emitter.emit_drain(build(lines, sources))
                    lines, sources = [], []
        if lines:  # short final batch of the epoch
            yield from emitter.emit_drain(build(lines, sources))
        yield from emitter.flush_window()


def prefetch(iterator: Iterator[DeviceBatch], depth: int = 2,
             gil_bound: bool = False) -> Iterator[DeviceBatch]:
    """Run ``iterator`` in a background thread, ``depth`` batches ahead,
    so parsing overlaps the device's steps. An error in the thread is
    re-raised on the consumer side; a consumer that stops early leaves
    no thread blocked. ``gil_bound`` (``gil_bound_iteration``): on a
    single core such an iterator would contend with the consumer for
    the GIL, so it runs in the consumer's thread instead."""
    if gil_bound and _host_cpus() <= 1:
        yield from iterator
        return
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    stop = threading.Event()
    errbox: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            errbox.append(e)
        finally:
            # A consumer that stopped early leaves the iterator open:
            # close it here, in the thread that drives it, so that its
            # build pool is joined now and not at garbage collection.
            try:
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
            except BaseException as e:  # re-raised on the consumer side
                errbox.append(e)
            put(sentinel)

    threading.Thread(target=worker, name="prefetch", daemon=True).start()
    ledgered = False
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errbox:
                    raise errbox[0]
                return
            if not ledgered:
                # The prefetch window's standing footprint (queue depth
                # and the batch in hand), sized once from the first
                # batch: host numpy until the wire places it.
                ledgered = True
                nb = sum(getattr(v, "nbytes", 0)
                         for v in getattr(item, "__dict__", {}).values())
                if nb:
                    LEDGER.register("prefetch_batches",
                                    (max(depth, 1) + 1) * nb, host=True)
            yield item
    finally:
        stop.set()
        LEDGER.release("prefetch_batches")
