"""Host batch assembly: text files -> padded [B, L] batches.

The single-process, raw-ids subset of ``fast_tffm_tpu/data/pipeline.py``:

- ``make_device_batch`` (raw-ids branch, the layout every port path
  uses: ``dedup = device``), its bucket fit ``_ladder_fit``, the
  ``require_bounded_examples`` guard and ``expand_files``;
- ``batch_iterator``, the training and validation stream. It yields
  the stream the JAX package's C++ fast path (``_fast_batch_iterator``)
  yields: per epoch, files in ``epoch_file_order``; B consecutive
  non-blank lines per batch, across file boundaries; a short batch
  closing each epoch; the ``_BatchEmitter`` window shuffle and row
  permutation with the same generators and the same draw order. The
  port parses with its pure-Python parser, not the C++ ``BatchBuilder``;
- ``prefetch``: one background thread, ``depth`` batches ahead.

Not ported yet: the host-side unique pass and the C++ ``BatchBuilder``
(A4), sharding and ``fixed_shape`` (A10); weight files, tolerant
``bad_line_policy`` and the generic reservoir path that
``max_features_per_example = 0`` takes raise ``NotImplementedError``
naming A4.

Padding invariants, as in the JAX package: pad cells of ``local_idx``
hold ``pad_id == vocabulary_size`` (the table's dead zero row) and pad
cells of ``vals`` hold 0.0, so a pad slot adds exactly zero to a score;
pad examples have weight 0.0 and no features.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import queue
import random
import re
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import (WHITESPACE, ParsedBlock,
                                             ParseError, parse_lines)


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


@dataclasses.dataclass
class DeviceBatch:
    """One padded batch of B examples with L feature slots each.
    ``local_idx`` holds RAW table rows (pad cells = pad_id)."""
    labels: np.ndarray       # f32 [B]
    weights: np.ndarray      # f32 [B]; 0.0 marks padded dummy examples
    local_idx: np.ndarray    # i32 [B, L]; raw row ids
    vals: np.ndarray         # f32 [B, L]; 0.0 padding
    num_real: int = 0        # examples that are not padding


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


def _ladder_fit(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    # beyond the configured ladder: next power of two
    b = ladder[-1]
    while b < n:
        b *= 2
    return b


def make_device_batch(block: ParsedBlock, cfg: FmConfig,
                      batch_size: int = 0) -> DeviceBatch:
    """CSR block -> padded raw-ids DeviceBatch: B = ``batch_size`` (or
    cfg.batch_size) examples, L = the smallest ``bucket_ladder`` rung
    that holds the longest example."""
    B = batch_size or cfg.batch_size
    n_real = block.batch_size
    if n_real > B:
        raise ValueError(f"block of {n_real} examples exceeds batch_size {B}")
    sizes = block.sizes
    max_l = int(sizes.max()) if n_real else 1
    L = _ladder_fit(max(max_l, 1), cfg.bucket_ladder)

    local_idx = np.full((B, L), cfg.pad_id, dtype=np.int32)
    vals = np.zeros((B, L), dtype=np.float32)
    if n_real:
        # Vectorized CSR -> padded scatter.
        ex_sizes = np.diff(block.poses[:n_real + 1])
        rows = np.repeat(np.arange(n_real), ex_sizes)
        cols = np.arange(len(rows)) - np.repeat(block.poses[:n_real],
                                                ex_sizes)
        local_idx[rows, cols] = block.ids
        vals[rows, cols] = block.vals

    labels = np.zeros(B, dtype=np.float32)
    labels[:n_real] = block.labels
    w = np.zeros(B, dtype=np.float32)
    w[:n_real] = 1.0
    return DeviceBatch(labels=labels, weights=w, local_idx=local_idx,
                       vals=vals, num_real=n_real)


def epoch_file_order(files: List[str], shuffle: bool, seed: int,
                     epoch: int) -> List[str]:
    """Per-epoch file visit order: shuffled when shuffling is on, from a
    dedicated per-(seed, epoch) Random, never the stream's rng."""
    if not shuffle or len(files) < 2:
        return files
    out = list(files)
    random.Random(f"{seed}/{epoch}").shuffle(out)
    return out


def _iter_lines(path: str, chunk_bytes: int = 4 << 20
                ) -> Iterator[Tuple[str, int]]:
    """(line, 1-based line number) for every non-blank line of ``path``.
    Lines split on b"\\n" before decoding (a multibyte character across
    a chunk boundary survives); a final line without its newline still
    counts; blank means only libsvm separator bytes."""
    tail = b""
    lineno = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(chunk_bytes)
            if not chunk:
                break
            parts = (tail + chunk if tail else chunk).split(b"\n")
            tail = parts.pop()
            for raw in parts:
                lineno += 1
                line = raw.decode("utf-8")
                if line.strip(WHITESPACE):
                    yield line, lineno
    if tail:
        line = tail.decode("utf-8")
        if line.strip(WHITESPACE):
            yield line, lineno + 1


class _BatchEmitter:
    """Window shuffle and row permutation of built batches — the JAX
    package's ``_BatchEmitter`` in raw-ids mode: the same rng
    construction, the same draws per emitted batch, the same window."""

    def __init__(self, cfg: FmConfig, B: int, shuffle: bool,
                 seed: Optional[int]):
        self.B = B
        self.shuffle = shuffle
        self.pyrng = random.Random(cfg.seed if seed is None else seed)
        self.nprng = np.random.default_rng(self.pyrng.getrandbits(64))
        self.window: List[DeviceBatch] = []
        self.window_cap = (max(2, cfg.queue_size // B) if shuffle
                           else 1)

    def emit_drain(self, batch: DeviceBatch) -> Iterator[DeviceBatch]:
        """Permute one batch's real rows and drain it through the bounded
        shuffle window (a passthrough when shuffle is off)."""
        if not self.shuffle:
            yield batch
            return
        n = batch.num_real
        if n > 1:
            # Only the real rows: the padding block stays at the tail.
            perm = np.concatenate([self.nprng.permutation(n),
                                   np.arange(n, self.B)])
            batch = DeviceBatch(labels=batch.labels[perm],
                                weights=batch.weights[perm],
                                local_idx=batch.local_idx[perm],
                                vals=batch.vals[perm], num_real=n)
        self.window.append(batch)
        if len(self.window) >= self.window_cap:
            yield self.window.pop(self.pyrng.randrange(len(self.window)))

    def flush_window(self) -> Iterator[DeviceBatch]:
        while self.window:
            yield self.window.pop(self.pyrng.randrange(len(self.window)))


_LINE_MSG = re.compile(r"^line (\d+): (.*)$", re.S)


def _build(cfg: FmConfig, B: int, lines: List[str],
           sources: List[Tuple[str, int]]) -> DeviceBatch:
    """Parse a chunk of lines into a padded raw-ids batch; a parse
    error names the file and line it came from."""
    try:
        block = parse_lines(
            lines, cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
            max_features_per_example=cfg.max_features_per_example)
    except ParseError as e:
        m = _LINE_MSG.match(str(e))
        if m is None:
            raise
        path, lineno = sources[int(m.group(1))]
        raise ParseError(f"{path} line {lineno}: {m.group(2)}") from None
    return make_device_batch(block, cfg, B)


def check_stream_supported(cfg: FmConfig) -> None:
    """Refuse the stream options this port does not have yet, naming
    the ROADMAP.md item that brings each."""
    refusals = (
        (cfg.weight_files or cfg.validation_weight_files,
         "weight_files / validation_weight_files", "A4"),
        (cfg.bad_line_policy != "error",
         f"bad_line_policy = {cfg.bad_line_policy}", "A4"),
        (cfg.max_features_per_example <= 0,
         "max_features_per_example = 0 (the generic reservoir stream)",
         "A4"),
    )
    for refused, what, item in refusals:
        if refused:
            raise NotImplementedError(
                f"{what} is not ported to fast_tffm_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")


def batch_iterator(cfg: FmConfig, files: Sequence[str],
                   training: bool = True,
                   epochs: Optional[int] = None,
                   batch_size: Optional[int] = None,
                   seed: Optional[int] = None) -> Iterator[DeviceBatch]:
    """Epoch/shuffle/batch loop over text files: the batches the JAX
    package's ``batch_iterator(cfg, files, training, epochs=epochs,
    batch_size=batch_size, seed=seed, raw_ids=True)`` yields on its C++
    fast path, array for array. Shuffling (training with
    ``cfg.shuffle``) is the window-of-batches pick plus the per-batch
    row permutation of ``_BatchEmitter``."""
    check_stream_supported(cfg)
    files = expand_files(files)
    B = batch_size or cfg.batch_size
    n_epochs = epochs if epochs is not None else (cfg.epoch_num if training
                                                  else 1)
    shuffle = training and cfg.shuffle
    emitter = _BatchEmitter(cfg, B, shuffle, seed)
    file_seed = cfg.seed if seed is None else seed
    for epoch in range(n_epochs):
        lines: List[str] = []
        sources: List[Tuple[str, int]] = []
        for path in epoch_file_order(files, shuffle, file_seed, epoch):
            for line, lineno in _iter_lines(path):
                lines.append(line)
                sources.append((path, lineno))
                if len(lines) == B:
                    yield from emitter.emit_drain(
                        _build(cfg, B, lines, sources))
                    lines, sources = [], []
        if lines:  # short final batch of the epoch
            yield from emitter.emit_drain(_build(cfg, B, lines, sources))
        yield from emitter.flush_window()


def prefetch(iterator: Iterator[DeviceBatch],
             depth: int = 2) -> Iterator[DeviceBatch]:
    """Run ``iterator`` in a background thread, ``depth`` batches ahead,
    so parsing overlaps the device's steps. An error in the thread is
    re-raised on the consumer side; a consumer that stops early leaves
    no thread blocked."""
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
            put(sentinel)

    threading.Thread(target=worker, name="prefetch", daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errbox:
                    raise errbox[0]
                return
            yield item
    finally:
        stop.set()
