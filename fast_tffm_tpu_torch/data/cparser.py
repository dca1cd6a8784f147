"""ctypes loader for the port's C++ parser (``_parser.cc``) — the
counterpart of ``fast_tffm_tpu/data/cparser.py``.

``_parser.cc`` is a byte-for-byte copy of the JAX package's source
(tests/test_torch_cparser.py holds the two files equal). It is host
code: g++ builds it into a shared library with a plain C interface at
first use, into ``fast_tffm_tpu_torch/_build/`` (listed in
``.gitignore``, shared with the CUDA kernels, ``ops/build.BUILD_DIR``),
under a name keyed by a hash of the source, the compiler and its flags,
so a stale object is never reused. ``parse_lines_fast`` matches
``parser.parse_lines``'s contract bit for bit.

There is no fallback: when the library cannot be built or loaded, every
entry point here raises ``RuntimeError`` with the compiler's output, and
the pipeline lets it propagate instead of parsing in Python (the JAX
package falls back to its Python parser; ROADMAP.md §C).

With a run's telemetry active, the parser counts what every pipeline
path feeds it, as the JAX package's ``_tel()`` hooks do:
``pipeline/lines_parsed`` and ``pipeline/parse_errors`` per block,
``pipeline/bytes_fed`` for ``BatchBuilder``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from fast_tffm_tpu_torch.data.parser import (ParsedBlock, ParseError,
                                             parse_lines)
from fast_tffm_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_parser.cc")

# The compiler and its flags (the JAX package's, minus -march=native:
# the library may be built on one host and loaded on another).
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# Must equal fm_abi_version() in _parser.cc.
_ABI_VERSION = 7

_SYMBOLS = ("fm_abi_version", "fm_auto_threads", "fm_parse_block",
            "fm_dedup_ids", "fm_scan_examples", "fm_bb_new", "fm_bb_feed",
            "fm_bb_finish", "fm_bb_free")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _tel():
    """The active run telemetry (obs/), or None."""
    from fast_tffm_tpu_torch.obs.telemetry import active
    return active()


def library_path() -> str:
    """Where the library lives: keyed by a hash of the source bytes, the
    compiler and its flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return os.path.join(BUILD_DIR, f"lib_parser-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile ``_parser.cc`` into ``out``: to a private name first, then
    ``os.replace``, so a process building the same library at the same
    time never loads a half-written one. Raises RuntimeError with the
    compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(
            f"C++ parser unavailable: cannot run {CXX!r} to build "
            f"{_SRC}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"C++ parser unavailable: {CXX} failed ({proc.returncode}) "
            f"building {_SRC}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _open_checked(path: str) -> Optional[ctypes.CDLL]:
    """dlopen ``path`` and check that every symbol exists and the
    compiled-in ABI version matches this wrapper; None for a stale or
    unloadable file, which the caller rebuilds once."""
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    if not all(hasattr(lib, name) for name in _SYMBOLS):
        return None
    lib.fm_abi_version.restype = ctypes.c_int64
    lib.fm_abi_version.argtypes = []
    if lib.fm_abi_version() != _ABI_VERSION:
        return None
    return lib


def _load() -> ctypes.CDLL:
    """The library, built if needed, loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.isfile(out):
            _build(out)
        lib = _open_checked(out)
        if lib is None:
            # A stale file under the current name: rebuild it, and open
            # the new one through a one-off path, since dlopen dedups by
            # path name and would hand back the stale mapping.
            _build(out)
            reload_path = f"{out}.reload.{os.getpid()}"
            shutil.copy2(out, reload_path)
            try:
                lib = _open_checked(reload_path)
            finally:
                os.unlink(reload_path)
            if lib is None:
                raise RuntimeError(
                    f"C++ parser unavailable: {out} is still a stale ABI "
                    "after a rebuild")
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.fm_auto_threads.restype = ctypes.c_int
    lib.fm_auto_threads.argtypes = []
    lib.fm_parse_block.restype = ctypes.c_int
    lib.fm_parse_block.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,              # buffer, length
        ctypes.c_int64, ctypes.c_int,                 # vocab, hash flag
        ctypes.c_int, ctypes.c_int64,                 # field flag, count
        ctypes.c_int,                                 # max feats/example
        ctypes.c_int,                                 # keep_empty
        ctypes.c_int,                                 # num threads
        ctypes.POINTER(ctypes.c_int64),               # out: n_examples
        ctypes.POINTER(ctypes.c_int64),               # out: nnz
        np.ctypeslib.ndpointer(np.float32),           # labels buf
        np.ctypeslib.ndpointer(np.int32),             # poses buf
        np.ctypeslib.ndpointer(np.int32),             # ids buf
        np.ctypeslib.ndpointer(np.float32),           # vals buf
        np.ctypeslib.ndpointer(np.int32),             # fields buf
        ctypes.c_char_p, ctypes.c_int64,              # err buf, err cap
    ]
    lib.fm_dedup_ids.restype = ctypes.c_int64
    lib.fm_dedup_ids.argtypes = [
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32),             # uniq out
        np.ctypeslib.ndpointer(np.int32),             # inverse out
    ]
    lib.fm_scan_examples.restype = ctypes.c_int64
    lib.fm_scan_examples.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,              # blob, length
        ctypes.c_int64, ctypes.c_int,                 # n_target, keep
        ctypes.POINTER(ctypes.c_int64),               # out: consumed
        ctypes.POINTER(ctypes.c_int64)]               # out: lines
    lib.fm_bb_new.restype = ctypes.c_void_p
    lib.fm_bb_new.argtypes = [ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int64,  # field flag, count
                              ctypes.c_int,                  # raw_ids
                              ctypes.c_int,                  # keep_empty
                              ctypes.c_int, ctypes.c_int64,
                              ctypes.c_int]                  # num_threads
    lib.fm_bb_free.argtypes = [ctypes.c_void_p]
    lib.fm_bb_feed.restype = ctypes.c_int
    lib.fm_bb_feed.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int64]
    lib.fm_bb_finish.restype = ctypes.c_int64
    lib.fm_bb_finish.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float32),           # labels
        np.ctypeslib.ndpointer(np.int32),             # uniq
        np.ctypeslib.ndpointer(np.int32),             # local_idx
        np.ctypeslib.ndpointer(np.float32),           # vals
        np.ctypeslib.ndpointer(np.int32),             # fields
        ctypes.POINTER(ctypes.c_int64),               # n_uniq
        ctypes.POINTER(ctypes.c_int64)]               # max_nnz


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def auto_threads() -> int:
    """The parse-thread count a ``num_threads=0`` builder uses, read
    from the library (fm_auto_threads) so reporting cannot drift from
    the C++ rule."""
    return int(_load().fm_auto_threads())


def parse_lines_fast(lines: Sequence[str], vocabulary_size: int,
                     hash_feature_id: bool = False,
                     field_aware: bool = False, field_num: int = 0,
                     max_features_per_example: int = 0,
                     keep_empty: bool = False,
                     num_threads: int = 0) -> ParsedBlock:
    """C++ ``parse_lines`` (FM and field-aware FFM formats), equal to the
    Python parser bit for bit. ``keep_empty`` keeps blank lines as
    zero-feature label-0 examples. Raises RuntimeError when the library
    is unusable, ParseError on malformed input."""
    lib = _load()
    # The output buffers are sized from len(lines), but the C++ side
    # splits the joined blob on '\n': an embedded newline would make it
    # emit more examples than allocated. The Python parser reads '\n'
    # inside a line as token whitespace, so ' ' keeps parity.
    lines = [ln.replace("\n", " ") if "\n" in ln else ln for ln in lines]
    blob = "\n".join(lines).encode("utf-8")
    if keep_empty and lines:
        # Terminate the final line: a trailing empty line is invisible
        # to the newline walk, and under keep_empty it owes an example.
        blob += b"\n"
    n_lines = len(lines)
    # Worst-case token count bounds the output buffers: a feature token
    # is at least 2 bytes ("i "), a line at least 2 ("0\n").
    max_nnz = max(len(blob) // 2 + 1, 1)
    labels = np.empty(n_lines, dtype=np.float32)
    poses = np.empty(n_lines + 1, dtype=np.int32)
    ids = np.empty(max_nnz, dtype=np.int32)
    vals = np.empty(max_nnz, dtype=np.float32)
    fields = np.empty(max_nnz if field_aware else 1, dtype=np.int32)
    n_ex = ctypes.c_int64(0)
    nnz = ctypes.c_int64(0)
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.fm_parse_block(
        blob, len(blob), vocabulary_size, int(hash_feature_id),
        int(field_aware), field_num,
        max_features_per_example, int(keep_empty), num_threads,
        ctypes.byref(n_ex), ctypes.byref(nnz),
        labels, poses, ids, vals, fields, errbuf, len(errbuf))
    tel = _tel()
    if rc != 0:
        if tel is not None:
            tel.count("pipeline/parse_errors")
        raise ParseError(errbuf.value.decode("utf-8", "replace"))
    if tel is not None:
        tel.count("pipeline/lines_parsed", len(lines))
    b = n_ex.value
    z = nnz.value
    return ParsedBlock(labels=labels[:b].copy(), poses=poses[:b + 1].copy(),
                       ids=ids[:z].copy(), vals=vals[:z].copy(),
                       fields=fields[:z].copy() if field_aware else None)


def scan_examples(data: bytes, n_target: int, keep_empty: bool = False,
                  offset: int = 0) -> "tuple[int, int, int]":
    """Count example-producing lines in the complete lines of
    ``data[offset:]`` up to ``n_target``, without parsing: returns
    ``(found, bytes_consumed, lines_consumed)``, where ``bytes_consumed``
    ends at the last counted line's newline (relative to ``offset``) and
    ``lines_consumed`` includes the blank lines inside that span. The
    counting rule is the BatchBuilder's own (C++ ``is_ws``). Zero-copy
    via pointer arithmetic, like ``BatchBuilder.feed``."""
    lib = _load()
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
    consumed = ctypes.c_int64(0)
    nlines = ctypes.c_int64(0)
    found = lib.fm_scan_examples(ctypes.c_void_p((base or 0) + offset),
                                 len(data) - offset, n_target,
                                 int(keep_empty), ctypes.byref(consumed),
                                 ctypes.byref(nlines))
    return int(found), int(consumed.value), int(nlines.value)


def parse_lines_salvage(lines: Sequence[str], vocabulary_size: int,
                        hash_feature_id: bool = False,
                        field_aware: bool = False, field_num: int = 0,
                        max_features_per_example: int = 0,
                        keep_empty: bool = False,
                        bad_lines: Optional[list] = None) -> ParsedBlock:
    """Tolerant block parse (``bad_line_policy = skip|quarantine``): the
    block goes through the C++ parser first, and only a failing block is
    parsed again by the Python parser's per-line tolerant mode, which
    records each bad line into ``bad_lines`` as ``(index, raw,
    message)`` and returns the block without them (under ``keep_empty``
    a bad line becomes a zero-feature example instead). Every buffer is
    per call, so the parallel data plane's workers call this at once."""
    if bad_lines is None:
        bad_lines = []
    try:
        return parse_lines_fast(
            lines, vocabulary_size,
            hash_feature_id=hash_feature_id,
            field_aware=field_aware, field_num=field_num,
            max_features_per_example=max_features_per_example,
            keep_empty=keep_empty)
    except ParseError:
        pass  # failing block -> tolerant Python retry below
    return parse_lines(
        lines, vocabulary_size, hash_feature_id=hash_feature_id,
        field_aware=field_aware, field_num=field_num,
        max_features_per_example=max_features_per_example,
        keep_empty=keep_empty, bad_lines=bad_lines)


class BatchBuilder:
    """Streaming raw-bytes -> padded-batch builder (C++ ``fm_bb_*``).

    ``feed(chunk)`` consumes whole lines until the batch holds B
    examples, returning True when full (unconsumed tail bytes of the
    chunk must be fed again). ``finish()`` returns the padded arrays —
    labels [B], uniq [n_uniq] with slot 0 = pad_id, local_idx [B, L],
    vals [B, L] — and resets for the next batch: parse, hash, dedup and
    padded scatter in one native pass.

    The library keeps all state per handle, so a pool of threads each
    owning one builder is safe, and every ctypes call releases the GIL.
    A single handle is not locked: one builder belongs to one thread.
    """

    def __init__(self, batch_size: int, max_cols: int,
                 vocabulary_size: int, hash_feature_id: bool = False,
                 field_aware: bool = False, field_num: int = 0,
                 raw_ids: bool = False, keep_empty: bool = False,
                 max_features_per_example: int = 0, max_uniq: int = 0,
                 num_threads: int = 0):
        """``raw_ids`` (dedup = device) skips the dedup pass: local_idx
        holds raw feature ids (pad cells = vocabulary_size) and finish()
        returns uniq=None. ``keep_empty`` turns blank lines into
        zero-feature examples (label 0). ``max_uniq`` > 0 caps the
        batch's unique rows (the multi-process fixed-U protocol).
        ``num_threads`` sets the feed's parse threads (0 = auto:
        min(8, cores)); outputs are byte-identical for any count."""
        self._lib = _load()
        self.B, self.L = batch_size, max_cols
        self.field_aware = field_aware
        self.raw_ids = raw_ids
        self._h = self._lib.fm_bb_new(batch_size, max_cols,
                                      vocabulary_size,
                                      int(hash_feature_id),
                                      int(field_aware), field_num,
                                      int(raw_ids), int(keep_empty),
                                      max_features_per_example,
                                      max_uniq, num_threads)
        if not self._h:
            # ValueError, not RuntimeError: the library is there, the
            # arguments are wrong.
            raise ValueError("fm_bb_new rejected its arguments (bad "
                             "sizes, or max_uniq <= max feature count "
                             "per example)")
        self._err = ctypes.create_string_buffer(512)

    def feed(self, chunk: bytes, offset: int = 0) -> "tuple[bool, int]":
        """Feed ``chunk[offset:]`` (zero-copy via pointer arithmetic).
        Returns (batch_full, bytes_consumed)."""
        base = ctypes.cast(ctypes.c_char_p(chunk), ctypes.c_void_p).value
        consumed = ctypes.c_int64(0)
        rc = self._lib.fm_bb_feed(self._h,
                                  ctypes.c_void_p((base or 0) + offset),
                                  len(chunk) - offset,
                                  ctypes.byref(consumed), self._err,
                                  len(self._err))
        tel = _tel()
        if rc < 0:
            if tel is not None:
                tel.count("pipeline/parse_errors")
            raise ParseError(self._err.value.decode("utf-8", "replace"))
        if tel is not None:
            # ``BatchBuilder`` forms no Python lines: bytes fed is
            # its parse-volume counter.
            tel.count("pipeline/bytes_fed", consumed.value)
        return rc == 1, consumed.value

    def finish(self):
        """-> (n_examples, labels[B], uniq[n_uniq] or None,
        local_idx[B,L], vals[B,L], fields[B,L] or None, max_nnz); resets
        the builder."""
        labels = np.empty(self.B, np.float32)
        uniq = np.empty(self.B * self.L + 1, np.int32)
        li = np.empty((self.B, self.L), np.int32)
        vals = np.empty((self.B, self.L), np.float32)
        fields = np.empty((self.B, self.L) if self.field_aware else (1, 1),
                          np.int32)
        n_uniq = ctypes.c_int64(0)
        max_nnz = ctypes.c_int64(0)
        n = self._lib.fm_bb_finish(self._h, labels, uniq, li, vals, fields,
                                   ctypes.byref(n_uniq),
                                   ctypes.byref(max_nnz))
        return (int(n), labels,
                None if self.raw_ids else uniq[:n_uniq.value].copy(),
                li, vals,
                fields if self.field_aware else None, int(max_nnz.value))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fm_bb_free(h)
            self._h = None


def dedup_ids_fast(ids: np.ndarray):
    """First-occurrence unique ids and each id's index into them (the
    ``np.unique(return_inverse=True)`` contract, in order of first
    occurrence instead of sorted)."""
    lib = _load()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n = len(ids)
    if n == 0:
        return ids[:0], np.zeros(0, dtype=np.int32)
    uniq = np.empty(n, dtype=np.int32)
    inverse = np.empty(n, dtype=np.int32)
    n_uniq = lib.fm_dedup_ids(ids, n, uniq, inverse)
    return uniq[:n_uniq].copy(), inverse
