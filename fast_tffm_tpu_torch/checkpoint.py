"""Checkpoints, the ``published`` pointer and step integrity — the port's
counterpart of ``fast_tffm_tpu/checkpoint.py``, in torch's own format
(the card's machine has no jax, orbax or tensorstore).

Everything outside a step directory keeps the JAX package's contract,
byte for byte: ``<model_file>.ckpt/`` holds digit-named step
directories, each committed by an atomic rename; beside each step, a
``manifest-<step>.json`` (per-file size + crc32, the step/epoch/vocab
echo, ``format: 1``) and, where the final save corrected a stale epoch
count, ``epoch_override-<step>``; in ``run_mode = stream``, the
step's stream position, ``watermark-<step>.json``; in ``vocab_mode =
admit``, the step's slot map and sketch, ``vocab-<step>.json.gz`` (gzip
of the sorted-key JSON payload with its own crc32: either package reads
the other's); a step that fails verification (or fails to load) is
quarantined as ``corrupt-<step>[.k]`` with its sidecars, and restore
walks back to the next older step, its older watermark and its older
slot map; the ``published`` and ``published-canary`` pointer
files name the step a scorer serves, and ``gate_baseline`` beside them
holds the publish gate's drop baseline. So the JAX package's
``tools.fmckpt ls``/``verify`` read a port directory as they read their
own.

Inside a step directory, ``<dir>/<step>/``: ``table.pt`` and ``acc.pt``,
one ``[ckpt_rows, D]`` float32 tensor each (``torch.save``; the rows
past ``vocabulary_size + 1`` are padding: zeros in the table,
``adagrad_init`` in the accumulator, as the JAX package's
``train.ckpt_state`` pads them), and ``meta.json``,
``{"format": "fast_tffm_tpu_torch/1", "step", "epoch", "vocab"}``. A
step is written under ``<step>.tmp``, fsynced, renamed to ``<step>``,
and the directory fsynced.

The two packages' step directories are not interchangeable: a step
without the port's ``meta.json`` mark (an orbax step) is refused loudly
and never quarantined; ``models/convert.save_checkpoint_from_numpy``
carries a JAX-trained model across.

``restore_partial`` (the offload predict path, lookup.py) loads the
table alone; the accumulator is never read.

Multi-process (``dist_train``; ``mesh``, a parallel.sharded.ProcessMesh):
the step files keep this one format. A save gathers the ranks' row
shards to the chief in 64 MB chunks (each rank sends one chunk at a
time), and only the chief writes the step, the manifest, the sidecars
and the pointers; a restore loads each rank's own rows of the stored
``[ckpt_rows, D]`` arrays (memory-mapped), so a step saved by N ranks
restores on any power-of-two count, 1 included. Every decision rides a
chief broadcast under the deadline guard: which step to restore
(``_broadcast_int``), whether every rank loaded it (``_all_agree``),
the epoch override and the sidecars, and whether a save writes.

With a run's telemetry active: ``checkpoint/save`` and
``checkpoint/restore`` spans, the ``checkpoint/saves``,
``checkpoint/fallbacks``, ``stream/publishes`` and
``stream/publish_failures`` counters, and a quarantine's ``health:
ckpt_fallback`` event with ``checkpoint/quarantined_steps``, as in the
JAX package. Across processes each rank counts into its own shard: the
chief's gather of the shards and its merged watermark run inside its
``checkpoint/save`` span, and every broadcast and gather is a
``collective`` event of the protocol trace (parallel/liveness.py).
"""

from __future__ import annotations

import gzip
import json
import math
import os
import pickle
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fast_tffm_tpu_torch.obs.health import emit_ckpt_fallback
from fast_tffm_tpu_torch.obs.telemetry import active as _tel
from fast_tffm_tpu_torch.obs.trace import span
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.retry import RetryPolicy, retry_io

# ckpt_verify knob values: "off" skips verification, "size" checks
# per-file byte counts against the manifest (catches torn writes for
# one stat per file), "full" also re-hashes every byte (bit rot).
CKPT_VERIFY_MODES = ("off", "size", "full")

# Quarantined step dirs: ``corrupt-<step>`` (+ ``.k`` suffixes when a
# step is quarantined more than once). Never deleted by a run; operators
# reclaim the space with ``fmckpt gc``.
QUARANTINE_PREFIX = "corrupt-"

_MANIFEST_FORMAT = 1
_HASH_CHUNK_BYTES = 1 << 20

# The JAX package's sidecar-name pattern, copied verbatim so that the
# run-time orphan pruning here and either package's fmckpt scan agree
# on what a sidecar is (a killed writer's .tmp litter included).
SIDECAR_RE = re.compile(
    r"(?:epoch_override-(\d+)|manifest-(\d+)\.json(?:\.tmp)?"
    r"|watermark-(\d+)\.json(?:\.tmp)?"
    r"|vocab-(\d+)\.json\.gz(?:\.tmp)?)")

# The pointer files a scorer follows (serve_pointer).
PUBLISHED_POINTER = "published"
CANARY_POINTER = "published-canary"

# The port's format inside a step directory.
STEP_FORMAT = "fast_tffm_tpu_torch/1"
META_FILE = "meta.json"
ARRAYS = ("table", "acc")
# A step being written (``<step>.tmp``) or deleted (``<step>.del``):
# never digit-named, so never listed as committed. A killed writer's
# litter is swept at its next run's first save.
_LITTER_RE = re.compile(r"\d+\.(?:tmp|del)")
# Stored rows are a multiple of this (the JAX package's
# FmConfig.ckpt_rows layout).
ROW_ALIGN = 4096


def ckpt_rows_for(num_rows: int) -> int:
    """Rows as stored: ``num_rows`` rounded up to ROW_ALIGN."""
    return -(-int(num_rows) // ROW_ALIGN) * ROW_ALIGN


def sidecar_step(name: str) -> Optional[int]:
    """The step a sidecar file name belongs to, or None for
    non-sidecar names."""
    m = SIDECAR_RE.fullmatch(name)
    if not m:
        return None
    return int(m.group(1) or m.group(2) or m.group(3) or m.group(4))


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"manifest-{step}.json")


def read_epoch_override(directory: str, step: int) -> Optional[int]:
    """The step's epoch-correction sidecar value, or None
    (missing/garbled/unreadable) — shared by restore's overlay and
    fmckpt's listing so the two can't disagree on what restores."""
    try:
        with open(os.path.join(directory,
                               f"epoch_override-{step}")) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (a directory's fsync makes the
    renames inside it durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_bytes(path: str, blob: bytes) -> None:
    """The one tmp-write + fsync + rename + directory-fsync sequence
    every sidecar writer (manifest, epoch override, pointers) shares:
    the file either exists complete or not at all, and survives a power
    cut once this returns. Deliberately unretried: save-side write
    failures surface at the save site."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_path(os.path.dirname(os.path.abspath(path)))


def _atomic_write_text(path: str, data: str) -> None:
    _atomic_write_bytes(path, data.encode("utf-8"))


def watermark_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"watermark-{step}.json")


def read_watermark(directory: str, step: int) -> Optional[dict]:
    """The step's durable stream-position sidecar (run_mode = stream),
    or None when the step has none (epoch-mode steps never do). A
    garbled sidecar also reads as None, with a warning: train then
    warns that the stream starts from the beginning."""
    path = watermark_path(directory, step)
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None
    except (ValueError, OSError):
        get_logger().warning(
            "stream watermark sidecar %s is unreadable/garbled; "
            "treating step %d as carrying no stream position", path,
            step, exc_info=True)
        return None


def write_watermark(directory: str, step: int, payload: dict) -> str:
    """Atomically renamed watermark write: the sidecar exists complete
    or not at all, so a stream never resumes at a garbage offset."""
    path = watermark_path(directory, step)
    _atomic_write_text(path, json.dumps(payload, sort_keys=True))
    return path


def vocab_sidecar_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"vocab-{step}.json.gz")


def load_vocab_sidecar(directory: str, step: int
                       ) -> Tuple[Optional[dict], Optional[str]]:
    """(payload, reason) for a step's vocab-admission sidecar: the one
    torn-sidecar decision the restore path and ``fmckpt verify`` share.
    Absent -> (None, None); readable with a matching embedded crc32 ->
    (payload, None); unreadable gzip or json, or a crc mismatch ->
    (None, <the failure>)."""
    from fast_tffm_tpu_torch.vocab.table import payload_crc_ok
    path = vocab_sidecar_path(directory, step)
    name = os.path.basename(path)
    try:
        with gzip.open(path, "rt", encoding="utf-8") as fh:
            payload = json.load(fh)
    except FileNotFoundError:
        return None, None
    except (ValueError, OSError, EOFError, zlib.error) as e:
        # zlib.error: a flipped byte inside the deflate stream (the JAX
        # reader lets it escape; the trailer's crc raises OSError).
        return None, f"vocab sidecar {name} is unreadable/garbled: {e}"
    if not payload_crc_ok(payload):
        return None, (f"vocab sidecar {name} failed its embedded "
                      "crc32 check (torn or bit-rotted)")
    return payload, None


def read_vocab_sidecar(directory: str, step: int) -> Optional[dict]:
    """The step's vocab-admission sidecar payload, or None when the step
    has none (every fixed-mode step). A garbled or torn sidecar also
    reads as None, with a warning: an admit-mode resume then starts
    admission fresh and cold-starts every row (train.py)."""
    payload, reason = load_vocab_sidecar(directory, step)
    if reason is not None:
        get_logger().warning(
            "%s; treating step %d as carrying no admission state",
            reason, step)
    return payload


def write_vocab_sidecar(directory: str, step: int, payload: dict) -> str:
    """Atomically renamed gzip write of the vocab admission payload (the
    tmp + fsync + rename + directory-fsync every sidecar gets): it
    exists complete or not at all. The payload carries its own crc32
    (vocab/table.py), which ``read_vocab_sidecar`` and ``fmckpt
    verify`` both check. The bytes are the JAX package's: gzip of the
    sorted-key JSON."""
    path = vocab_sidecar_path(directory, step)
    _atomic_write_bytes(path, gzip.compress(
        json.dumps(payload, sort_keys=True).encode("utf-8")))
    return path


def load_vocab_map(cfg, directory: str, step: Optional[int]):
    """The one inference-side (table, slot map, step) pairing load:
    predict and the serving reload both come here. Returns the step's
    VocabMap; raises FileNotFoundError when the step carries no
    readable sidecar (missing or torn: scoring without the slot map
    would misroute every admitted id)."""
    from fast_tffm_tpu_torch.vocab.table import VocabMap
    payload = (read_vocab_sidecar(directory, int(step))
               if step is not None and step >= 0 else None)
    if payload is None:
        raise FileNotFoundError(
            f"checkpoint step {step} at {directory} carries no "
            "readable vocab admission sidecar (vocab-<step>.json.gz) "
            "but vocab_mode = admit: scoring without the slot map "
            "would misroute every admitted id. Was the model trained "
            "with vocab_mode = fixed?")
    return VocabMap.from_payload(cfg, payload)


def refuse_fixed_mode_admit_step(cfg, directory: str, step: Optional[int],
                                 payload: Optional[dict] = None) -> None:
    """The one admit-trained-under-fixed refusal (train resume, predict
    and the serving reload call it): a step carrying a vocab admission
    sidecar was trained with ``vocab_mode = admit``, so its rows are
    slot-mapped and modulo ids would gather the wrong ones. Keys on the
    sidecar's existence (a torn one still proves admit training) or a
    ``payload`` the caller already read. A no-op under admit mode or
    when ``step`` is unknown."""
    if cfg.vocab_mode != "fixed":
        return
    if payload is None and (step is None or step < 0
                            or not os.path.exists(
                                vocab_sidecar_path(directory, int(step)))):
        return
    raise ValueError(
        f"checkpoint step {step} carries a vocab admission sidecar — "
        "it was trained with vocab_mode = admit, so its table rows "
        "are slot-mapped — but this config has vocab_mode = fixed: "
        "modulo ids would gather/train the wrong rows. Set "
        "vocab_mode = admit (or start a fresh model_file).")


# Beside the published pointer: the validation AUC of the last
# SUCCESSFUL gated publish, the publish gate's drop baseline
# (obs/quality.PublishGate). A resumed trainer re-arms
# publish_max_auc_drop from it.
GATE_BASELINE = "gate_baseline"


def read_gate_baseline(directory: str) -> Optional[float]:
    """The persisted drop baseline, or None (never published through a
    gate, unreadable or garbled: the gate starts baseline-free)."""
    try:
        with open(os.path.join(directory, GATE_BASELINE),
                  encoding="utf-8") as fh:
            v = float(fh.read().strip())
        return v if math.isfinite(v) else None
    except (OSError, ValueError):
        return None


def write_gate_baseline(directory: str, auc: float) -> None:
    """Atomically persist the drop baseline beside the pointer."""
    _atomic_write_text(os.path.join(directory, GATE_BASELINE),
                       f"{float(auc):.10f}\n")


def _read_pointer_file(directory: str, name: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, name), encoding="utf-8") as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None


def read_published(directory: str) -> Optional[int]:
    """The step the ``published`` pointer names, or None (never
    published / unreadable / garbled: the next poll heals it)."""
    return _read_pointer_file(directory, PUBLISHED_POINTER)


def write_published(directory: str, step: int) -> str:
    """Atomically repoint the ``published`` pointer at ``step``; a
    concurrent reader sees the old complete value or the new one.
    Callers own verification."""
    path = os.path.join(directory, PUBLISHED_POINTER)
    _atomic_write_text(path, f"{int(step)}\n")
    return path


def read_canary(directory: str) -> Optional[int]:
    """The step the ``published-canary`` pointer names, or None."""
    return _read_pointer_file(directory, CANARY_POINTER)


def write_canary(directory: str, step: int) -> str:
    """Atomically repoint the canary pointer (same contract as
    write_published)."""
    path = os.path.join(directory, CANARY_POINTER)
    _atomic_write_text(path, f"{int(step)}\n")
    return path


def read_pointer(directory: str, pointer: str = "published"
                 ) -> Optional[int]:
    """Resolve a scorer's configured pointer (``serve_pointer``):
    ``published`` reads the real pointer; ``canary`` reads the canary
    pointer, falling back to ``published`` until a canary step
    exists."""
    if pointer == "canary":
        step = read_canary(directory)
        if step is not None:
            return step
    return read_published(directory)


def wait_for_published(directory: str, last: Optional[int] = None,
                       timeout: Optional[float] = None,
                       poll_seconds: float = 0.5) -> Optional[int]:
    """Block until the ``published`` pointer names a step different
    from ``last`` (None = any published step), polling the pointer
    file. Returns the new step, or None on timeout."""
    deadline = (None if timeout is None
                else time.monotonic() + float(timeout))
    while True:
        step = read_published(directory)
        if step is not None and step != last:
            return step
        if deadline is not None and time.monotonic() >= deadline:
            return None
        time.sleep(poll_seconds)


def list_step_dirs(directory: str) -> List[int]:
    """Committed step numbers by direct directory listing: a
    digit-named directory IS a committed step (a killed writer leaves
    only non-digit names). Listed fresh on every call, so quarantine
    renames are visible at once."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory,
                                                                n)))


def _crc32_file(path: str) -> Tuple[int, int]:
    """(crc32, byte count) of one file, streamed — the one hashing loop
    the save-side manifest and the restore-side full verify share.
    Reads and zlib.crc32 on large buffers release the GIL, so the
    background manifest pass does not stall the train loop."""
    crc = 0
    n = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_HASH_CHUNK_BYTES)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return crc & 0xFFFFFFFF, n


def compute_manifest(directory: str, step: int,
                     payload: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Walk a committed step directory into its integrity manifest:
    per-file byte count + crc32 (sizes from the bytes actually read, so
    size and hash describe the same snapshot), plus the caller's
    payload echo (step/epoch/vocab)."""
    step_dir = os.path.join(directory, str(step))
    files: Dict[str, Dict[str, int]] = {}
    for root, _dirs, names in os.walk(step_dir):
        for name in sorted(names):
            p = os.path.join(root, name)
            rel = os.path.relpath(p, step_dir).replace(os.sep, "/")
            crc, n = _crc32_file(p)
            files[rel] = {"size": n, "crc32": crc}
    man: Dict[str, Any] = {"format": _MANIFEST_FORMAT, "step": int(step),
                           "files": files}
    if payload:
        man.update(payload)
    return man


def write_manifest(directory: str, step: int,
                   manifest: Dict[str, Any]) -> str:
    """Atomically-renamed manifest write: a torn manifest must never
    brand an intact step corrupt."""
    path = manifest_path(directory, step)
    _atomic_write_text(path, json.dumps(manifest, sort_keys=True))
    return path


def read_manifest(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """The step's manifest dict, or None when the step has none. A
    garbled manifest raises ValueError (json); callers decide whether
    that means corrupt (verify) or skip (ls)."""
    try:
        with open(manifest_path(directory, step), encoding="utf-8") as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def verify_step_dir(directory: str, step: int,
                    mode: str = "size") -> Optional[str]:
    """Integrity verdict for one committed step: None when it passes —
    or has no manifest to check against (such steps stay restorable) —
    else a human-readable failure reason. ``size`` stats every
    manifest-listed file; ``full`` also re-hashes them. Files not in
    the manifest are ignored."""
    if mode == "off":
        return None
    if mode not in CKPT_VERIFY_MODES:
        raise ValueError(f"unknown ckpt_verify mode {mode!r} "
                         f"(want one of {CKPT_VERIFY_MODES})")
    try:
        man = read_manifest(directory, step)
    except (ValueError, OSError) as e:
        # Garbled json and an unreadable file both become a verdict:
        # quarantine keeps the bytes, the walk-back keeps the job alive.
        return f"unreadable manifest: {e}"
    if man is None:
        return None
    step_dir = os.path.join(directory, str(step))
    if not os.path.isdir(step_dir):
        return "step directory missing"
    files = man.get("files") or {}
    for rel in sorted(files):
        p = os.path.join(step_dir, rel.replace("/", os.sep))
        try:
            size = os.path.getsize(p)
        except OSError:
            return f"missing file {rel}"
        if int(size) != int(files[rel]["size"]):
            return (f"size mismatch on {rel}: {size} bytes on disk != "
                    f"{files[rel]['size']} in manifest")
    if mode == "full":
        for rel in sorted(files):
            p = os.path.join(step_dir, rel.replace("/", os.sep))
            try:
                crc, _ = _crc32_file(p)
            except OSError as e:
                return f"unreadable file {rel}: {e}"
            if crc != int(files[rel]["crc32"]):
                return f"crc32 mismatch on {rel}"
    return None


# What a torn or foreign array file raises inside torch.load: a zip
# without its central directory is a RuntimeError, a short pickle an
# EOFError or UnpicklingError.
_LOAD_ERRORS = (ValueError, KeyError, TypeError, OSError, RuntimeError,
                EOFError, pickle.UnpicklingError)


class CheckpointState:
    """Manages checkpoints under ``<model_file>.ckpt/`` for one writer
    process (with a ``mesh``, the chief writes for every rank).

    Saves are asynchronous, as the JAX package's orbax saves are:
    ``save`` copies the table and accumulator into host buffers
    (pinned, and reused, when they live on the card) and returns once
    the copy is complete, so the caller may update its tensors in place
    at once; one background thread then writes the files, commits the
    step, deletes the steps beyond ``max_to_keep`` with their sidecars,
    and hashes the new step's manifest. A new save waits for the
    previous one first (back-pressure: at most one snapshot in flight,
    and the buffers are never overwritten while a write reads them);
    ``wait=True`` (the final and the preemption save) returns only once
    the step and its manifest are durable. ``stream_state`` (run_mode =
    stream) is the watermark adopted at the step being saved, taken at
    the same instant as the snapshot; it is written as
    ``watermark-<step>.json``. ``from_state=True`` (the offload
    backend's host-resident state, lookup.py: ``[ckpt_rows, D]`` CPU
    tensors in the stored layout) writes the tensors themselves, with no
    snapshot (at config #5's size a second copy is tens of GB), and so
    only with ``wait=True``.

    ``retry`` wraps RESTORE's reads in the transient-IO retry loop (a
    pure read is always safe to re-drive). SAVE is never retried: a
    failed write surfaces at the next save, ``wait_until_finished`` or
    ``close``.

    ``adagrad_init`` is the accumulator's value in the padded rows of
    the stored layout."""

    def __init__(self, model_file: str, max_to_keep: int = 3,
                 retry: Optional[RetryPolicy] = None,
                 verify: str = "size", adagrad_init: float = 0.1,
                 mesh=None):
        if verify not in CKPT_VERIFY_MODES:
            raise ValueError(f"unknown ckpt_verify mode {verify!r} "
                             f"(want one of {CKPT_VERIFY_MODES})")
        self._max_to_keep = int(max_to_keep)
        self.directory = os.path.abspath(model_file) + ".ckpt"
        self._retry = retry or RetryPolicy(retries=0)
        self.verify = verify
        self._acc_pad = float(adagrad_init)
        self._buffers: Dict[str, torch.Tensor] = {}
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._swept = False
        # parallel.sharded.ProcessMesh of a multi-process run, or None.
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.chief = self.mesh is None or self.mesh.rank == 0
        os.makedirs(self.directory, exist_ok=True)

    # -- multi-process decisions ----------------------------------------
    def _broadcast_int(self, value: int) -> int:
        """The chief's value on every rank (identity on one process):
        every step decision goes through here, so ranks never diverge
        onto different steps and pair mismatched collectives."""
        if self.mesh is None:
            return int(value)
        return int(self.mesh.broadcast_object(
            int(value), "checkpoint/step_decision"))

    def _broadcast_json(self, obj, label: str):
        """The chief's JSON-able value on every rank."""
        if self.mesh is None:
            return obj
        return self.mesh.broadcast_object(obj, label)

    def _all_agree(self, flag: bool) -> bool:
        """True only when every rank reports ``flag`` (identity on one
        process). A restore's success is a per-rank fact; branching on
        it without agreement would desynchronise the collectives."""
        if self.mesh is None:
            return bool(flag)
        flags = self.mesh.all_gather_host(np.asarray([int(bool(flag))]),
                                          "checkpoint/restore_agree")
        return bool(flags.all())

    # -- save -------------------------------------------------------------

    def save(self, step: int, table: torch.Tensor, acc: torch.Tensor,
             vocabulary_size: int, force: bool = False,
             wait: bool = False, epoch: int = 0,
             rewrite_stale_metadata: bool = False,
             stream_state: Optional[dict] = None,
             from_state: bool = False,
             vocab_state: Optional[dict] = None) -> None:
        """Save ``table`` and ``acc`` (``[vocabulary_size + 1, D]`` on
        any device; with ``from_state``, the stored ``[ckpt_rows, D]`` on
        the CPU) as ``step``, with ``epoch``, the count of COMPLETED
        epochs (train.resume_start_epoch reads it). ``vocabulary_size``
        is stored beside the arrays: the aligned row layout cannot tell
        two vocabularies in one bucket apart, so callers check it on
        restore.

        As orbax's manager does, a save at a step at or below the
        newest committed one is skipped unless ``force``. A save at a
        step that already exists does not rewrite the arrays (the state
        at a step is unique), except in admit mode after a barrier moved
        the slot map (below); the final save can land on the last
        periodic save's step with a different epoch count, and then
        ``rewrite_stale_metadata`` records the true count in the
        atomically written ``epoch_override-<step>`` sidecar, which
        restore overlays.

        ``stream_state``: the watermark payload of the last batch
        stepped into these arrays. On a fresh step the writer thread
        makes it durable just before the step's commit rename, so a
        committed step never lacks its position (as in the JAX package,
        whose watermark is written before orbax's background commit); a
        failed commit leaves it an orphan, pruned at the next save. On a
        step that exists it is written here: the arrays are the same
        state, and so is the position (it only advances with steps).

        ``vocab_state`` (``vocab_mode = admit``): the slot map and sketch
        payload (``VocabRuntime.state_payload``) paired with these
        arrays, written as ``vocab-<step>.json.gz`` where the watermark
        is: before the commit rename of a fresh step, here on a step
        that exists with that same payload. The slot map moves at
        barriers, and a barrier's eviction resets rows in place, so a
        publish or final save right after one may land on the step of
        the last periodic save with other arrays than it holds: when
        the step's payload differs from ``vocab_state``, forced or not,
        the step is written anew (``_write_step_files``: the old step
        leaves the digit namespace before the new sidecars land, so no
        instant pairs the old arrays with the new slot map)."""
        with span("checkpoint/save", step=int(step), wait=wait):
            self._save(step, table, acc, vocabulary_size, force, wait,
                       epoch, rewrite_stale_metadata, stream_state,
                       from_state, vocab_state)

    def _save(self, step, table, acc, vocabulary_size, force, wait, epoch,
              rewrite_stale_metadata, stream_state, from_state,
              vocab_state) -> None:
        step = int(step)
        if self.mesh is not None:
            return self._save_sharded(step, table, acc, vocabulary_size,
                                      force, wait, epoch,
                                      rewrite_stale_metadata, stream_state)
        if from_state and not wait:
            raise ValueError(
                "a from_state save writes the caller's own tensors, which "
                "it updates in place: save with wait=True")
        self._join_writer()
        steps = list_step_dirs(self.directory)
        replace = (step in steps and vocab_state is not None and
                   load_vocab_sidecar(self.directory, step)[0]
                   != vocab_state)
        if not replace and not force and steps and step <= steps[-1]:
            if step in steps:
                self._write_step_sidecars(step, stream_state, vocab_state)
            return
        if step in steps and not replace:
            if rewrite_stale_metadata:
                _atomic_write_text(self._epoch_sidecar(step),
                                   str(int(epoch)))
            self._write_step_sidecars(step, stream_state, vocab_state)
        else:
            if not self._swept:
                self._sweep_litter()
            # A fresh save carries authoritative metadata: a same-step
            # sidecar left by a cleared-and-reused directory would
            # overlay the wrong epoch, and a stale manifest would brand
            # the fresh bytes corrupt.
            if not replace:
                self._prune_fresh_step(step)
            if from_state:
                arrays = self._stored(table, acc, int(vocabulary_size))
            else:
                self._snapshot(table, acc, int(vocabulary_size))
                arrays = self._buffers
            meta = {"format": STEP_FORMAT, "step": step,
                    "epoch": int(epoch), "vocab": int(vocabulary_size)}
            self._writer = threading.Thread(
                target=self._write_step,
                args=(meta, stream_state, vocab_state, arrays, replace),
                name="fmt-ckpt-writer", daemon=True)
            self._writer.start()
            tel = _tel()
            if tel is not None:
                tel.count("checkpoint/saves")
        if wait:
            self._join_writer()

    def _save_sharded(self, step: int, table: torch.Tensor,
                      acc: torch.Tensor, vocabulary_size: int, force: bool,
                      wait: bool, epoch: int,
                      rewrite_stale_metadata: bool,
                      stream_state: Optional[dict] = None) -> None:
        """A multi-process save of this rank's ``[rows_per_rank, D]``
        shards (the same skip and epoch-correction rules as ``save``,
        decided by the chief and broadcast): the shards are gathered
        into the chief's stored-layout buffers, and the chief's writer
        thread writes the step. ``wait``: every rank returns once the
        step is durable. ``stream_state``: the merged watermark (the
        same payload on every rank), written by the chief as ``save``
        writes it."""
        decision, err = "write", None
        if self.chief:
            try:
                self._join_writer()
                steps = list_step_dirs(self.directory)
                if not force and steps and step <= steps[-1]:
                    decision = "skip" if step not in steps else "skip-meta"
                elif step in steps:
                    decision = "meta"
            except Exception as e:  # every rank raises it below
                decision, err = "error", f"{type(e).__name__}: {e}"
        decision, err = self._broadcast_json([decision, err],
                                             "checkpoint/save_decision")
        if decision == "error":
            raise RuntimeError(f"checkpoint save of step {step} refused "
                               f"by the chief: {err}")
        if decision in ("skip", "skip-meta"):
            if decision == "skip-meta" and self.chief:
                self._write_step_sidecars(step, stream_state, None)
            return
        if decision == "meta":
            if self.chief:
                if rewrite_stale_metadata:
                    _atomic_write_text(self._epoch_sidecar(step),
                                       str(int(epoch)))
                self._write_step_sidecars(step, stream_state, None)
        else:
            if self.chief:
                if not self._swept:
                    self._sweep_litter()
                self._prune_fresh_step(step)
            self._snapshot_sharded(table, acc, int(vocabulary_size))
            if self.chief:
                meta = {"format": STEP_FORMAT, "step": step,
                        "epoch": int(epoch), "vocab": int(vocabulary_size)}
                self._writer = threading.Thread(
                    target=self._write_step,
                    args=(meta, stream_state, None, self._buffers, False),
                    name="fmt-ckpt-writer", daemon=True)
                self._writer.start()
                # The chief alone counts a save that writes (the shards
                # merge by sum), as in the JAX package.
                tel = _tel()
                if tel is not None:
                    tel.count("checkpoint/saves")
        if wait:
            ok, err = True, None
            if self.chief:
                try:
                    self._join_writer()
                except Exception as e:
                    ok, err = False, e
            if not self._all_agree(ok):
                if err is not None:
                    raise err
                raise RuntimeError(
                    f"checkpoint step {step} failed to write on the chief")

    def _snapshot_sharded(self, table: torch.Tensor, acc: torch.Tensor,
                          vocabulary_size: int) -> None:
        """Every rank's shards into the chief's stored-layout buffers,
        a chunk of at most 64 MB per rank at a time: only the chief
        holds the whole table."""
        mesh = self.mesh
        n = mesh.rows_per_rank
        for name, t in (("table", table), ("acc", acc)):
            d = int(t.shape[1])
            if tuple(t.shape) != (n, d):
                raise ValueError(f"{name} shard of shape {tuple(t.shape)}; "
                                 f"want [{n}, D]")
            if self.chief:
                shape = (mesh.rows, d)
                buf = self._buffers.get(name)
                if buf is None or tuple(buf.shape) != shape:
                    buf = torch.empty(shape, dtype=torch.float32)
                    self._buffers[name] = buf
            chunk = max(1, (64 << 20) // (d * 4))
            for a in range(0, n, chunk):
                b = min(a + chunk, n)
                piece = t[a:b].detach().to("cpu", torch.float32).contiguous()
                parts = mesh.gather_to_chief(piece, f"checkpoint/{name}")
                if self.chief:
                    for r, part in enumerate(parts):
                        buf[r * n + a:r * n + b].copy_(part)

    def _write_step_sidecars(self, step: int, stream_state: Optional[dict],
                             vocab_state: Optional[dict]) -> None:
        """The step's watermark and vocab sidecars, where given."""
        if stream_state is not None:
            write_watermark(self.directory, step, stream_state)
        if vocab_state is not None:
            write_vocab_sidecar(self.directory, step, vocab_state)

    @staticmethod
    def _stored(table: torch.Tensor, acc: torch.Tensor,
                vocabulary_size: int) -> Dict[str, torch.Tensor]:
        """A ``from_state`` save's arrays, written as they are: CPU
        tensors in the stored layout, whose padded rows are the caller's
        (the offload state keeps them as the snapshot writes them)."""
        rows = ckpt_rows_for(vocabulary_size + 1)
        for name, t in (("table", table), ("acc", acc)):
            if t.device.type != "cpu" or t.dtype != torch.float32 or \
                    t.dim() != 2 or int(t.shape[0]) != rows or \
                    not t.is_contiguous():
                raise ValueError(
                    f"from_state saves a contiguous float32 [{rows}, D] "
                    f"CPU {name}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
        return {"table": table.detach(), "acc": acc.detach()}

    def _snapshot(self, table: torch.Tensor, acc: torch.Tensor,
                  vocabulary_size: int) -> None:
        """Copy both arrays into the stored ``[ckpt_rows, D]`` layout in
        host buffers; complete when this returns."""
        num_rows = vocabulary_size + 1
        cuda_devices = set()
        for name, t, pad in (("table", table, 0.0),
                             ("acc", acc, self._acc_pad)):
            if t.dim() != 2 or int(t.shape[0]) != num_rows:
                raise ValueError(
                    f"{name} of shape {tuple(t.shape)} does not match "
                    f"vocabulary_size {vocabulary_size}: want "
                    f"[{num_rows}, D]")
            shape = (ckpt_rows_for(num_rows), int(t.shape[1]))
            buf = self._buffers.get(name)
            if buf is None or tuple(buf.shape) != shape or (
                    t.is_cuda and not buf.is_pinned()):
                buf = torch.empty(shape, dtype=torch.float32,
                                  pin_memory=t.is_cuda)
                self._buffers[name] = buf
            buf[num_rows:].fill_(pad)
            buf[:num_rows].copy_(t.detach(), non_blocking=t.is_cuda)
            if t.is_cuda:
                cuda_devices.add(t.device)
        for device in cuda_devices:
            # The copies ran on the caller's stream behind its last
            # update; the writer thread may read the buffers only once
            # they are complete.
            torch.cuda.current_stream(device).synchronize()

    def _write_step(self, meta: Dict[str, Any],
                    stream_state: Optional[dict],
                    vocab_state: Optional[dict],
                    arrays: Dict[str, torch.Tensor],
                    replace: bool) -> None:
        """The writer thread: files, watermark and vocab sidecars,
        commit, retention, manifest."""
        step = meta["step"]
        t0 = time.perf_counter()
        try:
            nbytes = self._write_step_files(meta, stream_state,
                                            vocab_state, arrays, replace)
        except Exception as e:  # raised at the next join
            self._writer_error = e
            return
        t_commit = time.perf_counter()
        self._delete_old_steps()
        self._prune_orphans()
        self._write_manifest_for(step, meta["epoch"], meta["vocab"])
        get_logger().info(
            "checkpoint step %d committed (%.1f MB) in %.3fs; manifest "
            "hashed in %.3fs", step, nbytes / 1e6, t_commit - t0,
            time.perf_counter() - t_commit)

    def _write_step_files(self, meta: Dict[str, Any],
                          stream_state: Optional[dict],
                          vocab_state: Optional[dict],
                          arrays: Dict[str, torch.Tensor],
                          replace: bool) -> int:
        """Write the step into ``<step>.tmp`` and commit it by rename.
        ``replace``: the step exists and is written anew. Its old
        directory is renamed out of the digit namespace and its
        sidecars pruned first: a kill from there to the commit leaves
        the step missing (restore takes the step before it, with its
        own sidecars), never the old arrays under the new sidecars."""
        step = meta["step"]
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        retired = final + ".del"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        nbytes = 0
        try:
            for name in ARRAYS:
                path = os.path.join(tmp, name + ".pt")
                torch.save(arrays[name], path)
                _fsync_path(path)
                nbytes += os.path.getsize(path)
            with open(os.path.join(tmp, META_FILE), "w",
                      encoding="utf-8") as fh:
                json.dump(meta, fh, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_path(tmp)
            if replace:
                shutil.rmtree(retired, ignore_errors=True)
                os.rename(final, retired)
                self._prune_fresh_step(step)
            self._write_step_sidecars(step, stream_state, vocab_state)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_path(self.directory)
        if replace:
            shutil.rmtree(retired, ignore_errors=True)
        return nbytes

    def _delete_old_steps(self) -> None:
        """Keep the newest ``max_to_keep`` committed steps. A step is
        renamed out of the digit namespace before its bytes go, so a
        kill mid-delete never leaves a half-deleted committed step."""
        steps = list_step_dirs(self.directory)
        for s in steps[:max(0, len(steps) - self._max_to_keep)]:
            gone = os.path.join(self.directory, f"{s}.del")
            try:
                os.rename(os.path.join(self.directory, str(s)), gone)
            except OSError:
                get_logger().warning(
                    "could not retire checkpoint step %d past "
                    "max_to_keep = %d", s, self._max_to_keep,
                    exc_info=True)
                continue
            shutil.rmtree(gone, ignore_errors=True)

    def _join_writer(self) -> None:
        t, self._writer = self._writer, None
        if t is not None:
            t.join()
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def wait_until_finished(self) -> None:
        """Block until the in-flight save (if any) is committed and its
        manifest written; raise what its write raised."""
        self._join_writer()

    def _write_manifest_for(self, step: int, epoch: int,
                            vocab: int) -> None:
        try:
            man = compute_manifest(self.directory, step,
                                   payload={"epoch": epoch,
                                            "vocab": vocab})
            write_manifest(self.directory, step, man)
        except OSError:
            get_logger().warning(
                "manifest write for checkpoint step %d failed; the step "
                "stays restorable but unverifiable", step, exc_info=True)

    def _epoch_sidecar(self, step: int) -> str:
        return os.path.join(self.directory, f"epoch_override-{step}")

    def _sweep_litter(self) -> None:
        """Remove ``<step>.tmp``/``<step>.del`` directories a killed
        writer left (only the writer sweeps: a reader must never touch
        another process's save in progress)."""
        self._swept = True
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if _LITTER_RE.fullmatch(name):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _prune_fresh_step(self, step: int) -> None:
        """Correctness-bearing: anything but "not there" raises and
        fails the save. A stale same-step watermark (a cleared and
        reused directory, or an epoch-mode save landing on an old
        stream step) would resume a later stream at positions this
        state never trained; a stale vocab sidecar would remap ids onto
        rows this table never assigned them."""
        mp = manifest_path(self.directory, step)
        wp = watermark_path(self.directory, step)
        vp = vocab_sidecar_path(self.directory, step)
        for stale in (self._epoch_sidecar(step), mp, mp + ".tmp", wp,
                      wp + ".tmp", vp, vp + ".tmp"):
            try:
                os.remove(stale)
            except FileNotFoundError:
                pass

    def _prune_orphans(self) -> None:
        """Remove sidecars whose step no longer exists (retention deleted
        it). Cosmetic: no flake here may fail a committed save."""
        try:
            kept = set(list_step_dirs(self.directory))
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            s = sidecar_step(name)
            if s is not None and s not in kept:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    # -- publishing ---------------------------------------------------------

    def publish_step(self, step: int) -> Optional[str]:
        """Atomically repoint the ``published`` pointer at a
        manifest-verified committed step (settle its save first: a
        ``wait=True`` save does). Verification runs at the instance's
        ``ckpt_verify`` mode, at least ``size``; on failure the pointer
        is not moved, a warning names the reason, and None returns.
        With a mesh only the chief verifies and writes; the others
        return None."""
        if not self.chief:
            # Multi-process: the chief verifies and repoints; the other
            # ranks take its verify as passed (as the JAX package does).
            return None
        mode = self.verify if self.verify != "off" else "size"
        reason = verify_step_dir(self.directory, step, mode)
        if reason is not None:
            get_logger().warning(
                "publish of checkpoint step %d skipped: %s — the "
                "previous published pointer stays in place", step,
                reason)
            tel = _tel()
            if tel is not None:
                tel.count("stream/publish_failures")
            return None
        path = write_published(self.directory, step)
        tel = _tel()
        if tel is not None:
            tel.count("stream/publishes")
        get_logger().info(
            "published checkpoint step %d (%s-verified) -> %s", step,
            mode, path)
        return path

    def published_at_risk(self, margin: int = 1) -> bool:
        """Whether retention is about to lap the ``published`` pointer:
        True when the pointed-at step is gone already, or ``margin``
        more saves would delete it."""
        pub = read_published(self.directory)
        if pub is None:
            return False
        steps = list_step_dirs(self.directory)
        if pub not in steps:
            return True
        newer = sum(1 for s in steps if s > pub)
        return newer >= self._max_to_keep - margin

    # -- integrity: verify / quarantine / step decision -------------------

    def verify_step(self, step: int,
                    mode: Optional[str] = None) -> Optional[str]:
        """Integrity verdict for one committed step against its
        manifest (None: passes, or has no manifest). ``mode`` defaults
        to the instance's ``ckpt_verify``."""
        return verify_step_dir(self.directory, step, mode or self.verify)

    def quarantine_step(self, step: int, reason: str) -> str:
        """Move a bad step out of the restore path without deleting it:
        the step dir is renamed ``corrupt-<step>`` and its manifest,
        epoch, watermark and vocab sidecars move inside it. Returns the
        quarantine dir."""
        src = os.path.join(self.directory, str(step))
        dst = os.path.join(self.directory, f"{QUARANTINE_PREFIX}{step}")
        k = 0
        while os.path.exists(dst):
            k += 1
            dst = os.path.join(self.directory,
                               f"{QUARANTINE_PREFIX}{step}.{k}")
        os.rename(src, dst)
        for name in (f"manifest-{step}.json", f"epoch_override-{step}",
                     f"watermark-{step}.json", f"vocab-{step}.json.gz"):
            try:
                os.replace(os.path.join(self.directory, name),
                           os.path.join(dst, name))
            except OSError:
                pass  # sidecar absent: the rename above is the invariant
        try:
            with open(os.path.join(dst, "QUARANTINE"), "w",
                      encoding="utf-8") as fh:
                fh.write(f"step {step} quarantined at {time.time():.3f}: "
                         f"{reason}\n")
        except OSError:
            pass
        emit_ckpt_fallback(step, reason, dst)
        get_logger().warning(
            "checkpoint step %d failed integrity (%s); quarantined to %s "
            "— falling back to an older step", step, reason, dst)
        return dst

    def _check_format(self, step: int) -> None:
        """Refuse a step another writer made: the JAX package keeps its
        orbax checkpoints in the same ``<model_file>.ckpt/``. A port
        step has ``meta.json`` (or, torn, at least ``table.pt``: that
        one fails to load and walks back like any torn step)."""
        step_dir = os.path.join(self.directory, str(step))
        try:
            with open(os.path.join(step_dir, META_FILE),
                      encoding="utf-8") as fh:
                fmt = json.load(fh).get("format")
        except FileNotFoundError:
            if os.path.exists(os.path.join(step_dir, "table.pt")):
                return
            fmt = None
        except (OSError, ValueError, AttributeError):
            return
        if fmt == STEP_FORMAT:
            return
        raise ValueError(
            f"checkpoint step {step} at {self.directory} is not in "
            f"fast_tffm_tpu_torch's format (no {META_FILE} marked "
            f"{STEP_FORMAT!r}): most likely the JAX package wrote it "
            "(orbax), and the port cannot read that format. Carry a "
            "JAX model across with fast_tffm_tpu_torch.models.convert."
            "save_checkpoint_from_numpy into another model_file, or "
            "point model_file elsewhere. The step was left as it is "
            "(not quarantined).")

    def _pick_intact_step(self) -> Tuple[int, int]:
        """Newest step that passes verification, quarantining every
        newer step that doesn't. Returns (step, n_quarantined), step -1
        when no step survives."""
        n = 0
        while True:
            steps = list_step_dirs(self.directory)
            if not steps:
                return -1, n
            s = steps[-1]
            self._check_format(s)
            reason = self.verify_step(s)
            if reason is None:
                return s, n
            self.quarantine_step(s, reason)
            n += 1

    def latest_step(self) -> Optional[int]:
        steps = list_step_dirs(self.directory)
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Tuple[int, int]]] = None
                ) -> Optional[Dict[str, Any]]:
        """Returns ``{"table", "acc", "step", "epoch", "vocab",
        "stream", "vocab_admission"}`` with the arrays as CPU tensors
        ``[vocab + 1, D]`` (the stored padding sliced off), ``stream``
        the step's watermark payload and ``vocab_admission`` its vocab
        sidecar payload (each None without one; a torn vocab sidecar
        reads as None with a warning), or None when no checkpoint exists yet (a fresh
        start). ``template`` maps the arrays to load to the shapes this
        config wants (``train.checkpoint_template``); an array it leaves
        out is not read (predict loads the table alone), and a stored
        layout other than those shapes' fails the restore (a vocabulary
        in the same 4096-row bucket passes: ``train.check_restored_vocab``
        names it). None loads both, unchecked.

        With ``step=None`` the newest INTACT step wins: each candidate
        is verified against its manifest first, and one that fails —
        or fails to load — is quarantined while restore walks back. An
        EXPLICIT step is verified but never quarantined or walked past:
        the caller asked for those exact bytes.

        Multi-process (``mesh``): the arrays are this rank's rows
        ``[lo, hi)`` of the stored ``[ckpt_rows, D]`` layout; the chief
        picks, verifies and quarantines, and every rank loads the step
        the chief broadcast."""
        with span("checkpoint/restore"):
            return self._restore(step, template)

    def _restore(self, step: Optional[int], template
                 ) -> Optional[Dict[str, Any]]:
        self.wait_until_finished()
        if step is not None:
            self._check_format(step)
            reason = self._broadcast_json(
                self.verify_step(step) if self.chief else None,
                "checkpoint/verify")
            if reason is not None:
                raise ValueError(
                    f"checkpoint step {step} at {self.directory} "
                    f"failed integrity verification: {reason}. An "
                    "explicitly requested step is never quarantined "
                    "automatically — inspect it with `python -m "
                    "fast_tffm_tpu_torch.tools.fmckpt verify`.")
            restored, err = self._attempt_restore(step, template)
            if not self._all_agree(err is None):
                self._raise_restore_error(step, err or RuntimeError(
                    f"restore of step {step} failed on another process"))
            return self._apply_sidecars(step, restored)
        return self._restore_newest_intact(template)

    def restore_partial(self, template: Dict[str, Tuple[int, int]],
                        step: Optional[int] = None
                        ) -> Optional[Dict[str, Any]]:
        """Restore only the arrays ``template`` names (the JAX package's
        name): the offload predict path loads the table without the
        same-sized accumulator. ``restore`` with that template."""
        with span("checkpoint/restore", partial=True):
            return self._restore(step, template)

    def _restore_newest_intact(self, template
                               ) -> Optional[Dict[str, Any]]:
        """The self-healing walk-back: the chief picks, verifies and
        quarantines; every decision is broadcast, and every rank loads
        the agreed step."""
        quarantined = 0
        first_err: Optional[Tuple[int, BaseException]] = None
        while True:
            cand, refusal = -1, None
            if self.chief:
                try:
                    cand, nq = self._pick_intact_step()
                    quarantined += nq
                except ValueError as e:  # a step in another format
                    if self.mesh is None:
                        raise
                    refusal = str(e)
            cand, refusal = self._broadcast_json([cand, refusal],
                                                 "checkpoint/step_decision")
            if refusal is not None:
                raise ValueError(refusal)
            if cand < 0:
                if first_err is not None:
                    # Every remaining candidate failed to LOAD: surface
                    # the newest step's error (on a config mismatch it
                    # is the diagnosis for every step).
                    self._raise_restore_error(*first_err)
                if self._broadcast_int(1 if quarantined else 0):
                    # Never turn "every checkpoint failed integrity"
                    # into a silent fresh start over hours of
                    # quarantined-but-recoverable state.
                    raise ValueError(
                        f"every checkpoint step at {self.directory} "
                        "failed integrity verification and was "
                        "quarantined (corrupt-*). Inspect with `python "
                        "-m fast_tffm_tpu_torch.tools.fmckpt ls` / "
                        "`verify`; rename an intact corrupt-<step> back "
                        "to <step> to recover it, or point model_file "
                        "elsewhere to start fresh.")
                return None
            restored, err = self._attempt_restore(cand, template)
            # A load's success is a per-rank fact: agree before branching.
            if self._all_agree(err is None):
                if quarantined and self.chief:
                    tel = _tel()
                    if tel is not None:
                        tel.count("checkpoint/fallbacks")
                return self._apply_sidecars(cand, restored)
            if err is None:
                err = RuntimeError(
                    f"restore of step {cand} failed on another process")
            if first_err is None:
                first_err = (cand, err)
            # Walk past a load failure only when an OLDER step remains:
            # quarantining the last step on (say) a config mismatch
            # would turn a loud error into a silent fresh start.
            has_more = 0
            if self.chief and any(t != cand
                                  for t in list_step_dirs(self.directory)):
                has_more = 1
            if not self._broadcast_int(has_more):
                self._raise_restore_error(cand, err)
            if self.chief:
                self.quarantine_step(
                    cand, f"restore failed: {type(err).__name__}: {err}")
            quarantined += 1

    def _attempt_restore(self, s: int, template
                         ) -> Tuple[Optional[Dict[str, Any]],
                                    Optional[BaseException]]:
        """One load of step ``s`` to the CPU, transient-IO retries
        included: (restored, None) or (None, error). The load stays on
        the CPU so that no CUDA error can pass for a torn file. With a
        mesh the arrays are memory-mapped and only this rank's rows are
        read."""
        names = ARRAYS if template is None else tuple(
            n for n in ARRAYS if n in template)
        step_dir = os.path.join(self.directory, str(s))
        try:
            meta = retry_io(_read_json, os.path.join(step_dir, META_FILE),
                            policy=self._retry, op="checkpoint_restore")
            if int(meta["step"]) != s:
                raise ValueError(f"{META_FILE} names step {meta['step']}")
            out: Dict[str, Any] = {"step": s, "epoch": int(meta["epoch"]),
                                   "vocab": int(meta["vocab"])}
            num_rows = out["vocab"] + 1
            for name in names:
                t = retry_io(torch.load,
                             os.path.join(step_dir, name + ".pt"),
                             map_location="cpu", weights_only=True,
                             mmap=self.mesh is not None,
                             policy=self._retry, op="checkpoint_restore")
                if not isinstance(t, torch.Tensor) or t.dim() != 2 or \
                        t.dtype != torch.float32 or \
                        int(t.shape[0]) != ckpt_rows_for(num_rows):
                    raise ValueError(
                        f"{name}.pt does not hold a "
                        f"[{ckpt_rows_for(num_rows)}, D] float32 tensor")
                # As the JAX package's template does, hold the STORED
                # layout to this config's: a vocabulary inside the same
                # 4096-row bucket passes here, and the caller's vocab
                # check names it.
                if template is not None:
                    rows, dim = template[name]
                    want = [ckpt_rows_for(rows), int(dim)]
                    if list(t.shape) != want:
                        raise ValueError(
                            f"{name} is stored as {list(t.shape)}; this "
                            f"config's layout is {want}")
                if self.mesh is not None:
                    out[name] = t[self.mesh.lo:self.mesh.hi].clone()
                else:
                    out[name] = t[:num_rows]
            return out, None
        except _LOAD_ERRORS as e:
            return None, e

    def _apply_sidecars(self, step: int,
                        restored: Dict[str, Any]) -> Dict[str, Any]:
        """Overlay a same-step epoch-correction sidecar (see save())
        and attach the step's stream watermark and vocab admission
        payload: a walk-back to an older step resumes at that step's
        older position with its own slot map. Multi-process: the chief
        reads them and broadcasts, so a read error on one host can never
        give ranks different epochs or positions."""
        side = None
        if self.chief:
            side = [read_epoch_override(self.directory, step),
                    read_watermark(self.directory, step),
                    read_vocab_sidecar(self.directory, step)]
        override, restored["stream"], restored["vocab_admission"] = \
            self._broadcast_json(side, "checkpoint/epoch_override")
        if override is not None:
            restored["epoch"] = override
        return restored

    def _raise_restore_error(self, s, e) -> None:
        raise ValueError(
            f"checkpoint at {self.directory} step {s} could not be "
            "restored against this config's layout. Most likely the "
            "checkpoint was written under a different config "
            "(vocabulary_size / factor_num / model_type / field_num: a "
            "row holds factor_num + 1 values, factor_num * field_num + 1 "
            "for FFM) or an older "
            "storage layout — fix the config or point model_file at "
            "the matching checkpoint. If the config is right, this "
            "step directory may be corrupt/partially written (killed "
            "save): newer bad steps are quarantined automatically as "
            "corrupt-<step>; inspect the directory with `python -m "
            "fast_tffm_tpu_torch.tools.fmckpt ls`. Underlying error: "
            f"{e}") from e

    def close(self) -> None:
        """Settle any in-flight save (and its manifest), then release
        the snapshot buffers — the last point a crashed-out run can
        make the newest step verifiable."""
        try:
            self._join_writer()
        finally:
            self._buffers.clear()


def _read_json(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)
