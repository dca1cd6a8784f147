"""Slot map + the batch remap seam + the admission/eviction barrier — a
copy of ``fast_tffm_tpu/vocab/table.py`` (the port imports nothing of
the JAX package), with the row reset done in place on torch tensors.

``vocab_mode = admit`` splits the id space from the table: the
pipeline parses/hashes ids into ``sketch.HASH_SPACE`` (the build-side
config swap in ``batch_iterator``/``StreamSource``), and every built
batch passes through ``remap`` — the ONE seam between hashed ids and
physical rows — before anything downstream sees it:

- an ADMITTED hashed id maps to its private physical row (slot map);
- every other id maps to the shared COLD row (row 0);
- the hash-space pad sentinel maps to the physical ``pad_id``;
- host-deduped batches are re-deduped after mapping (many cold ids
  collapse into one slot), so the "uniq_ids are unique, padding slots
  hold pad_id, the last slot is padding" invariants the step's
  scatter relies on keep holding at EXACTLY the same array shapes.

The slot map is FROZEN between barriers (one atomic tuple the remap
reads), so the remap is deterministic and batch shapes never move.
``barrier()`` — called
only at existing synchronization points (epoch boundary, publish
settle, final save) — decays the sketch, evicts rows whose decayed
frequency fell below ``vocab_admit_threshold`` (their table rows are
RESET to the cold-start state so a later owner never inherits stale
embeddings), admits the hottest waiting candidates into the freed +
free rows, and refreezes.

Observation is split from remapping so the sketch advances exactly
once per TRAINED example stream position: ``remap`` attaches the
batch's distinct hashed ids (``batch.vocab_obs``) and the train loop
calls ``note_trained`` only for batches it actually stepped — the
same adopt-on-step rule the stream watermark uses, which is what lets
the checkpointed admission state round-trip a preemption bit-exactly.

``reset_table_rows`` is the JAX package's eviction reset on the port's
in-place state: it zeroes the table rows and sets the accumulator rows
to ``adagrad_init`` on the tensors' own device, on the current stream,
in one launch each; the offload backends call it on their CPU state.
The JAX package pads its index set to 4,096-row chunks with the pad
row, which already holds those values: the port writes only the rows
it is given, with the same result. With a run's telemetry active the
JAX package's counters and gauges land in its stream: ``vocab/ids`` and
``cold_ids`` at a batch's first remap (training maps only:
``count_telemetry``), ``candidates_dropped`` at observation, and
``admitted_rows``, ``evicted_rows``, ``live_rows`` and ``sketch_fill``
at each barrier.
"""

from __future__ import annotations

import base64
import dataclasses
import heapq
import json
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from fast_tffm_tpu_torch.vocab.sketch import HASH_SPACE, CountMinSketch


def _tel():
    from fast_tffm_tpu_torch.obs.telemetry import active
    return active()


# The shared cold row: physical row 0 is RESERVED in admit mode —
# every unadmitted id gathers/trains through it, so the "millions of
# users" tail shares one embedding instead of aliasing random hot rows
# (what plain modulo collisions do). Admitted ids get rows
# [1, vocabulary_size).
COLD_ROW = 0

PAYLOAD_FORMAT = 1

# Candidate-buffer bound: ids that crossed the admission threshold but
# wait for the next barrier. 4x capacity comfortably covers any real
# churn between barriers; beyond it new candidates are dropped (and
# counted) rather than growing without bound on adversarial streams.
_CANDIDATE_CAP_FACTOR = 4

def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()
                            ).decode("ascii")


def _unb64(s: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype).copy()


def _state_crc(state: Dict[str, object]) -> int:
    """crc32 of the canonical JSON serialization of ``state`` — the
    integrity check ``fmckpt verify`` re-runs on the sidecar."""
    blob = json.dumps(state, sort_keys=True).encode("utf-8")
    return zlib.crc32(blob) & 0xFFFFFFFF


def payload_crc_ok(payload: Dict[str, object]) -> bool:
    """Whether a vocab sidecar payload's embedded crc32 matches its
    state — shared by the restore path and fmckpt verify so the two
    can never disagree on what a torn sidecar is."""
    try:
        return int(payload["crc32"]) == _state_crc(payload["state"])
    except (KeyError, TypeError, ValueError):
        return False


class VocabMap:
    """Read-only remapper: the frozen (hashed id -> physical row)
    arrays plus the one batch transform. This is all inference needs —
    predict and the serving process load it from the checkpoint's
    vocab sidecar and never touch the sketch."""

    def __init__(self, capacity: int, pad_id: int,
                 keys: Optional[np.ndarray] = None,
                 rows: Optional[np.ndarray] = None):
        if capacity < 2:
            raise ValueError(
                f"vocab_mode = admit needs vocabulary_size >= 2 (one "
                f"cold row + at least one live row), got {capacity}")
        self.capacity = int(capacity)
        self.pad_id = int(pad_id)
        # One-tuple swap: remap (prefetch/build threads) reads this
        # reference once per call; barrier/load replace it atomically.
        self._frozen: Tuple[np.ndarray, np.ndarray] = (
            np.zeros(0, np.int64) if keys is None else keys,
            np.zeros(0, np.int32) if rows is None else rows)
        # Bumped on every slot-map movement (barrier refreeze, load):
        # remap stamps batches with it so ensure_current can catch a
        # batch that was remapped on the build side under a map a
        # barrier has since moved.
        self.generation = 0
        # False on eval_view() snapshots: a validation sweep's unique
        # tail must not skew the training stream's cold-hit rate.
        self.count_telemetry = True

    @staticmethod
    def build_cfg(cfg):
        """The config the BUILD side of the pipeline runs under in
        admit mode: identical except ids mod into HASH_SPACE (and the
        build-side pad sentinel becomes HASH_SPACE via ``pad_id``).
        ``remap`` converts everything back to the physical space."""
        return dataclasses.replace(cfg, vocabulary_size=HASH_SPACE)

    @classmethod
    def from_payload(cls, cfg, payload: Dict[str, object]) -> "VocabMap":
        """The inference-side load: checked against this config's
        capacity exactly like check_restored_vocab checks the table.
        Telemetry-silent, like eval_view: the vocab/* counters feed
        the TRAINING stream's cold-hit rate (the COLD-ROW SATURATION
        verdict), and a co-resident scorer's traffic — serve warmup
        batches are ~100% cold by construction — must not skew it."""
        state = _check_payload(cfg, payload)
        vm = cls(cfg.vocabulary_size, cfg.pad_id,
                 keys=_unb64(state["slot_keys"], np.int64),
                 rows=_unb64(state["slot_rows"], np.int32))
        vm.count_telemetry = False
        return vm

    @property
    def live_rows(self) -> int:
        return len(self._frozen[0])

    def _lookup_core(self, v64: np.ndarray):
        """(rows, hit) for hashed ids: admitted ids get their row +
        hit=True, everything else COLD_ROW + hit=False (the pad
        sentinel reads as a miss here — callers own pad handling)."""
        keys, rows = self._frozen
        if len(keys):
            idx = np.searchsorted(keys, v64)
            idx_c = np.minimum(idx, len(keys) - 1)
            hit = keys[idx_c] == v64
            out = np.where(hit, rows[idx_c],
                           np.int32(COLD_ROW)).astype(np.int32)
        else:
            out = np.full(v64.shape, COLD_ROW, np.int32)
            hit = np.zeros(v64.shape, bool)
        return out, hit

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Hashed ids -> physical rows (COLD_ROW for unadmitted, the
        physical pad for the hash-space pad sentinel). Vectorized
        binary search over the frozen sorted keys; any shape."""
        v64 = np.asarray(ids).astype(np.int64, copy=False)
        out, _hit = self._lookup_core(v64)
        out[v64 == HASH_SPACE] = self.pad_id
        return out

    def remap(self, batch):
        """Hash-space DeviceBatch -> physical-space, IN PLACE (same
        object, same shapes), attaching ``batch.vocab_obs`` — the
        batch's distinct real hashed ids — for the train loop's
        adopt-on-step observation. Returns the batch.

        Host-dedup batches are re-deduplicated after mapping (every
        cold id collapses into one shared slot) WITHOUT a sort: the
        slot map is injective and the incoming real slots are already
        unique, so the mapped values split exactly into {distinct hit
        rows} + {cold} + {pad} — the new unique set is [cold?, hit
        rows..., pad fill], built by masks. The padding invariants
        hold by construction: pad fill slots hold pad_id, the last
        slot is padding (hits + the cold slot can never fill the
        array: the incoming batch always carries >= 1 pad slot, and
        the cold slot only exists when a miss freed one). This runs
        per batch on the hot path — the admission feature's whole
        overhead budget lives here.

        The hash-space originals are RETAINED on the batch
        (``vocab_src`` — references, not copies: the transform builds
        new arrays) together with the map generation, so
        ``ensure_current`` can redo the mapping if a barrier moves the
        slot map while the batch sits in a prefetch queue."""
        fresh = getattr(batch, "vocab_gen", None) is None
        # Generation captured BEFORE any _frozen read: a barrier
        # refreeze landing mid-remap then leaves the batch stamped
        # with the OLD generation, so ensure_current forces a (cheap,
        # harmless) redo instead of treating a stale mapping as
        # current.
        gen = self.generation
        if batch.uniq_ids is not None:
            batch.vocab_src = (batch.uniq_ids, batch.local_idx)
            u = batch.uniq_ids
            v64 = u.astype(np.int64)
            phys, hit = self._lookup_core(v64)
            real = v64 != HASH_SPACE
            hit &= real
            miss = real & ~hit
            n_hits = int(hit.sum())
            n_miss = int(miss.sum())
            base = 1 if n_miss else 0
            inv = np.empty(len(u), np.int32)
            inv[hit] = base + np.arange(n_hits, dtype=np.int32)
            if n_miss:
                inv[miss] = 0
            inv[~real] = base + n_hits  # first pad slot
            new_uniq = np.full(len(u), self.pad_id, np.int32)
            if n_miss:
                new_uniq[0] = COLD_ROW
            new_uniq[base:base + n_hits] = phys[hit]
            batch.uniq_ids = new_uniq
            batch.local_idx = inv[batch.local_idx]
            obs = v64[real]  # unique by the host-dedup contract
            n_cold = n_miss
        else:
            # Raw-ids batch (dedup = device / the serving path):
            # local_idx holds hashed ids directly; map cellwise — the
            # device unique pass then dedups physical rows. The
            # distinct-id extraction (an O(B*L log B*L) sort) exists
            # only for note_trained (and the JAX package's cold-hit
            # counters), so inference-side maps — the serving flush is
            # a latency-SLO hot path — skip it entirely.
            batch.vocab_src = (None, batch.local_idx)
            n_cold = 0
            if self.count_telemetry:
                obs = np.unique(batch.local_idx).astype(np.int64)
                obs = obs[obs != HASH_SPACE]
                if _tel() is not None:
                    _rows, ohit = self._lookup_core(obs)
                    n_cold = int(len(obs) - ohit.sum())
            else:
                obs = None
            batch.local_idx = self.lookup(batch.local_idx)
        batch.vocab_obs = obs
        batch.vocab_gen = gen
        # Counted once per batch, at its first remap (an ensure_current
        # redo must not double the cold-hit rate), and only for training
        # maps.
        if fresh and self.count_telemetry and obs is not None:
            tel = _tel()
            if tel is not None and len(obs):
                tel.count("vocab/ids", len(obs))
                tel.count("vocab/cold_ids", n_cold)
        return batch

    def ensure_current(self, batch):
        """Redo the remap iff the slot map moved since this batch was
        remapped (a barrier ran while it sat in a prefetch queue):
        without this, a stepped stale batch would scatter into rows
        the barrier evicted, reset, or reassigned to other ids. The
        common case — generations match — is one integer compare."""
        gen = getattr(batch, "vocab_gen", None)
        src = getattr(batch, "vocab_src", None)
        if gen == self.generation or src is None:
            return batch
        batch.uniq_ids, batch.local_idx = src
        return self.remap(batch)

    def eval_view(self) -> "VocabMap":
        """A telemetry-silent snapshot sharing the frozen arrays —
        validation sweeps remap through this so their held-out unique
        tail never inflates the cold-hit rate behind the COLD-ROW
        SATURATION verdict. Safe as a snapshot: barriers cannot run
        mid-sweep (single train thread)."""
        keys, rows = self._frozen
        vm = VocabMap(self.capacity, self.pad_id, keys=keys, rows=rows)
        vm.count_telemetry = False
        return vm


def _check_payload(cfg, payload: Dict[str, object]) -> Dict[str, object]:
    """Validate a vocab sidecar payload against this config; returns
    the inner state dict. Raises ValueError with the actionable
    mismatch — a slot map sized for a different table would silently
    scramble row ownership exactly like a vocab-size mismatch on the
    table itself (train.check_restored_vocab)."""
    if not payload_crc_ok(payload):
        raise ValueError(
            "vocab admission sidecar failed its crc32 check (torn or "
            "bit-rotted); inspect with `python -m "
            "fast_tffm_tpu_torch.tools.fmckpt verify`")
    state = payload["state"]
    if int(state["capacity"]) != cfg.vocabulary_size:
        raise ValueError(
            f"vocab admission state was written for vocabulary_size="
            f"{state['capacity']}, but this config has "
            f"{cfg.vocabulary_size}; restoring would misalign slot "
            "rows. Retrain, or fix the config.")
    if int(state["hash_space"]) != HASH_SPACE:
        raise ValueError(
            f"vocab admission state hashed ids into a {state['hash_space']}"
            f"-slot space; this build uses {HASH_SPACE}")
    return state


class VocabRuntime(VocabMap):
    """The training-side runtime: VocabMap + the sketch, the candidate
    buffer, and the barrier. Single-process by design, as in the JAX
    package, which refuses admit mode with more than one process (the
    slot map is host state)."""

    def __init__(self, capacity: int, pad_id: int, threshold: float,
                 decay: float, sketch: CountMinSketch):
        super().__init__(capacity, pad_id)
        self.threshold = float(threshold)
        self.decay_factor = float(decay)
        self.sketch = sketch
        self._slots: Dict[int, int] = {}
        self._free: List[int] = list(range(1, capacity))  # heap: row 0
        # is the cold row, never assignable
        # Candidate buffer: O(1) per-batch array appends — the
        # barrier re-estimates the concatenation. ``_queued`` dedupes
        # across batches: an ever-present hot id must queue ONCE per
        # interval, not once per batch, or a handful of hot ids would
        # exhaust the cap and spuriously drop late-crossing ids.
        self._cand_chunks: List[np.ndarray] = []
        self._cand_len = 0
        self._queued: set = set()
        self._candidate_cap = _CANDIDATE_CAP_FACTOR * capacity
        # Stepped batches observed since the last REAL barrier: the
        # stream is the clock — a barrier with nothing trained behind
        # it is a no-op, so idle publish ticks and the back-to-back
        # epoch-boundary + final-save pair never double-decay the
        # sketch (which would evict still-hot ids on wall time alone).
        self._obs_batches = 0
        self.total_admitted = 0
        self.total_evicted = 0

    @classmethod
    def from_config(cls, cfg) -> "VocabRuntime":
        return cls(cfg.vocabulary_size, cfg.pad_id,
                   cfg.vocab_admit_threshold, cfg.vocab_decay,
                   CountMinSketch.from_mb(cfg.vocab_sketch_mb))

    # -- observation (train thread, adopt-on-step) ------------------------

    def note_trained(self, batch) -> None:
        """Feed the sketch with a STEPPED batch's distinct hashed ids
        (attached by remap) and queue the ones that crossed the
        admission threshold. Called only for trained batches — never
        validation/predict sweeps, never prefetched-but-unstepped
        batches — so the checkpointed sketch state corresponds exactly
        to the stream watermark beside it."""
        ids = getattr(batch, "vocab_obs", None)
        if ids is None or not len(ids):
            return
        self._obs_batches += 1
        est = self.sketch.observe_and_estimate(ids)
        hot_mask = est >= self.threshold
        if not hot_mask.any():
            return
        hot = ids[hot_mask]
        # Vectorized pre-filter: in steady state almost every hot id
        # is already admitted — only the cold remainder queues.
        _rows, admitted = self._lookup_core(
            hot.astype(np.int64, copy=False))
        hot = hot[~admitted]
        if not len(hot):
            return
        if self._queued:
            # Per-id set probes, but only over the unadmitted hot
            # remainder — steady state leaves this a handful of ids.
            mask = np.fromiter((int(i) not in self._queued
                                for i in hot), bool, len(hot))
            hot = hot[mask]
            if not len(hot):
                return
        room = self._candidate_cap - self._cand_len
        dropped = hot[room:] if room < len(hot) else hot[:0]
        hot = hot[:max(room, 0)]
        if len(dropped):
            tel = _tel()
            if tel is not None:
                tel.count("vocab/candidates_dropped", len(dropped))
            # Dropped ids join the membership set too — dropped ONCE
            # per interval — but only while the set itself stays
            # bounded: on an adversarial stream whose over-threshold
            # ids far exceed the cap, an unbounded set would be exactly
            # the memory growth the cap rules out.
            room_q = 2 * self._candidate_cap - len(self._queued)
            if room_q > 0:
                self._queued.update(dropped[:room_q].tolist())
        if not len(hot):
            return
        self._cand_chunks.append(hot.astype(np.int64, copy=False))
        self._cand_len += len(hot)
        self._queued.update(hot.tolist())

    # -- the barrier (epoch boundary / publish settle / final save) ------

    def barrier(self, reset_rows=None) -> Dict[str, int]:
        """Decay, evict, admit, refreeze — the ONE point the slot map
        moves. ``reset_rows(rows)`` is called with every freed
        physical row (sorted int32) so the table forgets the evicted
        owner's embedding: its id serves from the cold row afterwards,
        and a future owner of the row cold-starts instead of
        inheriting stale weights. Deterministic in the observation
        stream: eviction scans ids in sorted order, admission fills
        hottest-first with sorted-id tie-break.

        A barrier with NOTHING trained since the previous one is a
        no-op (the stream is the clock, like the watermark): idle
        publish ticks and the epoch-boundary/final-save pair must not
        stack decays and age out ids on wall time alone."""
        if self._obs_batches == 0:
            return {"admitted": 0, "evicted": 0,
                    "live": len(self._slots), "free": len(self._free)}
        self._obs_batches = 0
        self.sketch.decay(self.decay_factor)
        freed: List[int] = []
        if self._slots:
            keys = np.fromiter(self._slots.keys(), np.int64,
                               len(self._slots))
            keys.sort()
            est = self.sketch.estimate(keys)
            # Vectorized scan; the Python loop runs over EVICTED ids
            # only (churn-sized, not table-sized) — at 10^6 live rows
            # a per-slot interpreted pass would stall the train thread
            # for hundreds of ms at every publish barrier. The floor
            # is decay-scaled like admission's (both mean "pre-decay
            # estimate crossed threshold"): asymmetric floors would
            # leave a band of steady-rate ids oscillating
            # admit -> evict forever, wiping their embedding each
            # cycle.
            floor = self.threshold * self.decay_factor
            for k in keys[est < floor].tolist():
                freed.append(self._slots.pop(int(k)))
        for r in freed:
            heapq.heappush(self._free, r)
        evicted = len(freed)
        admitted = 0
        if self._cand_chunks and self._free:
            cand = np.unique(np.concatenate(self._cand_chunks))
            est = self.sketch.estimate(cand)
            # Re-check against the DECAY-SCALED floor: estimates here
            # already carry this barrier's own decay, and candidates
            # queued on the pre-decay basis (note_trained) — comparing
            # post-decay mass against the plain threshold would raise
            # the effective admission floor to threshold/decay, so an
            # id appearing at exactly the documented rate would never
            # admit. est >= threshold * decay IS "pre-decay est >=
            # threshold", which still drops candidates whose estimate
            # shrank for any other reason (a restore replay, float
            # drift) without double-charging the decay.
            keep = est >= self.threshold * self.decay_factor
            cand, est = cand[keep], est[keep]
            order = np.lexsort((cand, -est))  # hottest first, id tie
            for j in order.tolist():
                if not self._free:
                    break
                cid = int(cand[j])
                if cid in self._slots:
                    continue
                self._slots[cid] = heapq.heappop(self._free)
                admitted += 1
        self._cand_chunks.clear()
        self._cand_len = 0
        self._queued.clear()
        self._refreeze()
        if freed and reset_rows is not None:
            reset_rows(np.asarray(sorted(freed), np.int32))
        self.total_admitted += admitted
        self.total_evicted += evicted
        tel = _tel()
        if tel is not None:
            tel.count("vocab/admitted_rows", admitted)
            tel.count("vocab/evicted_rows", evicted)
            tel.set("vocab/live_rows", len(self._slots))
            tel.set("vocab/sketch_fill", self.sketch.fill_fraction())
        return {"admitted": admitted, "evicted": evicted,
                "live": len(self._slots), "free": len(self._free)}

    def _refreeze(self) -> None:
        if self._slots:
            # keys()/values() iterate in the same insertion order, so
            # one argsort aligns both — no per-key dict lookups at
            # table scale.
            keys = np.fromiter(self._slots.keys(), np.int64,
                               len(self._slots))
            rows = np.fromiter(self._slots.values(), np.int32,
                               len(self._slots))
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            rows = np.ascontiguousarray(rows[order])
        else:
            keys = np.zeros(0, np.int64)
            rows = np.zeros(0, np.int32)
        self._frozen = (keys, rows)  # single ref assignment: remap on
        # the prefetch thread sees the old pair or the new, never torn
        self.generation += 1

    # -- durability (the vocab-<step>.json.gz sidecar payload) ------------

    def state_payload(self) -> Dict[str, object]:
        """The crc-covered checkpoint sidecar payload. The slot map is
        serialized from the FROZEN arrays — what remap actually
        applied — so a restore reproduces the mapping bit-exactly even
        mid-interval (candidates re-accumulate from the replayed
        stream; they are derived state)."""
        keys, rows = self._frozen
        state = {
            "format": PAYLOAD_FORMAT,
            "hash_space": HASH_SPACE,
            "capacity": self.capacity,
            "threshold": self.threshold,
            "decay": self.decay_factor,
            "slot_keys": _b64(keys),
            "slot_rows": _b64(rows),
            "total_admitted": self.total_admitted,
            "total_evicted": self.total_evicted,
            "sketch": self.sketch.state(),
        }
        return {"format": PAYLOAD_FORMAT, "state": state,
                "crc32": _state_crc(state)}

    def load(self, cfg, payload: Dict[str, object]) -> None:
        """Restore the admission state a checkpoint carried: slot map,
        free list, sketch — bit-exact. Raises ValueError on crc or
        config mismatch (never silently trains against a scrambled
        map)."""
        state = _check_payload(cfg, payload)
        keys = _unb64(state["slot_keys"], np.int64)
        rows = _unb64(state["slot_rows"], np.int32)
        self._slots = {int(k): int(r) for k, r in zip(keys, rows)}
        used = set(self._slots.values())
        self._free = [r for r in range(1, self.capacity)
                      if r not in used]
        heapq.heapify(self._free)
        self._cand_chunks.clear()
        self._cand_len = 0
        self._queued.clear()
        self._obs_batches = 0
        self.total_admitted = int(state.get("total_admitted", 0))
        self.total_evicted = int(state.get("total_evicted", 0))
        self.sketch = CountMinSketch.from_state(state["sketch"])
        self._frozen = (keys, rows)
        self.generation += 1  # in-flight batches remapped pre-restore
        # must redo through ensure_current



# -- table row reset (the eviction hook's device/CPU form) ---------------

def reset_table_rows(table, acc, rows, adagrad_init: float) -> None:
    """Reset ``rows`` of a table and its accumulator (None: a score-only
    table) to the cold-start state, in place: zero embedding rows,
    accumulator rows set to ``adagrad_init``. One copy of the indices to
    the tensors' device and one ``index_fill_`` each, queued on the
    current stream behind the steps that wrote the rows, so a
    checkpoint snapshot taken on that stream sees the table wholly
    before or wholly after the reset."""
    import torch
    idx = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1),
                          device=table.device)
    with torch.no_grad():
        table.index_fill_(0, idx, 0.0)
        if acc is not None:
            acc.index_fill_(0, idx, float(adagrad_init))
