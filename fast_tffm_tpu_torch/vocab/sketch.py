"""Count-min frequency sketch — the admission filter's memory; a copy
of ``fast_tffm_tpu/vocab/sketch.py`` (the port imports nothing of the
JAX package); tests/test_torch_vocab.py holds its ``state()`` to the
original's byte for byte on one id stream.

A fixed ``[depth, width]`` float32 counter array with one multiplicative
hash row each: ``observe`` adds mass at every row's cell, ``estimate``
takes the min across rows. Estimates therefore NEVER undercount (no
false negative for a genuinely hot id) and overcount by at most the
colliding mass in the emptiest row — bounded in expectation by
``total_mass / width`` per row, so ``vocab_sketch_mb`` trades memory
for admission precision. ``decay`` multiplies every counter, aging out
ids that went cold so the eviction floor means *recent* frequency.

Everything is vectorized numpy on the host; the device never sees the
sketch. Serialization is exact (raw float32 bytes), so a checkpointed
sketch restores bit-identically — the exactly-once property the stream
resume relies on.
"""

from __future__ import annotations

import base64
from typing import Dict

import numpy as np

# The hashed-id space ``vocab_mode = admit`` parses into: feature ids
# (murmur-hashed strings, or raw integer ids) mod into [0, HASH_SPACE)
# instead of [0, vocabulary_size). Fits int32 with room for the
# hash-space pad sentinel (== HASH_SPACE) the build-side pipeline uses;
# at 2^30 slots, distinct-id collisions are ~10^-5 at a 10^5-id working
# set — the slot map below is what bounds the physical table.
HASH_SPACE = 1 << 30

# Fixed odd 64-bit multipliers (splitmix64 finalizer constants + golden
# ratio) — one per sketch row. Constants, not seeds: a checkpointed
# sketch must hash identically after restore, forever.
_MULTS = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
          0x94D049BB133111EB, 0xD6E8FEB86659FD93,
          0xA0761D6478BD642F, 0xE7037ED1A0B428DB)

_STATE_FORMAT = 1


class CountMinSketch:
    """float32 count-min sketch with decay and exact serialization."""

    def __init__(self, width: int, depth: int = 4):
        if width < 64:
            raise ValueError(f"sketch width must be >= 64, got {width}")
        if not 1 <= depth <= len(_MULTS):
            raise ValueError(
                f"sketch depth must be in [1, {len(_MULTS)}], got "
                f"{depth}")
        self.width = int(width)
        self.depth = int(depth)
        self.counts = np.zeros((self.depth, self.width), np.float32)

    @classmethod
    def from_mb(cls, mb: float, depth: int = 4) -> "CountMinSketch":
        """Budget-sized sketch: ``mb`` megabytes of float32 counters
        split across ``depth`` rows (vocab_sketch_mb)."""
        width = max(64, int(mb * (1 << 20) / 4 / depth))
        return cls(width, depth)

    def _cells(self, ids: np.ndarray) -> np.ndarray:
        """[depth, n] column indices for ``ids`` (nonneg ints)."""
        x = np.asarray(ids, np.uint64)
        out = np.empty((self.depth, len(x)), np.int64)
        for d in range(self.depth):
            h = x * np.uint64(_MULTS[d])  # uint64 wraps = mod 2^64
            out[d] = ((h >> np.uint64(33)).astype(np.int64)
                      % self.width)
        return out

    def observe(self, ids: np.ndarray, count: float = 1.0) -> None:
        """Add ``count`` mass for each id (callers pass a batch's
        UNIQUE ids once — the count unit is batch presence)."""
        if len(ids) == 0:
            return
        self._observe_cells(self._cells(ids), count)

    def _observe_cells(self, cells: np.ndarray, count: float) -> None:
        for d in range(self.depth):
            # bincount, not add.at: two ids of one call may share a
            # cell and both contributions must land (ruling out plain
            # fancy-index +=), and bincount is ~20x faster than
            # np.add.at at the 10^5-ids-per-batch scale this runs at —
            # the observe pass sits on the per-step hot path.
            self.counts[d] += np.bincount(
                cells[d], minlength=self.width
            ).astype(np.float32) * np.float32(count)

    def _estimate_cells(self, cells: np.ndarray) -> np.ndarray:
        est = self.counts[0][cells[0]]
        for d in range(1, self.depth):
            est = np.minimum(est, self.counts[d][cells[d]])
        return est

    def estimate(self, ids: np.ndarray) -> np.ndarray:
        """[n] estimated counts — min across rows, so >= truth."""
        if len(ids) == 0:
            return np.zeros(0, np.float32)
        return self._estimate_cells(self._cells(ids))

    def observe_and_estimate(self, ids: np.ndarray,
                             count: float = 1.0) -> np.ndarray:
        """observe() then estimate() for the same ids with ONE hash
        pass — the per-step hot path (note_trained) calls both
        back-to-back, and rehashing [depth, n] cells twice per batch
        is pure waste. Returns the post-observation estimates."""
        if len(ids) == 0:
            return np.zeros(0, np.float32)
        cells = self._cells(ids)
        self._observe_cells(cells, count)
        return self._estimate_cells(cells)

    def decay(self, factor: float) -> None:
        """Age every counter: counts *= factor (0 < factor <= 1).
        Monotone: no estimate ever grows from a decay."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"decay factor must be in (0, 1], got "
                             f"{factor}")
        if factor < 1.0:
            self.counts *= np.float32(factor)

    def fill_fraction(self) -> float:
        """Fraction of counters holding at least one batch-presence of
        mass — the ``vocab/sketch_fill`` gauge (a saturated sketch
        over-admits; raise vocab_sketch_mb). The >= 1 floor matters:
        multiplicative decay never actually zeroes a touched float32
        cell, so a plain nonzero count would read as monotone
        cumulative-touched fraction — still ~0.8 a hundred barriers
        after a one-time burst whose residue can no longer influence
        any admission decision."""
        return float(np.count_nonzero(self.counts >= 1.0)
                     / self.counts.size)

    # -- serialization (exact) -------------------------------------------

    def state(self) -> Dict[str, object]:
        return {"format": _STATE_FORMAT, "width": self.width,
                "depth": self.depth,
                "counts": base64.b64encode(
                    self.counts.tobytes()).decode("ascii")}

    @classmethod
    def from_state(cls, state: Dict[str, object]) -> "CountMinSketch":
        sk = cls(int(state["width"]), int(state["depth"]))
        raw = base64.b64decode(state["counts"])
        counts = np.frombuffer(raw, np.float32).reshape(sk.depth,
                                                        sk.width)
        sk.counts = counts.copy()  # frombuffer is read-only
        return sk
