"""Host batch assembly: parsed CSR blocks -> padded [B, L] batches.

The serving slice of ``fast_tffm_tpu/data/pipeline.py``: the raw-ids
branch of ``make_device_batch`` (the layout serving and predict score
with, ``dedup = device``), its bucket fit ``_ladder_fit``, the
``require_bounded_examples`` guard, and ``expand_files``. The host-side
unique pass, the C++ ``BatchBuilder`` and ``batch_iterator`` are not ported
yet (ROADMAP.md, queue A).

Padding invariants, as in the JAX package: pad cells of ``local_idx``
hold ``pad_id == vocabulary_size`` (the table's dead zero row) and pad
cells of ``vals`` hold 0.0, so a pad slot adds exactly zero to a score;
pad examples have weight 0.0 and no features.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
from typing import List, Sequence

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import ParsedBlock


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
