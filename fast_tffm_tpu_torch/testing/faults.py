"""Fault injection — a copy of ``truncate_checkpoint`` from
``fast_tffm_tpu/testing/faults.py``: a torn checkpoint write, chosen by
a seed."""

from __future__ import annotations

import os
import random
from typing import Optional


def truncate_checkpoint(model_file: str, seed: int = 0,
                        keep_bytes: int = 8,
                        step: Optional[int] = None) -> Optional[str]:
    """Simulate a torn checkpoint write: pick (seeded) one of the
    largest files under the LATEST step directory (or an explicit
    ``step``) of ``<model_file>.ckpt/`` and truncate it to
    ``keep_bytes``. Returns the truncated path, or None when no step
    directory exists. The step's ``manifest-<step>.json`` is left
    untouched — the torn-write shape ``ckpt_verify`` must catch."""
    directory = os.path.abspath(model_file) + ".ckpt"
    if not os.path.isdir(directory):
        return None
    steps = [d for d in os.listdir(directory) if d.isdigit()]
    if step is not None:
        steps = [d for d in steps if int(d) == step]
    if not steps:
        return None
    step_dir = os.path.join(directory, max(steps, key=int))
    candidates = []
    for root, _dirs, names in os.walk(step_dir):
        for name in names:
            p = os.path.join(root, name)
            candidates.append((os.path.getsize(p), p))
    if not candidates:
        return None
    candidates.sort(reverse=True)
    # Among the largest quartile (the array payloads — truncating a
    # tiny metadata file is a different, easier failure), pick one.
    top = candidates[:max(1, len(candidates) // 4)]
    _, victim = random.Random(f"trunc/{seed}").choice(top)
    with open(victim, "r+b") as fh:
        fh.truncate(keep_bytes)
    return victim
