"""The scorer handle both inference surfaces share, and the score-line
format — the port's counterpart of ``fast_tffm_tpu/scoring.py``.

``CompiledScorer`` keeps the JAX name: batch predict (predict.py) and
the serving process (serve/server.py) score every batch through it, so
the two cannot pair a batch with another score path. This slice has one
path, the raw gather (``dedup = device`` in the JAX package): a batch's
``local_idx`` holds raw table rows and the kernel reads them itself.

``format_scores`` is the one ``%.6f``-per-line formatter: predict writes
it to ``.score`` files and serving returns it as the response body, so
the same float64 scores give the same bytes on both surfaces.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import DeviceBatch
from fast_tffm_tpu_torch.metrics import sigmoid
from fast_tffm_tpu_torch.models.fm import ModelSpec, score_body


class CompiledScorer:
    """Scores padded raw-ids batches against a table on ``device``."""

    def __init__(self, cfg: FmConfig, device: torch.device):
        self.spec = ModelSpec.from_config(cfg)
        self.device = torch.device(device)

    def score_batch(self, table: torch.Tensor,
                    batch: DeviceBatch) -> torch.Tensor:
        """Raw [B] scores, left on the device (callers fetch them)."""
        idx = torch.from_numpy(batch.local_idx).to(self.device)
        vals = torch.from_numpy(batch.vals).to(self.device)
        return score_body(self.spec, table, idx, vals)

    def transform(self, raw: np.ndarray) -> np.ndarray:
        """What the score lines hold: sigmoid for logistic loss, the raw
        score for mse; float64 either way."""
        if self.spec.loss_type == "logistic":
            return sigmoid(raw)
        return np.asarray(raw, dtype=np.float64)


def format_scores(vals: Iterable[float]) -> str:
    """One ``%.6f`` line per score (the ``.score`` file format)."""
    return "".join(f"{v:.6f}\n" for v in vals)
