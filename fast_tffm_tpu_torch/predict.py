"""Batch predict — the port's counterpart of ``fast_tffm_tpu/predict.py``
(single device).

Loads the dense table export ``<model_file>.npz``, reads each predict
file in ``batch_size`` chunks of lines, and writes one score per input
line, order-preserving, to ``<score_path>/<basename(f)>.score`` —
sigmoid for logistic loss, raw for mse, ``%.6f`` per line. Blank lines
score as the model bias (``keep_empty``), so score files stay
line-aligned with their inputs.

Not ported yet: the mesh and multi-process sweeps, offload, admit, the
C++ ``BatchBuilder`` and the cross-file overlapped sweep (ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import parse_lines
from fast_tffm_tpu_torch.data.pipeline import expand_files, make_device_batch
from fast_tffm_tpu_torch.models.convert import load_npz
from fast_tffm_tpu_torch.scoring import CompiledScorer, format_scores
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.utils.logging import get_logger


def load_table(cfg: FmConfig, device: torch.device) -> torch.Tensor:
    """The dense export every single-process JAX train writes."""
    path = cfg.model_file + ".npz"
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no dense table export at {path}: train with the JAX "
            "package (it writes <model_file>.npz) or write one with "
            "fast_tffm_tpu_torch.models.convert.save_npz")
    return load_npz(path, cfg, device)


def _line_chunks(path: str, n: int) -> Iterator[List[str]]:
    """Lines of ``path`` in chunks of ``n``. Lines split on b"\\n" only,
    as the JAX pipeline splits them; a final line without its newline
    still counts."""
    chunk: List[str] = []
    with open(path, "rb") as fh:
        for raw in fh:
            if raw.endswith(b"\n"):
                raw = raw[:-1]
            chunk.append(raw.decode("utf-8"))
            if len(chunk) == n:
                yield chunk
                chunk = []
    if chunk:
        yield chunk


def _score_out_path(cfg: FmConfig, path: str) -> str:
    return os.path.join(cfg.score_path, os.path.basename(path) + ".score")


def predict(cfg: FmConfig, table: Optional[torch.Tensor] = None,
            device=None) -> List[str]:
    """Run batch prediction; returns the score files written. ``device``
    defaults to the card (utils/device.py); ``table`` defaults to the
    ``.npz`` export."""
    device = resolve_device(device)
    scorer = CompiledScorer(cfg, device)  # refuses unported config values
    logger = get_logger(log_file=cfg.log_file or None)
    if table is None:
        table = load_table(cfg, device)
    return _predict_body(cfg, table, scorer, logger)


def _predict_body(cfg: FmConfig, table: torch.Tensor,
                  scorer: CompiledScorer, logger) -> List[str]:
    os.makedirs(cfg.score_path, exist_ok=True)
    written: List[str] = []
    n_examples = 0
    t0 = time.perf_counter()
    for path in expand_files(cfg.predict_files):
        out_path = _score_out_path(cfg, path)
        with open(out_path, "w") as out:
            for lines in _line_chunks(path, cfg.batch_size):
                block = parse_lines(
                    lines, cfg.vocabulary_size,
                    hash_feature_id=cfg.hash_feature_id,
                    max_features_per_example=cfg.max_features_per_example,
                    keep_empty=True)
                batch = make_device_batch(block, cfg)
                raw = scorer.score_batch(table, batch)[:batch.num_real]
                out.write(format_scores(scorer.transform(raw.cpu().numpy())))
                n_examples += batch.num_real
        written.append(out_path)
        logger.info("wrote scores to %s", out_path)
    seconds = time.perf_counter() - t0
    logger.info("predict: %d files, %d examples, %.0f examples/s",
                len(written), n_examples,
                n_examples / seconds if seconds > 0 else 0.0)
    return written
