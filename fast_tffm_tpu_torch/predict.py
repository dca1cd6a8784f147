"""Batch predict — the port's counterpart of ``fast_tffm_tpu/predict.py``
(single device).

Restores the table of the newest intact checkpoint step under
``<model_file>.ckpt/`` (checkpoint.py; the accumulator is not read),
scores every predict file in one cross-file sweep through the C++
``BatchBuilder`` (``scoring.score_sweep``: batches cross file
boundaries, the copy of scores to the host and the score-file writes
overlap the scoring), and writes one score per input line,
order-preserving, to ``<score_path>/<basename(f)>.score`` — sigmoid for
logistic loss, raw for mse, ``%.6f`` per line. Blank lines score as the
model bias (``keep_empty``), so score files stay line-aligned with their
inputs. Batches ship through the scorer's wire encoder (wire.py), padded
or packed as ``wire_format`` says.

``lookup = host``: the table is restored (table only) or wrapped into a
score backend (``lookup.make_score_backend``), page-locked on the host;
the card only ever holds each batch's gathered ``[U, D]`` rows. The
scores equal the device lookup's byte for byte.

``vocab_mode = admit``: the restored step's table is paired with that
step's slot map (``checkpoint.load_vocab_map``: the (table, slot map,
step) triple), and the sweep remaps through it; a caller-held table has
no slot map and is refused. Under ``vocab_mode = fixed`` a step that
carries a vocab sidecar is refused (``refuse_fixed_mode_admit_step``).

Not ported yet: the mesh and multi-process sweeps with their part
files (ROADMAP.md A10).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import (CheckpointState, load_vocab_map,
                                            refuse_fixed_mode_admit_step)
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import expand_files
from fast_tffm_tpu_torch.lookup import make_score_backend
from fast_tffm_tpu_torch.scoring import (CompiledScorer, ScoreWriter,
                                         score_sweep)
from fast_tffm_tpu_torch.train import check_restored_vocab, checkpoint_template
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.utils.ignored import log_ignored_keys
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.retry import RetryPolicy


def load_table(cfg: FmConfig, device: torch.device,
               step: Optional[int] = None, with_step: bool = False):
    """Restore the table from the newest intact checkpoint step — or,
    with an explicit ``step``, those exact verified bytes (the serving
    process's hot reload; restore verifies an explicit step and raises
    instead of walking past it) — onto ``device``, as ``[num_rows, D]``.
    The copy to the card is complete when this returns.
    ``with_step=True`` returns ``(table, step)``."""
    ckpt = CheckpointState(cfg.model_file,
                           retry=RetryPolicy.from_config(cfg),
                           verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init)
    try:
        restored = ckpt.restore(step=step,
                                template=checkpoint_template(cfg,
                                                             acc=False))
    finally:
        ckpt.close()
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint found under {cfg.model_file}.ckpt "
            "(run training first)")
    check_restored_vocab(cfg, restored)
    table = restored["table"].to(device)
    if table.is_cuda:
        torch.cuda.synchronize(table.device)
    return (table, int(restored["step"])) if with_step else table


def _score_out_path(cfg: FmConfig, path: str) -> str:
    return os.path.join(cfg.score_path, os.path.basename(path) + ".score")


def predict(cfg: FmConfig, table: Optional[torch.Tensor] = None,
            device=None) -> List[str]:
    """Run batch prediction; returns the score files written. ``device``
    defaults to the card (utils/device.py); ``table`` defaults to the
    newest intact checkpoint step's (``load_table``). With ``lookup =
    host`` a given ``table`` is a CPU tensor and stays on the host."""
    device = resolve_device(device)
    logger = get_logger(log_file=cfg.log_file or None)
    log_ignored_keys(cfg, logger)
    admit = cfg.vocab_mode == "admit"
    if admit and table is not None:
        raise ValueError(
            "vocab_mode = admit predict restores the (table, slot "
            "map, step) triple from the checkpoint together — a "
            "caller-held table has no slot map to pair with; pass "
            "table=None")
    backend = None
    step = None  # the restored step; None for a caller-held table
    if cfg.lookup == "host":
        # Never table.to(device): an offload-scale table does not fit
        # the card's memory.
        backend = make_score_backend(cfg, table, device=device)
        step = getattr(backend, "step", None)
        table = None
        logger.info("offload predict [%s]: table [%d, %d] outside HBM",
                    type(backend).__name__, *backend.table.shape)
    elif table is None:
        table, step = load_table(cfg, device, with_step=True)
    directory = os.path.abspath(cfg.model_file) + ".ckpt"
    vocab = None
    if admit:
        # The restored table with ITS step's slot map: the sidecar rides
        # the step, so a walk-back never splits the pair.
        vocab = load_vocab_map(cfg, directory, step)
        logger.info("vocab admission map: %d live rows at step %d",
                    vocab.live_rows, step)
    else:
        refuse_fixed_mode_admit_step(cfg, directory, step)
    scorer = CompiledScorer(cfg, device, backend=backend)
    logger.info("wire format: %s", scorer.wire.describe())
    return _predict_body(cfg, table, scorer, logger, vocab)


def _predict_body(cfg: FmConfig, table: Optional[torch.Tensor],
                  scorer: CompiledScorer, logger, vocab=None) -> List[str]:
    os.makedirs(cfg.score_path, exist_ok=True)
    written: List[str] = []
    # The inner close() raises a deferred write error on the clean path;
    # the finally's close flushes without masking an error in flight.
    writer = ScoreWriter(logger)
    t0 = time.perf_counter()

    def on_file(path: str, raw: np.ndarray) -> None:
        # On the fetch worker mid-sweep: a vectorized transform and a
        # bounded queue put.
        out_path = _score_out_path(cfg, path)
        writer.submit(out_path, scorer.transform(raw))
        written.append(out_path)

    try:
        n_examples = score_sweep(cfg, table, expand_files(cfg.predict_files),
                                 on_file, scorer, vocab=vocab)
        writer.close()
    finally:
        writer.close(raise_error=False)
    seconds = time.perf_counter() - t0
    logger.info("predict sweep: %d files, %d examples, %.0f examples/s",
                len(written), n_examples,
                n_examples / seconds if seconds > 0 else 0.0)
    return written
