"""TensorBoard scalar summaries (``save_summaries_steps``) — the port of
``fast_tffm_tpu/utils/summaries.py``.

The knob writes TensorBoard scalars (train loss, examples/sec,
validation AUC) as event files under ``<model_file>.tb/`` through
``torch.utils.tensorboard.SummaryWriter``, which needs the
``tensorboard`` package. The import is lazy, and a failed one warns once
and training goes on without summaries, as the JAX package does without
TensorFlow.

Scalar values may be device tensors: they are buffered as they are and
fetched together at ``flush()`` (``utils/fetch.fetch_floats``), which
the train loop calls at epoch barriers, so summaries add no fetch
between them up to ``SUMMARY_BUFFER_MAX`` buffered entries.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

from fast_tffm_tpu_torch.config import FmConfig

# Buffered-scalar cap (train.LOG_BUFFER_MAX's bound).
SUMMARY_BUFFER_MAX = 1024


class ScalarSummaries:
    """Buffered TensorBoard scalar writer; ``writer`` is a
    ``SummaryWriter`` (``add_scalar``, ``flush``, ``close``)."""

    def __init__(self, logdir: str, writer):
        self._writer = writer
        self.logdir = logdir
        self._buf: List[Tuple[str, int, object]] = []

    def add(self, tag: str, step: int, value) -> None:
        """Queue one scalar; ``value`` may be a device tensor (not read
        here: see flush)."""
        self._buf.append((tag, step, value))
        if len(self._buf) >= SUMMARY_BUFFER_MAX:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        from fast_tffm_tpu_torch.utils.fetch import fetch_floats
        values = fetch_floats([v for _, _, v in self._buf])
        for (tag, step, _), val in zip(self._buf, values):
            self._writer.add_scalar(tag, val, global_step=step)
        self._writer.flush()
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._writer.close()


def make_summaries(cfg: FmConfig) -> Optional[ScalarSummaries]:
    """A ScalarSummaries under ``<model_file>.tb/`` when
    ``save_summaries_steps`` is set and the writer imports, else None
    (with one warning when the knob asked for summaries the writer
    cannot give)."""
    if cfg.save_summaries_steps <= 0:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception as e:  # noqa: BLE001 - no tensorboard package
        warnings.warn(
            f"save_summaries_steps = {cfg.save_summaries_steps} needs the "
            f"tensorboard package for torch.utils.tensorboard, which "
            f"failed to import ({type(e).__name__}); summaries are "
            "disabled for this run")
        return None
    logdir = cfg.model_file + ".tb"
    return ScalarSummaries(logdir, SummaryWriter(log_dir=logdir))
