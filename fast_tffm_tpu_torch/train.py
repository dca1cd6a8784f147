"""Training — the single-process, single-device subset of
``fast_tffm_tpu/train.py`` (``train`` → ``_train_session`` on one device,
``lookup = device``, padded wire, ``vocab_mode = fixed``,
``dedup = device``).

    python -m fast_tffm_tpu_torch train <cfg> [--device cuda|cpu]

Per epoch: the training stream (``batch_iterator`` with ``seed =
cfg.seed + epoch``, under ``prefetch``) through ``train_step_body``,
then ``evaluate`` over the validation files. At the end the table is
exported to ``<model_file>.npz`` in ``export_npz``'s layout, which the
port's predict and serve read. Log lines are the JAX package's. Losses
stay on the device and are fetched together at the epoch barrier, so
the loop never waits for the device to log.

Not ported yet, each refused with the ROADMAP.md item that brings it:
checkpoints and resume, periodic saves and publishing (A3); weight
files, tolerant bad-line policies (A4); multi-process and elastic
training (A10); the stream run mode (A13). The observability knobs are
accepted and ignored (A11).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import (batch_iterator,
                                               check_stream_supported,
                                               prefetch)
from fast_tffm_tpu_torch.metrics import StreamingAUC
from fast_tffm_tpu_torch.models.convert import save_npz
from fast_tffm_tpu_torch.models.fm import (ModelSpec, batch_args,
                                           init_accumulator, init_table,
                                           score_body, train_step_body)
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.timing import StepTimer

# Above this, the dense .npz export is skipped (the JAX package's gate).
EXPORT_NPZ_MAX_BYTES = 2 << 30

# Buffered loss scalars between fetches: a long epoch with a short
# log_steps syncs once per this many log lines instead of never.
LOG_BUFFER_MAX = 1024

# Validation scores fetched from the device this many batches at a time.
FETCH_CHUNK_BATCHES = 16

# Accepted and ignored until observability is ported (ROADMAP.md A11).
_IGNORED_KNOBS = ("metrics_file", "trace_spans", "save_summaries_steps",
                  "profile_dir", "watchdog_stall_seconds",
                  "mem_pressure_fraction")


def check_train_supported(cfg: FmConfig) -> None:
    """Refuse what this port cannot train yet, naming the ROADMAP.md
    item that brings each; a silently ignored key would give another
    result than the JAX package's."""
    check_stream_supported(cfg)
    refusals = (
        (cfg.run_mode == "stream", "run_mode = stream", "A13"),
        (cfg.publish_interval_seconds > 0 or cfg.publish_min_auc > 0
         or cfg.publish_max_auc_drop > 0,
         "publish_interval_seconds / publish_min_auc / "
         "publish_max_auc_drop", "A3"),
        (cfg.save_steps > 0,
         f"save_steps = {cfg.save_steps} (periodic checkpoints)", "A3"),
        (bool(cfg.ps_hosts or cfg.worker_hosts),
         "ps_hosts / worker_hosts (dist_train)", "A10"),
        (cfg.elastic != "off", f"elastic = {cfg.elastic}", "A10"),
    )
    for refused, what, item in refusals:
        if refused:
            raise NotImplementedError(
                f"{what} is not ported to fast_tffm_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")
    ckpt_dir = cfg.model_file + ".ckpt"
    if os.path.exists(ckpt_dir):
        raise NotImplementedError(
            f"{ckpt_dir} exists, and fast_tffm_tpu_torch cannot resume "
            "from a checkpoint yet (ROADMAP.md, queue A, item A3); move "
            "it away to train from a fresh table")


def evaluate(cfg: FmConfig, table: torch.Tensor, files,
             max_batches: Optional[int] = None) -> Tuple[float, int]:
    """Streamed AUC over ``files``: (auc, n_examples). Scores stay on
    the device and are fetched FETCH_CHUNK_BATCHES batches at a time."""
    spec = ModelSpec.from_config(cfg)
    auc = StreamingAUC()
    n = 0
    n_batches = 0
    pending = []

    def flush():
        if not pending:
            return
        scores = torch.cat([s for s, _ in pending]).cpu().numpy()
        off = 0
        for s, batch in pending:
            B, m = len(s), batch.num_real
            auc.update(scores[off:off + m], batch.labels[:m],
                       batch.weights[:m])
            off += B
        pending.clear()

    with torch.no_grad():
        for batch in prefetch(batch_iterator(cfg, files, training=False,
                                             epochs=1),
                              depth=cfg.prefetch_depth):
            idx = torch.from_numpy(batch.local_idx).to(table.device)
            vals = torch.from_numpy(batch.vals).to(table.device)
            pending.append((score_body(spec, table, idx, vals), batch))
            n += batch.num_real
            n_batches += 1
            if len(pending) >= FETCH_CHUNK_BATCHES:
                flush()
            if max_batches and n_batches >= max_batches:
                break
    flush()
    return auc.result(), n


def train(cfg: FmConfig, device=None,
          init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> torch.Tensor:
    """Train per ``cfg``; returns the final table ``[num_rows, D]``.
    ``device`` defaults to the card (utils/device.py). ``init_state``
    is a ``(table, acc)`` pair to start from (models/convert.py
    ``state_from_numpy``); by default the table is drawn from
    ``cfg.seed`` and the accumulator filled with ``adagrad_init``.
    Both are updated in place."""
    device = resolve_device(device)
    spec = ModelSpec.from_config(cfg)  # refuses unported model values
    check_train_supported(cfg)
    logger = get_logger(log_file=cfg.log_file or None)
    defaults = FmConfig()
    for knob in _IGNORED_KNOBS:
        if getattr(cfg, knob) != getattr(defaults, knob):
            logger.info(
                "%s = %r is accepted and ignored: observability is not "
                "ported to fast_tffm_tpu_torch yet (ROADMAP.md, queue A, "
                "item A11)", knob, getattr(cfg, knob))
    if init_state is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        table = init_table(cfg, device, gen)
        acc = init_accumulator(cfg, device)
    else:
        table, acc = init_state
        want = (cfg.num_rows, cfg.row_dim)
        if tuple(table.shape) != want or tuple(acc.shape) != want or \
                {table.device.type, acc.device.type} != {device.type}:
            raise ValueError(
                f"init_state must be two {list(want)} tensors on {device}, "
                f"got {tuple(table.shape)} on {table.device} and "
                f"{tuple(acc.shape)} on {acc.device}")

    timer = StepTimer()
    global_step = 0
    loss = None
    loss_val = float("nan")
    log_buffer: list = []  # (step, epoch, loss on the device, examples/s)

    def flush_log():
        nonlocal loss_val
        if not log_buffer:
            return
        values = torch.stack([b[2] for b in log_buffer]).cpu().tolist()
        for (s, ep, _, eps), val in zip(log_buffer, values):
            loss_val = val
            logger.info("step %d epoch %d loss %.6f examples/sec %.0f",
                        s, ep, val, eps)
        log_buffer.clear()

    for epoch in range(cfg.epoch_num):
        for batch in prefetch(batch_iterator(cfg, cfg.train_files,
                                             training=True, epochs=1,
                                             seed=cfg.seed + epoch),
                              depth=cfg.prefetch_depth):
            table, acc, loss, _ = train_step_body(
                spec, table, acc, **batch_args(batch, device))
            global_step += 1
            timer.tick(batch.num_real)
            if cfg.log_steps and global_step % cfg.log_steps == 0:
                log_buffer.append((global_step, epoch, loss,
                                   timer.consume_window_rate()))
                if len(log_buffer) >= LOG_BUFFER_MAX:
                    flush_log()
        flush_log()  # the epoch barrier: one fetch for the epoch's lines
        if cfg.validation_files:
            auc, n = evaluate(cfg, table, cfg.validation_files,
                              max_batches=cfg.validation_max_batches
                              or None)
            logger.info("epoch %d validation AUC %.6f over %d examples",
                        epoch, auc, n)
    loss_val = float(loss) if loss is not None else loss_val
    nbytes = cfg.num_rows * cfg.row_dim * 4
    if nbytes > EXPORT_NPZ_MAX_BYTES:
        logger.warning(
            "skipping dense .npz export: table is %.1f GB > %.1f GB "
            "threshold, and fast_tffm_tpu_torch writes no checkpoint yet "
            "(ROADMAP.md, queue A, item A3): this run's table is not "
            "saved", nbytes / 2**30, EXPORT_NPZ_MAX_BYTES / 2**30)
    else:
        save_npz(table, cfg.model_file + ".npz", cfg)
    logger.info("training done: %d steps, final loss %.6f, %.0f examples/sec",
                global_step, loss_val, timer.total_examples_per_sec)
    return table

