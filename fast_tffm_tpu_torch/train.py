"""Training — the single-process, single-device subset of
``fast_tffm_tpu/train.py`` (``train`` → ``_train_session`` on one device,
``lookup = device``, ``vocab_mode = fixed``): FM of order 2 and higher,
and field-aware FM.

    python -m fast_tffm_tpu_torch train <cfg> [--device cuda|cpu]

At start the newest intact step of ``<model_file>.ckpt/`` is restored
(checkpoint.py; a torn newer step is quarantined and walked past): the
run continues from its table, accumulator and step. An interrupted
epoch schedule resumes at its first incomplete epoch; a completed one
runs a fresh ``epoch_num``-epoch schedule on top (the JAX package's
``resume_start_epoch``). Per epoch: the training stream
(``batch_iterator`` with ``seed = cfg.seed + epoch``, under
``prefetch``) through ``train_step_body``, an asynchronous checkpoint
save every ``save_steps`` steps, then ``evaluate`` over the validation
files. Weight files (``weight_files``, ``validation_weight_files``)
weight each example's loss and its validation AUC; a tolerant
``bad_line_policy`` skips or quarantines bad lines through one
run-scoped ``BadLineTracker`` that every epoch's streams share, so its
breaker and quarantine dedupe see the whole run. ``dedup = host``
trains on the pipeline's host-deduped batches. Every step's batch ships
through one ``WireEncoder`` (wire.py; ``wire_format`` padded or packed,
``wire_dtypes``), double-buffered on the card, and ``evaluate`` scores
through a ``CompiledScorer``, which owns another; the run logs the wire
mode and, at the end, the bytes shipped against the padded layout's.
SIGTERM/SIGINT stop the loop at the next step boundary; the cut
epoch does not count as completed. The final save (also the preemption
save) waits until the step is durable; then the table is exported to
``<model_file>.npz`` in ``export_npz``'s layout, unless it is over 2 GiB.
Log lines are the JAX package's. Losses stay on the device and are
fetched together at the epoch barrier, so the loop never waits for the
device to log.

Not ported yet, each refused with the ROADMAP.md item that brings it:
multi-process and elastic training and the fixed unique bucket (A10);
the stream run mode and its publishing (A13). The observability keys
are accepted, ignored and logged (utils/ignored.py: A11, A13).
"""

from __future__ import annotations

import signal
from typing import Dict, Optional, Tuple

import torch

from fast_tffm_tpu_torch.checkpoint import CheckpointState
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.data.pipeline import (batch_iterator,
                                               check_stream_supported,
                                               gil_bound_iteration,
                                               host_parallel_workers,
                                               prefetch)
from fast_tffm_tpu_torch.metrics import StreamingAUC
from fast_tffm_tpu_torch.models.convert import save_npz
from fast_tffm_tpu_torch.models.fm import (ModelSpec, init_accumulator,
                                           init_table,
                                           packed_train_step_body,
                                           train_step_body)
from fast_tffm_tpu_torch.scoring import CompiledScorer
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.utils.fetch import ChunkedFetcher
from fast_tffm_tpu_torch.utils.ignored import log_ignored_keys
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.retry import RetryPolicy
from fast_tffm_tpu_torch.utils.timing import StepTimer
from fast_tffm_tpu_torch.wire import WireEncoder, resolve_wire

# Above this, the dense .npz export is skipped (the JAX package's gate).
EXPORT_NPZ_MAX_BYTES = 2 << 30

# Buffered loss scalars between fetches: a long epoch with a short
# log_steps syncs once per this many log lines instead of never.
LOG_BUFFER_MAX = 1024


def check_train_supported(cfg: FmConfig) -> None:
    """Refuse what this port cannot train yet, naming the ROADMAP.md
    item that brings each; a silently ignored key would give another
    result than the JAX package's."""
    check_stream_supported(cfg)
    refusals = (
        (cfg.run_mode == "stream", "run_mode = stream", "A13"),
        # The JAX config takes the publish knobs in stream mode only.
        (cfg.publish_interval_seconds > 0 or cfg.publish_min_auc > 0
         or cfg.publish_max_auc_drop > 0,
         "publish_interval_seconds / publish_min_auc / "
         "publish_max_auc_drop", "A13"),
        (bool(cfg.ps_hosts or cfg.worker_hosts),
         "ps_hosts / worker_hosts (dist_train)", "A10"),
        (cfg.elastic != "off", f"elastic = {cfg.elastic}", "A10"),
    )
    for refused, what, item in refusals:
        if refused:
            raise NotImplementedError(
                f"{what} is not ported to fast_tffm_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")


def checkpoint_template(cfg: FmConfig, acc: bool = True
                        ) -> Dict[str, Tuple[int, int]]:
    """The arrays ``CheckpointState.restore`` loads for this config and
    their shapes; ``acc=False`` loads the table alone (predict)."""
    shape = (cfg.num_rows, cfg.row_dim)
    return {"table": shape, "acc": shape} if acc else {"table": shape}


def resume_start_epoch(stored_epoch: int, epoch_num: int) -> int:
    """Where a restarted run's epoch loop begins.

    An INTERRUPTED schedule (0 < stored < epoch_num) resumes at the
    first incomplete epoch — restarting from zero would revisit the
    same data under the same per-epoch seeds and, under preemptions
    recurring faster than a full schedule, never terminate. A COMPLETED
    checkpoint (stored >= epoch_num, or a smaller epoch_num configured
    since) keeps the reference's semantics: invoking train again runs a
    fresh epoch_num-epoch schedule on top of the restored weights."""
    return stored_epoch if 0 < stored_epoch < epoch_num else 0


def check_restored_vocab(cfg: FmConfig, restored) -> None:
    """The 4096-aligned storage shape can't distinguish vocabularies in
    the same bucket, so the stored vocab is verified explicitly — a
    mismatch would silently turn a trained row into the pad row."""
    v = int(restored["vocab"])
    if v != cfg.vocabulary_size:
        raise ValueError(
            f"checkpoint was written with vocabulary_size={v}, but this "
            f"config has vocabulary_size={cfg.vocabulary_size}; restoring "
            "would misalign the pad row and feature ids. Retrain, or fix "
            "the config.")


def evaluate(cfg: FmConfig, table: torch.Tensor, files,
             max_batches: Optional[int] = None, weight_files=(),
             bad_lines: Optional[BadLineTracker] = None
             ) -> Tuple[float, int]:
    """Streamed AUC over ``files``: (auc, n_examples). ``weight_files``
    (sidecars parallel to ``files``) weight each example's AUC
    contribution as training weights its loss. ``bad_lines``: the run's
    tracker, so a bad line met every epoch is quarantined once. Batches
    score through a ``CompiledScorer`` (its wire encoder, as predict's);
    scores stay on the device and are fetched in chunks, behind the
    scoring (utils/fetch.py)."""
    scorer = CompiledScorer(cfg, table.device)
    auc = StreamingAUC()
    n = 0
    n_batches = 0

    def consume(scores, meta):
        labels, m, weights = meta
        auc.update(scores[:m], labels[:m], weights[:m])

    fetcher = ChunkedFetcher(consume)
    try:
        with torch.no_grad():
            for batch in prefetch(
                    batch_iterator(cfg, files, training=False, epochs=1,
                                   weight_files=weight_files,
                                   raw_ids=scorer.raw,
                                   bad_lines=bad_lines),
                    depth=cfg.prefetch_depth,
                    gil_bound=gil_bound_iteration(cfg, weight_files)):
                fetcher.add(scorer.score_batch(table, batch),
                            (batch.labels, batch.num_real, batch.weights))
                n += batch.num_real
                n_batches += 1
                if max_batches and n_batches >= max_batches:
                    break
        fetcher.flush()
    finally:
        fetcher.close()
    return auc.result(), n


def train(cfg: FmConfig, device=None,
          init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> torch.Tensor:
    """Train per ``cfg``; returns the final table ``[num_rows, D]``.
    ``device`` defaults to the card (utils/device.py). A checkpoint
    under ``<model_file>.ckpt/`` is resumed; without one the run starts
    from ``init_state``, a ``(table, acc)`` pair (models/convert.py
    ``state_from_numpy``), or else from a table drawn from ``cfg.seed``
    and an accumulator filled with ``adagrad_init``. Both are updated in
    place."""
    device = resolve_device(device)
    spec = ModelSpec.from_config(cfg)  # refuses unported model values
    check_train_supported(cfg)
    logger = get_logger(log_file=cfg.log_file or None)
    log_ignored_keys(cfg, logger)
    wire = resolve_wire(cfg, train=True)
    encoder = WireEncoder(wire, pad_id=cfg.pad_id)
    logger.info("wire format: %s%s", wire.describe(),
                " (flat CSR, unpacked on the device)" if wire.packed
                else "")
    host_workers = host_parallel_workers(cfg, cfg.weight_files)
    if host_workers > 1:
        logger.info(
            "host data plane: %d parallel batch-build workers "
            "(host_threads = %s; bounded ordered ring)",
            host_workers, cfg.host_threads)
    ckpt = CheckpointState(cfg.model_file,
                           retry=RetryPolicy.from_config(cfg),
                           verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init)
    # One run-scoped tracker (None under bad_line_policy = error): the
    # breaker and the quarantine dedupe see every epoch's streams.
    bad_tracker = BadLineTracker.from_config(cfg)
    prev_handlers = {}
    try:
        restored = ckpt.restore(template=checkpoint_template(cfg))
        global_step = 0
        restored_epoch = 0
        if restored is not None:
            check_restored_vocab(cfg, restored)
        table, acc = _initial_state(cfg, device, restored, init_state,
                                    ckpt.directory)
        if restored is not None:
            global_step = int(restored["step"])
            restored_epoch = int(restored["epoch"])
            logger.info("restored checkpoint at step %d", global_step)
        restored_step = global_step
        start_epoch = resume_start_epoch(restored_epoch, cfg.epoch_num)
        if start_epoch:
            logger.info("resuming interrupted epoch schedule at epoch "
                        "%d/%d", start_epoch, cfg.epoch_num)

        # Preemption: SIGTERM/SIGINT set a flag the loop drains at the
        # next step boundary, and the final save below is the
        # preemption save.
        preempted: list = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(
                    sig, lambda s, f: preempted.append(s))
            except ValueError:  # not the main thread
                pass

        timer = StepTimer()
        h2d_bytes = logical_bytes = 0
        loss = None
        loss_val = float("nan")
        log_buffer: list = []  # (step, epoch, loss on the device, ex/s)

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

        completed_epochs = start_epoch
        last_periodic_save = (None, None)  # (step, epoch) of the latest
        stopping = False
        for epoch in range(start_epoch, cfg.epoch_num):
            it = prefetch(batch_iterator(cfg, cfg.train_files,
                                         training=True,
                                         weight_files=cfg.weight_files,
                                         epochs=1, seed=cfg.seed + epoch,
                                         raw_ids=spec.dedup == "device",
                                         bad_lines=bad_tracker),
                          depth=cfg.prefetch_depth,
                          gil_bound=gil_bound_iteration(cfg,
                                                        cfg.weight_files))
            try:
                for batch in it:
                    if preempted:
                        stopping = True
                        logger.info(
                            "preemption signalled; saving and exiting")
                        break
                    wb = encoder.encode_train(batch)
                    args = encoder.device_put(wb, device)
                    if wb.packed:
                        table, acc, loss, _ = packed_train_step_body(
                            spec, wb.L, table, acc, **args)
                    else:
                        table, acc, loss, _ = train_step_body(
                            spec, table, acc, **args)
                    h2d_bytes += wb.wire_bytes
                    logical_bytes += wb.logical_bytes
                    global_step += 1
                    timer.tick(batch.num_real)
                    if cfg.log_steps and global_step % cfg.log_steps == 0:
                        log_buffer.append((global_step, epoch, loss,
                                           timer.consume_window_rate()))
                        if len(log_buffer) >= LOG_BUFFER_MAX:
                            flush_log()
                    if cfg.save_steps and \
                            global_step % cfg.save_steps == 0:
                        # Asynchronous: the snapshot is complete when
                        # save returns, so the next step may update the
                        # table in place; the write runs behind it.
                        ckpt.save(global_step, table, acc,
                                  vocabulary_size=cfg.vocabulary_size,
                                  epoch=completed_epochs)
                        last_periodic_save = (global_step,
                                              completed_epochs)
            finally:
                it.close()
            flush_log()  # the epoch barrier: one fetch for its lines
            if bad_tracker is not None and bad_tracker.bad:
                logger.info("bad-line policy through epoch %d: %s",
                            epoch, bad_tracker.describe())
            if stopping:  # a preemption-cut epoch is NOT completed
                break
            completed_epochs = epoch + 1
            if cfg.validation_files:
                auc, n = evaluate(cfg, table, cfg.validation_files,
                                  max_batches=cfg.validation_max_batches
                                  or None,
                                  weight_files=cfg.validation_weight_files,
                                  bad_lines=bad_tracker)
                logger.info("epoch %d validation AUC %.6f over %d "
                            "examples", epoch, auc, n)
        loss_val = float(loss) if loss is not None else loss_val
        # Final/preemption save: returns once the step is durable. If
        # this step's checkpoint exists with a stale epoch count — from
        # this run's last periodic save, or the restored checkpoint
        # when the schedule advanced without a step — the save records
        # the completed count in the epoch_override sidecar.
        stale = ((last_periodic_save[0] == global_step
                  and last_periodic_save[1] != completed_epochs)
                 or (restored is not None
                     and global_step == restored_step
                     and completed_epochs != restored_epoch))
        ckpt.save(global_step, table, acc,
                  vocabulary_size=cfg.vocabulary_size, force=True,
                  wait=True, epoch=completed_epochs,
                  rewrite_stale_metadata=stale)
        nbytes = cfg.num_rows * cfg.row_dim * 4
        if nbytes > EXPORT_NPZ_MAX_BYTES:
            logger.info(
                "skipping dense .npz export: table is %.1f GB > %.1f GB "
                "threshold; use the checkpoint at %s.ckpt",
                nbytes / 2**30, EXPORT_NPZ_MAX_BYTES / 2**30,
                cfg.model_file)
        else:
            save_npz(table, cfg.model_file + ".npz", cfg)
        logger.info("wire %s: h2d_bytes = %d over %d steps, against %d "
                    "in the padded layout", wire.describe(), h2d_bytes,
                    global_step - restored_step, logical_bytes)
        logger.info("training done: %d steps, final loss %.6f, %.0f "
                    "examples/sec", global_step, loss_val,
                    timer.total_examples_per_sec)
        return table
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        # Every exit path settles the in-flight save: an exception
        # between saves must not leave a write half done.
        ckpt.close()
        if bad_tracker is not None:
            bad_tracker.close()


def _initial_state(cfg: FmConfig, device: torch.device, restored,
                   init_state, directory: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table, acc)`` on ``device``: the restored checkpoint's, else
    ``init_state``, else a fresh draw from ``cfg.seed``."""
    if restored is not None:
        if init_state is not None:
            raise ValueError(
                f"init_state was given, but {directory} holds a "
                "checkpoint to resume; point model_file elsewhere to "
                "start from init_state")
        return (restored["table"].to(device).contiguous(),
                restored["acc"].to(device).contiguous())
    if init_state is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        return init_table(cfg, device, gen), init_accumulator(cfg, device)
    table, acc = init_state
    want = (cfg.num_rows, cfg.row_dim)
    if tuple(table.shape) != want or tuple(acc.shape) != want or \
            {table.device.type, acc.device.type} != {device.type}:
        raise ValueError(
            f"init_state must be two {list(want)} tensors on {device}, "
            f"got {tuple(table.shape)} on {table.device} and "
            f"{tuple(acc.shape)} on {acc.device}")
    return table, acc
