"""Batch predict — the port's counterpart of ``fast_tffm_tpu/predict.py``
(one device, or one device per rank of a ``dist_train`` job).

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

``dist_train worker <i>`` (more than one ``worker_hosts`` entry): the
process joins the cluster as rank i, restores its row shard of the
step, reads its byte range of every predict file, and scores it through
the sharded forward in lockstep (``parallel.sharded.
lockstep_score_batches``: a rank whose shard ran dry scores filler);
each rank writes its scores of each file as a part file, and the
chief's ``PartMerger`` merges them into the one ``.score`` file per
input, one line per input line, blank lines included. ``lookup = host``
and ``vocab_mode = admit`` are single-process here, as in the JAX
package.

Telemetry (``metrics_file``; obs/): the sweep's counters,
``predict_file`` events, spans, the ledger's ``table`` and the crash
event, as in the JAX package. In the ``dist_train`` sweep each rank
writes its own shard (the chief ``<metrics_file>``, rank i
``<metrics_file>.p<i>``), made once the cluster has formed: its
lockstep spans and counters (parallel/sharded.py), a ``predict/sweep``
span, ``predict/examples`` and a ``predict_file`` event per file
carrying the rank, and the rank's own ``predict/seconds`` and rate.
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
from fast_tffm_tpu_torch.data.pipeline import (FileMarks, batch_iterator,
                                               expand_files,
                                               probe_uniq_bucket,
                                               require_bounded_examples)
from fast_tffm_tpu_torch.lookup import make_score_backend
from fast_tffm_tpu_torch.metrics import sigmoid
from fast_tffm_tpu_torch.models.fm import (ModelSpec, batch_args,
                                           sharded_score_body)
from fast_tffm_tpu_torch.obs.memory import LEDGER, bind_device
from fast_tffm_tpu_torch.obs.telemetry import (active, make_telemetry,
                                               pop_active, push_active)
from fast_tffm_tpu_torch.obs.trace import span
from fast_tffm_tpu_torch.parallel import distributed as dist_mod
from fast_tffm_tpu_torch.parallel.liveness import (HeartbeatLease,
                                                   WorkerLostError,
                                                   install_guard, lease_dir,
                                                   restore_guard)
from fast_tffm_tpu_torch.parallel.sharded import (ProcessMesh,
                                                  lockstep_score_batches,
                                                  make_mesh, place_table)
from fast_tffm_tpu_torch.scoring import (CompiledScorer, PartMerger,
                                         ScoreDemux, ScoreWriter,
                                         score_sweep, scrub_stale_parts)
from fast_tffm_tpu_torch.train import check_restored_vocab, checkpoint_template
from fast_tffm_tpu_torch.utils.device import indexed, resolve_device
from fast_tffm_tpu_torch.utils.ignored import log_ignored_keys
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.retry import RetryPolicy


def load_table(cfg: FmConfig, device: torch.device,
               step: Optional[int] = None, with_step: bool = False,
               mesh: Optional[ProcessMesh] = None):
    """Restore the table from the newest intact checkpoint step — or,
    with an explicit ``step``, those exact verified bytes (the serving
    process's hot reload; restore verifies an explicit step and raises
    instead of walking past it) — onto ``device``, as ``[num_rows, D]``
    (with a ``mesh``, this rank's row shard). The copy to the card is
    complete when this returns. ``with_step=True`` returns ``(table,
    step)``."""
    ckpt = CheckpointState(cfg.model_file,
                           retry=RetryPolicy.from_config(cfg),
                           verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init, mesh=mesh)
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
            device=None, job_name: Optional[str] = None,
            task_index: Optional[int] = None) -> List[str]:
    """Run batch prediction; returns the score files written. ``device``
    defaults to the card (utils/device.py); ``table`` defaults to the
    newest intact checkpoint step's (``load_table``). With ``lookup =
    host`` a given ``table`` is a CPU tensor and stays on the host.
    ``job_name`` / ``task_index``: the ``dist_train worker <i>`` argv
    (the multi-process sweep; ``table``, if given, is the dense
    ``[num_rows, D]`` one, of which each rank keeps its rows)."""
    device = resolve_device(device)
    logger = get_logger(log_file=cfg.log_file or None)
    rank, size = 0, 1
    if job_name is not None:
        if len(cfg.worker_hosts) > 1:
            if cfg.lookup == "host":
                raise ValueError("lookup = host predict is single-process")
            if cfg.vocab_mode == "admit":
                raise ValueError(
                    "vocab_mode = admit predict is single-process (the "
                    "slot map is host state; see the train-side "
                    "restriction)")
        rank, size = dist_mod.init_from_cluster(cfg, job_name,
                                                task_index or 0)
    log_ignored_keys(cfg, logger)
    # The run's telemetry (metrics_file; obs/), made once the cluster has
    # formed, keyed by the rank: the sink's lifecycle spans the whole
    # predict, so a crash mid-sweep still flushes.
    cluster = job_name is not None
    tel = make_telemetry(cfg, "predict",
                         process_index=rank if cluster else None,
                         process_count=size if cluster else None,
                         device=device)
    bind_device(device)
    tel_prev = push_active(tel)
    try:
        if size > 1:
            return _predict_cluster(cfg, table, device, logger, rank, size)
        return _predict_single(cfg, table, device, logger)
    except BaseException as e:
        if isinstance(e, WorkerLostError) and tel is not None:
            # The buffered device scalars come from collectives that will
            # never complete on a dead cluster: dropped, as in the JAX
            # package.
            tel.sink.discard_scalars()
        if tel is not None:
            try:
                tel.record_crash(e)
            except Exception:  # noqa: BLE001 - never mask the error
                logger.exception("crash event emission failed")
        raise
    finally:
        if tel is not None:
            try:
                tel.close()
            except Exception:  # noqa: BLE001 - never mask the error
                logger.exception("metrics sink close failed")
        pop_active(tel_prev)


def _predict_single(cfg: FmConfig, table: Optional[torch.Tensor],
                    device: torch.device, logger) -> List[str]:
    """The single-process predict: restore, then one sweep."""
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
    tel = active()
    if table is not None:
        # The sweep's resident table in the memory ledger (host
        # metadata, no fetch); released when the sweep ends.
        LEDGER.register("table", int(table.nbytes))
    os.makedirs(cfg.score_path, exist_ok=True)
    written: List[str] = []
    # The inner close() raises a deferred write error on the clean path;
    # the finally's close flushes without masking an error in flight.
    writer = ScoreWriter(logger)
    t0 = time.perf_counter()
    emitted = [0]  # examples cut so far (on_file runs on one thread)

    def on_file(path: str, raw: np.ndarray) -> None:
        # On the fetch worker mid-sweep: a vectorized transform and a
        # bounded queue put.
        out_path = _score_out_path(cfg, path)
        writer.submit(out_path, scorer.transform(raw))
        written.append(out_path)
        emitted[0] += len(raw)
        if tel is not None:
            # Files overlap in the sweep: seconds and rate are the
            # sweep's so far, at this file's cut.
            dt = time.perf_counter() - t0
            tel.sink.emit("predict_file",
                          {"path": path, "examples": len(raw),
                           "seconds": dt,
                           "examples_per_sec":
                               emitted[0] / dt if dt > 0 else 0.0})

    try:
        n_examples = score_sweep(cfg, table, expand_files(cfg.predict_files),
                                 on_file, scorer, vocab=vocab)
        writer.close()
    finally:
        writer.close(raise_error=False)
        LEDGER.release("table")
    seconds = time.perf_counter() - t0
    if tel is not None:
        tel.count("predict/seconds", seconds)
        tel.set("predict/examples_per_sec",
                n_examples / seconds if seconds > 0 else 0.0)
        # One barrier for the sweep (its scores are on the host).
        tel.barrier_flush(step=len(written))
    logger.info("predict sweep: %d files, %d examples, %.0f examples/s",
                len(written), n_examples,
                n_examples / seconds if seconds > 0 else 0.0)
    return written


def _predict_cluster(cfg: FmConfig, table: Optional[torch.Tensor],
                     device: torch.device, logger, rank: int,
                     size: int) -> List[str]:
    """The multi-process sweep under the heartbeat lease and the
    deadline guard: a dead peer raises ``WorkerLostError`` naming it (no
    recovery: predict is cheap to run again)."""
    lease = None
    lost = False
    if cfg.heartbeat_seconds > 0:
        lease = HeartbeatLease(lease_dir(cfg), process_index=rank,
                               members=range(size),
                               heartbeat_seconds=cfg.heartbeat_seconds
                               ).start()
    tel = active()
    if tel is not None:
        # The per-worker liveness gauges ride every flush.
        tel.lease = lease
    guard_prev = install_guard(lease, cfg.collective_timeout_seconds)
    try:
        return _predict_multiprocess(cfg, table, device, logger,
                                     make_mesh(cfg, rank, size))
    except WorkerLostError as e:
        lost = True
        logger.error("WorkerLostError: %s", e)
        raise
    finally:
        if tel is not None:
            tel.lease = None
        if lease is not None:
            lease.stop()
        restore_guard(guard_prev)
        if not lost:
            dist_mod.shutdown()


def _predict_multiprocess(cfg: FmConfig, table: Optional[torch.Tensor],
                          device: torch.device, logger,
                          mesh: ProcessMesh) -> List[str]:
    """One continuous sharded sweep: every rank scores its byte range of
    all files through ``sharded_score_body`` in lockstep, cuts its
    ordered scores into per-file part files (``ScoreDemux``, written by
    a ``ScoreWriter`` with a ``.done`` marker each), and the chief's
    ``PartMerger`` merges each file's parts as their markers land.
    Three barriers: the stale-part scrub, the parts written, the merge
    done."""
    require_bounded_examples(cfg, "multi-process predict")
    device = indexed(device)
    dist_mod.share_host_threads(cfg, device, range(mesh.size), mesh.rank)
    p, P = mesh.rank, mesh.size
    logger.info("multi-process predict: rank %d of %d on %s", p, P, device)
    directory = os.path.abspath(cfg.model_file) + ".ckpt"
    if table is None:
        table, step = load_table(cfg, device, with_step=True, mesh=mesh)
        # The existence probe reads the shared directory alike on every
        # rank: all refuse together.
        refuse_fixed_mode_admit_step(cfg, directory, step)
    else:
        table = place_table(cfg, mesh, table, device)
    spec = ModelSpec.from_config(cfg, num_processes=P)
    files = expand_files(cfg.predict_files)
    if not files:
        logger.warning("predict_files is empty; nothing to score")
        return []
    os.makedirs(cfg.score_path, exist_ok=True)
    out_paths = [_score_out_path(cfg, f) for f in files]
    # One bucket for the sweep: the probe reads the same bytes on every
    # rank.
    ub = cfg.uniq_bucket or probe_uniq_bucket(cfg, files)
    marks = FileMarks()
    it = batch_iterator(cfg, files, training=False, epochs=1,
                        keep_empty=True, shard_index=p, num_shards=P,
                        fixed_shape=True, uniq_bucket=ub, raw_ids=False,
                        file_marks=marks)
    if p == 0:
        stale = scrub_stale_parts(out_paths)
        if stale:
            logger.warning(
                "removed %d stale part file(s) from a prior predict sweep "
                "into %s (first: %s)", len(stale), cfg.score_path, stale[0])
    mesh.barrier("predict/clean_barrier")
    writer = ScoreWriter(logger)
    merger = PartMerger(out_paths, P, logger) if p == 0 else None
    tel = active()
    t0 = time.perf_counter()
    n_local = 0

    def on_file(path: str, raw: np.ndarray) -> None:
        vals = sigmoid(raw) if cfg.loss_type == "logistic" else raw
        part = f"{_score_out_path(cfg, path)}.part{p}"
        writer.submit(part, vals, marker=f"{part}.done")
        if tel is not None:
            tel.count("predict/examples", len(raw))
            tel.sink.emit("predict_file",
                          {"path": path, "examples": len(raw),
                           "process_index": p})

    def score_fn(table, batch):
        args = batch_args(batch, device)
        del args["labels"], args["weights"]
        args["uniq_ids"] = batch.uniq_ids
        return sharded_score_body(spec, mesh, table, **args)

    demux = ScoreDemux(marks, on_file)
    try:
        with torch.no_grad(), span("predict/sweep", files=len(files)):
            for batch, local in lockstep_score_batches(cfg, it, mesh,
                                                       score_fn, table, ub):
                demux.consume(local[:batch.num_real])
                n_local += batch.num_real
                if tel is not None:
                    tel.heartbeat()  # lockstep progress feeds the watchdog
        demux.finalize()
        writer.close()  # every part and marker of this rank is on disk
        mesh.barrier("predict/parts_barrier")
        if merger is not None:
            merger.finish()
        # The chief read and deleted every part before anyone returns.
        mesh.barrier("predict/merge_barrier")
    finally:
        writer.close(raise_error=False)
        if merger is not None:
            merger.stop()
    seconds = time.perf_counter() - t0
    if tel is not None:
        # This rank's own rate; fmstat over every shard sums examples
        # and seconds.
        tel.count("predict/seconds", seconds)
        tel.set("predict/examples_per_sec",
                n_local / seconds if seconds > 0 else 0.0)
        tel.barrier_flush(step=len(out_paths))
    logger.info("predict sweep (rank %d of %d): %d files, %d local "
                "examples, %.0f examples/s", p, P, len(out_paths), n_local,
                n_local / seconds if seconds > 0 else 0.0)
    return out_paths
