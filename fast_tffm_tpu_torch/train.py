"""Training — the port of ``fast_tffm_tpu/train.py`` (``train`` →
``_train_session``): FM of order 2 and higher, and field-aware FM, with the table on the device or, with
``lookup = host``, outside it, and ids mod into the table or, with
``vocab_mode = admit``, admitted into it; one process, or the ranks of
a ``dist_train`` job with the table row-sharded over them.

    python -m fast_tffm_tpu_torch train <cfg> [--device cuda|cpu]
                                        [dist_train worker <i> | --join]

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

``run_mode = stream`` (``_run_stream``) replaces the epoch loop with the
online loop over ``stream_dir`` (data/stream.py): every arriving batch
is stepped; the watermark of the last stepped batch rides every save
(``watermark-<step>.json``), so a restore resumes the stream with no
example skipped or repeated; every ``publish_interval_seconds`` a
publish runs the validation sweep (``publish_quality_eval``), the
``publish_min_auc`` / ``publish_max_auc_drop`` gate (obs/quality.py;
its baseline persists beside the pointer), then a synchronous save, a
verify and the ``published`` pointer flip; a held publish mints no
step. A ``STOP`` marker ends the run: the final save carries the
watermark and, when publishing, a gated exit publish follows (a
preempted gated run skips it). As in the JAX package,
``publish_interval_seconds`` is inert in ``run_mode = epochs``. Across
the ranks of a ``dist_train`` job the stream runs in lockstep: rank r
reads the ledger's files ``i % W == r`` as fixed-shape batches (the
chief's probed bucket), the chief's discovery is broadcast, one flags
all-gather an iteration decides step, filler, idle, drain, preemption
and the publish (on the chief's clock), the publish sweep merges its
quality sums into the AUC all-gather, the chief's gate decision is
broadcast, and every save carries the watermark merged from the ranks.

``lookup = host`` (lookup.py; BASELINE config #5): the table and the
accumulator live in page-locked host memory (``make_offload_backend``,
restored into in place), each step runs ``make_offload_train_step`` on
host-deduped, padded-wide batches, and the card holds only each batch's
``[U, D]`` rows and their gradient. Every save is written from the
backend's ``state()`` with ``wait=True`` (no snapshot copy), evaluate
and the publish sweep score through ``CompiledScorer(backend=...)``, and
``train`` returns the host table. A multi-process offload run is
refused, as in the JAX package.

``vocab_mode = admit`` (vocab/; README "Unbounded vocabulary"): a
``VocabRuntime`` owns the sketch and the slot map. Every stream (the
epoch iterators, the stream source, ``evaluate`` through ``eval_view``)
builds in the 2^30 hashed space and remaps to physical rows; before a
batch is encoded ``ensure_current`` redoes a remap a barrier made stale,
and once it is stepped ``note_trained`` feeds its ids to the sketch.
Barriers (decay, evict, admit, refreeze, then the freed rows'
cold-start: ``reset_table_rows`` on the device tensors, or the offload
backend's ``reset_rows``) run at each epoch boundary, at each publish
settle (the published step pairs the post-barrier table with its slot
map) and before the final save. Every
save carries the payload as ``vocab-<step>.json.gz``; a resume loads it,
and a restored step without one starts admission fresh over a
cold-started table. A fixed-mode resume of an admit step is refused.

``dist_train worker <i>`` (``train(job_name=, task_index=)``, more
than one ``worker_hosts`` entry; parallel/): rank i of one synchronous
job. The table and the accumulator are row-sharded over the ranks
(``init_sharded_state``, or the restored rows of a step in the one
checkpoint layout); each rank reads its byte range of every file as
fixed-shape, host-deduped batches (one probed ``uniq_bucket``, adapted
between epochs from the job-wide spill counts); every step all-gathers
the ranks' exhaustion and preemption flags, a dry rank steps all-padding
filler, and ``sharded_train_step_body`` exchanges the rows and their
gradients; validation (``evaluate_distributed``) scores each rank's
shard in lockstep and merges the AUC histograms; saves gather the shards
to the chief, which alone writes; the chief logs validation and writes
the ``.npz`` export, gathered chunk by chunk (``_chief_finalize``). The
heartbeat lease and the collective deadline guard turn a dead peer into
``WorkerLostError`` naming it.

Elastic membership (``[Cluster] elastic``; ``train`` is the elastic
loop around ``_train_session``, which owns what must outlive a session: the
lease, the guard, the bad-line tracker). With ``elastic = shrink`` a
``WorkerLostError`` makes the survivors abandon the group, settle
generation g+1 in the lease directory and reform at its bumped port
(parallel/distributed.py), or go on as a lone single process; the
session is re-entered, restores the last verified step onto the new
membership's row shards and re-shards the input over the members in
original index order, so the rest of the schedule runs exactly once.
``elastic = grow`` adds the healing direction: at every epoch boundary
but the last (in a stream: at every publish settle that did not hold)
the chief scans for join tickets and broadcasts its plan; when one
admits a joiner into a free original slot, the barrier state is saved
durably and every member raises ``ClusterGrowth`` together, the loop
reforms the grown cluster, and the joiner (``train(join=True)``,
``train <cfg> --join``) restores the same step. A stream's re-entered
session resumes at the restored step's merged watermark, its files
owned anew under the new membership.

The observability keys are accepted, ignored and logged
(utils/ignored.py: ROADMAP.md A11); admit mode and ``lookup = host``
across processes are refused as in the JAX package.
"""

from __future__ import annotations

import signal
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import (CheckpointState,
                                            read_gate_baseline,
                                            refuse_fixed_mode_admit_step,
                                            write_gate_baseline)
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.data.pipeline import (SPILL_WARN_FRACTION,
                                               SpillStats, batch_iterator,
                                               empty_batch,
                                               gil_bound_iteration,
                                               host_parallel_workers,
                                               prefetch, probe_uniq_bucket,
                                               require_bounded_examples,
                                               uniq_bucket_top)
from fast_tffm_tpu_torch.data.stream import (DONE, IDLE, WATERMARK_FORMAT,
                                             StreamPrefetcher, StreamSource,
                                             StreamTracker,
                                             exchange_watermarks,
                                             probe_stream_uniq_bucket,
                                             stream_workers)
from fast_tffm_tpu_torch.lookup import (make_offload_backend,
                                        make_offload_train_step)
from fast_tffm_tpu_torch.metrics import StreamingAUC
from fast_tffm_tpu_torch.models.convert import save_npz
from fast_tffm_tpu_torch.models.fm import (ModelSpec, batch_args,
                                           init_accumulator, init_table,
                                           packed_train_step_body,
                                           sharded_score_body,
                                           sharded_train_step_body,
                                           train_step_body)
from fast_tffm_tpu_torch.obs.quality import PublishGate, QualityStats
from fast_tffm_tpu_torch.parallel import distributed as dist_mod
from fast_tffm_tpu_torch.parallel import liveness as lv
from fast_tffm_tpu_torch.parallel.liveness import (HeartbeatLease,
                                                   WorkerLostError,
                                                   install_guard, lease_dir,
                                                   restore_guard)
from fast_tffm_tpu_torch.parallel.sharded import (ProcessMesh,
                                                  init_sharded_state,
                                                  lockstep_score_batches,
                                                  make_mesh, place_table)
from fast_tffm_tpu_torch.scoring import CompiledScorer
from fast_tffm_tpu_torch.utils.device import indexed, resolve_device
from fast_tffm_tpu_torch.utils.fetch import ChunkedFetcher
from fast_tffm_tpu_torch.utils.ignored import log_ignored_keys
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.utils.retry import RetryPolicy
from fast_tffm_tpu_torch.utils.timing import StepTimer
from fast_tffm_tpu_torch.vocab.table import VocabRuntime, reset_table_rows
from fast_tffm_tpu_torch.wire import WireEncoder, resolve_wire

# Above this, the dense .npz export is skipped (the JAX package's gate).
EXPORT_NPZ_MAX_BYTES = 2 << 30

# Buffered loss scalars between fetches: a long epoch with a short
# log_steps syncs once per this many log lines instead of never.
LOG_BUFFER_MAX = 1024


def check_train_supported(cfg: FmConfig) -> None:
    """Refuse what the JAX package refuses itself: admit mode and
    ``lookup = host`` across processes."""
    multi = len(cfg.worker_hosts) > 1
    if cfg.vocab_mode == "admit" and multi:
        # The JAX package's own refusal (fast_tffm_tpu/train.py).
        raise ValueError(
            "vocab_mode = admit is single-process: the slot map is host "
            "state, and lockstep workers would need a chief-broadcast "
            "admission protocol to agree on it. Run admit-mode training "
            "on one process.")
    if cfg.lookup == "host" and multi:
        # The JAX package's design position: multi-host scale uses the
        # row-sharded mesh (lookup = device).
        raise ValueError(
            "lookup = host is single-process by design: multi-host scale "
            "uses the row-sharded mesh (lookup = device) — see "
            "BASELINE.md's multi-host beyond-HBM design note")


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


def evaluate(cfg: FmConfig, table: Optional[torch.Tensor], files,
             max_batches: Optional[int] = None, weight_files=(),
             bad_lines: Optional[BadLineTracker] = None,
             collect: Optional[QualityStats] = None, backend=None,
             vocab=None) -> Tuple[float, int]:
    """Streamed AUC over ``files``: (auc, n_examples). A lookup
    ``backend`` (lookup.py) scores a host-resident table; ``table`` is
    then unused. ``vocab`` (``vocab_mode = admit``): the run's slot map,
    through which the sweep remaps (its ``eval_view``). ``weight_files``
    (sidecars parallel to ``files``) weight each example's AUC
    contribution as training weights its loss. ``bad_lines``: the run's
    tracker, so a bad line met every epoch is quarantined once. Batches
    score through a ``CompiledScorer`` (its wire encoder, as predict's);
    scores stay on the device and are fetched in chunks, behind the
    scoring (utils/fetch.py). ``collect`` (obs/quality.QualityStats)
    is fed the same score chunks as the AUC: the publish gate's quality
    numbers."""
    scorer = CompiledScorer(
        cfg, backend.device if backend is not None else table.device,
        backend=backend)
    if vocab is not None:
        vocab = vocab.eval_view()
    auc = StreamingAUC()
    n = 0
    n_batches = 0

    def consume(scores, meta):
        labels, m, weights = meta
        auc.update(scores[:m], labels[:m], weights[:m])
        if collect is not None:
            collect.update(scores[:m], labels[:m], weights[:m])

    fetcher = ChunkedFetcher(consume)
    try:
        with torch.no_grad():
            for batch in prefetch(
                    batch_iterator(cfg, files, training=False, epochs=1,
                                   weight_files=weight_files,
                                   raw_ids=scorer.raw,
                                   bad_lines=bad_lines, vocab=vocab),
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


def evaluate_distributed(cfg: FmConfig, table: torch.Tensor, files,
                         mesh: ProcessMesh, uniq_bucket: int = 0,
                         max_batches: Optional[int] = None,
                         weight_files=(),
                         bad_lines: Optional[BadLineTracker] = None,
                         preempt=None,
                         collect: Optional[QualityStats] = None
                         ) -> Tuple[float, int]:
    """Multi-process AUC: every rank scores its own byte-range shard of
    ``files`` through the sharded score (``sharded_score_body``) in
    lockstep (``lockstep_score_batches``; ``preempt`` rides its window
    flags), then the ranks' binned-AUC histograms are all-gathered and
    merged: no score set crosses ranks. Returns the same ``(auc,
    n_examples)`` on every rank; weight files weight it as in
    ``evaluate``. ``max_batches`` caps real batches per shard.
    ``uniq_bucket``: the caller's probed value (0 probes, the same
    bytes on every rank). ``collect`` (obs/quality.QualityStats) is fed
    each rank's local scores as the AUC is, and its four sums ride the
    same all-gather payload (float64 on gloo): the publish gate's
    quality numbers add no collective, and after the merge the collector
    holds the job-wide totals. Its presence is the config's, so every
    rank ships one payload width."""
    spec = ModelSpec.from_config(cfg, num_processes=mesh.size)
    device = table.device
    auc = StreamingAUC()
    n = 0
    ub = uniq_bucket or cfg.uniq_bucket or probe_uniq_bucket(cfg, files)
    it = batch_iterator(cfg, files, training=False, epochs=1,
                        weight_files=weight_files, shard_index=mesh.rank,
                        num_shards=mesh.size, fixed_shape=True,
                        uniq_bucket=ub, raw_ids=False, bad_lines=bad_lines)

    def score_fn(table, batch):
        args = batch_args(batch, device)
        del args["labels"], args["weights"]
        args["uniq_ids"] = batch.uniq_ids
        return sharded_score_body(spec, mesh, table, **args)

    with torch.no_grad():
        for batch, local in lockstep_score_batches(
                cfg, it, mesh, score_fn, table, ub,
                max_batches=max_batches, preempt=preempt):
            nr = batch.num_real
            auc.update(local[:nr], batch.labels[:nr], batch.weights[:nr])
            if collect is not None:
                collect.update(local[:nr], batch.labels[:nr],
                               batch.weights[:nr])
            n += nr
    bins = auc.num_bins
    extra = (collect.sums() if collect is not None
             else np.zeros(0, np.float64))
    payload = np.concatenate([auc.pos, auc.neg,
                              np.asarray([n], np.float64), extra])
    vals = mesh.all_gather_host(payload,
                                "validation/auc_merge").sum(axis=0)
    merged = StreamingAUC(num_bins=bins)
    merged.pos[:] = vals[:bins]
    merged.neg[:] = vals[bins:2 * bins]
    if collect is not None:
        collect.load_sums(vals[2 * bins + 1:])
    return merged.result(), int(round(vals[2 * bins]))


class _Stepper:
    """What one train session steps: the table and accumulator (updated
    in place) or the offload backend ``lookup`` that holds them, the
    admit mode's ``vocab`` runtime, the step count, the last loss on the
    device, the wire accounting and the buffered loss log lines."""

    def __init__(self, cfg: FmConfig, spec: ModelSpec,
                 encoder: WireEncoder, device: torch.device,
                 table: Optional[torch.Tensor], acc: Optional[torch.Tensor],
                 step: int, logger, lookup=None,
                 vocab: Optional[VocabRuntime] = None,
                 mesh: Optional[ProcessMesh] = None):
        self.cfg, self.spec, self.encoder = cfg, spec, encoder
        self.device, self.logger = device, logger
        self.table, self.acc = table, acc
        # Multi-process: this rank's row shards of a ProcessMesh.
        self.mesh = mesh
        self.local_examples = 0
        self.loop_seconds = 0.0  # in the epoch loops
        self.lookup = lookup
        self.vocab = vocab
        self._offload_step = (None if lookup is None else
                              make_offload_train_step(spec, lookup,
                                                      cfg.learning_rate))
        self.global_step = step
        self.loss: Optional[torch.Tensor] = None
        self.loss_val = float("nan")
        self.timer = StepTimer()
        self.h2d_bytes = self.logical_bytes = 0
        self._log_buffer: list = []  # (step, epoch, loss on device, ex/s)

    def step(self, batch, epoch: int) -> None:
        if self.vocab is not None:
            # A barrier may have moved the slot map while this batch sat
            # in a prefetch queue: redo its remap before it is encoded,
            # so it never scatters into rows the barrier evicted, reset
            # or reassigned (one integer compare when nothing moved).
            batch = self.vocab.ensure_current(batch)
        wb = self.encoder.encode_train(batch)
        args = self.encoder.device_put(wb, self.device)
        if self.mesh is not None:
            # The row exchange all-gathers the ids on the host.
            args["uniq_ids"] = wb.args["uniq_ids"]
            self.table, self.acc, self.loss, _ = sharded_train_step_body(
                self.spec, self.mesh, self.table, self.acc, **args)
        elif self._offload_step is not None:
            self.loss, _ = self._offload_step(**args)
        elif wb.packed:
            self.table, self.acc, self.loss, _ = packed_train_step_body(
                self.spec, wb.L, self.table, self.acc, **args)
        else:
            self.table, self.acc, self.loss, _ = train_step_body(
                self.spec, self.table, self.acc, **args)
        if self.vocab is not None:
            # Adopt-on-step, as the watermark: only stepped batches feed
            # the sketch, so a saved payload describes the trained
            # prefix.
            self.vocab.note_trained(wb)
        self.h2d_bytes += wb.wire_bytes
        self.logical_bytes += wb.logical_bytes
        self.global_step += 1
        self.local_examples += batch.num_real
        # The rate estimate counts the global batch (each rank's local
        # examples times the ranks), as the JAX package logs it.
        self.timer.tick(batch.num_real * (self.mesh.size if self.mesh
                                          else 1))
        log_steps = self.cfg.log_steps
        if log_steps and self.global_step % log_steps == 0:
            self._log_buffer.append((self.global_step, epoch, self.loss,
                                     self.timer.consume_window_rate()))
            if len(self._log_buffer) >= LOG_BUFFER_MAX:
                self.flush_log()

    def save(self, ckpt: CheckpointState, wait: bool = False,
             **kwargs) -> None:
        """Save this step. An offload state is written from the
        backend's ``state()`` (synced with the card) and waits for the
        write: the next step updates it in place."""
        if self.lookup is None:
            table, acc = self.table, self.acc
        else:
            (table, acc), wait = self.lookup.state(), True
            kwargs["from_state"] = True
        ckpt.save(self.global_step, table, acc,
                  vocabulary_size=self.cfg.vocabulary_size, wait=wait,
                  vocab_state=(None if self.vocab is None
                               else self.vocab.state_payload()),
                  **kwargs)

    def vocab_reset(self, rows: np.ndarray) -> None:
        """The eviction hook: cold-start ``rows`` of the device tensors
        in place, on the current stream behind the last step, or through
        the offload backend's ``reset_rows``."""
        if self.lookup is not None:
            self.lookup.reset_rows(rows, self.cfg.adagrad_init)
        else:
            reset_table_rows(self.table, self.acc, rows,
                             self.cfg.adagrad_init)

    def vocab_barrier(self, where: str) -> None:
        """One admission/eviction barrier (admit mode; a no-op
        otherwise, and when nothing was stepped since the last one)."""
        if self.vocab is None:
            return
        st = self.vocab.barrier(self.vocab_reset)
        self.logger.info(
            "vocab barrier (%s): +%d admitted, -%d evicted, %d/%d live "
            "rows", where, st["admitted"], st["evicted"], st["live"],
            self.cfg.vocabulary_size - 1)

    def host_table(self) -> torch.Tensor:
        """The ``[num_rows, D]`` table: the device tensor, or a view of
        the offload state once the card's writes to it are done."""
        if self.lookup is None:
            return self.table
        return self.lookup.state()[0][:self.cfg.num_rows]

    def evaluate(self, files, preempt=None, uniq_bucket: int = 0,
                 **kwargs) -> Tuple[float, int]:
        if self.mesh is not None:
            return evaluate_distributed(self.cfg, self.table, files,
                                        self.mesh, uniq_bucket=uniq_bucket,
                                        preempt=preempt, **kwargs)
        return evaluate(self.cfg, self.table, files, backend=self.lookup,
                        vocab=self.vocab, **kwargs)

    def flush_log(self) -> None:
        """One fetch for every buffered loss line."""
        if not self._log_buffer:
            return
        values = torch.stack([b[2] for b in self._log_buffer]
                             ).cpu().tolist()
        for (s, ep, _, eps), val in zip(self._log_buffer, values):
            self.loss_val = val
            self.logger.info("step %d epoch %d loss %.6f examples/sec %.0f",
                             s, ep, val, eps)
        self._log_buffer.clear()


class _Publisher:
    """The session's publish gate and quality sweep (the JAX package's
    ``_gate_published`` and ``_publish_decision``): session-scoped, since
    the exit publish after the final save is gated too. Across ranks
    (``mesh``) the sweep is ``evaluate_distributed``'s, the chief's gate
    decision is broadcast, so every rank takes the same arm, and only
    the chief logs the sweep and writes the baseline."""

    def __init__(self, cfg: FmConfig, ckpt: CheckpointState,
                 bad_tracker: Optional[BadLineTracker], logger,
                 mesh: Optional[ProcessMesh] = None):
        self.cfg, self.ckpt = cfg, ckpt
        self.bad_tracker, self.logger = bad_tracker, logger
        self.mesh = mesh
        stream_mode = cfg.run_mode == "stream"
        self.gate = PublishGate.from_config(cfg) if stream_mode else None
        # "auto" opts in exactly when the run declared a quality
        # objective (a gate knob, or slo_min_auc): a stream config with
        # validation_files does not silently start paying a sweep per
        # publish.
        qmode = cfg.publish_quality_eval
        self.quality_on = (stream_mode and bool(cfg.validation_files)
                           and cfg.publish_interval_seconds > 0
                           and (qmode == "on"
                                or (qmode == "auto"
                                    and (self.gate is not None
                                         or cfg.slo_min_auc > 0))))
        if self.gate is not None:
            # The drop baseline survives restarts beside the pointer: a
            # resumed run does not exempt its first publish from
            # publish_max_auc_drop.
            self.gate.note_published(read_gate_baseline(ckpt.directory))
            logger.info(
                "publish gate armed: min AUC %s, max AUC drop %s%s "
                "(validation sweep at every publish settle)",
                cfg.publish_min_auc or "off",
                cfg.publish_max_auc_drop or "off",
                "" if self.gate.baseline is None
                else f", restored baseline {self.gate.baseline:.6f}")

    def publish(self, step: int, decision: Optional[dict]) -> None:
        """Repoint ``published`` at the settled ``step`` and advance and
        persist the drop baseline once the publish landed: the one
        baseline write of interval and exit publishes. Only the chief
        verifies, repoints and writes; the other ranks take its verify
        as passed (as the JAX package does)."""
        if self.ckpt.publish_step(step) is None and self.ckpt.chief:
            return
        if self.gate is None or decision is None:
            return
        self.gate.note_published(decision.get("auc"))
        if self.gate.baseline is not None and self.ckpt.chief:
            write_gate_baseline(self.ckpt.directory, self.gate.baseline)

    def decide(self, st: "_Stepper", uniq_bucket: int = 0,
               preempt=None) -> Optional[dict]:
        """Quality sweep and gate decision for the publish of ``st``'s
        step about to happen; None when no quality loop is configured
        (publish unconditionally). Across ranks ``uniq_bucket`` is the
        validation files' bucket and ``preempt`` rides the sweep's
        window flags."""
        if not self.quality_on:
            return None
        cfg = self.cfg
        step = st.global_step
        stats = QualityStats(cfg.loss_type)
        t_q = time.perf_counter()
        auc, n = st.evaluate(cfg.validation_files,
                             max_batches=cfg.validation_max_batches or None,
                             weight_files=cfg.validation_weight_files,
                             bad_lines=self.bad_tracker, collect=stats,
                             uniq_bucket=uniq_bucket, preempt=preempt)
        dt_q = time.perf_counter() - t_q
        if self.ckpt.chief:
            self.logger.info(
                "publish quality eval at step %d: AUC %.6f, loss %s, "
                "calibration %s over %d examples (%.2fs)", step, auc,
                "-" if stats.loss is None else f"{stats.loss:.6f}",
                "-" if stats.calibration is None
                else f"{stats.calibration:.4f}", n, dt_q)
        if self.gate is None:
            return {"held": False, "auc": float(auc), "examples": int(n)}
        decision = self.gate.decide(float(auc), step)
        if self.mesh is not None:
            # The chief decides; every rank applies its decision.
            decision = self.mesh.broadcast_object(decision,
                                                  "quality/gate_decision")
        # n is job-wide already (the sweep's merge).
        decision["examples"] = int(n)
        if decision["held"]:
            self.logger.warning(
                "publish GATE HELD at step %d: %s — the published "
                "pointer stays on the last passing step", step,
                "; ".join(decision["reasons"]))
        return decision


class ClusterGrowth(Exception):
    """The way out of ``_train_session`` at a safe barrier: the chief
    planned the admission of joiners (``plan``, ``liveness.plan_grow``'s
    payload) and the barrier state is saved durably, so ``train`` can
    end the session and reform the grown cluster. Not an error."""

    def __init__(self, plan: dict):
        super().__init__(f"cluster growth planned: generation "
                         f"{plan.get('generation')}")
        self.plan = plan


class _GrowContext:
    """The elastic loop's grow state handed into the session (``elastic =
    grow``): the current membership and generation, which only the
    loop's reforms move, and the barrier's admission check.
    ``capacity`` is the original cluster size: joiners take the
    original indices of departed workers."""

    def __init__(self, cfg: FmConfig, lease: HeartbeatLease, members,
                 generation: int):
        self.lease = lease
        self.members = tuple(int(m) for m in members)
        self.generation = int(generation)
        self.capacity = max(len(cfg.worker_hosts), 1)

    def adopt(self, members, generation: int) -> None:
        self.members = tuple(int(m) for m in members)
        self.generation = int(generation)

    def check_barrier(self, mesh: Optional[ProcessMesh]) -> Optional[dict]:
        """The admission check of every safe barrier: fresh join tickets
        against free original slots give the next generation's plan, or
        None. Every member scans and the chief's answer is broadcast, so
        a ticket appearing mid-scan cannot split the cluster: all raise
        ``ClusterGrowth`` together or none does."""
        if len(self.members) >= self.capacity:
            return None
        tickets = lv.pending_join_tickets(self.lease.directory,
                                          self.lease.stale_after)
        plan = lv.plan_grow(self.generation + 1, self.members,
                            self.capacity, tickets)
        if mesh is not None:
            plan = mesh.broadcast_object(plan, "cluster/grow_decision")
        return plan


def train(cfg: FmConfig, device=None,
          init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          job_name: Optional[str] = None,
          task_index: Optional[int] = None,
          join: bool = False) -> torch.Tensor:
    """Train per ``cfg``; returns the final table ``[num_rows, D]``
    (with ``lookup = host``, on the host: a view of the backend's
    page-locked state; in a multi-process run, this rank's row shard).
    ``device`` defaults to the card (utils/device.py). A checkpoint
    under ``<model_file>.ckpt/`` is resumed; without one the run starts
    from ``init_state``, a ``(table, acc)`` pair (models/convert.py
    ``state_from_numpy``; device lookup only), or else from a table
    drawn from ``cfg.seed`` and an accumulator filled with
    ``adagrad_init``. Both are updated in place.

    ``job_name`` / ``task_index``: the ``dist_train worker <i>`` argv.
    With more than one ``worker_hosts`` entry this process joins the
    cluster as rank i (parallel/distributed.py), the table and the
    accumulator are row-sharded over the ranks (parallel/sharded.py),
    each rank reads its byte range of the input, and the ranks step in
    lockstep. The heartbeat lease (``heartbeat_seconds`` > 0) and the
    collective deadline guard run for the whole run: a peer that dies
    makes the survivors raise ``WorkerLostError`` naming it, or exit
    ``EXIT_WORKER_LOST`` if a collective blocks past
    ``collective_timeout_seconds``. With ``elastic = shrink | grow`` the
    survivors reform instead and re-enter the session (the module
    docstring), a collective blocked past that deadline on a peer the
    lease names dead included (liveness.guarded_work); ``elastic = grow`` also admits joiners at epoch
    boundaries, or a stream's publish settles. ``join``: this process
    is such a joiner (``train <cfg> --join``): it rendezvouses into the
    running cluster first, its worker slot assigned there, then runs as
    any member."""
    device = resolve_device(device)
    check_train_supported(cfg)
    logger = get_logger(log_file=cfg.log_file or None)
    shard_index, num_shards, generation, members = 0, 1, 0, None
    lease = None
    if join:
        if cfg.elastic != "grow":
            raise ValueError(
                "train --join requires elastic = grow in [Cluster]: the "
                "running cluster only scans for join tickets when grow is "
                "on")
        if job_name is not None:
            raise ValueError(
                "train --join replaces the dist_train role argv: the worker "
                "slot is assigned by the running cluster, not the launcher")
        lease, shard_index, num_shards, members, generation, _ = \
            dist_mod.join_rendezvous(cfg, logger)
    elif job_name is not None:
        shard_index, num_shards = dist_mod.init_from_cluster(
            cfg, job_name, task_index or 0)
        members = list(range(num_shards))
    # One run-scoped tracker (None under bad_line_policy = error): its
    # breaker and quarantine dedupe span every epoch and every reform.
    bad_tracker = BadLineTracker.from_config(cfg)
    guard_prev = None
    guarded = False
    lost = False
    try:
        if lease is None and num_shards > 1 and cfg.heartbeat_seconds > 0:
            lease = HeartbeatLease(
                lease_dir(cfg), process_index=shard_index,
                members=range(num_shards),
                heartbeat_seconds=cfg.heartbeat_seconds).start()
        if num_shards > 1:
            guard_prev = install_guard(lease,
                                       cfg.collective_timeout_seconds,
                                       recover=cfg.elastic != "off")
            guarded = True
        grow_ctx = (_GrowContext(cfg, lease, members, generation)
                    if cfg.elastic == "grow" and lease is not None else None)
        while True:
            try:
                return _train_session(cfg, device, init_state, logger,
                                      shard_index, num_shards, members,
                                      bad_tracker, grow_ctx)
            except ClusterGrowth as g:
                # Every member raises it off the chief's broadcast plan at
                # the same barrier.
                generation = int(g.plan["generation"])
                logger.info(
                    "elastic grow: admitting joiner(s) %s into cluster "
                    "generation %d (barrier state saved)",
                    sorted(int(s) for s in g.plan["joiners"].values()),
                    generation)
                # No guarded collective completes during a reform: the
                # deadline guard would read it as a hang.
                if guarded:
                    restore_guard(guard_prev)
                    guarded = False
                if shard_index == 0:
                    # The plan file is what the joiner polls for.
                    lv.write_grow_plan(lease.directory, g.plan)
                shard_index, num_shards, members, generation = \
                    dist_mod.reform_grown_cluster(cfg, lease, generation,
                                                  g.plan, logger)
                grow_ctx.adopt(members, generation)
                incumbents = {int(i) for i in g.plan["incumbents"]}
                logger.info(
                    "elastic recovery complete: %d member(s) (admitted %s), "
                    "input shards re-balanced, resuming from the last "
                    "verified checkpoint", num_shards,
                    sorted(set(members) - incumbents) or "nobody")
            except WorkerLostError as e:
                if (cfg.elastic == "off" or num_shards <= 1
                        or lease is None):
                    # Fail fast with the diagnosis; the group is not torn
                    # down, its peers are gone.
                    lost = True
                    logger.error("WorkerLostError: %s", e)
                    raise
                generation += 1
                logger.warning("worker lost (%s); elastic shrink recovery, "
                               "cluster generation %d", e, generation)
                if guarded:
                    restore_guard(guard_prev)
                    guarded = False
                shard_index, num_shards, members = \
                    dist_mod.reform_shrunken_cluster(cfg, lease, generation,
                                                     logger)
                if grow_ctx is not None:
                    grow_ctx.adopt(members, generation)
                logger.info(
                    "elastic recovery complete: %d survivor(s), input shards "
                    "redistributed, resuming from the last verified "
                    "checkpoint", num_shards)
                if num_shards <= 1 and grow_ctx is None:
                    # A lone survivor has no peer left to watch; stop the
                    # lease so the next run here starts from a clean
                    # table (elastic = grow keeps it: joiners and the
                    # barrier's ticket scan read beside it).
                    lease.stop()
                    lease = None
            # The state a reformed session starts from is the verified
            # checkpoint's (or, before any save, a fresh draw).
            init_state = None
            if num_shards > 1:
                guard_prev = install_guard(lease,
                                           cfg.collective_timeout_seconds,
                                           recover=cfg.elastic != "off")
                guarded = True
    finally:
        if lease is not None:
            lease.stop()
        if guarded:
            restore_guard(guard_prev)
        if not lost:
            dist_mod.shutdown()
        if bad_tracker is not None:
            bad_tracker.close()


def _train_session(cfg: FmConfig, device: torch.device,
                   init_state: Optional[Tuple[torch.Tensor, torch.Tensor]],
                   logger, shard_index: int, num_shards: int,
                   members, bad_tracker: Optional[BadLineTracker],
                   grow_ctx: Optional[_GrowContext]) -> torch.Tensor:
    """One training session against the current membership: restore,
    the epoch (or stream) loop, the final save and the export.
    ``num_shards`` > 1: the multi-process arm, as rank ``shard_index``
    of ``members`` (original worker indices in rank order; None outside
    a cluster, a lone survivor's is its own index). Raises
    ``WorkerLostError`` out of a collective whose peer died and
    ``ClusterGrowth`` out of an epoch boundary or a stream's publish
    settle where ``grow_ctx`` plans an admission; everything made here
    is torn down here, so ``train`` can re-enter."""
    multi = num_shards > 1
    spec = ModelSpec.from_config(cfg, num_processes=num_shards)
    offload = cfg.lookup == "host"
    if offload and init_state is not None:
        raise ValueError(
            "lookup = host draws its state on the host "
            "(lookup.init_host_state) or restores it; init_state is a "
            "lookup = device start")
    stream_mode = cfg.run_mode == "stream"
    # slo_min_auc takes effect in a publishing stream run with
    # validation files (it switches the quality sweep on there).
    log_ignored_keys(cfg, logger, in_effect=(
        ("slo_min_auc",) if stream_mode and cfg.validation_files
        and cfg.publish_interval_seconds > 0 else ()))
    mesh = None
    uniq_bucket = val_bucket = 0
    if multi:
        if spec.dedup == "device":
            # Unreachable through dedup = auto (host on more than one
            # process); an explicit config gets the JAX package's error.
            raise ValueError(
                "dedup = device is single-device only: multi-process "
                "paths rely on the host-side unique contract (fixed-U "
                "buckets, the row exchange's global unique axis)")
        require_bounded_examples(cfg, "multi-process training")
        device = indexed(device)
        mesh = make_mesh(cfg, shard_index, num_shards)
        logger.info(
            "multi-process training: rank %d of %d on %s, table rows "
            "[%d, %d) of %d (gloo)", mesh.rank, mesh.size, device,
            mesh.lo, mesh.hi, mesh.rows)
        if not stream_mode:
            # Fixed-shape batches need one U for the whole job; the
            # probe reads the same bytes on every rank, so all agree
            # without a collective. (A stream probes the sealed shards
            # present at startup, chief-decided: _run_stream.)
            uniq_bucket = cfg.uniq_bucket or probe_uniq_bucket(
                cfg, cfg.train_files)
            logger.info("fixed unique-row bucket: %d", uniq_bucket)
        if cfg.validation_files:
            val_bucket = cfg.uniq_bucket or probe_uniq_bucket(
                cfg, cfg.validation_files)
    if members is not None:
        dist_mod.share_host_threads(cfg, device, members,
                                    members[shard_index])
    host_workers = host_parallel_workers(cfg, cfg.weight_files,
                                         fixed_shape=multi)
    if host_workers > 1 and not stream_mode:
        logger.info(
            "host data plane: %d parallel batch-build workers "
            "(host_threads = %s; bounded ordered ring)",
            host_workers, cfg.host_threads)
    vocab = None
    if cfg.vocab_mode == "admit":
        vocab = VocabRuntime.from_config(cfg)
        logger.info(
            "vocab admission: %d physical rows (row 0 = shared cold row) "
            "over a 2^30 hashed id space; admit/evict threshold %.1f, "
            "decay %.2f/barrier, sketch %.1f MB", cfg.vocabulary_size,
            cfg.vocab_admit_threshold, cfg.vocab_decay, cfg.vocab_sketch_mb)
    ckpt = CheckpointState(cfg.model_file,
                           retry=RetryPolicy.from_config(cfg),
                           verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init, mesh=mesh)
    prev_handlers = {}
    try:
        restored = ckpt.restore(template=checkpoint_template(cfg))
        global_step = 0
        restored_epoch = 0
        if restored is not None:
            check_restored_vocab(cfg, restored)
            global_step = int(restored["step"])
            restored_epoch = int(restored["epoch"])
            logger.info("restored checkpoint at step %d", global_step)
        fresh_over_restore = _restore_vocab(cfg, vocab, restored,
                                            ckpt.directory, logger)
        lk = table = acc = None
        if offload:
            # The backend adopts the restored tensors and page-locks them
            # in place; the restored dict lets go of them.
            lk = make_offload_backend(cfg, cfg.seed, restored=restored,
                                      device=device)
            if restored is not None:
                restored["table"] = restored["acc"] = None
            logger.info("offload lookup [pinned-host (%s)]: table [%d, %d] "
                        "outside HBM (%.2f GB + accumulator)", lk.mode,
                        lk.rows, lk.dim, lk.rows * lk.dim * 4 / 2**30)
        elif mesh is not None:
            table, acc = _initial_shards(cfg, mesh, device, restored,
                                         init_state, ckpt.directory)
        else:
            table, acc = _initial_state(cfg, device, restored, init_state,
                                        ckpt.directory)
        # The offload step gathers by the host's uniq ids, and the
        # lockstep exchanges the padded rows: padded-wide.
        wire = resolve_wire(cfg, backend=lk, multi_process=multi,
                            train=True)
        encoder = WireEncoder(wire, pad_id=cfg.pad_id)
        logger.info("wire format: %s%s", wire.describe(),
                    " (flat CSR, unpacked on the device)" if wire.packed
                    else "")
        restored_step = global_step
        start_epoch = resume_start_epoch(restored_epoch, cfg.epoch_num)
        if start_epoch:
            logger.info("resuming interrupted epoch schedule at epoch "
                        "%d/%d", start_epoch, cfg.epoch_num)
        publisher = _Publisher(cfg, ckpt, bad_tracker, logger, mesh=mesh)

        # Preemption: SIGTERM/SIGINT set a flag the loop drains at the
        # next step boundary (multi-process: the flag rides the step
        # flags all-gather, so every rank stops at the same step), and
        # the final save below is the preemption save.
        preempted: list = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(
                    sig, lambda s, f: preempted.append(s))
            except ValueError:  # not the main thread
                pass

        st = _Stepper(cfg, spec, encoder, device, table, acc, global_step,
                      logger, lookup=lk, vocab=vocab, mesh=mesh)
        if fresh_over_restore:
            # Every row, the cold row 0 included, still holds the lost
            # mapping's trained weights: cold-start them all, so no id
            # trains through another id's vector.
            st.vocab_reset(np.arange(0, cfg.vocabulary_size,
                                     dtype=np.int32))
            logger.info("cold-started %d table rows for the fresh "
                        "admission state", cfg.vocabulary_size)
        completed_epochs = start_epoch
        last_periodic_save = (None, None)  # (step, epoch) of the latest
        last_val = None  # (auc, n) of the last validation of this table
        stopping = False
        stream_watermark = None
        if stream_mode:
            stopping, stream_watermark, last_periodic_save = _run_stream(
                cfg, st, ckpt, publisher, restored, bad_tracker,
                preempted, logger, grow_ctx=grow_ctx, val_bucket=val_bucket)
        epoch_schedule = (range(0) if stream_mode
                          else range(start_epoch, cfg.epoch_num))
        for epoch in epoch_schedule:
            epoch_stats = SpillStats()
            it = prefetch(batch_iterator(cfg, cfg.train_files,
                                         training=True,
                                         weight_files=cfg.weight_files,
                                         shard_index=shard_index,
                                         num_shards=num_shards,
                                         epochs=1, seed=cfg.seed + epoch,
                                         fixed_shape=multi,
                                         uniq_bucket=uniq_bucket,
                                         stats=epoch_stats,
                                         raw_ids=spec.dedup == "device",
                                         bad_lines=bad_tracker,
                                         vocab=vocab),
                          depth=cfg.prefetch_depth,
                          gil_bound=gil_bound_iteration(cfg,
                                                        cfg.weight_files))
            t_loop = time.perf_counter()
            try:
                while True:
                    batch = next(it, None)
                    if mesh is not None:
                        # Lockstep: byte-range shards give ranks batch
                        # counts that differ, and every step is a
                        # collective, so the ranks agree each step on
                        # exhaustion and preemption and a dry rank
                        # steps all-padding filler (zero weight: zero
                        # loss and gradient) until every rank is dry.
                        flags = mesh.all_gather_host(
                            np.asarray([batch is None, bool(preempted)],
                                       np.int32), "train/step_flags")
                        if flags[:, 1].any():
                            preempted.append(signal.SIGTERM)
                        elif flags[:, 0].all():
                            break
                        elif batch is None:
                            batch = empty_batch(cfg,
                                                uniq_bucket=uniq_bucket)
                    elif batch is None:
                        break
                    if preempted:
                        stopping = True
                        logger.info(
                            "preemption signalled; saving and exiting")
                        break
                    st.step(batch, epoch)
                    last_val = None  # the table moved
                    if cfg.save_steps and \
                            st.global_step % cfg.save_steps == 0:
                        # Asynchronous: the snapshot is complete when
                        # save returns, so the next step may update the
                        # table in place; the write runs behind it (an
                        # offload save writes the state itself and waits).
                        st.save(ckpt, epoch=completed_epochs)
                        last_periodic_save = (st.global_step,
                                              completed_epochs)
            finally:
                it.close()
                st.loop_seconds += time.perf_counter() - t_loop
            st.flush_log()  # the epoch barrier: one fetch for its lines
            if bad_tracker is not None and bad_tracker.bad:
                logger.info("bad-line policy through epoch %d: %s",
                            epoch, bad_tracker.describe())
            if epoch_stats.spilled_batches or (multi and
                                               epoch_stats.batches):
                logger.info("epoch %d input: %s", epoch,
                            epoch_stats.describe())
                if epoch_stats.spill_fraction > SPILL_WARN_FRACTION:
                    logger.warning(
                        "uniq_bucket %d is undersized for this data: "
                        "%.0f%% of batches closed early on the unique-row "
                        "budget; raise uniq_bucket (or set 0 to re-probe) "
                        "to recover effective batch size", uniq_bucket,
                        100 * epoch_stats.spill_fraction)
            if stopping:  # a preemption-cut epoch is NOT completed
                break
            if mesh is not None and epoch + 1 < cfg.epoch_num:
                # The job-wide spill counts decide the next epoch's
                # bucket on every rank alike (a local decision would
                # give the ranks different shapes).
                tot = mesh.all_gather_host(
                    np.asarray([epoch_stats.spilled_batches,
                                epoch_stats.batches, epoch_stats.max_uniq],
                               np.int64), "train/spill_stats")
                uniq_bucket = adapt_uniq_bucket(
                    cfg, uniq_bucket, int(tot[:, 0].sum()),
                    int(tot[:, 1].sum()), logger,
                    max_uniq=int(tot[:, 2].max()))
            # The epoch boundary is a barrier point: the next epoch and
            # the validation sweep below run on the refreshed slot map.
            st.vocab_barrier(f"epoch {epoch}")
            completed_epochs = epoch + 1
            if cfg.validation_files:
                auc, n = st.evaluate(cfg.validation_files,
                                     max_batches=cfg.validation_max_batches
                                     or None,
                                     weight_files=cfg.validation_weight_files,
                                     bad_lines=bad_tracker,
                                     uniq_bucket=val_bucket,
                                     **({"preempt": lambda: bool(preempted)}
                                        if mesh is not None else {}))
                last_val = (auc, n)
                if ckpt.chief:
                    logger.info("epoch %d validation AUC %.6f over %d "
                                "examples", epoch, auc, n)
            if (grow_ctx is not None
                    and completed_epochs < cfg.epoch_num):
                # The epoch boundary is the grow barrier: every member
                # is here, and all raise together off the chief's plan.
                # The barrier state is saved durably first (the joiner
                # restores exactly it). The last epoch never grows.
                plan = grow_ctx.check_barrier(mesh)
                if plan is not None:
                    st.save(ckpt, force=True, wait=True,
                            epoch=completed_epochs,
                            rewrite_stale_metadata=_stale_epoch(
                                last_periodic_save, restored, restored_step,
                                restored_epoch, st.global_step,
                                completed_epochs))
                    raise ClusterGrowth(plan)
        global_step = st.global_step
        if st.loss is not None:
            st.loss_val = float(st.loss)
        # The final save is a barrier point: nothing is in flight, so the
        # durable (table, slot map) pair admits the last interval's ids
        # and cold-starts its evicted rows before the bytes land.
        st.vocab_barrier(f"final save step {global_step}")
        # Final/preemption save: returns once the step is durable. If
        # this step's checkpoint exists with a stale epoch count — from
        # this run's last periodic save, or the restored checkpoint
        # when the schedule advanced without a step — the save records
        # the completed count in the epoch_override sidecar.
        st.save(ckpt, force=True, wait=True, epoch=completed_epochs,
                rewrite_stale_metadata=_stale_epoch(
                    last_periodic_save, restored, restored_step,
                    restored_epoch, global_step, completed_epochs),
                stream_state=(_stream_state(stream_watermark, mesh)
                              if stream_mode else None))
        if stream_mode and cfg.publish_interval_seconds > 0:
            decision = _exit_publish(publisher, st, stopping, logger,
                                     val_bucket, preempted)
            if decision is not None:
                # The exit sweep is this table's final validation:
                # _chief_finalize does not run it again.
                last_val = (decision["auc"], decision["examples"])
        if stream_mode and mesh is None and cfg.validation_files and \
                not publisher.quality_on:
            # Stream mode has no per-epoch sweeps: a validation corpus
            # gets one scored pass here (a publishing stream validated
            # through the exit publish's sweep; across ranks,
            # _chief_finalize validates).
            auc, n = st.evaluate(cfg.validation_files,
                                 max_batches=cfg.validation_max_batches
                                 or None,
                                 weight_files=cfg.validation_weight_files,
                                 bad_lines=bad_tracker)
            logger.info("final validation AUC %.6f over %d examples",
                        auc, n)
        if mesh is not None:
            t_exp = _chief_finalize(cfg, st, mesh, logger, last_val,
                                    val_bucket, bad_tracker)
            table = st.table
        else:
            table = st.host_table()
            t0 = time.perf_counter()
            if _export_allowed(cfg, logger):
                save_npz(table, cfg.model_file + ".npz", cfg)
            t_exp = time.perf_counter() - t0
        logger.info("wire %s: h2d_bytes = %d over %d steps, against %d "
                    "in the padded layout", wire.describe(), st.h2d_bytes,
                    global_step - restored_step, st.logical_bytes)
        if mesh is not None:
            steps = global_step - restored_step
            loop = st.loop_seconds
            logger.info(
                "worker %d of %d: %d steps, %d local examples, loop %.0f "
                "local examples/sec, %.3f ms a step, export %.2fs",
                mesh.rank, mesh.size, steps, st.local_examples,
                st.local_examples / loop if loop > 0 else 0.0,
                1e3 * loop / steps if steps else 0.0, t_exp)
        logger.info("training done: %d steps, final loss %.6f, %.0f "
                    "examples/sec", global_step, st.loss_val,
                    st.timer.total_examples_per_sec)
        return table
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        # Every exit path settles the in-flight save: an exception
        # between saves must not leave a write half done.
        ckpt.close()


def _stale_epoch(last_periodic_save, restored, restored_step: int,
                 restored_epoch: int, step: int, completed_epochs: int
                 ) -> bool:
    """Whether a save at ``step`` lands on a step written with another
    epoch count: this session's last periodic save, or the restored
    checkpoint when the schedule advanced without a step. The save then
    records the completed count in the epoch_override sidecar."""
    return ((last_periodic_save[0] == step
             and last_periodic_save[1] != completed_epochs)
            or (restored is not None and step == restored_step
                and completed_epochs != restored_epoch))


def _export_allowed(cfg: FmConfig, logger) -> bool:
    """The dense ``.npz`` export's size gate (the JAX package's): over
    ``EXPORT_NPZ_MAX_BYTES`` the checkpoint is the model, which
    ``logger`` (None: no line) says."""
    nbytes = cfg.num_rows * cfg.row_dim * 4
    if nbytes > EXPORT_NPZ_MAX_BYTES:
        if logger is not None:
            logger.info(
                "skipping dense .npz export: table is %.1f GB > %.1f GB "
                "threshold; use the checkpoint at %s.ckpt",
                nbytes / 2**30, EXPORT_NPZ_MAX_BYTES / 2**30,
                cfg.model_file)
        return False
    return True


def _chief_finalize(cfg: FmConfig, st: _Stepper, mesh: ProcessMesh,
                    logger, last_val, val_bucket: int,
                    bad_tracker: Optional[BadLineTracker]) -> float:
    """The multi-process epilogue: the final validation AUC through the
    sharded score (when the last epoch did not validate this table
    already; only histograms cross ranks), then the size-gated dense
    export, assembled chunk by chunk on the chief (the others hold one
    chunk at a time), and a closing barrier. Returns the export's
    seconds."""
    if cfg.validation_files:
        if last_val is None:  # e.g. a preemption cut the epoch short
            last_val = evaluate_distributed(
                cfg, st.table, cfg.validation_files, mesh,
                uniq_bucket=val_bucket,
                max_batches=cfg.validation_max_batches or None,
                weight_files=cfg.validation_weight_files,
                bad_lines=bad_tracker)
        if mesh.rank == 0:
            logger.info("final validation AUC %.6f over %d examples",
                        *last_val)
    t0 = time.perf_counter()
    chief = mesh.rank == 0
    if _export_allowed(cfg, logger if chief else None):
        out = (np.empty((cfg.num_rows, cfg.row_dim), np.float32)
               if chief else None)
        n = mesh.rows_per_rank
        chunk = max(1, (64 << 20) // (cfg.row_dim * 4))
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            piece = st.table[a:b].detach().to("cpu").contiguous()
            parts = mesh.gather_to_chief(piece, "finalize/export_chunk")
            if chief:
                for r, part in enumerate(parts):
                    lo = r * n + a
                    hi = min(lo + (b - a), cfg.num_rows)
                    if hi > lo:
                        out[lo:hi] = part[:hi - lo].numpy()
        if chief:
            save_npz(torch.from_numpy(out), cfg.model_file + ".npz", cfg)
    mesh.barrier("finalize/sync")
    return time.perf_counter() - t0


# Shrink threshold: halve the bucket only when the epoch's densest batch
# used under this fraction of it, so the halved bucket still holds that
# batch with headroom and the shrink cannot itself cause spills.
SHRINK_FILL_FRACTION = 0.35


def adapt_uniq_bucket(cfg: FmConfig, uniq_bucket: int, spilled: int,
                      batches: int, logger, max_uniq: int = 0) -> int:
    """The next epoch's fixed unique-row bucket from this epoch's
    job-wide counts: doubled (up to the ladder top) while the spill
    fraction stays above SPILL_WARN_FRACTION; halved (never below 64 or
    the per-example cap) after a spill-free epoch whose densest batch
    filled under SHRINK_FILL_FRACTION of it. Deterministic in its
    inputs, which every rank gets alike (train all-gathers them). An
    explicit ``uniq_bucket`` config is never overridden."""
    if cfg.uniq_bucket or not batches:
        return uniq_bucket
    if spilled / batches > SPILL_WARN_FRACTION:
        top = uniq_bucket_top(cfg)
        if uniq_bucket >= top:
            return uniq_bucket
        new_bucket = min(uniq_bucket * 2, top)
        logger.info(
            "raising uniq_bucket %d -> %d for the next epoch (%.0f%% of "
            "batches spilled on the unique-row budget this epoch)",
            uniq_bucket, new_bucket, 100 * spilled / batches)
        return new_bucket
    half = uniq_bucket // 2
    if (spilled == 0 and max_uniq
            and max_uniq <= uniq_bucket * SHRINK_FILL_FRACTION
            and half >= 64 and half > cfg.max_features_per_example):
        logger.info(
            "lowering uniq_bucket %d -> %d for the next epoch (densest "
            "batch used %d unique rows, %.0f%% fill — recovering "
            "gather/scatter width from an oversized probe or an earlier "
            "raise)", uniq_bucket, half, max_uniq,
            100 * max_uniq / uniq_bucket)
        return half
    return uniq_bucket


def _stream_state(watermark: Optional[dict],
                  mesh: Optional[ProcessMesh]) -> dict:
    """The watermark payload a stream save carries: the one adopted from
    the last stepped batch (an empty ledger before any), merged across
    the ranks of ``mesh`` (a collective: call it at step-deterministic
    points only)."""
    return exchange_watermarks(
        watermark or {"format": WATERMARK_FORMAT, "files": []}, mesh)


def _run_stream(cfg: FmConfig, st: _Stepper, ckpt: CheckpointState,
                publisher: _Publisher, restored: Optional[dict],
                bad_tracker: Optional[BadLineTracker], preempted: list,
                logger, grow_ctx: Optional[_GrowContext] = None,
                val_bucket: int = 0) -> Tuple[bool, Optional[dict], tuple]:
    """The online loop of ``run_mode = stream``: poll the stream
    source, step every arriving batch, save with the watermark adopted
    from the last stepped batch, and publish a verified checkpoint
    every ``publish_interval_seconds``. Returns (preempted, the adopted
    watermark, (step, epoch) of the last save).

    One process: a prefetch thread builds batches behind the steps.
    Across ranks (``st.mesh``) the ranks own the ledger's files by index
    and run in lockstep: the source is pumped inline on this thread (its
    discovery broadcast and the flags all-gather must keep one order on
    every rank, which two threads would not), and every iteration
    all-gathers ``[has a batch, preempted, done, publish due]``: a
    preemption anywhere saves and exits everywhere, a job with every
    rank done and dry drains, a batch anywhere is stepped everywhere (a
    dry rank steps all-padding filler), and the publish runs on the
    chief's clock. Every save carries the merged watermark.

    ``grow_ctx`` (``elastic = grow``): the publish settle is the grow
    barrier; after a publish that did not hold, a planned admission
    raises ``ClusterGrowth`` on every rank (the lone survivor of a
    shrink checks it too, on one process)."""
    mesh = st.mesh
    restored_wm = (restored or {}).get("stream")
    # Seeded from the restored sidecar: a resumed session may save at
    # its restored step before any new batch steps (a publish fires on
    # an idle tick), and an empty watermark there would rewrite the
    # step's sidecar to empty and retrain the consumed prefix.
    state = {"watermark": restored_wm, "last_save": (None, None),
             "stopping": False}
    if restored is not None and restored_wm is None:
        logger.warning(
            "restored checkpoint at step %d carries no stream "
            "watermark (an epoch-mode warm start, or a lost "
            "watermark sidecar): streaming starts from the "
            "BEGINNING of %s — any stream bytes this model "
            "already trained on will be trained again",
            st.global_step, cfg.stream_dir)
    # Ownership is agreed under this session's membership: a reformed
    # session's ranks own the ledger anew from the restored watermark.
    tracker = StreamTracker(
        cfg.stream_dir, cfg.stream_poll_seconds, cfg.seal_policy,
        retry=RetryPolicy.from_config(cfg), bad_lines=bad_tracker,
        watermark=restored_wm,
        shard_index=mesh.rank if mesh is not None else 0,
        num_shards=mesh.size if mesh is not None else 1, mesh=mesh)
    u_bucket = 0
    if mesh is not None:
        u_bucket = cfg.uniq_bucket or probe_stream_uniq_bucket(cfg, tracker)
        logger.info("fixed unique-row bucket: %d", u_bucket)
    workers = stream_workers(cfg, fixed_shape=mesh is not None)
    if workers > 1:
        logger.info(
            "stream host data plane: %d parallel batch-build "
            "workers (host_threads = %s; sealed line groups "
            "through the bounded ordered ring)",
            workers, cfg.host_threads)
    source = StreamSource(cfg, tracker,
                          stop=None if mesh is not None
                          else (lambda: bool(preempted)),
                          raw_ids=st.spec.dedup == "device",
                          workers=workers, bad_lines=bad_tracker,
                          vocab=st.vocab, fixed_shape=mesh is not None,
                          uniq_bucket=u_bucket)
    gate = publisher.gate
    publish_every = float(cfg.publish_interval_seconds)
    last_publish = [time.monotonic()]
    # While the last gate decision HELD, the retention-pressure trigger
    # is disarmed (a republish would hold the same state again); the
    # interval keeps re-checking at the publish cadence.
    gate_holding = [False]
    risk_pause_logged = [False]  # one retention-pause log per hold
    sweep_preempt = (lambda: bool(preempted)) if mesh is not None else None

    def publish_due() -> bool:
        """Interval elapsed, or retention pressure: periodic saves must
        never delete the published step from under a scorer (across
        ranks only the chief's answer counts: it rides the flags)."""
        if publish_every <= 0:
            return False
        if time.monotonic() - last_publish[0] >= publish_every:
            return True
        # Gated runs check one retention slot early (margin=2): the tick
        # this arm triggers may turn out HELD, and the mandatory final
        # save must still land without evicting the last-good step.
        return (bool(cfg.save_steps) and not gate_holding[0]
                and ckpt.published_at_risk(
                    margin=2 if gate is not None else 1))

    def stream_save(wait: bool) -> None:
        # The watermark passed here is the one adopted at this step: the
        # snapshot is taken now, and later steps update the table in
        # place (an offload save always waits).
        st.save(ckpt, wait=wait, epoch=0,
                stream_state=_stream_state(state["watermark"], mesh))
        state["last_save"] = (st.global_step, 0)

    def do_publish() -> None:
        """Sweep and gate, then save, verify and repoint ``published``.
        A HELD decision skips the save too: held ticks must not mint
        steps that retention could use to lap the published one."""
        st.flush_log()
        # The publish settle is a barrier point, before the sweep: the
        # published (table, slot map, step) triple is post-barrier, and
        # the sweep measures exactly what a pass would publish.
        st.vocab_barrier(f"publish step {st.global_step}")
        decision = publisher.decide(st, uniq_bucket=val_bucket,
                                    preempt=sweep_preempt)
        gate_holding[0] = bool(decision and decision.get("held"))
        if not gate_holding[0]:
            risk_pause_logged[0] = False
        if decision is None or not decision.get("held"):
            # A publish on the step of the last periodic save rewrites
            # that step's sidecars (the barrier may have moved the slot
            # map), as a forced save does in the JAX package.
            stream_save(wait=True)
            publisher.publish(st.global_step, decision)
        last_publish[0] = time.monotonic()
        if grow_ctx is not None and not gate_holding[0]:
            # The publish settle is the grow barrier: the save above is
            # durable with the merged watermark, so a joiner's restore
            # resumes the stream exactly once from here. A held publish
            # saved nothing and admits nobody (the hold is the chief's
            # broadcast decision, so every rank takes this arm alike).
            plan = grow_ctx.check_barrier(mesh)
            if plan is not None:
                raise ClusterGrowth(plan)

    def step_once(batch) -> None:
        st.step(batch, 0)
        # The durable position advances ONLY with stepped batches
        # (lockstep fillers carry None).
        if batch.stream_pos is not None:
            state["watermark"] = batch.stream_pos
        if not (cfg.save_steps and st.global_step % cfg.save_steps == 0):
            return
        if gate_holding[0] and ckpt.published_at_risk(margin=2):
            # Retention pause: while the gate holds, a periodic save
            # that would push the published (last-good) step past
            # max_to_keep does not run; the watermark re-trains the
            # progress since the last save exactly once after a crash.
            if not risk_pause_logged[0]:
                risk_pause_logged[0] = True
                logger.warning(
                    "publish gate holding with the published step at "
                    "the retention boundary: pausing periodic saves so "
                    "GC cannot evict the last-good checkpoint; heal the "
                    "input stream (or raise max_to_keep) to resume")
            return
        # Gated runs save synchronously: the retention arithmetic above
        # counts COMMITTED steps, and an in-flight step is not one yet.
        stream_save(wait=gate is not None)

    def emit_preempted() -> None:
        state["stopping"] = True
        logger.info("preemption signalled; saving the stream position "
                    "and exiting")

    t_loop = time.perf_counter()
    try:
        if mesh is not None:
            while True:
                b = source.next_batch()
                has = b is not IDLE and b is not DONE
                flags = mesh.all_gather_host(
                    np.asarray([has, bool(preempted), b is DONE,
                                publish_due()], np.int32),
                    "stream/step_flags")
                if flags[:, 1].any():
                    emit_preempted()
                    break
                if flags[:, 2].all() and not flags[:, 0].any():
                    break
                if flags[:, 0].any():
                    step_once(b if has else
                              empty_batch(cfg, uniq_bucket=u_bucket))
                else:
                    st.flush_log()
                    time.sleep(min(cfg.stream_poll_seconds, 0.5))
                if flags[0, 3]:  # the chief's clock
                    do_publish()
        else:
            pf = StreamPrefetcher(source, depth=cfg.prefetch_depth)
            try:
                while True:
                    if preempted:
                        emit_preempted()
                        break
                    # A bounded wait: the publish clock and the
                    # preemption check keep ticking while the stream
                    # idles.
                    batch = pf.get(timeout=min(cfg.stream_poll_seconds,
                                               0.5))
                    if batch is DONE:
                        if preempted:
                            emit_preempted()
                        break
                    if batch is IDLE:
                        st.flush_log()
                    else:
                        step_once(batch)
                    if publish_due():
                        do_publish()
            finally:
                pf.close()
    finally:
        source.close()
        st.loop_seconds += time.perf_counter() - t_loop
    st.flush_log()
    if bad_tracker is not None and bad_tracker.bad:
        logger.info("bad-line policy through the stream run: %s",
                    bad_tracker.describe())
    if source.stats.batches:
        logger.info("stream input: %s", source.stats.describe())
    return state["stopping"], state["watermark"], state["last_save"]


def _exit_publish(publisher: _Publisher, st: _Stepper, stopping: bool,
                  logger, val_bucket: int, preempted: list
                  ) -> Optional[dict]:
    """The exit publish after the final save: a clean STOP drain, or a
    preemption's durable save, is the freshest state a scorer can
    hot-reload. Gated like every other publish. A PREEMPTED gated run
    skips it: the grace window before SIGKILL has no room for a
    validation sweep, and the pointer stays on the last passing step.
    Returns the gate's decision (None without a sweep)."""
    if stopping and publisher.gate is not None:
        logger.info(
            "preempted with a publish gate configured: exit "
            "publish skipped (no quality sweep inside the "
            "grace window); the pointer stays on the last "
            "passing step")
        return None
    decision = None if stopping else publisher.decide(
        st, uniq_bucket=val_bucket,
        preempt=(lambda: bool(preempted)) if st.mesh is not None else None)
    if decision is None or not decision.get("held"):
        publisher.publish(st.global_step, decision)
    return decision


def _restore_vocab(cfg: FmConfig, vocab: Optional[VocabRuntime],
                   restored: Optional[dict], directory: str,
                   logger) -> bool:
    """Pair a restored step with its admission state. Admit mode loads
    the step's vocab payload; a step without one (a fixed-mode warm
    start, or a lost or torn sidecar) starts admission fresh and returns
    True: the caller then cold-starts every row. Fixed mode refuses a
    step trained under admit mode."""
    if restored is None:
        return False
    step = int(restored["step"])
    payload = restored.get("vocab_admission")
    if vocab is None:
        refuse_fixed_mode_admit_step(cfg, directory, step, payload=payload)
        return False
    if payload is None:
        logger.warning(
            "restored checkpoint at step %d carries no vocab admission "
            "sidecar (a fixed-mode warm start, or a lost/garbled "
            "sidecar): admission state starts FRESH — previously "
            "admitted ids serve from the cold row until they re-cross "
            "the threshold", step)
        return True
    vocab.load(cfg, payload)
    logger.info("restored vocab admission state at step %d: %d live rows",
                step, vocab.live_rows)
    return False


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


def _initial_shards(cfg: FmConfig, mesh: ProcessMesh, device: torch.device,
                    restored, init_state, directory: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``(table, acc)`` row shards on ``device``: the
    restored checkpoint's rows, else ``init_state``'s (a dense pair,
    placed), else a fresh sharded draw (``init_sharded_state``)."""
    if restored is not None:
        if init_state is not None:
            raise ValueError(
                f"init_state was given, but {directory} holds a "
                "checkpoint to resume; point model_file elsewhere to "
                "start from init_state")
        return (restored["table"].to(device).contiguous(),
                restored["acc"].to(device).contiguous())
    if init_state is None:
        return init_sharded_state(cfg, mesh, cfg.seed, device)
    table, acc = init_state
    return (place_table(cfg, mesh, table, device),
            place_table(cfg, mesh, acc, device, fill=cfg.adagrad_init))
