#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (fast_tffm_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; exits non-zero, printing no result, without them.
It drives the port's serving and training paths at full width —
BASELINE config #2's model: 2nd-order FM, factor_num = 16, hashed ids,
vocabulary 2^24, a [2^24+1, 17] f32 table (1.14 GB) — over
Criteo-shaped lines it generates itself; then, on the same lines,
config #3's FFM and config #4's order-3 FM, and config #2's model again
on the packed wire, and config #2's model in the stream run mode, and
config #5's width with the table offloaded to the host, and config #2's
model in vocabulary admit mode, and config #2's model trained and
predicted by two ranks over a row-sharded table (``dist_train``), in
epochs and as a stream, both across a kill and a join; and BASELINE
config #1 at its published width (2nd-order FM, k = 8, hashed ids into
2^22, L = 48) on the port's own synthesized Criteo-like data, held to
the port's independent NumPy trainer:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: the three kernel libraries, one nvcc each, and the C++ parser
   library (g++), all started together, with nvcc's register report and
   the parser's build seconds;
   pipeline: the train phase's 131,072 lines (written here) through
   the C++ fast path with ``host_threads = 1`` and with ``host_threads``
   = auto (its worker count printed), which must be equal array for
   array, and the first 32,768 of them also through the plain
   pure-Python stream, equal to both; each with its lines/s and the
   host's CPU count; then the generic path (a
   weight sidecar, ``bad_line_policy = skip`` with planted bad lines)
   against its plain expectation;
3. kernel: each CUDA kernel against its plain PyTorch version at the
   main path's shapes (fm_score bit for bit, also on the first predict
   batch's Zipf-skewed raw ids), with errors, median times (CUDA events,
   L2 flushed between launches), the kernel's device time alone (a
   profiler trace of bare launches, or CUDA events around them where
   the trace misses the kernel), bytes moved and the bound; fm_score_bwd
   against the plain version with float64 row sums, at rtol 1e-5 of each
   element's sum of absolute contributions plus atol 1e-6 on every row,
   and equal to the bit across two launches on one input. Tables
   are drawn N(0, 0.1^2) from a seeded torch.Generator.
   The random table of phases 4-5 is written as a checkpoint step with
   ``models/convert.save_checkpoint_from_numpy`` and published with
   ``python -m fast_tffm_tpu_torch.tools.fmckpt publish`` (in process);
4. predict: 65,536 lines through ``python -m fast_tffm_tpu_torch
   predict`` (in process), which reads that step, checked line by line
   and against a float64 reference on the first lines;
5. serve: ScorerServer + HTTP front end on a free port, concurrent
   requests of 1-256 lines whose bodies must equal the predict file's
   lines byte for byte and carry the published step in ``X-FM-Step``,
   one malformed request (400), /healthz;
   config1: BASELINE config #1's AUC parity. Its host side starts after
   the pipeline phase in a process of its own and runs beside phases
   3-5: ``data/synth.write_dataset`` at seed 17 (131,072 train and
   32,768 test lines, cut from 1,000,000 / 100,000), the port's C++
   block parse of both files, and ``synth.numpy_fm_train_predict`` (the
   independent NumPy SGD-FM) on them. After phase 5, ``python -m
   fast_tffm_tpu_torch train`` then ``predict`` (in process) at config
   #1's settings (tools/criteo_bench.py: k = 8, 2^22 hashed rows, L =
   48, lr 0.05, lambdas 1e-6, init range 0.01, logistic loss, 2 epochs,
   no shuffle) with B = 1,024 (cut from 8,192: at this depth 8,192
   leaves 32 steps, where the oracle reaches only ~0.59), the oracle at
   the same B. The score file's test AUC must lie within 0.015 of the
   oracle's, the oracle's reach 0.80, the card's stay below the Bayes
   ceiling of the generator's logits; fm_score launches on every train
   step and predict batch, fm_score_bwd on every step; both kernels
   against their plain versions on the first train step's captured
   inputs at (1,024, 48, 8) (the forward bit for bit, the backward at
   the row sums' tolerance and equal across launches). Its line: the
   AUCs, the ceiling, the host side's seconds (generate, parse,
   oracle), the train and predict commands' and the .npz export's
   seconds, the loop's examples/s and the launches;
6. train: ``python -m fast_tffm_tpu_torch train`` (in process), one
   epoch (run A) with ``save_steps = 8`` over 131,072 lines whose labels
   come from a planted logistic model, validating on 16,384 more: it
   saves at steps 8 and 16 and its final save at 16 writes the epoch
   override. ``fmckpt`` must then list exactly steps 8 and 16, both
   verifying in full. Both kernels must launch, the mean loss must fall
   over the epoch, the validation AUC must clear a floor derived from
   the planted model, and predict of the trained model (step 16) must
   reach the same AUC. (No resumed second epoch here: the offload,
   stream and admit phases each resume a step.) Then both kernels against their plain versions
   on one of the stream's Zipf-skewed batches (fm_score with L2 warm, as
   in the step; fm_score_bwd also with the numeric fields' slots zeroed,
   which takes its hottest rows away), the median time of one step on
   batches already on the card, its kernels' device time from a
   profiler trace, and the card's idle share computed from them. The
   train and predict commands stream their batches through the C++
   builder (the parallel data plane);
7. hot reload: step 8 published and served while client threads post
   blocks of validation lines; step 16 is published under that load,
   and every response must be a 200 whose body equals the predict lines
   of the step its ``X-FM-Step`` names, byte for byte; /healthz must
   count one reload and no failure;
   fleet: ``serve --replicas 3`` in process (a ``FleetSupervisor`` with
   a 0.2 s health poll on a free block of ports) over the same model
   directory: three replica processes on the card behind the failover
   proxy, step 8 published first; every replica's /healthz must name
   ``cuda:0`` and the CUDA kernel; 4 client threads post blocks of 1-256
   validation lines through the proxy; replica 1 is SIGKILLed mid-burst
   and must respawn (a new pid) and the fleet return to 3 ready; step 16
   is published under load and reloaded replica by replica, while a
   sampler of the proxy's /healthz must read at least one ready replica
   every time. Every response must be a 200 whose body equals the
   predict lines of its ``X-FM-Step`` byte for byte, both steps must
   appear, the supervisor must count a death, a restart, at least two
   reloads and no reload failure, every replica must have flushed and
   launched fm_score, and no ``fmt-fleet``/``fmt-proxy`` thread may
   outlive the drain. Its line: spawn-to-ready of each replica,
   kill-to-ready, the stagger's seconds, the proxied p50/p99 beside
   phase 5's single server, the retries absorbed and the replicas'
   fm_score launches;
8. quarantine: the newest step (16) is torn with ``truncate_checkpoint``;
   a restore must walk back to step 8 and leave ``corrupt-16/`` holding
   ``QUARANTINE`` and ``manifest-16.json``, and publishing step 16 must
   fail with the pointer untouched;
9. train with ``dedup = host``: one epoch (reduced depth) through ``python
   -m fast_tffm_tpu_torch train`` on host-deduped batches, which must
   launch both kernels and clear the same AUC floor; both kernels against
   their plain versions on one of its batches, and its resident step
   time beside the ``dedup = device`` step's;
10. the packed wire (config #2's model): after phase 5, predict with
   ``wire_format = packed`` — wide, whose score file must equal the
   padded one byte for byte, and narrow, within 2e-3 of it — and a
   packed-wide server whose bodies equal the predict lines byte for byte;
   after phase 9, one epoch of train on packed-wide (periodic saves off),
   whose mean loss and validation AUC must match run A's first epoch at
   the training tolerance (rtol 1e-4, AUC within 1e-3) with fewer bytes
   shipped; then bytes per batch (wire against the padded layout) and
   H2D ms per batch for padded, packed-wide and packed-narrow;
11. FFM and order 3 (reduced depth: one epoch, periodic saves off): the
   train lines again with each token tagged by its field (39 fields, 13
   numeric + 26 categorical), FFM at libffm's Criteo setting (k = 4,
   hashed vocabulary 2^20, a [2^20+1, 157] f32 table, 0.66 GB; config
   #3), and the plain train lines through an order-3 FM (k = 8,
   vocabulary 2^24, a [2^24+1, 9] table, 0.60 GB; config #4): each
   through ``train`` then ``predict``; the loss must fall, the validation
   AUC clear the train phase's floor and predict reach it, a validation
   batch's scores on the card agree with float64 on the CPU within
   1e-4, and neither launches a hand-written kernel (torch ops, as XLA
   ran them in the JAX package); each with its resident step time and
   device ms by op;
12. the stream run mode (config #2's model): a writer thread appends the
   train lines as 4 shards of 32,768 lines (3 appends each, cut in the
   middle of a line, then ``<shard>.done``); ``python -m
   fast_tffm_tpu_torch train`` in a subprocess (``run_mode = stream``,
   publishes every 2 s through a gate at the train phase's AUC floor,
   no periodic saves) steps shards 1-2 and takes a SIGTERM once the
   ``published`` pointer names step 8, which must save step 8's
   watermark and exit 0; the same command again must restore step 8,
   resume from its watermark, step shards 3-4 and end at step 16 on
   ``STOP``, the two runs stepping 131,072 examples in all. A
   ScorerServer (hot reload by poll) on the model directory answers
   client threads throughout: every ``X-FM-Step`` a step the trainer
   published, at least two swaps, and bodies for the validation lines
   equal to predict of the final published step byte for byte. A
   control run in process (the port's StreamSource over the finished
   directory through train_step_body, no saves) must match step 16's
   table and accumulator at rtol 1e-4 / atol 1e-6 and its watermark
   exactly. Its line: the loop's rate, each publish's sweep, save,
   verify and flip seconds, freshness (a shard's ``.done`` to the first
   published step holding it), resume seconds, the server's swaps and
   p99, and the kernels' launches;
13. ``lookup = host`` (config #5's width: 2nd-order FM, k = 8, hashed
   ids; its 10^9 rows cut to 10^8, a [10^8+1, 9] f32 table and an equal
   accumulator, 7.2 GB of page-locked host state): run A (one epoch,
   final save at 16) and run B (restores 16 into page-locked memory,
   resumes at epoch 1/2, ends at 32) of ``python -m fast_tffm_tpu_torch
   train`` as subprocesses, started before phase 14 and run beside it
   (the rest of the phase follows phase 14), under a wrapper that
   writes to JSON the four
   kernels' launches, the host RSS before and after the backend is built
   and at its peak, the card's peak allocated bytes from then on, and
   whether the state is page-locked. The loss must fall, the AUC clear
   the floor, all four kernels launch on every step, the card's peak
   stay under 1 GiB, and RSS grow by about two tables' bytes and peak
   at most three. A control run in process draws run A's initial table
   again with the port's host init (a CPU generator: the same numbers)
   and steps run A's stream on the card through ``train_step_body``; it
   must match step 16 at rtol 1e-4 / atol 1e-6; its loop, and the same
   loop on a pinned backend, give the two paths' rates side by side.
   Predict of step 32 with
   ``lookup = host`` on the padded and the packed wire must equal
   ``lookup = device`` predict byte for byte. Eight batches step a
   fresh pinned backend and a ``HostOffloadLookup`` (whose states must
   agree at the step's tolerance), with each one's step ms; then the
   pinned backend's resident step by events and by kernel, and both
   offload kernels against their plain versions on a batch (gather
   exact, write-back within rtol 1e-6), with device and event ms, bytes
   over the host link each way and in device memory, and the bound at
   the host link's rate each way, measured by 64 MiB pinned copies to
   and from the card; the offload diagnosis (``offload_diagnosis``:
   both kernels on the batch's ids and on as many ids inside one 2 MiB
   span, and a gather of the accumulator's rows, with L2 flushed); and
   both FM kernels against their plain versions
   on that batch with the control run's table (K = 8, Zipf-skewed
   host-deduped rows); then, on the pinned backend, ``reset_rows``
   straight after a step over a set holding the batch's hottest row:
   exactly 0.0 and ``adagrad_init`` there, and the next step equal to
   the HostOffloadLookup backend's at rtol 1e-4 / atol 1e-6;
14. ``vocab_mode = admit`` (config #2's model, 2^24 physical rows, ids
   hashed into 2^30; threshold 2, decay 0.5, sketch 1 MB): run A of
   ``python -m fast_tffm_tpu_torch train`` (in process) over the train
   phase's lines, one epoch, whose barrier admits and whose final save
   writes ``vocab-16.json.gz``; run B restores step 16 with its slot map
   and trains one epoch to step 32 on 131,072 new lines (and 16,384
   validation lines) whose planted fields keep their tokens and whose
   high-cardinality fields take ids run A never saw, so its barrier
   evicts. Both kernels launch every step; the loss falls and run B's
   AUC clears the floor (run A's validation follows its first barrier,
   whose admitted rows are untrained: near chance); live rows stay
   under 2^24; the rows run B's barrier freed hold 0.0 and
   ``adagrad_init`` at step 32; ``fmckpt`` marks steps 16 and 32
   ``+VOCAB`` and verifies them in full. Both runs save every 8 steps,
   so each barrier's step is also a periodic save's, written anew by the
   final save. A control run in process (a fresh VocabRuntime and
   train_step_body over both streams, the same barriers and initial
   table), run twice, must match step 32's payload exactly each time,
   and the two runs' tables and accumulators must be equal to the bit;
   step 32 must equal the control at rtol 1e-4 / atol 1e-6 in every
   element, and to the bit in every row outside the cold row's reach;
   the control gives the loop's rate beside the same loop in fixed
   mode. Admit predict of step 32 (65,536 lines) on the padded and the packed-wide wire must be
   equal byte for byte, a fixed-mode predict is refused, and a
   ScorerServer serves step 16 then step 32 (published under client
   load) with every body equal to the predict lines of the step it
   names, one reload and no failure; a copy of step 32 whose sidecar has
   one flipped byte fails its reload and step 32 keeps serving. Both
   kernels against their plain versions on the two runs' first remapped
   raw-ids batches as the control stepped them (run A's: every id on the
   cold row 0; run B's: its unseen ids there), with the cold row's share
   of their slots; the remap's ms a batch, each barrier's seconds and
   reset's ms, the sidecar's bytes;
15. ``dist_train`` (config #2's model, two ranks on cuda:0 over gloo,
   each a process with its CUDA context and a [ckpt_rows/2, 17] shard
   of the table and of its accumulator): ``python -m fast_tffm_tpu_torch
   train <cfg> dist_train worker <i>`` for both ranks (subprocesses that
   write their kernels' launch counts), one epoch of the train phase's
   lines (each rank its byte range), one periodic save, validation on
   its 16,384 lines split alike. Each worker's log must name ``cuda:0``,
   both kernels must launch in both workers, the two logs carry the same
   losses, which fall, the validation AUC clears the floor and lies
   within 0.03 of run A's over the same lines, the workers step every
   line once, and the chief's checkpoint verifies in full with
   ``fmckpt``. The 2-rank predict leaves one merged score file and no
   part, equal within 2e-6 to a single-process predict of the same
   step. A second run's worker 1 is SIGKILLed a few steps into epoch 1:
   the survivor must exit non-zero naming process 1
   (``WorkerLostError``) within ``collective_timeout_seconds`` plus the
   lease's staleness. Its line (correctness-run figures, not a
   benchmark): the phase's seconds, each worker's loop examples/s and
   step ms, the export's seconds, the launches, the detection seconds;
   then the elastic leg (``elastic = grow``), started after the phase and
   run beside phase 12: two ranks of ``train <cfg> dist_train worker
   <i>`` on cuda:0, two epochs of the padded lines, a periodic save
   every 8 steps; once step 8 is committed, rank 1 is SIGKILLed (in
   epoch 0: the save at 16 waits for step 8's write) and ``train <cfg>
   --join`` started. The survivor must name process 1 (a kill that
   lands in a save's gather to the chief is abandoned at
   ``collective_timeout_seconds``), reform generation 1 alone (a single
   process: the whole table on the card), restore the last committed
   step s0 (8, or 16 if its gather beat the kill; epoch 0 either way)
   and train epoch 0 again, then at the epoch boundary save
   and admit the joiner into slot 1 (generation 2); both restore that
   step and train epoch 1 as two ranks. Both must end at step s0 + 32 +
   16 (the exactly-once arithmetic), epoch 2, the
   validation AUC over the floor, the lease directory holding only
   generation 2's files, both kernels launched in both processes, and
   the first step of each post-reform session (the survivor's lone and
   grown sessions, the joiner's) held against the plain versions on its
   captured kernel inputs. Its line: kill to detection, detection to
   recovery, each restore's seconds, ticket to admission, the launches;
   then the multi-process stream leg (``dist_stream``), started after
   phase 12 and run beside phases 13-14: the train lines as 4 shards of
   32,768 lines (8 batches of a rank's 4,096 each; each written in torn
   appends under a dot name, sealed, then renamed into place with its
   partner so that both ranks' shards appear in one discovery); shards
   0-1 staged, then two ranks of ``train <cfg> dist_train worker <i>``
   on cuda:0 with ``run_mode = stream``, ``elastic = grow``, a gated
   publish every 2 s at the train phase's AUC floor; once ``published``
   names step 8, rank 1 is SIGKILLed as both idle in the flags window.
   The survivor must name process 1, reform generation 1 alone and
   restore step 8 with its merged watermark; ``train <cfg> --join`` is
   then started and must be admitted at a publish settle (generation 2,
   ``input shards re-balanced``); shards 2-3 are staged, then ``STOP``.
   Both must exit 0 at step 16, the final watermark must cover every
   byte and line of the 4 shards (each sealed by its ``.done``), the
   joiner must have stepped shard 3 (ledger index 3 is rank 1's), the
   final AUC clear
   the floor and lie within 0.03 of run A's, the lease directory hold
   generation 2's files, every session launch the forward and each
   2-rank session one backward a step; both kernels against their plain
   versions on the lone survivor's first sweep batch and the grown
   ranks' first step. Its line: kill to detection, detection to
   recovery, each restore's seconds, ticket to admission, each publish's
   sweep and each waited save's seconds, the launches;
16. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

The phases time the checkpoint plane: each periodic save's pause in the
train loop (the snapshot), the final save with ``wait``, the background
write and manifest hash, the restore at train start, predict's table
load, and the reload from the pointer flip to the swap. Every phase line
carries the card's name and power limit.

Any failed check raises, and the script exits non-zero. Scratch files
(checkpoint steps of 2.28 GB, 1.14 GB .npz exports, the offload phase's
7.2 GB steps, the admit phase's serving directory) live in ``.smoke/``
at the repo root and are removed at the end. ``--out DIR`` also writes a
JSON summary of every phase to ``DIR/chip_smoke.json``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

SEED = 20261017
VOCAB = 1 << 24
FACTORS = 16
PREDICT_LINES = 65536
PREDICT_BATCH = 8192
SERVE_MAX_BATCH = 256
KERNEL_SHAPES = ((256, 64, 16), (8192, 64, 16), (8192, 256, 16),
                 (1024, 64, 8))
HEADLINE_SHAPE = (8192, 64, 16)   # the predict batch of the main path
# fm_score must equal its plain version bit for bit; ATOL floors |plain|
# in the relative error its rows report.
ATOL = 1e-6
# fm_score_bwd sums each row exactly in fixed point, so each element is
# held to BWD_RTOL of its sum of absolute contributions, plus BWD_ATOL,
# against the plain version with each row's contributions summed in
# float64, and two launches on one input must agree to the bit.
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
# The kernels of one fm_score_bwd call, in launch order.
BWD_KERNEL_NAMES = ("fm_score_bwd_scale", "fm_score_bwd_kernel",
                    "fm_score_bwd_finish")
TRAIN_LINES = 131072
PLAIN_LINES = 32768               # the plain Python stream's check: a prefix
GENERIC_LINES = 32768             # the generic path's check: a prefix
GENERIC_BAD = (101, 5000, 17777, 25000, 32000)   # planted bad lines
VAL_LINES = 16384
TRAIN_BATCH = 8192
TRAIN_EPOCHS = 2                  # the offload phase: run A takes the first,
#                                   run B the second
SERVED_STEPS = (8, 16)            # the train phase's periodic and final
#                                   saves: the steps the reload, fleet and
#                                   quarantine phases serve, reload and tear
TRAIN_LR = 0.1
SAVE_STEPS = 8                    # half an epoch of TRAIN_LINES
SERVE_STEP = 1                    # the step the random table is written at
RELOAD_POLL_SECONDS = 0.2
RELOAD_CLIENTS = 8
RELOAD_ROUNDS = 6                 # each client's requests after the swap
MIN_FREE_BYTES = 24 << 30         # the offload phase's two 7.2 GB steps,
                                  # data and score files (the widest)
RESIDENT_BATCHES = 4
RESIDENT_STEPS = 20
PROFILED_STEPS = 8
AUC_GAP = 2e-3               # |exact AUC of predict - binned AUC|
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12          # H100 SXM, non-tensor-core f32
L2_FLUSH_BYTES = 64 << 20         # > the 50 MB L2
LINK_PEAK_BYTES = 64 << 20        # a copy long enough to reach the link's
                                  # rate (no per-copy cost in sight)
TIMED_LAUNCHES = 30
PROFILED_LAUNCHES = 10
PROFILE_ATTEMPTS = 5
SPIN_CYCLES = 2_000_000           # ~1 ms of the card's clock

# Criteo line format (the JAX package's data/synth.py:generate): 13
# numeric "I<j>:<log1p count>" tokens, ~8% dropped, then 26 hashed
# categorical "C<f>=v<id>" tokens with Zipf-skewed ids.
CAT_VOCABS = (40, 500, 90000, 30000, 200, 15, 10000, 400, 3, 25000,
              4000, 80000, 3000, 25, 8000, 60000, 10, 4000, 1500, 4,
              50000, 12, 14, 30000, 60, 20000)
NUM_FIELDS = 13
ZIPF_A = 1.35
# Train phase labels: a logistic model over the categorical fields with
# at most 25 values (C5, C8, C13, C16, C19, C21, C22).
PLANTED_FIELDS = tuple(f for f, v in enumerate(CAT_VOCABS) if v <= 25)
PLANTED_SCALE = 0.8
PLANTED_BIAS = -1.2


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


class CheckpointTimes:
    """While active, times each ``CheckpointState.save`` call (a periodic
    save's time is the train loop's pause for the snapshot; a
    ``wait=True`` save's includes the write and the manifest) and each
    ``restore``."""

    def __enter__(self):
        from fast_tffm_tpu_torch.checkpoint import CheckpointState
        self.saves, self.restores = [], []
        self._cls = CheckpointState
        self._orig = save, restore = (CheckpointState.save,
                                      CheckpointState.restore)

        def timed_save(ckpt, step, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return save(ckpt, step, *args, **kwargs)
            finally:
                self.saves.append({"step": int(step),
                                   "wait": bool(kwargs.get("wait")),
                                   "seconds": time.perf_counter() - t0})

        def timed_restore(ckpt, *args, **kwargs):
            t0 = time.perf_counter()
            out = restore(ckpt, *args, **kwargs)
            self.restores.append({"step": None if out is None
                                  else out["step"],
                                  "seconds": time.perf_counter() - t0})
            return out
        CheckpointState.save = timed_save
        CheckpointState.restore = timed_restore
        return self

    def __exit__(self, *exc):
        self._cls.save, self._cls.restore = self._orig


def committed_steps_in_log(path):
    """The checkpoint writer's commit lines in a log: per step, the MB
    written, the seconds to commit and the manifest hash's seconds."""
    import re
    with open(path) as fh:
        text = fh.read()
    return [{"step": int(s), "mb": float(mb), "write_seconds": float(w),
             "manifest_seconds": float(m)} for s, mb, w, m in re.findall(
                 r"checkpoint step (\d+) committed \(([0-9.]+) MB\) in "
                 r"([0-9.]+)s; manifest hashed in ([0-9.]+)s", text)]


def criteo_lines(n, seed, planted=None, ffm=False, fresh=False):
    """``n`` Criteo-shaped lines. Labels are Bernoulli(0.25), or, with
    ``planted`` (a PLANTED_* model), Bernoulli(sigmoid(planted logit));
    returns (lines, planted logits or None). ``ffm``: the same tokens
    tagged with their field, one field per column (13 numeric, then 26
    categorical), as libffm's Criteo files are. ``fresh``: the
    categorical fields outside PLANTED_FIELDS take token names no other
    call makes (``C{f}=w...``), the planted fields keep theirs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cat = np.stack([(rng.zipf(ZIPF_A, size=n) - 1) % v for v in CAT_VOCABS],
                   axis=1)
    num = np.round(np.log1p(rng.lognormal(1.0, 1.2, size=(n, NUM_FIELDS))),
                   3)
    miss = rng.random((n, NUM_FIELDS)) < 0.08
    tags = ["w" if fresh and f not in PLANTED_FIELDS else "v"
            for f in range(len(CAT_VOCABS))]
    logits = None
    if planted is None:
        labels = (rng.random(n) < 0.25).astype(np.int32)
    else:
        logits = planted_logits(planted, cat)
        labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))
                  ).astype(np.int32)
    lines = []
    for i in range(n):
        parts = [str(labels[i])]
        if ffm:
            parts += [f"{j}:I{j}:{num[i, j]}" for j in range(NUM_FIELDS)
                      if not miss[i, j]]
            parts += [f"{NUM_FIELDS + f}:C{f}=v{cat[i, f]}"
                      for f in range(len(CAT_VOCABS))]
        else:
            parts += [f"I{j}:{num[i, j]}" for j in range(NUM_FIELDS)
                      if not miss[i, j]]
            parts += [f"C{f}={tags[f]}{cat[i, f]}"
                      for f in range(len(CAT_VOCABS))]
        lines.append(" ".join(parts))
    return lines, logits


def planted_model(seed):
    """The planted logistic model of the train phase: an intercept and
    one N(0, PLANTED_SCALE^2) weight per value of each field in
    PLANTED_FIELDS (the low-cardinality categorical fields)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {f: rng.normal(0.0, PLANTED_SCALE, size=CAT_VOCABS[f])
            for f in PLANTED_FIELDS}


def planted_logits(model, cat):
    import numpy as np
    logits = np.full(cat.shape[0], PLANTED_BIAS)
    for f, beta in model.items():
        logits += beta[cat[:, f]]
    return logits


def write_cfg(path, wire="padded-wide"):
    """The predict and serve config of phases 4-5; ``wire`` another
    ``wire_format``-``wire_dtypes`` pair writes its own score files."""
    model = os.path.join(WORK, "model", "fm_model")
    fmt, dtypes = wire.split("-")
    score = "score" if wire == "padded-wide" else f"score_{wire}"
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = {FACTORS}
model_file = {model}
log_file = {os.path.join(WORK, 'fm.log')}

[Train]
batch_size = {PREDICT_BATCH}
loss_type = logistic
wire_format = {fmt}
wire_dtypes = {dtypes}

[Predict]
predict_files = {os.path.join(WORK, 'criteo.txt')}
score_path = {os.path.join(WORK, score)}

[Serve]
serve_port = 0
serve_max_batch = {SERVE_MAX_BATCH}
serve_max_wait_ms = 2
""")


def random_batch(torch, gen, B, L, pad_id, device):
    """Uniform random rows, values in [0, 1), a random pad tail per
    example (pad_id rows with value 0), laid out as make_device_batch
    lays out a batch."""
    idx = torch.randint(0, pad_id, (B, L), generator=gen, device=device,
                        dtype=torch.int32)
    vals = torch.rand((B, L), generator=gen, device=device)
    lengths = torch.randint(0, L + 1, (B, 1), generator=gen, device=device)
    tail = torch.arange(L, device=device)[None, :] >= lengths
    idx[tail] = pad_id
    vals[tail] = 0.0
    return idx, vals


def median_ms(torch, fn, flush):
    """Median of TIMED_LAUNCHES single-call CUDA-event times, after a
    warmup, with the L2 cache flushed (outside the timed span) before
    each call: a serving flush finds the table's rows cold. ``flush``
    None leaves L2 warm, as a train step finds the rows it just
    gathered."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def profiled_ms(torch, launch, flush, kernel_names):
    """Mean device time per call of the kernels named ``kernel_names``
    (one launch of each a call) over PROFILED_LAUNCHES calls of
    ``launch.run`` under torch.profiler, L2 flushed (unless ``flush`` is
    None) and the outputs reset (``launch.reset``) before each: the
    kernels alone. The profiler now and then returns a trace without the
    records of a kernel launched through ctypes; such a trace is taken
    again, up to PROFILE_ATTEMPTS times in all, and then None."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_LAUNCHES):
                if flush is not None:
                    flush.zero_()
                launch.reset()
                launch.run()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    any(name in e.key for name in kernel_names):
                us += e.self_device_time_total
                n += e.count
        if n == PROFILED_LAUNCHES * len(kernel_names):
            return us / 1e3 / PROFILED_LAUNCHES
    return None


def event_ms(torch, launch, flush):
    """Median device time of ``launch.run`` by CUDA events around the
    launch alone, recorded behind a spin of the card long enough that the
    host has queued the launch and the end event before the card reaches
    the start event, so no host work falls inside; they do add the
    card's few microseconds from event to kernel and back."""
    pairs = []
    for _ in range(PROFILED_LAUNCHES):
        if flush is not None:
            flush.zero_()
        launch.reset()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch.run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def kernel_ms(torch, launch, flush, kernel_names):
    """(device ms of the kernels of one call alone, "profiler" or
    "events"): by profiled_ms, or by event_ms where the profiler keeps
    missing them."""
    launch.reset()
    launch.run()  # warm up
    ms = profiled_ms(torch, launch, flush, kernel_names)
    if ms is not None:
        return ms, "profiler"
    return event_ms(torch, launch, flush), "events"


class Launch:
    """A bare kernel launch on outputs allocated beforehand (``run``),
    and what puts those outputs back as a fresh call would find them
    (``reset``: dparams zeroed, which also leaves it in L2 as the
    wrapper's torch.zeros_like does)."""

    def __init__(self, run, reset=lambda: None):
        self.run, self.reset = run, reset


def fwd_launch(torch, params, idx, vals):
    """A bare launch of this tree's fm_score (what the wrapper launches,
    without its checks and allocation), on an output allocated here."""
    from fast_tffm_tpu_torch.ops import build
    lib = build.load_fm_score()
    (N, D), (B, L) = params.shape, idx.shape
    out = torch.empty(B, dtype=torch.float32, device=params.device)

    def run():
        rc = lib.fm_score_forward(
            params.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            out.data_ptr(), N, D, B, L, params.device.index,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"fm_score launch failed: {rc}")
    return Launch(run)


def bwd_launch(torch, params, idx, vals, g, need_dx):
    """A bare launch of this tree's fm_score_bwd on outputs allocated
    here."""
    from fast_tffm_tpu_torch.ops import build
    lib = build.load_fm_score_bwd()
    (N, D), (B, L) = params.shape, idx.shape
    dparams = torch.zeros_like(params)
    dvals = torch.empty((B, L), dtype=torch.float32, device=vals.device)
    acc = torch.empty((N, D), dtype=torch.int64, device=params.device)
    row_max = torch.empty(N, dtype=torch.int32, device=params.device)

    def run():
        rc = lib.fm_score_bwd(
            params.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            g.data_ptr(), dparams.data_ptr(), dvals.data_ptr(),
            acc.data_ptr(), row_max.data_ptr(), N, D, B, L, int(need_dx),
            params.device.index, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"fm_score_bwd launch failed: {rc}")
    return Launch(run, dparams.zero_)


def fwd_kernel_row(torch, table, idx, vals, flush, **tags):
    """fm_score against its plain version on one input: bit-equal, or a
    raised SmokeFailure; times, bytes and bound in one row (emitted,
    tagged with ``tags``). ``flush`` None times it with L2 warm."""
    from fast_tffm_tpu_torch.ops import fm_kernel, interaction
    B, L = idx.shape
    D = table.shape[1]
    K = D - 1
    plain = interaction.fm_batch_scores(table, idx, vals)
    kern = fm_kernel.fm_batch_scores(table, idx, vals)
    torch.cuda.synchronize()
    diff = (kern - plain).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / plain.abs().clamp_min(ATOL)).max())
    bit_equal = bool(torch.equal(kern, plain))
    check(bit_equal and bool(torch.isfinite(kern).all()),
          f"fm_score differs from its plain version on {tags} at B={B} "
          f"L={L} K={K}: max abs err {max_abs}")
    ms = median_ms(torch, lambda: fm_kernel.fm_batch_scores(
        table, idx, vals), flush)
    plain_ms = median_ms(torch, lambda: interaction.fm_batch_scores(
        table, idx, vals), flush)
    new = fwd_launch(torch, table, idx, vals)
    device_ms, timing = kernel_ms(torch, new, flush, ("fm_score_kernel",))
    # Each input read once: the U distinct rows the batch references
    # (all pad cells share one), idx and vals; the scores written.
    U = int(torch.unique(idx).numel())
    nbytes = U * D * 4 + B * L * 8 + B * 4
    flops = B * (L * (4 * K + 2) + 3 * K + 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    row = {"phase": "kernel", "name": "fm_score", **tags, "B": B, "L": L,
           "K": K, "U": U, "l2": "cold" if flush is not None else "warm",
           "bit_equal": bit_equal, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms,
           "device_ms": device_ms, "device_timing": timing,
           "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
           "bound_share": bound_ms / ms,
           "bound_share_device": bound_ms / device_ms}
    emit(row)
    return row


def kernel_phase(torch, tables, predict_batch, device):
    """fm_score at the kernel shapes on uniform rows, then on the first
    predict batch (raw, Zipf-skewed ids into the 2^24 table)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for B, L, K in KERNEL_SHAPES:
        idx, vals = random_batch(torch, gen, B, L, VOCAB, device)
        rows.append(fwd_kernel_row(torch, tables[K], idx, vals, flush,
                                   batch="uniform"))
    idx, vals = predict_batch
    rows.append(fwd_kernel_row(torch, tables[FACTORS], idx, vals, flush,
                               batch="predict"))
    del flush
    return rows


def bwd_row_sums_f64(torch, params, local, vals, g):
    """(dparams, dparams_abs) of the plain backward
    (ops/interaction.py:fm_batch_scores_bwd) with each slot's float32
    contribution, formed as the plain version forms it, summed into its
    row in float64: the reference a float32 sum of a row's slots is
    held to."""
    B, L = local.shape
    K = params.shape[1] - 1
    s = params.new_zeros((B, K))
    for l in range(L):
        s = s + params.index_select(0, local[:, l].long())[:, :K] * \
            vals[:, l][:, None]
    dp = torch.zeros(params.shape, dtype=torch.float64,
                     device=params.device)
    dp_abs = torch.zeros_like(dp)
    for l in range(L):
        r = local[:, l].long()
        v = params.index_select(0, r)[:, :K]
        x = vals[:, l]
        gx = g * x
        grow = torch.cat([gx[:, None] * (s - v * x[:, None]), gx[:, None]],
                         dim=1).double()
        dp.index_add_(0, r, grow)
        dp_abs.index_add_(0, r, grow.abs())
    return dp, dp_abs


def bwd_kernel_rows(torch, params, local, vals, g, flush,
                    need_dx_cases=(False, True), **tags):
    """fm_score_bwd against its plain version on one input, for each
    ``need_dx`` in ``need_dx_cases``: a row each (emitted, tagged with
    ``tags``), or a raised SmokeFailure. ``flush`` None times it with L2
    warm. The reference is the plain version with each row's float32
    contributions summed in float64 (``bwd_row_sums_f64``); the kernel,
    which sums each row exactly in fixed point, is held to rtol 1e-5 of
    each element's sum of absolute contributions plus atol 1e-6 on every
    row, and a second launch on the same input must equal the first to
    the bit. The float32 plain version's own error against the same
    reference is reported beside it (a row taking hundreds of thousands
    of slots, an admit batch's cold row, drives it past that bound)."""
    from fast_tffm_tpu_torch.ops import fm_kernel, interaction
    B, L = local.shape
    U, D = params.shape
    K = D - 1
    pdp, dv, _, dv_abs = interaction.fm_batch_scores_bwd(
        params, local, vals, g, need_dx=True, magnitudes=True)
    dp, dp_abs = bwd_row_sums_f64(torch, params, local, vals, g)
    bound = BWD_ATOL + BWD_RTOL * dp_abs
    perr = (pdp.double() - dp).abs()
    plain_err = float(perr.max())
    plain_misses = int((perr > bound).any(dim=1).sum())
    del pdp, perr
    rows = []
    for need_dx in need_dx_cases:
        kdp, kdv = fm_kernel.fm_batch_scores_bwd(params, local, vals, g,
                                                 need_dx)
        again, _ = fm_kernel.fm_batch_scores_bwd(params, local, vals, g,
                                                 need_dx)
        torch.cuda.synchronize()
        repeatable = bool(torch.equal(kdp, again))
        del again
        err = (kdp.double() - dp).abs()
        ok = bool((err <= bound).all()) and bool(torch.isfinite(kdp).all())
        max_abs = float(err.max())
        excess = float((err - bound).max())
        if need_dx:
            derr = (kdv.double() - dv).abs()
            dbound = BWD_ATOL + BWD_RTOL * dv_abs
            ok = ok and bool((derr <= dbound).all()) and bool(
                torch.isfinite(kdv).all())
            max_abs = max(max_abs, float(derr.max()))
            excess = max(excess, float((derr - dbound).max()))
        ms = median_ms(torch, lambda: fm_kernel.fm_batch_scores_bwd(
            params, local, vals, g, need_dx), flush)
        plain_ms = median_ms(
            torch, lambda: interaction.fm_batch_scores_bwd(
                params, local, vals, g, need_dx), flush)
        new = bwd_launch(torch, params, local, vals, g, need_dx)
        device_ms, timing = kernel_ms(torch, new, flush, BWD_KERNEL_NAMES)
        # Each input read once (the U gathered rows, idx, vals, g),
        # each output written once (dparams, and dvals if asked).
        nbytes = (2 * U * D * 4 + B * L * 8 + B * 4
                  + (B * L * 4 if need_dx else 0))
        nnz = int((vals != 0).sum())
        # The most atomics on one row: its nonzero slots in the batch.
        hottest = int(torch.bincount(local[vals != 0].long(),
                                     minlength=U).max()) if nnz else 0
        # pass 1: 2K per nonzero slot; pass 2: 3K + 1 per nonzero slot
        # plus its K + 1 adds; dvals: 2K + 2 per slot.
        flops = nnz * (6 * K + 2) + (B * L * (2 * K + 2) if need_dx else 0)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOPS_PER_S * 1e3
        row = {"phase": "kernel", "name": "fm_score_bwd", **tags, "B": B,
               "L": L, "K": K, "U": U,
               "l2": "cold" if flush is not None else "warm", "nnz": nnz,
               "hottest_row_slots": hottest, "need_dx": need_dx,
               "max_abs_err": max_abs, "max_excess_over_bound": excess,
               "plain_f32_max_abs_err": plain_err,
               "plain_f32_rows_over_bound": plain_misses,
               "repeatable": repeatable,
               "within_tol": ok, "rtol_of_abs_sum": BWD_RTOL,
               "atol": BWD_ATOL, "ms": ms, "plain_ms": plain_ms,
               "device_ms": device_ms, "device_timing": timing,
               "bytes": nbytes, "flops": flops,
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
               "bound_share": max(bytes_ms, flops_ms) / ms,
               "bound_share_device": max(bytes_ms, flops_ms) / device_ms}
        emit(row)
        rows.append(row)
        check(ok, f"fm_score_bwd disagrees with its plain version on "
                  f"{tags} at B={B} L={L} K={K} need_dx={need_dx}: max abs "
                  f"err {max_abs}, worst excess over the bound {excess}")
        check(repeatable, f"fm_score_bwd gave two results on one input on "
                          f"{tags} at B={B} L={L} K={K} need_dx={need_dx}")
    return rows


def bwd_kernel_phase(torch, tables, device):
    """fm_score_bwd against its plain version at the kernel shapes, on
    the rows a train step hands it: the batch's unique rows, gathered,
    and each cell's index into them. Ids are uniform random, so few
    atomics meet on one row; train_phase adds Zipf-skewed batches."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for B, L, K in KERNEL_SHAPES:
        raw, vals = random_batch(torch, gen, B, L, VOCAB, device)
        uniq, inv = torch.unique(raw.reshape(-1), sorted=True,
                                 return_inverse=True)
        params = tables[K].index_select(0, uniq)
        local = inv.reshape(B, L).to(torch.int32)
        g = torch.randn(B, generator=gen, device=device)
        rows += bwd_kernel_rows(torch, params, local, vals, g, flush,
                                batch="uniform")
    del flush
    return rows


def numeric_ids(vocab):
    """The hashed row ids of the NUM_FIELDS numeric features I0, I1,
    ... (one row each, whatever the value)."""
    from fast_tffm_tpu_torch.data.hashing import hash_feature
    return [hash_feature(f"I{j}", vocab) for j in range(NUM_FIELDS)]


def train_batch_kernel_rows(torch, spec, table, args, device, tag="train",
                            numeric=None):
    """Both kernels against their plain versions on one batch of the
    train phase's stream, deduped (on the card for a raw-ids batch, by
    the host for a ``dedup = host`` one) and gathered as train_step_body
    does, with g = dloss/dscore of that batch: Criteo's low-cardinality
    fields put thousands of atomics on a few rows there. fm_score runs with L2
    warm, as in the step; fm_score_bwd with L2 flushed and, need_dx off,
    warm (as in the step), then flushed once more on the same batch with
    the numeric fields' slots at x = 0 ("train_no_numeric"), which
    leaves the Zipf-spread categorical rows and takes the hottest rows
    away. Rows are tagged ``tag`` (and ``tag + "_no_numeric"``).
    ``numeric``: the numeric features' rows (default: their hashed ids;
    in admit mode, the rows the slot map gives them). Returns (forward
    rows, backward rows)."""
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.ops.interaction import gather_rows
    if "uniq_ids" in args:
        uniq, local = args["uniq_ids"], args["local_idx"]
    else:
        uniq, local = port_fm._device_dedup(spec, args["local_idx"])
    raw_idx = uniq[local.long()]
    rows = gather_rows(table, uniq).requires_grad_(True)
    loss, scores = port_fm.loss_and_scores(
        spec, rows, args["labels"], args["weights"], uniq, local,
        args["vals"])
    (g,) = torch.autograd.grad(loss, scores)
    rows, g = rows.detach(), g.detach()
    fwd = [fwd_kernel_row(torch, rows, local, args["vals"], None,
                          batch=tag)]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    bwd = bwd_kernel_rows(torch, rows, local, args["vals"], g, flush,
                          batch=tag)
    bwd += bwd_kernel_rows(torch, rows, local, args["vals"], g, None,
                           need_dx_cases=(False,), batch=tag)
    if numeric is None:
        numeric = numeric_ids(spec.vocabulary_size)
    numeric = torch.isin(raw_idx, torch.tensor(
        numeric, dtype=raw_idx.dtype, device=device))
    check(bool(numeric.any()), "the train batch has no numeric slot")
    no_numeric = args["vals"].masked_fill(numeric, 0.0)
    bwd += bwd_kernel_rows(torch, rows, local, no_numeric, g, flush,
                           need_dx_cases=(False,),
                           batch=tag + "_no_numeric")
    del flush
    return fwd, bwd


def reference_scores(table_cpu, cfg, lines):
    """float64 numpy FM scores through sigmoid for ``lines``."""
    import numpy as np
    from fast_tffm_tpu_torch.data.parser import parse_lines
    block = parse_lines(lines, cfg.vocabulary_size, hash_feature_id=True,
                        max_features_per_example=cfg.max_features_per_example,
                        keep_empty=True)
    out = []
    for e in range(block.batch_size):
        lo, hi = block.poses[e], block.poses[e + 1]
        rows = table_cpu[block.ids[lo:hi]].astype(np.float64)
        x = block.vals[lo:hi].astype(np.float64)
        z = rows[:, :-1] * x[:, None]
        s = z.sum(0)
        raw = rows[:, -1] @ x + 0.5 * (s @ s - (z * z).sum())
        out.append(1.0 / (1.0 + np.exp(-raw)))
    return np.asarray(out)


def predict_phase(torch, cfg, cfg_path, table_cpu, lines, device, card):
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.predict import load_table
    t0 = time.perf_counter()
    table, step = load_table(cfg, device, with_step=True)
    load_s = time.perf_counter() - t0
    check(step == SERVE_STEP and torch.equal(
        table[:512].cpu(), torch.from_numpy(table_cpu[:512])),
          f"predict loaded step {step}, not step {SERVE_STEP}'s table")
    del table
    fm_kernel.launches = 0
    metrics_path = os.path.join(WORK, "predict.metrics.jsonl")
    t0 = time.perf_counter()
    with env_vars(FM_METRICS_FILE=metrics_path):
        rc = cli(["predict", cfg_path, "--device", device.type])
    total_s = time.perf_counter() - t0
    launches = fm_kernel.launches
    check(rc == 0, f"predict entry point returned {rc}")
    stream = stream_summary(metrics_path)
    want = {"predict/examples": len(lines), "pipeline/examples": len(lines),
            "predict/batches": launches}
    got = {k: stream["counters"].get(k) for k in want}
    check(got == want and stream["last_event"] == "run_end"
          and not stream["health"] and not stream["crashes"],
          f"predict's stream: {got} (want {want}), {stream}")
    with open(os.path.join(cfg.score_path, "criteo.txt.score")) as fh:
        score_lines = fh.read().splitlines(keepends=True)
    check(len(score_lines) == len(lines),
          f"{len(score_lines)} scores for {len(lines)} lines")
    scores = np.array([float(s) for s in score_lines])
    check(np.isfinite(scores).all() and (scores >= 0).all()
          and (scores <= 1).all(), "predict scores outside [0, 1]")
    ref = reference_scores(table_cpu, cfg, lines[:512])
    ref_err = float(np.abs(scores[:512] - ref).max())
    # %.6f rounds by up to 5e-7; f32 against f64 adds well under 1e-6.
    check(ref_err <= 2e-6, f"predict vs float64 reference: {ref_err}")
    check(launches == -(-len(lines) // PREDICT_BATCH),
          f"predict launched the kernel {launches} times")
    row = {"phase": "predict", "card": card, "lines": len(lines),
           "batch_size": PREDICT_BATCH, "entry_seconds": total_s,
           "table_load_seconds": load_s, "checkpoint_step": step,
           "examples_per_s_end_to_end": len(lines) / total_s,
           "examples_per_s_after_load": len(lines) / (total_s - load_s),
           "launches": launches, "max_err_vs_float64_reference": ref_err,
           "score_std": float(scores.std()), "stream_counters": got}
    emit(row)
    return row, score_lines


class env_vars:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stream_summary(path):
    """The last run of a metrics stream: its last metrics event's
    counters and gauges, its health statuses and crash events, and its
    last event."""
    from fast_tffm_tpu_torch.obs.sink import read_events
    run = []
    for e in read_events(path):
        if e["event"] == "run_start":
            run = []
        run.append(e)
    metrics = [e for e in run if e["event"] == "metrics"]
    return {"counters": metrics[-1]["counters"] if metrics else {},
            "gauges": metrics[-1]["gauges"] if metrics else {},
            "health": [e.get("status") for e in run
                       if e["event"] == "health"],
            "crashes": [e.get("error") for e in run if e["event"] == "crash"],
            "last_event": run[-1]["event"] if run else None}


def get_text(port, path, timeout=60):
    """(status, content type, body) of one GET."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return (resp.status, resp.headers["Content-Type"],
                resp.read().decode())


def post(port, body, timeout=120):
    """(status, body, X-FM-Step) of one POST /score."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers["X-FM-Step"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), None


def healthz(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as resp:
        return json.loads(resp.read())


def serve_phase(torch, cfg, lines, score_lines, device, card):
    """The ``serve`` entry point (``run_serve``, in process, on the main
    thread) with ``FM_METRICS_FILE`` and ``FM_SERVE_PORT`` set: once it
    is ready, concurrent requests whose bodies must equal the predict
    file's lines, one malformed request, /healthz and GET /metrics
    (Prometheus text, its request counter equal to the requests sent);
    then SIGTERM, after which the serve stream must end with run_end."""
    import signal
    import numpy as np
    from fast_tffm_tpu_torch.config import apply_env_overrides
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.serve.frontend import run_serve
    metrics_path = os.path.join(WORK, "serve.metrics.jsonl")
    port = free_port_block(1)
    with env_vars(FM_METRICS_FILE=metrics_path, FM_SERVE_PORT=str(port)):
        serve_cfg = apply_env_overrides(cfg)
    rng = np.random.default_rng(SEED + 2)
    sizes = [1, SERVE_MAX_BATCH] + [int(n) for n in
                                    rng.integers(1, SERVE_MAX_BATCH + 1, 46)]
    spans = [(int(rng.integers(0, len(lines) - n + 1)), n) for n in sizes]
    results = [None] * len(spans)
    latencies = [None] * len(spans)
    n_clients = 8
    out = {}
    done = threading.Event()  # run_serve returned

    def client(k):
        for i in range(k, len(spans), n_clients):
            lo, n = spans[i]
            t = time.perf_counter()
            results[i] = post(port, "\n".join(lines[lo:lo + n]) + "\n")
            latencies[i] = (time.perf_counter() - t) * 1e3

    def drive():
        """Wait until ready, send the requests and read the endpoints;
        then SIGTERM this process (run_serve's handler drains)."""
        try:
            deadline = time.monotonic() + 300
            health = None
            while not done.is_set() and time.monotonic() < deadline:
                try:
                    health = healthz(port)
                    if health["ready"]:
                        break
                except OSError:
                    pass
                time.sleep(0.05)
            check(health is not None and health["ready"],
                  f"serve not ready: {health}")
            out["startup_s"] = time.perf_counter() - t0
            out["warm_launches"] = fm_kernel.launches
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_clients)]
            for th in threads:
                th.start()
            out["bad"] = post(port, lines[0] + "\n1 I1:x:y:z\n")
            for th in threads:
                th.join(timeout=300)
                check(not th.is_alive(), "a serve client hung")
            out["health"] = healthz(port)
            out["metrics"] = get_text(port, "/metrics")
        except BaseException as e:  # raised on the main thread below
            out["error"] = e
        finally:
            if not done.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    # A SIGTERM landing before run_serve installs its handler (a failed
    # startup) must not kill the script.
    prev = signal.signal(signal.SIGTERM, lambda *_: None)
    fm_kernel.launches = 0
    t0 = time.perf_counter()
    requester = threading.Thread(target=drive, name="smoke-serve-client",
                                 daemon=True)
    requester.start()
    try:
        rc = run_serve(serve_cfg, device=device.type)
    finally:
        done.set()
        requester.join(timeout=600)
        signal.signal(signal.SIGTERM, prev)
    run_s = time.perf_counter() - t0
    if "error" in out:
        raise out["error"]
    check(rc == 0, f"serve entry point returned {rc}")
    for (lo, n), (status, body, step) in zip(spans, results):
        check(status == 200, f"serve answered {status}: {body[:200]}")
        check(body == "".join(score_lines[lo:lo + n]).encode(),
              f"serve body for lines [{lo}, {lo + n}) differs from "
              "the predict file")
        check(step == str(SERVE_STEP),
              f"X-FM-Step {step}, not the published {SERVE_STEP}")
    bad_status = out["bad"][0]
    check(bad_status == 400, f"malformed request answered {bad_status}")
    health = out["health"]
    check(health["alive"] and health["ready"]
          and health["requests"] == len(spans)
          and health["served_step"] == SERVE_STEP
          and health["flush_errors"] == 0, f"/healthz: {health}")
    m_status, m_type, m_body = out["metrics"]
    prom = {ln.split()[0]: float(ln.split()[1])
            for ln in m_body.splitlines() if ln and not ln.startswith("#")}
    check(m_status == 200 and m_type.startswith("text/plain; version=0.0.4")
          and prom.get("fm_serve_requests") == len(spans)
          and prom.get("fm_serve_request_latency_ms_count") == len(spans),
          f"GET /metrics: {m_status} {m_type}, fm_serve_requests "
          f"{prom.get('fm_serve_requests')} for {len(spans)} requests")
    stream = stream_summary(metrics_path)
    check(stream["last_event"] == "run_end" and not stream["crashes"]
          and stream["counters"].get("serve/requests") == len(spans),
          f"serve stream after SIGTERM: {stream}")
    launches = fm_kernel.launches
    warm_launches = out["warm_launches"]
    check(launches > warm_launches > 0,
          f"serve launches: {warm_launches} at warmup, {launches} after "
          "the requests")
    lat = sorted(latencies)
    row = {"phase": "serve", "card": card, "requests": len(spans),
           "clients": n_clients, "served_step": health["served_step"],
           "lines": sum(sizes), "startup_seconds": out["startup_s"],
           "entry_seconds": run_s,
           "warmup_launches": warm_launches,
           "request_launches": launches - warm_launches,
           "launches": launches, "flushes": health["flushes"],
           "round_trip_ms_median": lat[len(lat) // 2],
           "round_trip_ms_max": lat[-1], "malformed_status": bad_status,
           "server_p50_ms": health["latency_p50_ms"],
           "server_p99_ms": health["latency_p99_ms"],
           "metrics_requests": prom.get("fm_serve_requests"),
           "metrics_lines": len(m_body.splitlines()),
           "stream_requests": stream["counters"].get("serve/requests"),
           "stream_last_event": stream["last_event"]}
    emit(row)
    return row


def write_train_cfg(wd, epochs, dedup="auto", save_steps=SAVE_STEPS,
                    leg=None, model="", train="", files="",
                    vocab=VOCAB, factors=FACTORS):
    """A train config over ``wd``'s ``{files}train.txt`` and
    ``{files}val.txt``; ``dedup = host`` or a ``leg`` name gets a model
    directory and log of its own; ``model`` and ``train`` are extra
    [General] and [Train] lines."""
    tag = (f"_{leg}" if leg else "") + (
        "" if dedup == "auto" else f"_{dedup}")
    path = os.path.join(wd, f"train{epochs}{tag}.cfg")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {vocab}
hash_feature_id = True
factor_num = {factors}
model_file = {os.path.join(wd, 'model' + tag, 'fm_model')}
log_file = {os.path.join(wd, f'train{tag}.log')}
dedup = {dedup}
{model}
[Train]
train_files = {os.path.join(wd, files + 'train.txt')}
validation_files = {os.path.join(wd, files + 'val.txt')}
epoch_num = {epochs}
batch_size = {TRAIN_BATCH}
learning_rate = {TRAIN_LR}
loss_type = logistic
log_steps = 1
save_steps = {save_steps}
{train}
[Predict]
predict_files = {os.path.join(wd, files + 'val.txt')}
score_path = {os.path.join(wd, 'score' + tag)}

[Serve]
serve_port = 0
serve_max_batch = {SERVE_MAX_BATCH}
serve_max_wait_ms = 2
serve_poll_seconds = {RELOAD_POLL_SECONDS}
""")
    return path


def read_train_log(path):
    """(per-epoch step losses, per-step examples/s, validation AUCs, each
    run's 'training done' (steps, examples/s)) from the train log."""
    import re
    with open(path) as fh:
        text = fh.read()
    losses, rates = {}, []
    for ep, loss, eps in re.findall(
            r"step \d+ epoch (\d+) loss ([0-9.]+) examples/sec ([0-9.]+)",
            text):
        losses.setdefault(int(ep), []).append(float(loss))
        rates.append(float(eps))
    aucs = [float(a) for a in re.findall(
        r"epoch \d+ validation AUC ([0-9.]+) over", text)]
    done = re.findall(r"training done: (\d+) steps, final loss [0-9.]+, "
                      r"([0-9.]+) examples/sec", text)
    return losses, rates, aucs, [(int(n), float(e)) for n, e in done]


KERNEL_NAMES = ("fm_score_kernel", "fm_score_bwd_kernel")

# Run A's telemetry: the stream, spans, the watchdog, the pressure alarm
# (the 2.28 GB of table and accumulator are ~2.7% of an 80 GB card, so
# exactly one hbm_pressure event), and a profiler window of 3 steps
# after step 5.
RUN_A_TELEMETRY = """metrics_file = {wd}/run_a.metrics.jsonl
metrics_flush_steps = 4
trace_spans = true
watchdog_stall_seconds = 120
mem_pressure_fraction = 0.02
profile_dir = {wd}/run_a_profile
profile_start_step = 5
profile_num_steps = 3
"""
TELEMETRY_STEPS = 30              # steps of each arm of the in-process
TELEMETRY_ROUNDS = 4              # telemetry check, its rounds in turns
PREFLIGHT_VOCAB = 1 << 32         # a plan far beyond the card (~584 GB)


def step_kernel_ms(torch, step, names=KERNEL_NAMES):
    """Device ms per step of each kernel, from a torch.profiler trace of
    ``step(i)`` for i < PROFILED_STEPS. The profiler now and then returns
    a trace without some records of the kernels launched through ctypes
    (one launch each step): their time per step is then the mean of the
    records it holds, and a trace holding fewer than half of them is
    taken again, up to PROFILE_ATTEMPTS times in all; None means not
    measured. Returns (kernel ms or None, the launches of each of
    ``names`` — the hand-written kernels the step runs, none for FFM and
    order 3 — the trace held)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(PROFILED_STEPS):
                step(i)
            torch.cuda.synchronize()
        kernel_ms, counts = {}, dict.fromkeys(names, 0)
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                ours = [n for n in names if n in e.key]
                kernel_ms[e.key] = us / 1e3 / (
                    e.count if ours else PROFILED_STEPS)
                for name in ours:
                    counts[name] += e.count
        if all(PROFILED_STEPS // 2 <= counts[n] <= PROFILED_STEPS
               for n in names):
            return kernel_ms, counts
    return None, counts


def resident_step_ms(torch, cfg, device, tag="train", kernel_rows=True):
    """One train step (dedup -> gather -> forward -> backward -> Adagrad;
    with ``dedup = host`` the batches come deduped) on batches of the
    train stream already on the card: the median
    CUDA-event time of train_step_body and, from a torch.profiler trace
    of PROFILED_STEPS more steps, the device time per step by kernel
    (step_kernel_ms).
    Event intervals include the gaps in which the card waits for the
    host to launch the next kernel; the profiler's kernel times do not.
    Also both kernels against their plain versions on the first of these
    batches (train_batch_kernel_rows, rows tagged ``tag``), unless
    ``kernel_rows`` is off (FFM and order 3 run no hand-written kernel);
    returns (timings, forward rows, backward rows)."""
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models import fm as port_fm
    spec = port_fm.ModelSpec.from_config(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    table = port_fm.init_table(cfg, device, gen)
    acc = port_fm.init_accumulator(cfg, device)
    batches = []
    it = batch_iterator(cfg, cfg.train_files, training=True, epochs=1,
                        raw_ids=spec.dedup == "device")
    try:
        for b in it:
            batches.append(port_fm.batch_args(b, device))
            if len(batches) == RESIDENT_BATCHES:
                break
    finally:
        it.close()
    fwd_rows, bwd_rows = ([], []) if not kernel_rows else \
        train_batch_kernel_rows(torch, spec, table, batches[0], device, tag)

    whole = []
    for i in range(RESIDENT_STEPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        port_fm.train_step_body(spec, table, acc,
                                **batches[i % len(batches)])
        end.record()
        end.synchronize()
        if i >= 2:  # the first two are warmup
            whole.append(start.elapsed_time(end))

    per_kernel, counts = step_kernel_ms(
        torch, lambda i: port_fm.train_step_body(
            spec, table, acc, **batches[i % len(batches)]),
        names=KERNEL_NAMES if kernel_rows else ())
    top = (None if per_kernel is None else
           dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]))
    device_ms = None if per_kernel is None else sum(per_kernel.values())
    del table, acc, batches
    torch.cuda.empty_cache()
    return {"resident_step_ms_median": sorted(whole)[len(whole) // 2],
            "profiled_device_ms_per_step": device_ms,
            "profiled_kernels_ms_per_step": top,
            "profiled_kernel_count":
                None if per_kernel is None else len(per_kernel),
            "profiled_kernel_launches_seen": counts}, \
        fwd_rows, bwd_rows


def write_train_data():
    """The train phase's Criteo-shaped lines with planted labels, written
    to ``WORK/train``: TRAIN_LINES to train.txt, VAL_LINES to val.txt.
    Returns (directory, validation lines, their planted logits, the
    seconds it took)."""
    wd = os.path.join(WORK, "train")
    os.makedirs(wd)
    t0 = time.perf_counter()
    model = planted_model(SEED + 4)
    train_lines, _ = criteo_lines(TRAIN_LINES, SEED + 5, model)
    val_lines, val_logits = criteo_lines(VAL_LINES, SEED + 6, model)
    for name, lines in (("train.txt", train_lines), ("val.txt", val_lines)):
        with open(os.path.join(wd, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return wd, val_lines, val_logits, time.perf_counter() - t0


def train_phase(torch, device, card, data):
    """``python -m fast_tffm_tpu_torch train`` (in process) at config
    #2's width on Criteo-shaped lines with planted labels (``data``, from
    write_train_data), one epoch (run A) with a periodic save at step 8;
    then ``fmckpt`` over it, and predict of the newest step over the
    validation lines."""
    import dataclasses
    import io
    import re
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.metrics import exact_auc
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.tools import fmckpt
    wd, val_lines, val_logits, gen_s = data
    val_labels = np.array([int(ln.split(" ", 1)[0]) for ln in val_lines])
    # The planted model's own AUC on the validation lines is the best any
    # model can reach; the trained model must recover at least half of
    # its margin over chance.
    bayes_auc = exact_auc(val_logits, val_labels)
    auc_floor = 0.5 + 0.5 * (bayes_auc - 0.5)
    cfg_path = write_train_cfg(wd, 1, train=RUN_A_TELEMETRY.format(wd=wd))
    cfg = load_config(cfg_path)

    fm_kernel.launches = 0
    fm_kernel.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    with CheckpointTimes() as times:
        t0 = time.perf_counter()
        rc = cli(["train", cfg_path])
        train_s = time.perf_counter() - t0
        check(rc == 0, f"train entry point ({cfg_path}) returned {rc}")
    fwd_launches, bwd_launches = fm_kernel.launches, fm_kernel.bwd_launches
    run_peak_bytes = torch.cuda.max_memory_allocated(device)
    with open(cfg.log_file) as fh:
        log = fh.read()
    plane = [int(n) for n in re.findall(
        r"host data plane: (\d+) parallel batch-build workers", log)]
    losses, rates, aucs, done = read_train_log(cfg.log_file)
    steps = -(-TRAIN_LINES // TRAIN_BATCH)
    check([n for n, _ in done] == [steps],
          f"the run ended at steps {done}, not {steps}")
    val_batches = -(-VAL_LINES // TRAIN_BATCH)
    check(bwd_launches == steps and fwd_launches == steps + val_batches,
          f"train launched fm_score {fwd_launches} and fm_score_bwd "
          f"{bwd_launches} times for {steps} steps and {val_batches} "
          "validation batches")
    check(sorted(losses) == [0] and len(rates) == steps
          and np.isfinite(losses[0]).all(),
          f"train log losses: {losses}, {len(rates)} rates")
    half = steps // 2
    half_loss = [float(np.mean(losses[0][:half])),
                 float(np.mean(losses[0][half:]))]
    check(half_loss[-1] < half_loss[0],
          f"mean loss did not fall over the epoch: {half_loss}")
    check(len(aucs) == 1 and aucs[-1] > auc_floor,
          f"validation AUC {aucs} not above {auc_floor} (planted model's "
          f"AUC {bayes_auc})")
    t0 = time.perf_counter()
    run_a_telemetry = run_a_stream_checks(cfg, steps, run_peak_bytes, card)
    run_a_telemetry["check_seconds"] = time.perf_counter() - t0

    # The checkpoint directory as the operator's tool shows it: the
    # final save at 16 writes the epoch override onto the periodic save.
    directory = cfg.model_file + ".ckpt"
    state = fmckpt.scan(directory)
    check([s["step"] for s in state["steps"]] == list(SERVED_STEPS)
          and [s["epoch"] for s in state["steps"]] == [0, 1]
          and not state["orphans"] and not state["quarantined"],
          f"fmckpt ls: {state}")
    ls_out, verify_out = io.StringIO(), io.StringIO()
    fmckpt.cmd_ls(directory, out=ls_out)
    t0 = time.perf_counter()
    rc = fmckpt.cmd_verify(directory, mode="full", out=verify_out)
    verify_s = time.perf_counter() - t0
    print(ls_out.getvalue() + verify_out.getvalue(), end="", flush=True)
    check(rc == 0 and verify_out.getvalue().count(": OK (full check")
          == len(SERVED_STEPS),
          f"fmckpt verify --mode full: {verify_out.getvalue()}")
    commits = committed_steps_in_log(cfg.log_file)
    check([c["step"] for c in commits] == list(SERVED_STEPS),
          f"committed steps in the log: {commits}")

    fm_kernel.launches = 0
    t0 = time.perf_counter()
    rc = cli(["predict", cfg_path])
    predict_s = time.perf_counter() - t0
    predict_launches = fm_kernel.launches
    check(rc == 0, f"predict of the trained model returned {rc}")
    with open(os.path.join(cfg.score_path, "val.txt.score")) as fh:
        scores = np.array([float(x) for x in fh.read().split()])
    check(scores.shape == (VAL_LINES,) and np.isfinite(scores).all(),
          f"{scores.shape} predict scores for {VAL_LINES} lines")
    predict_auc = exact_auc(scores, val_labels)
    check(abs(predict_auc - aucs[-1]) <= AUC_GAP,
          f"predict's exact AUC {predict_auc} vs train's binned AUC "
          f"{aucs[-1]}")

    resident, fwd_rows, bwd_rows = resident_step_ms(torch, cfg, device)
    step_ms = resident["resident_step_ms_median"]
    busy_ms = resident["profiled_device_ms_per_step"]
    # log_steps = 1: each logged rate covers one step's window, so the
    # loop's rate is the examples over the sum of the windows (the
    # periodic saves' pauses fall inside them).
    loop_eps = steps * TRAIN_BATCH / sum(TRAIN_BATCH / r for r in rates)
    examples = TRAIN_LINES
    periodic = [t for t in times.saves if not t["wait"]]
    final = [t for t in times.saves if t["wait"]]
    row = {"phase": "train", "card": card, "lines": TRAIN_LINES,
           "validation_lines": VAL_LINES, "batch_size": TRAIN_BATCH,
           "epochs": 1, "steps": steps,
           "learning_rate": TRAIN_LR, "save_steps": SAVE_STEPS,
           "generate_seconds": gen_s, "entry_seconds": train_s,
           "examples_per_s_end_to_end": examples / train_s,
           "examples_per_s_train_log": [e for _, e in done],
           "examples_per_s_loop": loop_eps,
           "epoch_mean_loss": [float(np.mean(losses[0]))],
           "half_epoch_mean_loss": half_loss, "validation_auc": aucs,
           "planted_auc": bayes_auc, "auc_floor": auc_floor,
           "predict_exact_auc": predict_auc,
           "predict_entry_seconds": predict_s,
           "fm_score_launches": fwd_launches,
           "fm_score_bwd_launches": bwd_launches,
           "predict_launches": predict_launches,
           "checkpoint_steps": [s["step"] for s in state["steps"]],
           "periodic_save_pause_seconds": [t["seconds"] for t in periodic],
           "periodic_save_steps": [t["step"] for t in periodic],
           "final_save_seconds": [t["seconds"] for t in final],
           "final_save_steps": [t["step"] for t in final],
           "restore_seconds": [t["seconds"] for t in times.restores],
           "restored_steps": [t["step"] for t in times.restores],
           "checkpoint_commits": commits,
           "fmckpt_verify_full_seconds": verify_s,
           "host_data_plane_workers": plane,
           "telemetry": run_a_telemetry,
           **resident,
           # Idle share of the card while the loop runs, from the
           # resident step time and the loop's rate, and over the train
           # command (validation, saves and export included); then
           # the same from the profiler's kernel time per step.
           "device_idle_share_loop":
               1.0 - step_ms / 1e3 * loop_eps / TRAIN_BATCH,
           "device_idle_share_end_to_end":
               1.0 - steps * step_ms / 1e3 / train_s,
           "device_idle_share_loop_profiled":
               (None if busy_ms is None
                else 1.0 - busy_ms / 1e3 * loop_eps / TRAIN_BATCH)}
    emit(row)
    # The later phases over run A's steps write no stream of their own.
    quiet = dataclasses.replace(
        cfg, metrics_file="", trace_spans=False, watchdog_stall_seconds=0.0,
        mem_pressure_fraction=0.0, profile_dir="")
    return row, fwd_rows, bwd_rows, quiet, val_lines


def run_a_stream_checks(cfg, steps, run_peak_bytes, card):
    """Run A's telemetry: its stream's counters against the steps and
    lines it trained, the checkpoint counters against its saves, its
    spans within the loop's wall time, no stall, non-finite loss or crash
    and a closing run_end, exactly one hbm_pressure event, the ledger's
    table and accumulator bytes, the plan within 10% of the ledger, the
    ledger under the card's peak allocation, and the profiler window's
    kernel launches. Prints one line; returns its figures."""
    from fast_tffm_tpu_torch.obs import memory as obs_memory
    from fast_tffm_tpu_torch.obs.sink import read_events
    from fast_tffm_tpu_torch.testing.telemetry import trace_kernel_counts
    runs = []
    for e in read_events(cfg.metrics_file):
        if e["event"] == "run_start":
            runs.append([])
        runs[-1].append(e)
    check(runs and runs[0][0]["meta"]["kind"] == "train",
          f"run A's stream starts with {runs and runs[0][0]}")
    events = runs[0]  # the predict of the trained model appends its own
    metrics = [e for e in events if e["event"] == "metrics"]
    c = metrics[-1]["counters"]
    want = {"train/steps": steps, "train/examples": TRAIN_LINES,
            "pipeline/examples": TRAIN_LINES + VAL_LINES,
            "checkpoint/saves": len(SERVED_STEPS),
            "train/checkpoints": len(SERVED_STEPS), "train/epochs": 1}
    got = {k: c.get(k) for k in want}
    check(got == want, f"run A's counters {got}, not {want}")
    health = [e.get("status") for e in events if e["event"] == "health"]
    crashes = [e for e in events if e["event"] == "crash"]
    check(health == ["hbm_pressure"] and not crashes
          and events[-1]["event"] == "run_end",
          f"run A's health events {health}, {len(crashes)} crash events, "
          f"last event {events[-1]['event']}")
    pressure = next(e for e in events if e.get("status") == "hbm_pressure")
    spans = {}
    for e in events:
        if e["event"] == "span" and e["name"] in ("train/step", "train/h2d"):
            spans.setdefault(e["name"], []).append(e)
    both = spans.get("train/step", []) + spans.get("train/h2d", [])
    wall = (max(e["ts"] + e["dur"] for e in both)
            - min(e["ts"] for e in both)) if both else 0.0
    span_sum = sum(e["dur"] for e in both)
    check([len(spans.get(n, [])) for n in ("train/step", "train/h2d")]
          == [steps, steps] and span_sum <= wall,
          f"run A's spans: {[len(v) for v in spans.values()]} for {steps} "
          f"steps, {span_sum}s summed over {wall}s of loop wall time")
    gauges = [m["gauges"] for m in metrics]
    state = max(g.get("mem/table_bytes", 0) + g.get("mem/adagrad_acc_bytes",
                                                    0) for g in gauges)
    live = max(g.get("mem/live_bytes", 0) for g in gauges)
    plan = obs_memory.plan(cfg, "train")["total_bytes"]
    check(state == 2 * cfg.num_rows * cfg.row_dim * 4 == 2 * 1140850756,
          f"the ledger's table + adagrad_acc: {state} bytes")
    check(abs(plan - live) <= 0.10 * live,
          f"plan {plan} bytes against the ledger's live {live}")
    check(live <= run_peak_bytes,
          f"the ledger's {live} bytes above the card's peak allocation "
          f"{run_peak_bytes} over the run")
    traces = os.listdir(cfg.profile_dir)
    check(len(traces) == 1, f"profile_dir holds {traces}")
    counts = trace_kernel_counts(os.path.join(cfg.profile_dir, traces[0]))
    window = cfg.profile_num_steps
    check(counts == dict.fromkeys(KERNEL_NAMES, window),
          f"the profiler window's trace holds {counts} kernel events for "
          f"{window} steps")
    out = {"counters": got, "health": health, "spans": {
        k: len(v) for k, v in spans.items()}, "span_seconds": span_sum,
        "span_wall_seconds": wall, "ledger_state_bytes": state,
        "ledger_live_bytes": live, "plan_bytes": plan,
        "run_peak_allocated_bytes": run_peak_bytes,
        "hbm_pressure": {k: pressure[k] for k in ("live_bytes",
                                                  "capacity_bytes",
                                                  "fraction")},
        "profile_trace": traces[0], "profile_kernel_events": counts,
        "metrics_events": len(metrics), "events": len(events)}
    print(f"train telemetry: {card}; steps {got['train/steps']}, examples "
          f"{got['train/examples']}, pipeline examples "
          f"{got['pipeline/examples']}, saves {got['checkpoint/saves']}; "
          f"spans {span_sum:.3f}s of {wall:.3f}s; one hbm_pressure at "
          f"{pressure['fraction']}; ledger {state} B state, {live} B live, "
          f"plan {plan} B, card peak {run_peak_bytes} B; profiler window "
          f"{counts}", flush=True)
    return out


def telemetry_phase(torch, device, card, cfg):
    """In process, on resident batches of run A's data: the same train
    steps of config #2 with the run's telemetry off and on (their step ms
    and spread, and their synchronizations, which must be equal); an
    allocation beyond the card's free memory under ``oom_guard`` while
    config #2's table and accumulator are held (``HbmExhaustedError``
    naming them, the allocator usable after); and the capacity pre-flight
    refusing a config whose plan exceeds the card, before any
    allocation."""
    import dataclasses
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.obs import memory as obs_memory
    from fast_tffm_tpu_torch.testing import telemetry as probe
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, mem_pressure_fraction=0.02)
    batches = []
    it = batch_iterator(cfg, cfg.train_files, training=True, epochs=1)
    try:
        for b in it:
            batches.append(b)
            if len(batches) == RESIDENT_BATCHES:
                break
    finally:
        it.close()
    wd = os.path.join(WORK, "telemetry")
    os.makedirs(wd)
    steps = probe.telemetry_steps(cfg, device, batches, TELEMETRY_STEPS,
                                  rounds=TELEMETRY_ROUNDS, workdir=wd)
    check(steps["off"]["syncs"] == steps["on"]["syncs"]
          and len(set(steps["on"]["syncs"])) == 1,
          f"synchronizations of {TELEMETRY_STEPS} steps: telemetry off "
          f"{steps['off']['syncs']}, on {steps['on']['syncs']}")
    steps_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    table = port_fm.init_table(cfg, device, gen)
    acc = port_fm.init_accumulator(cfg, device)
    obs_memory.bind_device(device)
    obs_memory.LEDGER.register("table", table.nbytes)
    obs_memory.LEDGER.register("adagrad_acc", acc.nbytes)
    try:
        oom = probe.oom_wrap(device)
    finally:
        obs_memory.LEDGER.release("table")
        obs_memory.LEDGER.release("adagrad_acc")
        del table, acc
        torch.cuda.empty_cache()
    check(oom["cause"] == "OutOfMemoryError" and oom["names_owners"]
          and oom["owners"] == ["adagrad_acc", "table"]
          and oom["allocator_usable"], f"oom_guard on the card: {oom}")
    pre = probe.preflight_refusal(device, vocabulary_size=PREFLIGHT_VOCAB,
                                  factor_num=FACTORS)
    check(pre["refused"] and pre["verdict"] == "EXCEEDS"
          and pre["allocated_after"] == pre["allocated_before"],
          f"pre-flight on a {pre['plan_bytes']}-byte plan: {pre}")
    row = {"phase": "telemetry", "card": card, "steps": TELEMETRY_STEPS,
           "rounds": TELEMETRY_ROUNDS, "batch_size": TRAIN_BATCH,
           "step_ms_off": steps["off"]["ms"],
           "step_ms_on": steps["on"]["ms"],
           "step_ms_median_off": steps["off"]["median_ms"],
           "step_ms_median_on": steps["on"]["median_ms"],
           "step_ms_spread_off": steps["off"]["spread_ms"],
           "step_ms_spread_on": steps["on"]["spread_ms"],
           "on_within_off_spread": (
               min(steps["off"]["ms"]) <= steps["on"]["median_ms"]
               <= max(steps["off"]["ms"])),
           "syncs_off": steps["off"]["syncs"],
           "syncs_on": steps["on"]["syncs"],
           "sync_sites_off": steps["off"]["sync_sites"],
           "sync_sites_on": steps["on"]["sync_sites"],
           "unrecorded_syncs": [steps[a]["unrecorded_syncs"]
                                for a in ("off", "on")],
           "barrier_syncs": steps["barrier_syncs"],
           "steps_seconds": steps_s, "oom": oom, "preflight": pre,
           "seconds": time.perf_counter() - t0}
    print(f"telemetry: {card}; {TELEMETRY_STEPS} steps x "
          f"{TELEMETRY_ROUNDS} rounds, step ms off {steps['off']['ms']} "
          f"on {steps['on']['ms']}; syncs off {steps['off']['syncs']} on "
          f"{steps['on']['syncs']}, barrier {steps['barrier_syncs']}; "
          f"oom_guard {oom['cause']} -> HbmExhaustedError naming "
          f"{oom['owners']}; pre-flight refused {pre['plan_bytes']} B > "
          f"{pre['capacity_bytes']} B; {row['seconds']:.2f}s", flush=True)
    emit(row)
    return row


def reload_phase(torch, cfg, lines, device, card):
    """Hot reload at full width: serve step 8, publish step 16 while
    client threads post, and hold every response to the predict lines of
    the step it names."""
    import dataclasses
    import numpy as np
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.predict import load_table, predict
    from fast_tffm_tpu_torch.serve.frontend import make_http_server
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    from fast_tffm_tpu_torch.tools import fmckpt
    old, new = (str(s) for s in SERVED_STEPS)
    fm_kernel.launches = 0
    expected, load_s = {}, {}
    for step in SERVED_STEPS:
        step_cfg = dataclasses.replace(
            cfg, score_path=os.path.join(WORK, f"reload{step}"))
        t0 = time.perf_counter()
        table = load_table(cfg, device, step=step)
        load_s[step] = time.perf_counter() - t0
        predict(step_cfg, table=table, device=device)
        del table
        with open(os.path.join(step_cfg.score_path, "val.txt.score")) as fh:
            expected[step] = fh.read().splitlines(keepends=True)
    torch.cuda.empty_cache()
    check(fmckpt.main(["publish", cfg.model_file, old]) == 0,
          f"fmckpt publish of step {old} failed")
    server = ScorerServer(cfg, device=device)
    httpd = make_http_server(server, 0)
    http_thread = threading.Thread(target=httpd.serve_forever,
                                   name="smoke-http", daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    results, lock = [], threading.Lock()
    swapped = threading.Event()
    failures = []

    def client(k):
        rng = np.random.default_rng(SEED + 10 + k)
        after_rounds = 0
        try:
            while after_rounds < RELOAD_ROUNDS:
                n = int(rng.integers(1, min(SERVE_MAX_BATCH,
                                            len(lines)) + 1))
                lo = int(rng.integers(0, len(lines) - n + 1))
                after = swapped.is_set()
                status, body, step = post(
                    port, "\n".join(lines[lo:lo + n]) + "\n")
                with lock:
                    results.append((lo, n, status, body, step, after))
                after_rounds += after
        except Exception as e:  # noqa: BLE001 - reported by the check
            failures.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(RELOAD_CLIENTS)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 120
        while len(results) < 4 * RELOAD_CLIENTS and \
                time.monotonic() < deadline and not failures:
            time.sleep(0.01)
        t_flip = time.perf_counter()
        check(fmckpt.main(["publish", cfg.model_file, new]) == 0,
              f"fmckpt publish of step {new} failed")
        while server.served_step != SERVED_STEPS[1] and time.monotonic() < deadline:
            time.sleep(0.005)
        flip_to_swap_s = time.perf_counter() - t_flip
        swapped.set()
        for th in threads:
            th.join(timeout=300)
            check(not th.is_alive(), "a reload client hung")
        health = healthz(port)
    finally:
        httpd.shutdown()
        http_thread.join(timeout=60)
        httpd.server_close()
        server.close()
    launches = fm_kernel.launches
    check(launches > 0, "the reload leg never launched fm_score")
    check(not failures, f"reload clients failed: {failures[:3]}")
    check(server.served_step == SERVED_STEPS[1],
          f"the server never swapped to step {new}")
    seen = {}
    for lo, n, status, body, step, after in results:
        check(status == 200, f"reload answered {status}: {body[:200]}")
        check(step in (old, new) and (step == new or not after),
              f"X-FM-Step {step} (sent after the swap: {after})")
        check(body == "".join(expected[int(step)][lo:lo + n]).encode(),
              f"body for lines [{lo}, {lo + n}) differs from step {step}'s "
              "predict lines")
        seen[step] = seen.get(step, 0) + 1
    check(set(seen) == {old, new}, f"responses by step: {seen}")
    check(health["reloads"] == 1 and health["reload_failures"] == 0
          and health["served_step"] == health["published_step"]
          == SERVED_STEPS[1]
          and health["flush_errors"] == 0, f"/healthz: {health}")
    row = {"phase": "reload", "card": card, "requests": len(results),
           "responses_by_step": seen, "clients": RELOAD_CLIENTS,
           "poll_seconds": RELOAD_POLL_SECONDS,
           "flip_to_swap_seconds": flip_to_swap_s,
           "table_load_seconds_by_step": load_s, "launches": launches,
           "reloads": health["reloads"],
           "reload_failures": health["reload_failures"],
           "server_p50_ms": health["latency_p50_ms"],
           "server_p99_ms": health["latency_p99_ms"]}
    emit(row)
    return row, expected


FLEET_REPLICAS = 3
FLEET_CLIENTS = 4
FLEET_HEALTH_POLL_SECONDS = 0.2
FLEET_RESTART_BACKOFF_SECONDS = 0.5
FLEET_ROUNDS = 40                 # responses before the kill, after the
#                                   respawn, and before the publish
FLEET_TIMEOUT = 300               # seconds for any one wait of the phase


def free_port_block(n):
    """A base port with ``n`` consecutive free loopback ports from it
    (each bound, then released), below the host's ephemeral range: a
    replica port inside it can be held for a minute by an outgoing
    connection's TIME_WAIT, so a killed replica's restart fails to bind
    until then."""
    import random
    import socket
    from fast_tffm_tpu_torch.serve.fleet import ephemeral_port_range
    rng = random.Random(os.getpid())
    top = min(ephemeral_port_range()[0], 32768)
    for _ in range(200):
        base = rng.randrange(10000, top - n)
        socks = []
        try:
            for port in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise SmokeFailure(f"no block of {n} free ports")


def post_proxy(port, body, timeout=120):
    """(status, body, X-FM-Step, X-FM-Replica) of one POST /score."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return (resp.status, resp.read(), resp.headers["X-FM-Step"],
                    resp.headers["X-FM-Replica"])
    except urllib.error.HTTPError as e:
        return e.code, e.read(), None, None


def wait_for(cond, what, timeout=FLEET_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.02)


def fleet_phase(train_cfg_path, lines, expected, serve_row, card):
    """``serve --replicas 3`` at config #2's width, in process: a
    FleetSupervisor on phase 7's model directory spawns three replica
    processes on the card behind its failover proxy. Step 8 published
    first; client threads post blocks of validation lines through the
    proxy; replica 1 is SIGKILLed mid-burst and must respawn; step 16 is
    published under load and reloaded replica by replica. Every response
    a 200 whose body equals the predict lines of its step. The fleet
    writes its telemetry (``metrics_file``): the supervisor's stream,
    flushed on each edge of the ready count, reads ``FLEET DEGRADED (2/3
    ready)`` in a snapshot taken across the kill and ``OK`` once drained,
    with the death counted once; each replica writes ``.r<i>``; the
    proxy answers ``GET /metrics``."""
    import signal
    import numpy as np
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.serve.fleet import FleetSupervisor
    from fast_tffm_tpu_torch.tools import fmckpt
    old, new = (str(s) for s in SERVED_STEPS)
    t_phase = time.perf_counter()
    base = free_port_block(FLEET_REPLICAS + 1)
    proxy_port = base + FLEET_REPLICAS
    cfg_path = os.path.join(os.path.dirname(train_cfg_path), "fleet.cfg")
    metrics = os.path.join(os.path.dirname(train_cfg_path),
                           "fleet.metrics.jsonl")
    with open(train_cfg_path) as fh:
        text = fh.read()
    check("serve_port = 0\n" in text and text.count("\n[Predict]") == 1,
          "the train config has no [Serve] or no [Predict]")
    text = text.replace("\n[Predict]", f"metrics_file = {metrics}\n\n"
                        "[Predict]")
    with open(cfg_path, "w") as fh:
        fh.write(text.replace("serve_port = 0\n", f"""serve_port = {base}
serve_proxy_port = {proxy_port}
serve_replicas = {FLEET_REPLICAS}
serve_health_poll_seconds = {FLEET_HEALTH_POLL_SECONDS}
serve_restart_backoff_seconds = {FLEET_RESTART_BACKOFF_SECONDS}
"""))
    cfg = load_config(cfg_path)
    check(fmckpt.main(["publish", cfg.model_file, old]) == 0,
          f"fmckpt publish of step {old} failed")
    results, lock, failures = [], threading.Lock(), []
    stop_clients, stop_sampling = threading.Event(), threading.Event()
    samples, clients, sampler = [], [], None

    def client(k):
        rng = np.random.default_rng(SEED + 60 + k)
        while not stop_clients.is_set():
            n = int(rng.integers(1, SERVE_MAX_BATCH + 1))
            lo = int(rng.integers(0, len(lines) - n + 1))
            t0 = time.perf_counter()
            try:
                out = post_proxy(proxy_port,
                                 "\n".join(lines[lo:lo + n]) + "\n")
            except Exception as e:  # noqa: BLE001 - reported by a check
                failures.append(repr(e))
                continue
            with lock:
                results.append((lo, n) + out
                               + ((time.perf_counter() - t0) * 1e3,))

    def sample():
        while not stop_sampling.is_set():
            try:
                samples.append(healthz_status(proxy_port))
            except Exception as e:  # noqa: BLE001 - reported by a check
                samples.append((repr(e), 0))
            time.sleep(0.01)

    def count():
        with lock:
            return len(results)

    sup = FleetSupervisor(cfg, cfg_path)
    t_spawn = time.perf_counter()
    ready_s = {}
    try:
        sup.start()

        def all_ready():
            for r in sup.replicas:
                if r.index not in ready_s and r.row.is_ready():
                    ready_s[r.index] = time.perf_counter() - t_spawn
            return len(ready_s) == FLEET_REPLICAS

        wait_for(all_ready, f"{FLEET_REPLICAS} ready replicas")
        prom = get_text(proxy_port, "/metrics")
        first = [r.probe(timeout=30) for r in sup.replicas]
        for i, h in enumerate(first):
            check(h is not None and h["device"] == "cuda:0"
                  and h["kernel"] == "cuda" and h["served_step"] == SERVED_STEPS[0],
                  f"replica {i} /healthz: {h}")
        clients = [threading.Thread(target=client, args=(k,),
                                    name=f"smoke-fleet-{k}")
                   for k in range(FLEET_CLIENTS)]
        for th in clients:
            th.start()
        wait_for(lambda: count() >= FLEET_ROUNDS, "the burst")
        victim = sup.replicas[1]
        old_pid = victim.pid()
        t_kill = time.perf_counter()
        os.kill(old_pid, signal.SIGKILL)
        degraded = f"FLEET DEGRADED ({FLEET_REPLICAS - 1}/{FLEET_REPLICAS} " \
            "ready)"
        wait_for(lambda: fleet_verdict(metrics) == degraded,
                 "the supervisor's flushed snapshot of the degraded fleet")
        t_degraded = time.perf_counter() - t_kill
        degraded_copy = metrics + ".degraded"
        shutil.copyfile(metrics, degraded_copy)
        wait_for(lambda: victim.pid() != old_pid, "the respawn")
        respawn_s = time.perf_counter() - t_kill
        wait_for(lambda: victim.row.is_ready()
                 and sup.wait_ready(FLEET_REPLICAS, 0.05),
                 f"{FLEET_REPLICAS} ready replicas after the kill")
        kill_to_ready_s = time.perf_counter() - t_kill
        mark = count()
        wait_for(lambda: count() >= mark + FLEET_ROUNDS,
                 "responses after the respawn")
        sampler = threading.Thread(target=sample, name="smoke-sampler")
        sampler.start()
        t_pub = time.perf_counter()
        check(fmckpt.main(["publish", cfg.model_file, new]) == 0,
              f"fmckpt publish of step {new} failed")

        def reloaded():
            rows = [r.probe(timeout=30) for r in sup.replicas]
            return all(h and h["served_step"] == SERVED_STEPS[1] and h["ready"]
                       for h in rows)

        wait_for(reloaded, f"every replica serving step {new}")
        stagger_s = time.perf_counter() - t_pub
        wait_for(lambda: any(r[4] == new for r in list(results)),
                 f"a response on step {new}")
        stop_clients.set()
        for th in clients:
            th.join(timeout=FLEET_TIMEOUT)
            check(not th.is_alive(), "a fleet client hung")
        stop_sampling.set()
        sampler.join(timeout=FLEET_TIMEOUT)
        # The stream closes on the health loop's last tick, which may
        # have caught the stagger's last replica mid-reload after the
        # probes above saw it back: drain once that loop counts the whole
        # fleet ready again.
        wait_for(lambda: sup.stats().get("fleet/ready") == FLEET_REPLICAS,
                 f"the supervisor's count of {FLEET_REPLICAS} ready "
                 "replicas after the reload")
        final = [r.probe(timeout=30) for r in sup.replicas]
        stats = sup.stats()
        pids = sup.pids()
    finally:
        stop_clients.set()
        stop_sampling.set()
        for th in clients + ([sampler] if sampler else []):
            th.join(timeout=FLEET_TIMEOUT)
        sup.stop()
    check(all(r.exited() for r in sup.replicas), "a replica outlived stop")
    # The fleet's telemetry, read by the port's readers.
    snap = read_shards([degraded_copy], degraded, "the fleet's snapshot "
                       "across the kill")
    final_stream = read_shards([metrics], "OK", "the fleet's final stream")
    check(final_stream["counters"].get("fleet/deaths") == 1
          and final_stream["counters"].get("fleet/restarts", 0) >= 1,
          f"the fleet stream's counters {final_stream['counters']}")
    check(all(os.path.isfile(f"{metrics}.r{i}")
              for i in range(FLEET_REPLICAS)),
          f"replica streams: {sorted(os.listdir(os.path.dirname(metrics)))}")
    status, ctype, body = prom
    check(status == 200 and ctype.startswith("text/plain; version=0.0.4")
          and f"fm_fleet_replicas {FLEET_REPLICAS}" in body,
          f"the proxy's GET /metrics: {status} {ctype} {body[:200]}")
    leaked = [t.name for t in threading.enumerate() if t.is_alive()
              and t.name.startswith(("fmt-fleet", "fmt-proxy"))]
    check(not leaked, f"fleet threads left after the drain: {leaked}")
    check(not failures, f"fleet clients failed: {failures[:3]}")
    check(victim.pid() != old_pid and pids[1] != old_pid,
          "replica 1 was never respawned")
    bad = [(s, r) for s, r in samples if s != 200 or r < 1]
    check(samples and not bad, f"proxy /healthz samples with no replica "
          f"ready during the reload: {bad[:5]}")
    by_step, by_replica = {}, {}
    for lo, n, status, body, step, replica, _ms in results:
        check(status == 200, f"the proxy answered {status}: {body[:200]}")
        check(step in (old, new), f"X-FM-Step {step}")
        check(body == "".join(expected[int(step)][lo:lo + n]).encode(),
              f"fleet body for lines [{lo}, {lo + n}) differs from step "
              f"{step}'s predict lines")
        by_step[step] = by_step.get(step, 0) + 1
        by_replica[replica] = by_replica.get(replica, 0) + 1
    check(set(by_step) == {old, new},
          f"responses by step: {by_step}")
    check(stats.get("fleet/deaths", 0) >= 1
          and stats.get("fleet/restarts", 0) >= 1
          and stats.get("fleet/reloads", 0) >= 2
          and stats.get("fleet/reload_failures", 0) == 0,
          f"fleet counters: {stats}")
    for i, h in enumerate(final):
        check(h is not None and h["device"] == "cuda:0"
              and h["kernel"] == "cuda" and h["flushes"] > 0
              and h["kernel_launches"] > 0 and h["flush_errors"] == 0
              and h["served_step"] == SERVED_STEPS[1],
              f"replica {i} /healthz: {h}")
    lat = np.array([r[-1] for r in results])
    retries = int(stats.get("proxy/retries", 0))
    row = {"phase": "fleet", "card": card, "replicas": FLEET_REPLICAS,
           "requests": len(results), "clients": FLEET_CLIENTS,
           "non_200": 0, "responses_by_step": by_step,
           "responses_by_replica": by_replica,
           "phase_seconds": time.perf_counter() - t_phase,
           "spawn_to_ready_seconds": [ready_s[i]
                                      for i in range(FLEET_REPLICAS)],
           "kill_to_respawn_seconds": respawn_s,
           "kill_to_ready_seconds": kill_to_ready_s,
           "stagger_seconds": stagger_s,
           "healthz_samples": len(samples),
           "min_ready_during_reload": min(r for _, r in samples),
           "proxied_p50_ms": float(np.percentile(lat, 50)),
           "proxied_p99_ms": float(np.percentile(lat, 99)),
           "single_server_round_trip_ms_median":
               serve_row["round_trip_ms_median"],
           "single_server_p50_ms": serve_row["server_p50_ms"],
           "single_server_p99_ms": serve_row["server_p99_ms"],
           "retries_absorbed": retries,
           "transport_errors": int(stats.get("proxy/transport_errors", 0)),
           "upstream_5xx": int(stats.get("proxy/upstream_5xx", 0)),
           "deaths": int(stats["fleet/deaths"]),
           "restarts": int(stats["fleet/restarts"]),
           "reloads": int(stats["fleet/reloads"]),
           "reload_failures": int(stats.get("fleet/reload_failures", 0)),
           "replica_flushes": [h["flushes"] for h in final],
           "replica_launches": [h["kernel_launches"] for h in final],
           # The replicas' fm_score launches, from their /healthz at the
           # end (replica 1's killed process took its count with it).
           "launches": sum(h["kernel_launches"] for h in final),
           "telemetry": {"degraded_verdict": snap["verdict"],
                         "kill_to_degraded_snapshot_seconds": t_degraded,
                         "final_verdict": final_stream["verdict"],
                         "stream_deaths":
                             final_stream["counters"]["fleet/deaths"],
                         "replica_streams": FLEET_REPLICAS,
                         "proxy_metrics_status": status}}
    print(f"fleet telemetry: {card}; the supervisor's snapshot "
          f"{t_degraded:.2f}s after the kill reads {snap['verdict']}, the "
          f"drained stream {final_stream['verdict']} with "
          f"{final_stream['counters']['fleet/deaths']:g} death; "
          f"{FLEET_REPLICAS} replica streams; proxy GET /metrics {status}",
          flush=True)
    emit(row)
    return row


def fleet_verdict(path):
    """The health verdict of the supervisor's stream as it stands (the
    port's reader; the stream may be mid-write)."""
    from fast_tffm_tpu_torch.obs import attribution
    if not os.path.isfile(path):
        return None
    return attribution.health_verdict(
        attribution.summarize([path]))["verdict"]


def healthz_status(port):
    """(HTTP status, ready count) of the proxy's /healthz; a 503 is an
    answer too."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        return resp.status, int(json.loads(resp.read())["ready"])
    finally:
        conn.close()


def quarantine_phase(cfg, card):
    """Tear the newest step (16); restore must walk back to 8 and
    quarantine 16; publishing 16 must then fail and leave the pointer as
    it was."""
    from fast_tffm_tpu_torch.checkpoint import (CheckpointState,
                                                read_published)
    from fast_tffm_tpu_torch.testing.faults import truncate_checkpoint
    from fast_tffm_tpu_torch.tools import fmckpt
    from fast_tffm_tpu_torch.train import checkpoint_template
    old, new = (str(s) for s in SERVED_STEPS)
    directory = cfg.model_file + ".ckpt"
    before = read_published(directory)
    victim = truncate_checkpoint(cfg.model_file)
    check(victim is not None and os.path.dirname(victim).endswith(
        os.sep + new), f"truncate_checkpoint tore {victim}")
    ckpt = CheckpointState(cfg.model_file, verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init)
    t0 = time.perf_counter()
    try:
        restored = ckpt.restore(template=checkpoint_template(cfg))
    finally:
        ckpt.close()
    restore_s = time.perf_counter() - t0
    qdir = os.path.join(directory, "corrupt-" + new)
    check(restored is not None and restored["step"] == SERVED_STEPS[0],
          f"restore walked back to {restored and restored['step']}")
    check(os.path.isfile(os.path.join(qdir, "QUARANTINE")) and
          os.path.isfile(os.path.join(qdir, f"manifest-{new}.json")),
          f"corrupt-{new}/ holds {os.listdir(qdir)}")
    del restored
    rc = fmckpt.main(["publish", cfg.model_file, new])
    after = read_published(directory)
    check(rc == 1 and after == before,
          f"publish of the torn step: rc {rc}, pointer {before} -> {after}")
    row = {"phase": "quarantine", "card": card, "torn_file": victim,
           "restored_step": SERVED_STEPS[0], "walk_back_restore_seconds": restore_s,
           "publish_rc": rc, "pointer": after}
    emit(row)
    return row


def timed_list(make_iter):
    """(every item of ``make_iter()``, the seconds it took)."""
    t0 = time.perf_counter()
    items = list(make_iter())
    return items, time.perf_counter() - t0


def check_same_stream(want, got, what):
    """Two batch streams equal array for array and dtype for dtype."""
    import numpy as np
    check(len(got) == len(want) > 0,
          f"{what}: {len(got)} batches against {len(want)}")
    for i, (w, g) in enumerate(zip(want, got)):
        check(g.num_real == w.num_real,
              f"{what}: batch {i} has {g.num_real} examples, not "
              f"{w.num_real}")
        for key in ("labels", "weights", "uniq_ids", "local_idx", "vals"):
            a, b = getattr(w, key), getattr(g, key)
            check((a is None) == (b is None) and (
                a is None or (a.dtype == b.dtype and a.shape == b.shape
                              and np.array_equal(a, b))),
                  f"{what}: batch {i} differs in {key}")


def host_cpus():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def pipeline_phase(cfg, parser_build_s, card):
    """The train stream three ways — the C++ fast path serially and over
    the parallel data plane, equal array for array, and on its first
    PLAIN_LINES lines the plain pure-Python stream, equal to both — each
    with its lines/s; then the generic path (a
    weight sidecar and planted bad lines under ``bad_line_policy =
    skip``) against the plain expectation built from the pure-Python
    parser and make_device_batch."""
    import dataclasses
    import numpy as np
    from fast_tffm_tpu_torch.data import pipeline as pl
    from fast_tffm_tpu_torch.data.badlines import BadLineTracker
    from fast_tffm_tpu_torch.data.parser import parse_lines
    files = list(cfg.train_files)
    kw = dict(training=True, epochs=1, seed=cfg.seed)
    serial_cfg = dataclasses.replace(cfg, host_threads=1)
    auto_cfg = dataclasses.replace(cfg, host_threads=0)
    workers = pl.host_parallel_workers(auto_cfg)
    serial, serial_s = timed_list(
        lambda: pl.batch_iterator(serial_cfg, files, **kw))
    parallel, parallel_s = timed_list(
        lambda: pl.batch_iterator(auto_cfg, files, **kw))
    check(sum(b.num_real for b in serial) == TRAIN_LINES,
          "the C++ fast path lost lines")
    check_same_stream(serial, parallel,
                      f"C++ fast path (host_threads = {workers})")
    n_batches = len(serial)
    del serial, parallel
    # The plain Python stream (~8k lines/s) against both C++ routes on a
    # prefix of the train lines.
    gdir = os.path.join(WORK, "pipeline")
    os.makedirs(gdir)
    with open(files[0]) as fh:
        lines = fh.read().splitlines()
    prefix = os.path.join(gdir, "prefix.txt")
    with open(prefix, "w") as fh:
        fh.write("\n".join(lines[:PLAIN_LINES]) + "\n")
    plain, plain_s = timed_list(
        lambda: pl.plain_batch_iterator(cfg, [prefix], **kw))
    check(sum(b.num_real for b in plain) == PLAIN_LINES,
          "the plain stream lost lines")
    for what, c in (("host_threads = 1", serial_cfg),
                    (f"host_threads = {workers}", auto_cfg)):
        check_same_stream(plain, list(pl.batch_iterator(c, [prefix], **kw)),
                          f"C++ fast path ({what}) on {PLAIN_LINES} lines")
    del plain

    # The generic path: a prefix of the train lines with planted bad
    # lines and a weight sidecar, not shuffled.
    lines = lines[:GENERIC_LINES]
    for i in GENERIC_BAD:
        lines[i] = "1 I1:x C3=v1"
    rng = np.random.default_rng(SEED + 9)
    weights = [f"{w:.3f}" for w in rng.uniform(0.2, 3.0, len(lines))]
    data, wpath = os.path.join(gdir, "g.txt"), os.path.join(gdir, "g.w")
    with open(data, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(wpath, "w") as fh:
        fh.write("\n".join(weights) + "\n")
    gcfg = dataclasses.replace(cfg, bad_line_policy="skip",
                               max_bad_fraction=0.01, host_threads=0)
    tracker = BadLineTracker.from_config(gcfg)
    got, generic_s = timed_list(lambda: pl.batch_iterator(
        gcfg, [data], training=False, weight_files=[wpath],
        bad_lines=tracker))
    check(tracker.bad == len(GENERIC_BAD) and
          tracker.total == GENERIC_LINES,
          f"generic path: {tracker.describe()}")
    t0 = time.perf_counter()
    want, bad, B = [], set(GENERIC_BAD), cfg.batch_size
    for lo in range(0, len(lines), B):
        kept = [i for i in range(lo, min(lo + B, len(lines)))
                if i not in bad]
        block = parse_lines(
            [lines[i] for i in kept], cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
            max_features_per_example=cfg.max_features_per_example)
        want.append(pl.make_device_batch(
            block, gcfg, B,
            weights=np.array([float(weights[i]) for i in kept],
                             dtype=np.float32)))
    generic_plain_s = time.perf_counter() - t0
    check_same_stream(want, got, "generic path (weights, skip)")
    row = {"phase": "pipeline", "card": card, "host_cpus": host_cpus(),
           "os_cpu_count": os.cpu_count(), "lines": TRAIN_LINES,
           "batch_size": cfg.batch_size, "batches": n_batches,
           "parser_build_seconds": parser_build_s,
           "streams_equal": True,
           "serial_lines_per_s": TRAIN_LINES / serial_s,
           "parallel_workers": workers,
           "parallel_lines_per_s": TRAIN_LINES / parallel_s,
           "plain_lines": PLAIN_LINES,
           "plain_lines_per_s": PLAIN_LINES / plain_s,
           "serial_over_plain": (TRAIN_LINES / serial_s)
           / (PLAIN_LINES / plain_s),
           "parallel_over_serial": serial_s / parallel_s,
           "generic_lines": GENERIC_LINES,
           "generic_bad_lines_skipped": tracker.bad,
           "generic_lines_per_s": GENERIC_LINES / generic_s,
           "generic_plain_lines_per_s": GENERIC_LINES / generic_plain_s}
    emit(row)
    return row


def host_dedup_phase(torch, device, card, wd, train_row):
    """One epoch of ``python -m fast_tffm_tpu_torch train`` with ``dedup
    = host`` (periodic saves off; the final save and the export stay):
    both kernels launch on host-deduped batches, the validation AUC
    clears the train phase's floor; then its resident step, beside the
    ``dedup = device`` step's."""
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.ops import fm_kernel
    path = write_train_cfg(wd, 1, dedup="host", save_steps=0)
    cfg = load_config(path)
    fm_kernel.launches = 0
    fm_kernel.bwd_launches = 0
    t0 = time.perf_counter()
    rc = cli(["train", path])
    entry_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = fm_kernel.launches, fm_kernel.bwd_launches
    check(rc == 0, f"dedup = host train returned {rc}")
    losses, rates, aucs, done = read_train_log(cfg.log_file)
    steps = -(-TRAIN_LINES // TRAIN_BATCH)
    val_batches = -(-VAL_LINES // TRAIN_BATCH)
    check([n for n, _ in done] == [steps], f"dedup = host ran {done}")
    check(bwd_launches == steps and fwd_launches == steps + val_batches,
          f"dedup = host launched fm_score {fwd_launches} and "
          f"fm_score_bwd {bwd_launches} times for {steps} steps")
    check(len(aucs) == 1 and aucs[0] > train_row["auc_floor"],
          f"dedup = host validation AUC {aucs} not above "
          f"{train_row['auc_floor']}")
    loop_eps = steps * TRAIN_BATCH / sum(TRAIN_BATCH / r for r in rates)
    resident, fwd_rows, bwd_rows = resident_step_ms(torch, cfg, device,
                                                    tag="train_host")
    row = {"phase": "train_host", "card": card, "dedup": "host",
           "epochs": 1, "steps": steps, "entry_seconds": entry_s,
           "examples_per_s_loop": loop_eps,
           "epoch_mean_loss": float(np.mean(losses[0])),
           "validation_auc": aucs, "auc_floor": train_row["auc_floor"],
           "fm_score_launches": fwd_launches,
           "fm_score_bwd_launches": bwd_launches,
           "resident_step_ms_median": resident["resident_step_ms_median"],
           "device_dedup_resident_step_ms_median":
               train_row["resident_step_ms_median"],
           "profiled_device_ms_per_step":
               resident["profiled_device_ms_per_step"],
           "device_dedup_profiled_device_ms_per_step":
               train_row["profiled_device_ms_per_step"],
           "profiled_kernels_ms_per_step":
               resident["profiled_kernels_ms_per_step"],
           "profiled_kernel_launches_seen":
               resident["profiled_kernel_launches_seen"]}
    emit(row)
    return row, fwd_rows, bwd_rows


FFM_FIELDS = NUM_FIELDS + len(CAT_VOCABS)   # 39: a field per column
FFM_FACTORS = 4                   # libffm's Criteo setting; config #3
FFM_VOCAB = 1 << 20
ORDER3_FACTORS = 8                # config #4's protocol
F64_ATOL = 1e-4                   # raw score, f32 on the card vs f64
NARROW_TOL = 2e-3                 # packed-narrow vs wide scores
LOSS_RTOL, AUC_ATOL = 1e-4, 1e-3  # the training tolerance
WIRE_BATCHES = 8


def write_ffm_data(wd):
    """The train phase's lines again (same seeds, same planted labels),
    each token tagged with its field: ffm_train.txt and ffm_val.txt."""
    t0 = time.perf_counter()
    model = planted_model(SEED + 4)
    for name, n, seed in (("ffm_train.txt", TRAIN_LINES, SEED + 5),
                          ("ffm_val.txt", VAL_LINES, SEED + 6)):
        lines, _ = criteo_lines(n, seed, model, ffm=True)
        with open(os.path.join(wd, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return time.perf_counter() - t0


def float64_check(torch, cfg, device, val_path):
    """One validation batch scored on the card (the scorer predict runs)
    against the same function in float64 on the CPU, over the rows the
    batch touches; returns the largest raw-score difference."""
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.predict import load_table
    from fast_tffm_tpu_torch.scoring import CompiledScorer
    table = load_table(cfg, device)
    scorer = CompiledScorer(cfg, device)
    it = batch_iterator(cfg, [val_path], training=False)
    try:
        batch = next(it)
    finally:
        it.close()
    got = scorer.score_batch(table, batch).cpu().double()
    local = torch.from_numpy(batch.local_idx).long()
    uniq, inv = torch.unique(local.reshape(-1), return_inverse=True)
    rows = table[uniq.to(device)].cpu().double()
    want = port_fm.score_body(
        scorer.spec, rows, inv.reshape(local.shape),
        torch.from_numpy(batch.vals).double(),
        fields=(None if batch.fields is None
                else torch.from_numpy(batch.fields)))
    n = batch.num_real
    del table
    return float((got[:n] - want[:n]).abs().max())


def model_leg(torch, device, card, wd, kind, train_row):
    """``python -m fast_tffm_tpu_torch train`` (one epoch, periodic saves
    off) then ``predict`` for FFM (``kind = "ffm"``, config #3's model
    at libffm's Criteo setting) or an order-3 FM (config #4's): the loss
    falls, the validation AUC clears the train phase's floor, predict
    reaches it, a batch's scores on the card agree with float64 on the
    CPU; then the resident step and its device ms by op. Neither model
    runs a hand-written kernel (torch ops, as XLA ran them)."""
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.metrics import exact_auc
    from fast_tffm_tpu_torch.ops import fm_kernel
    if kind == "ffm":
        path = write_train_cfg(
            wd, 1, save_steps=0, leg=kind, files="ffm_", vocab=FFM_VOCAB,
            factors=FFM_FACTORS,
            model=f"model_type = ffm\nfield_num = {FFM_FIELDS}\n")
    else:
        path = write_train_cfg(wd, 1, save_steps=0, leg=kind,
                               factors=ORDER3_FACTORS, model="order = 3\n")
    cfg = load_config(path)
    val_path = cfg.validation_files[0]
    fm_kernel.launches = 0
    fm_kernel.bwd_launches = 0
    t0 = time.perf_counter()
    rc = cli(["train", path])
    entry_s = time.perf_counter() - t0
    check(rc == 0, f"{kind} train returned {rc}")
    losses, rates, aucs, done = read_train_log(cfg.log_file)
    steps = -(-TRAIN_LINES // TRAIN_BATCH)
    check([n for n, _ in done] == [steps], f"{kind} train ran {done}")
    loss = losses[0]
    check(np.isfinite(loss).all() and len(loss) == steps
          and np.mean(loss[-4:]) < np.mean(loss[:4]),
          f"{kind} loss did not fall: {loss}")
    check(len(aucs) == 1 and aucs[0] > train_row["auc_floor"],
          f"{kind} validation AUC {aucs} not above {train_row['auc_floor']}")
    t0 = time.perf_counter()
    rc = cli(["predict", path])
    predict_s = time.perf_counter() - t0
    check(rc == 0, f"{kind} predict returned {rc}")
    check(fm_kernel.launches == 0 and fm_kernel.bwd_launches == 0,
          f"{kind} launched the order-2 kernels")
    with open(os.path.join(cfg.score_path,
                           os.path.basename(val_path) + ".score")) as fh:
        scores = np.array([float(x) for x in fh.read().split()])
    with open(val_path) as fh:
        labels = np.array([int(ln.split(" ", 1)[0]) for ln in fh])
    check(scores.shape == (VAL_LINES,) and np.isfinite(scores).all(),
          f"{kind}: {scores.shape} predict scores for {VAL_LINES} lines")
    predict_auc = exact_auc(scores, labels)
    check(abs(predict_auc - aucs[0]) <= AUC_GAP,
          f"{kind} predict's exact AUC {predict_auc} vs train's {aucs[0]}")
    f64_err = float64_check(torch, cfg, device, val_path)
    check(f64_err <= F64_ATOL,
          f"{kind} scores on the card vs float64 on the CPU: {f64_err}")
    loop_eps = steps * TRAIN_BATCH / sum(TRAIN_BATCH / r for r in rates)
    resident, _, _ = resident_step_ms(torch, cfg, device, tag=kind,
                                      kernel_rows=False)
    shutil.rmtree(os.path.dirname(cfg.model_file))
    row = {"phase": f"train_{kind}", "card": card,
           "model": ("ffm" if kind == "ffm" else "fm order 3"),
           "vocabulary_size": cfg.vocabulary_size,
           "factor_num": cfg.factor_num, "field_num": cfg.field_num,
           "row_dim": cfg.row_dim,
           "table_bytes": cfg.num_rows * cfg.row_dim * 4,
           "reduced": f"{TRAIN_LINES} train + {VAL_LINES} validation "
                      "Criteo-shaped lines, one epoch, periodic saves off",
           "epochs": 1, "steps": steps, "entry_seconds": entry_s,
           "predict_entry_seconds": predict_s,
           "examples_per_s_loop": loop_eps,
           "step_losses_first_last": [loss[0], loss[-1]],
           "validation_auc": aucs, "auc_floor": train_row["auc_floor"],
           "planted_auc": train_row["planted_auc"],
           "predict_exact_auc": predict_auc,
           "max_err_vs_float64": f64_err,
           "fm_score_launches": fm_kernel.launches,
           "fm_score_bwd_launches": fm_kernel.bwd_launches, **resident}
    emit(row)
    return row


def packed_serving_phase(torch, cfg, lines, score_lines, device, card):
    """Phases 4-5 again on the packed wire, against the padded run's
    predict file: predict with ``wire_format = packed`` (wide: the score
    file equal byte for byte; narrow: within NARROW_TOL), then a server
    on packed-wide whose bodies equal the predict lines byte for
    byte."""
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.serve.frontend import make_http_server
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    row = {"phase": "packed_serving", "card": card,
           "reduced": "16 sequential serve requests (phase 5: 48 from 8 "
                      "clients)"}
    want = np.array([float(x) for x in score_lines])
    cfgs = {}
    for wire in ("packed-wide", "packed-narrow"):
        path = os.path.join(WORK, f"smoke_{wire}.cfg")
        write_cfg(path, wire)
        cfgs[wire] = load_config(path)
        fm_kernel.launches = 0
        t0 = time.perf_counter()
        rc = cli(["predict", path, "--device", device.type])
        row[f"predict_{wire}_entry_seconds"] = time.perf_counter() - t0
        row[f"predict_{wire}_launches"] = fm_kernel.launches
        check(rc == 0, f"{wire} predict returned {rc}")
        check(fm_kernel.launches == -(-len(lines) // PREDICT_BATCH),
              f"{wire} predict launched fm_score {fm_kernel.launches} "
              "times")
        with open(os.path.join(cfgs[wire].score_path,
                               "criteo.txt.score")) as fh:
            got = fh.read().splitlines(keepends=True)
        if wire == "packed-wide":
            check(got == score_lines, "packed-wide predict's score file "
                  "differs from the padded one")
        else:
            err = float(np.abs(np.array([float(x) for x in got])
                               - want).max())
            row["narrow_max_abs_diff"] = err
            check(len(got) == len(score_lines) and err <= NARROW_TOL,
                  f"packed-narrow scores differ from wide by {err}")
    fm_kernel.launches = 0
    server = ScorerServer(cfgs["packed-wide"], device=device)
    warm = fm_kernel.launches
    httpd = make_http_server(server, 0)
    th = threading.Thread(target=httpd.serve_forever, name="smoke-http",
                          daemon=True)
    th.start()
    rng = np.random.default_rng(SEED + 8)
    try:
        for n in [1, SERVE_MAX_BATCH] + [int(n) for n in
                                         rng.integers(1, SERVE_MAX_BATCH,
                                                      14)]:
            lo = int(rng.integers(0, len(lines) - n + 1))
            status, body, step = post(port=httpd.server_address[1],
                                      body="\n".join(lines[lo:lo + n])
                                      + "\n")
            check(status == 200 and step == str(SERVE_STEP)
                  and body == "".join(score_lines[lo:lo + n]).encode(),
                  f"packed serve of lines [{lo}, {lo + n}) answered "
                  f"{status}, differing from the predict file")
        health = healthz(httpd.server_address[1])
        check(health["wire"] == "packed-wide" and health["requests"] == 16
              and health["flush_errors"] == 0, f"/healthz: {health}")
    finally:
        httpd.shutdown()
        th.join(timeout=60)
        httpd.server_close()
        server.close()
    row.update(serve_warmup_launches=warm,
               serve_launches=fm_kernel.launches,
               serve_requests=health["requests"],
               serve_p50_ms=health["latency_p50_ms"],
               serve_p99_ms=health["latency_p99_ms"])
    check(fm_kernel.launches > warm > 0, "packed serve launched no kernel")
    emit(row)
    return row


def packed_train_phase(torch, device, card, wd, train_row):
    """One epoch of ``train`` on ``wire_format = packed`` (wide; periodic
    saves off) at config #2's width: the same steps as run A's first
    epoch, so its loss and validation AUC match run A's at the training
    tolerance (the backward's atomics keep them from the bit), with fewer
    bytes shipped; then bytes per batch and H2D ms per batch for the
    padded, packed-wide and packed-narrow wires (wire_bytes_rows)."""
    import re
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.ops import fm_kernel
    path = write_train_cfg(wd, 1, save_steps=0, leg="packed",
                           train="wire_format = packed\n")
    cfg = load_config(path)
    fm_kernel.launches = 0
    fm_kernel.bwd_launches = 0
    t0 = time.perf_counter()
    rc = cli(["train", path])
    entry_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = fm_kernel.launches, fm_kernel.bwd_launches
    check(rc == 0, f"packed train returned {rc}")
    losses, rates, aucs, done = read_train_log(cfg.log_file)
    steps = -(-TRAIN_LINES // TRAIN_BATCH)
    val_batches = -(-VAL_LINES // TRAIN_BATCH)
    check([n for n, _ in done] == [steps], f"packed train ran {done}")
    check(bwd_launches == steps and fwd_launches == steps + val_batches,
          f"packed train launched fm_score {fwd_launches} and "
          f"fm_score_bwd {bwd_launches} times")
    mean_loss = float(np.mean(losses[0]))
    padded_loss = train_row["epoch_mean_loss"][0]
    check(abs(mean_loss - padded_loss) <= LOSS_RTOL * abs(padded_loss)
          and abs(aucs[0] - train_row["validation_auc"][0]) <= AUC_ATOL,
          f"packed train: loss {mean_loss}, AUC {aucs} against the padded "
          f"run's {padded_loss}, {train_row['validation_auc'][0]}")
    with open(cfg.log_file) as fh:
        log = fh.read()
    sent = re.findall(r"wire packed-wide: h2d_bytes = (\d+) over \d+ "
                      r"steps, against (\d+)", log)
    check("wire format: packed-wide" in log and len(sent) == 1
          and int(sent[0][0]) < int(sent[0][1]),
          f"packed train's wire lines: {sent}")
    loop_eps = steps * TRAIN_BATCH / sum(TRAIN_BATCH / r for r in rates)
    shutil.rmtree(os.path.dirname(cfg.model_file))
    row = {"phase": "train_packed", "card": card,
           "wire_format": "packed-wide",
           "reduced": "one epoch of the train phase's lines, periodic "
                      "saves off",
           "epochs": 1, "steps": steps, "entry_seconds": entry_s,
           "examples_per_s_loop": loop_eps, "epoch_mean_loss": mean_loss,
           "padded_epoch_mean_loss": padded_loss, "validation_auc": aucs,
           "padded_validation_auc": train_row["validation_auc"][0],
           "h2d_bytes": int(sent[0][0]),
           "h2d_bytes_padded_layout": int(sent[0][1]),
           "fm_score_launches": fwd_launches,
           "fm_score_bwd_launches": bwd_launches,
           "wire": wire_bytes_rows(torch, cfg, device)}
    emit(row)
    return row


def wire_bytes_rows(torch, cfg, device):
    """Per wire: bytes a batch ships against the padded layout's, the
    host's encode ms and the H2D ms (``device_put`` until the card has
    the arrays) per batch, medians over the train stream's first
    WIRE_BATCHES batches after one warmup pass; and, as the same-call
    baseline, "padded-direct": the padded arrays copied by
    ``batch_args(batch, device)``, each a blocking ``.to(device)`` from
    pageable memory, as the train loop shipped them before the wire."""
    import statistics
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models.fm import batch_args
    from fast_tffm_tpu_torch.wire import WireEncoder, WireSpec
    it = batch_iterator(cfg, cfg.train_files, training=True, epochs=1)
    try:
        batches = [b for _, b in zip(range(WIRE_BATCHES), it)]
    finally:
        it.close()
    out = {}
    for fmt, dtypes in (("padded", "wide"), ("packed", "wide"),
                        ("packed", "narrow")):
        enc = WireEncoder(WireSpec(fmt, dtypes), cfg.pad_id)
        enc_ms, h2d_ms, sent, logical = [], [], [], []
        for rep in range(2):
            for b in batches:
                t0 = time.perf_counter()
                wb = enc.encode_train(b)
                t1 = time.perf_counter()
                enc.device_put(wb, device)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if rep:
                    enc_ms.append((t1 - t0) * 1e3)
                    h2d_ms.append((t2 - t1) * 1e3)
                    sent.append(wb.wire_bytes)
                    logical.append(wb.logical_bytes)
        out[f"{fmt}-{dtypes}"] = {
            "bytes_per_batch": statistics.mean(sent),
            "logical_bytes_per_batch": statistics.mean(logical),
            "encode_ms_median": statistics.median(enc_ms),
            "h2d_ms_median": statistics.median(h2d_ms)}
    direct = []
    for rep in range(2):
        for b in batches:
            t0 = time.perf_counter()
            batch_args(b, device)
            torch.cuda.synchronize()
            if rep:
                direct.append((time.perf_counter() - t0) * 1e3)
    out["padded-direct"] = {"h2d_ms_median": statistics.median(direct)}
    return out


STREAM_SHARDS = 4                 # of TRAIN_LINES / 4 lines: 4 batches each
STREAM_APPENDS = 3                # each shard written in 3 appends
STREAM_POLL_SECONDS = 0.5
STREAM_PUBLISH_SECONDS = 2
STREAM_CLIENTS = 4
STREAM_RUN_TIMEOUT = 420          # seconds for one train command
# The train command in a subprocess (so that SIGTERM is real): the entry
# point ``python -m fast_tffm_tpu_torch train`` calls, with the
# checkpoint and publish calls timed and the kernels' launch counts
# written to a JSON file when it returns.
STREAM_TRAIN = r"""
import json, sys, time
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch import train as tr
from fast_tffm_tpu_torch import wire
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.ops import fm_kernel
out_path, argv = sys.argv[1], sys.argv[2:]
rec = {"saves": [], "verifies": [], "flips": [], "sweeps": [],
       "restore_start": None, "first_step": None, "last_step": None,
       "stepped_examples": 0}


def timed(store, fn, **fields):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        store.append({"seconds": t1 - t0, "end": t1,
                      **{k: f(args, kwargs, out)
                         for k, f in fields.items()}})
        return out
    return wrapper


save, restore, body = (ck.CheckpointState.save, ck.CheckpointState.restore,
                       tr.train_step_body)
ck.CheckpointState.save = timed(
    rec["saves"], save, step=lambda a, k, o: int(a[1]),
    wait=lambda a, k, o: bool(k.get("wait")))
ck.verify_step_dir = timed(rec["verifies"], ck.verify_step_dir,
                           step=lambda a, k, o: int(a[1]))
ck.write_published = timed(
    rec["flips"], ck.write_published, step=lambda a, k, o: int(a[1]),
    t=lambda a, k, o: time.time(),
    watermark=lambda a, k, o: ck.read_watermark(a[0], int(a[1])))
tr.evaluate = timed(rec["sweeps"], tr.evaluate,
                    auc=lambda a, k, o: o[0])


def timed_restore(self, *args, **kwargs):
    rec["restore_start"] = time.perf_counter()
    return restore(self, *args, **kwargs)


def timed_body(*args, **kwargs):
    now = time.perf_counter()
    rec["first_step"] = rec["first_step"] or now
    rec["last_step"] = now
    return body(*args, **kwargs)


encode = wire.WireEncoder.encode_train


def counted_encode(self, batch):
    rec["stepped_examples"] += int(batch.num_real)
    return encode(self, batch)


ck.CheckpointState.restore = timed_restore
tr.train_step_body = timed_body
wire.WireEncoder.encode_train = counted_encode
rc = main(argv)
rec.update(rc=rc, fm_score_launches=fm_kernel.launches,
           fm_score_bwd_launches=fm_kernel.bwd_launches)
with open(out_path, "w") as fh:
    json.dump(rec, fh)
sys.exit(rc)
"""


def write_stream_cfg(wd, data_wd, auc_floor):
    path = os.path.join(wd, "stream.cfg")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = {FACTORS}
model_file = {os.path.join(wd, 'model', 'fm_model')}
log_file = {os.path.join(wd, 'stream.log')}

[Train]
run_mode = stream
stream_dir = {os.path.join(wd, 'stream')}
stream_poll_seconds = {STREAM_POLL_SECONDS}
publish_interval_seconds = {STREAM_PUBLISH_SECONDS}
publish_min_auc = {auc_floor!r}
validation_files = {os.path.join(data_wd, 'val.txt')}
batch_size = {TRAIN_BATCH}
learning_rate = {TRAIN_LR}
loss_type = logistic
log_steps = 1
save_steps = 0

[Predict]
predict_files = {os.path.join(data_wd, 'val.txt')}
score_path = {os.path.join(wd, 'score')}

[Serve]
serve_port = 0
serve_max_batch = {SERVE_MAX_BATCH}
serve_max_wait_ms = 2
serve_poll_seconds = {RELOAD_POLL_SECONDS}
""")
    return path


def write_shard(sd, k, lines, done_times, hidden=False):
    """Shard ``k`` in STREAM_APPENDS appends, every cut but the last in
    the middle of a line, then its ``.done`` marker (its wall time kept
    in ``done_times``). ``hidden``: the appends go to ``.part-<k>``,
    which the caller renames into place. Returns the written path."""
    text = ("\n".join(lines) + "\n").encode()
    cuts = [len(text) * i // STREAM_APPENDS
            for i in range(1, STREAM_APPENDS)]
    cuts = [c + 1 if text[c - 1:c] == b"\n" else c for c in cuts]
    path = os.path.join(sd, f"part-{k:05d}")
    target = os.path.join(sd, f".part-{k:05d}") if hidden else path
    for lo, hi in zip([0] + cuts, cuts + [len(text)]):
        with open(target, "ab") as fh:
            fh.write(text[lo:hi])
        time.sleep(0.2)
    open(path + ".done", "w").close()
    done_times[path] = time.time()
    return target


def start_stream_train(wd, cfg_path, run):
    out = open(os.path.join(wd, f"run{run}.out"), "w")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-c", STREAM_TRAIN,
         os.path.join(wd, f"run{run}.json"), "train", cfg_path],
        cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, out


def wait_until(cond, what, proc=None, timeout=STREAM_RUN_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        check(proc is None or proc.poll() is None,
              f"the stream trainer exited before {what}")
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.05)


def stream_phase(torch, device, card, data, train_row):
    """``run_mode = stream`` at config #2's width: a writer appends the
    train lines as 4 shards (each in 3 appends cut mid-line, then
    ``.done``); run 1 of ``python -m fast_tffm_tpu_torch train
    stream.cfg`` (a subprocess) steps shards 1-2 and publishes through the
    gate (publish_min_auc = the train phase's AUC floor) until the
    ``published`` pointer names step 8, then takes a SIGTERM; run 2
    restores step 8 and its watermark and steps shards 3-4 to ``STOP``.
    A ScorerServer on the model directory answers requests throughout.
    Then a control run in process: the port's StreamSource over the
    finished directory through train_step_body from the same table."""
    import dataclasses
    import re
    import signal
    import numpy as np
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data import stream as sl
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.predict import predict
    from fast_tffm_tpu_torch.serve.frontend import make_http_server
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    data_wd, val_lines = data[0], data[1]
    wd = os.path.join(WORK, "stream_phase")
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    cfg_path = write_stream_cfg(wd, data_wd, train_row["auc_floor"])
    cfg = load_config(cfg_path)
    directory = cfg.model_file + ".ckpt"
    with open(os.path.join(data_wd, "train.txt")) as fh:
        lines = fh.read().splitlines()
    per = len(lines) // STREAM_SHARDS
    steps_per_shard = per // TRAIN_BATCH
    shards = [lines[k * per:(k + 1) * per] for k in range(STREAM_SHARDS)]
    del lines
    done_times, writer_errors = {}, []

    def log_has(text):
        try:
            with open(cfg.log_file) as fh:
                return text in fh.read()
        except OSError:
            return False

    def writer(first, then_stop):
        """Shards ``first`` and ``first + 1``; the second once a publish
        has evaluated the first's last step, so that publishes land
        while the stream flows."""
        try:
            write_shard(sd, first, shards[first], done_times)
            wait_until(lambda: log_has(
                "publish quality eval at step "
                f"{(first + 1) * steps_per_shard}:"),
                f"a publish sweep after shard {first + 1}")
            write_shard(sd, first + 1, shards[first + 1], done_times)
            if then_stop:
                open(os.path.join(sd, "STOP"), "w").close()
        except Exception as e:  # noqa: BLE001 - reported by a check
            writer_errors.append(repr(e))

    fm_kernel.launches = 0
    fm_kernel.bwd_launches = 0
    server = httpd = http_thread = None
    stop_clients = threading.Event()
    results, lock, failures, clients = [], threading.Lock(), [], []

    def client(k):
        rng = np.random.default_rng(SEED + 40 + k)
        try:
            while not stop_clients.is_set():
                n = int(rng.integers(1, SERVE_MAX_BATCH + 1))
                lo = int(rng.integers(0, len(val_lines) - n + 1))
                t0 = time.perf_counter()
                status, body, step = post(
                    port, "\n".join(val_lines[lo:lo + n]) + "\n")
                with lock:
                    results.append((lo, n, status, body, step,
                                    time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - reported by a check
            failures.append(repr(e))

    runs, t_phase = [], time.perf_counter()
    try:
        # Run 1: shards 1-2, published through the gate, then SIGTERM.
        proc, out = start_stream_train(wd, cfg_path, 1)
        try:
            w = threading.Thread(target=writer, args=(0, False))
            w.start()
            wait_until(lambda: ck.read_published(directory) is not None,
                       "the first publish", proc)
            server = ScorerServer(dataclasses.replace(
                cfg, log_file=os.path.join(wd, "serve.log")), device=device)
            httpd = make_http_server(server, 0)
            http_thread = threading.Thread(target=httpd.serve_forever,
                                           name="smoke-http", daemon=True)
            http_thread.start()
            port = httpd.server_address[1]
            clients = [threading.Thread(target=client, args=(k,))
                       for k in range(STREAM_CLIENTS)]
            for th in clients:
                th.start()
            w.join()
            run1_steps = 2 * steps_per_shard
            wait_until(lambda: ck.read_published(directory) == run1_steps,
                       f"a publish of step {run1_steps}", proc)
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=STREAM_RUN_TIMEOUT)
            runs.append({"rc": rc, "sigterm_to_exit_seconds":
                         time.perf_counter() - t_term})
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
        check(runs[0]["rc"] == 0, f"stream run 1 exited {runs[0]['rc']}")
        with open(cfg.log_file) as fh:
            log1 = fh.read()
        check("preemption signalled; saving the stream position and "
              "exiting" in log1, "run 1 did not log the preemption")
        wm8 = ck.read_watermark(directory, run1_steps)
        check(wm8 is not None and sum(f["lines"] for f in wm8["files"])
              == 2 * per, f"watermark-{run1_steps}.json: {wm8}")

        # Run 2: shards 3-4 and STOP; restores step 8 and its watermark.
        proc, out = start_stream_train(wd, cfg_path, 2)
        try:
            w = threading.Thread(target=writer, args=(2, True))
            w.start()
            rc = proc.wait(timeout=STREAM_RUN_TIMEOUT)
            runs.append({"rc": rc})
            w.join()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
        check(runs[1]["rc"] == 0, f"stream run 2 exited {runs[1]['rc']}")
        check(not writer_errors, f"the writer failed: {writer_errors}")
        final_steps = STREAM_SHARDS * steps_per_shard
        wait_until(lambda: server.served_step == final_steps,
                   f"the server's swap to step {final_steps}",
                   timeout=120)
        time.sleep(4 * RELOAD_POLL_SECONDS)
        stop_clients.set()
        for th in clients:
            th.join(timeout=300)
            check(not th.is_alive(), "a stream serve client hung")
        # The final published step's predict lines, against the server's
        # bodies for the validation lines.
        pred_cfg = dataclasses.replace(
            cfg, log_file=os.path.join(wd, "predict.log"))
        predict(pred_cfg, device=device)
        with open(os.path.join(cfg.score_path, "val.txt.score")) as fh:
            expected = fh.read().splitlines(keepends=True)
        final_bodies_equal = True
        for lo in range(0, len(val_lines), SERVE_MAX_BATCH):
            status, body, step = post(port, "\n".join(
                val_lines[lo:lo + SERVE_MAX_BATCH]) + "\n")
            final_bodies_equal &= (status == 200 and step == str(final_steps)
                                   and body == "".join(
                                       expected[lo:lo + SERVE_MAX_BATCH]
                                       ).encode())
        health = healthz(port)
    finally:
        stop_clients.set()
        if httpd is not None:
            httpd.shutdown()
            http_thread.join(timeout=60)
            httpd.server_close()
        if server is not None:
            server.close()
    serve_launches = fm_kernel.launches
    phase_s = time.perf_counter() - t_phase
    with open(cfg.log_file) as fh:
        log = fh.read()
    recs = []
    for run in (1, 2):
        with open(os.path.join(wd, f"run{run}.json")) as fh:
            recs.append(json.load(fh))
    check("restored checkpoint at step 8" in log,
          "run 2 did not restore step 8")
    done = [int(n) for n in re.findall(r"training done: (\d+) steps", log)]
    check(done == [run1_steps, final_steps],
          f"the stream runs ended at steps {done}")
    stepped = [r["stepped_examples"] for r in recs]
    check(sum(stepped) == STREAM_SHARDS * per,
          f"the two runs stepped {stepped} examples, not "
          f"{STREAM_SHARDS * per} in all")
    published = [int(n) for n in re.findall(
        r"published checkpoint step (\d+) \(size-verified\)", log)]
    check(published and published[-1] == final_steps
          and ck.read_published(directory) == final_steps,
          f"published steps {published}")
    check(not failures, f"stream serve clients failed: {failures[:3]}")
    by_step = {}
    for lo, n, status, body, step, _ in results:
        check(status == 200, f"stream serve answered {status}: "
                             f"{body[:200]}")
        check(int(step) in published,
              f"X-FM-Step {step} is not a step the trainer published "
              f"({published})")
        if int(step) == final_steps:
            check(body == "".join(expected[lo:lo + n]).encode(),
                  f"body for lines [{lo}, {lo + n}) differs from step "
                  f"{final_steps}'s predict lines")
        by_step[step] = by_step.get(step, 0) + 1
    check(final_bodies_equal, "the server's bodies for the validation "
          "lines differ from predict of the final published step")
    check(health["reloads"] >= 2, f"the server swapped "
          f"{health['reloads']} times: {health}")
    launches = {k: sum(r[k] for r in recs)
                for k in ("fm_score_launches", "fm_score_bwd_launches")}
    check(all(r["fm_score_launches"] > 0 and r["fm_score_bwd_launches"] > 0
              for r in recs), f"stream kernel launches: {recs}")
    check(launches["fm_score_bwd_launches"] == final_steps,
          f"fm_score_bwd launched {launches} for {final_steps} steps")
    check(serve_launches > 0, "the stream server never launched fm_score")

    # The control run: the same batches through train_step_body.
    from fast_tffm_tpu_torch.models.fm import batch_args
    spec = port_fm.ModelSpec.from_config(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    table = port_fm.init_table(cfg, device, gen)
    acc = port_fm.init_accumulator(cfg, device)
    src = sl.StreamSource(cfg, sl.StreamTracker(
        sd, cfg.stream_poll_seconds, cfg.seal_policy), raw_ids=True,
        workers=sl.stream_workers(cfg))
    n_control, last_pos = 0, None
    t0 = time.perf_counter()
    try:
        while True:
            b = src.next_batch(block=True)
            if b is sl.DONE:
                break
            table, acc, _, _ = port_fm.train_step_body(
                spec, table, acc, **batch_args(b, device))
            n_control += 1
            last_pos = b.stream_pos
    finally:
        src.close()
    torch.cuda.synchronize()
    control_s = time.perf_counter() - t0
    check(n_control == final_steps, f"the control run took {n_control} "
                                    "steps")
    restored = ck.CheckpointState(cfg.model_file).restore(
        step=final_steps)
    errs = {}
    for name, want in (("table", table), ("acc", acc)):
        got = restored[name].to(device)
        diff = (got - want).abs()
        errs[name] = float(diff.max())
        check(bool((diff <= 1e-6 + 1e-4 * want.abs()).all()),
              f"step {final_steps}'s {name} differs from the control run "
              f"by up to {errs[name]}")
        del got, diff
    wm16 = ck.read_watermark(directory, final_steps)
    check(wm16 == last_pos, "watermark-16.json differs from the control "
                            "source's final snapshot")
    del table, acc, restored
    torch.cuda.empty_cache()

    rates = [float(r) for r in re.findall(
        r"step \d+ epoch 0 loss [0-9.]+ examples/sec ([0-9.]+)", log)]
    def last_before(items, t):
        before = [x for x in items if x["end"] <= t]
        return before[-1]["seconds"] if before else None

    # Each publish: the sweep, the save that waits, the verify and the
    # pointer flip that came last before its flip.
    publishes = []
    for r in recs:
        waits = [x for x in r["saves"] if x["wait"]]
        for flip in r["flips"]:
            t = flip["end"] - flip["seconds"]
            publishes.append({
                "step": flip["step"],
                "sweep_seconds": last_before(r["sweeps"], t),
                "save_seconds": last_before(waits, t),
                "verify_seconds": last_before(r["verifies"], t),
                "flip_seconds": flip["seconds"]})
    freshness = {}
    for path, t_done in done_times.items():
        firsts = [f["t"] for r in recs for f in r["flips"]
                  if any(x["path"] == path and x["end"] is not None
                         and x["bytes"] >= x["end"]
                         for x in (f["watermark"] or {}).get("files", ()))]
        freshness[os.path.basename(path)] = (
            min(firsts) - t_done if firsts else None)
    lat = sorted(x[5] for x in results)
    row = {"phase": "stream", "card": card, "shards": STREAM_SHARDS,
           "lines_per_shard": per, "appends_per_shard": STREAM_APPENDS,
           "batch_size": TRAIN_BATCH, "steps": final_steps,
           "poll_seconds": STREAM_POLL_SECONDS,
           "publish_interval_seconds": STREAM_PUBLISH_SECONDS,
           "publish_min_auc": train_row["auc_floor"],
           "phase_seconds": phase_s, "runs": runs,
           "stepped_examples_by_run": stepped,
           # Arrival sets the stream's pace: the loop's rate over the
           # logged windows counts the waits for data; the median window
           # is a step that followed another.
           "examples_per_s_loop": (len(rates) * TRAIN_BATCH
                                   / sum(TRAIN_BATCH / r for r in rates)
                                   if rates else None),
           "examples_per_s_step_window_median": (
               sorted(rates)[len(rates) // 2] if rates else None),
           "stepping_seconds_by_run": [r["last_step"] - r["first_step"]
                                       for r in recs],
           "publishes": publishes, "published_steps": published,
           "quality_sweep_auc": [s["auc"] for r in recs
                                 for s in r["sweeps"]],
           "freshness_seconds": freshness,
           "resume_seconds": recs[1]["first_step"] - recs[1]["restore_start"],
           "server_swaps": health["reloads"],
           "server_reload_failures": health["reload_failures"],
           "server_requests": len(results), "responses_by_step": by_step,
           "server_p50_ms": health["latency_p50_ms"],
           "server_p99_ms": health["latency_p99_ms"],
           "round_trip_ms_median": lat[len(lat) // 2] * 1e3,
           "fm_score_launches": launches["fm_score_launches"],
           "fm_score_bwd_launches": launches["fm_score_bwd_launches"],
           "serve_launches": serve_launches,
           "control_seconds": control_s,
           "control_max_abs_err": errs}
    emit(row)
    return row


OFFLOAD_VOCAB = 10 ** 8           # config #5's 10^9 rows, cut to 10^8
OFFLOAD_FACTORS = 8               # config #5: k = 8, a row of 9 floats
OFFLOAD_MIN_FREE_BYTES = 24 << 30  # two 7.2 GB steps, data, score files
OFFLOAD_HBM_PEAK = 1 << 30        # tools/offload_smoke.py's bound
OFFLOAD_LEG_STEPS = 8             # steps of the HostOffloadLookup leg
OFFLOAD_RUN_TIMEOUT = 600         # seconds for one train command
OFFLOAD_KERNELS = ("fm_score_kernel", "fm_score_bwd_kernel",
                   "offload_gather_kernel", "offload_adagrad_kernel")
# The offload train command in a subprocess, so that its host RSS and the
# card's peak are its own: the entry point ``python -m fast_tffm_tpu_torch
# train`` calls, with the backend's construction, the saves and the
# restore timed and measured, the host RSS (/proc's VmRSS) sampled every
# 10 ms and its peak kept per stage, and the four kernels' launch counts
# written to a JSON file when it returns. The peak is sampled because
# /proc lacks VmHWM under some container runtimes, and getrusage's peak
# then carries the RSS of the parent that forked the process.
OFFLOAD_TRAIN = r"""
import json, sys, threading, time
import torch
torch.zeros(1, device="cuda")  # the CUDA context sits in the baseline
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch import lookup as lu
from fast_tffm_tpu_torch import train as tr
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.ops import fm_kernel
from fast_tffm_tpu_torch.ops import offload_kernel as ok
out_path, argv = sys.argv[1], sys.argv[2:]
rec = {"saves": [], "restores": [], "start": lu.memory_report()}
make, save, restore = (tr.make_offload_backend, ck.CheckpointState.save,
                       ck.CheckpointState.restore)
make_step, evaluate = tr.make_offload_train_step, tr.evaluate
stage, peaks, done = ["start"], {}, threading.Event()


def rss_mb():
    with open("/proc/self/status") as fh:
        for ln in fh:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) // 1024


def sample():
    while True:
        now = stage[0]
        peaks[now] = max(peaks.get(now, 0), rss_mb())
        if done.wait(0.01):
            return


def staged(name, fn):
    def wrapper(*args, **kwargs):
        prev, stage[0] = stage[0], name
        try:
            return fn(*args, **kwargs)
        finally:
            stage[0] = prev
    return wrapper


def stepper(*args, **kwargs):
    step = make_step(*args, **kwargs)

    def staged_step(*a, **k):
        stage[0] = "steps"
        return step(*a, **k)
    return staged_step


def made(*args, **kwargs):
    t0 = time.perf_counter()
    lk = make(*args, **kwargs)
    rec["backend_seconds"] = time.perf_counter() - t0
    rec["backend"] = lu.memory_report()
    rec["state_bytes"] = lk.table.nbytes + lk.acc.nbytes
    rec["table_bytes"] = lk.table.nbytes
    rec["page_locked"] = [ok.is_page_locked(lk.table),
                          ok.is_page_locked(lk.acc)]
    rec["pinned_by_torch"] = [lk.table.is_pinned(), lk.acc.is_pinned()]
    rec["registered_bytes"] = ok.registered_bytes()
    rec["mode"] = lk.mode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec["hbm_after_backend"] = torch.cuda.memory_allocated()
    return lk


def timed_save(self, step, *args, **kwargs):
    t0 = time.perf_counter()
    out = save(self, step, *args, **kwargs)
    rec["saves"].append({"step": int(step), "wait": bool(kwargs.get("wait")),
                         "seconds": time.perf_counter() - t0})
    return out


def timed_restore(self, *args, **kwargs):
    t0 = time.perf_counter()
    out = restore(self, *args, **kwargs)
    rec["restores"].append({"step": None if out is None else out["step"],
                            "seconds": time.perf_counter() - t0})
    return out


tr.make_offload_backend = staged("backend", made)
tr.make_offload_train_step = stepper
tr.evaluate = staged("evaluate", evaluate)
ck.CheckpointState.save = staged("save", timed_save)
ck.CheckpointState.restore = staged("restore", timed_restore)
sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
rc = main(argv)
torch.cuda.synchronize()
done.set()
sampler.join()
rec.update(rc=rc, end=lu.memory_report(), rss_peaks_mb=peaks,
           hbm_peak=torch.cuda.max_memory_allocated(),
           fm_score=fm_kernel.launches, fm_score_bwd=fm_kernel.bwd_launches,
           offload_gather=ok.gather_launches,
           offload_adagrad=ok.adagrad_launches)
with open(out_path, "w") as fh:
    json.dump(rec, fh)
sys.exit(rc)
"""


def run_offload_train(wd, cfg_path, run, procs):
    """One offload train command in a subprocess (appended to ``procs``,
    so that ``offload_stop`` can end it); returns its record."""
    out_json = os.path.join(wd, f"run{run}.json")
    with open(os.path.join(wd, f"run{run}.out"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", OFFLOAD_TRAIN, out_json, "train",
             cfg_path], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=out, stderr=subprocess.STDOUT)
        procs.append(proc)
        try:
            proc.wait(timeout=OFFLOAD_RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        with open(os.path.join(wd, f"run{run}.out")) as fh:
            print(fh.read()[-6000:], flush=True)
    check(proc.returncode == 0,
          f"offload train run {run} exited {proc.returncode}")
    with open(out_json) as fh:
        return json.load(fh)


def events_median_ms(torch, fn, n, warmup=2):
    """Median CUDA-event time of ``fn(i)`` for i in [warmup, warmup + n),
    after ``warmup`` untimed calls; each interval includes any wait of
    the card for the host inside the call."""
    times = []
    for i in range(warmup + n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def compare_chunked(torch, got, want, device, rtol=1e-4, atol=1e-6,
                    chunk=1 << 24):
    """(count of elements outside |a - b| <= atol + rtol|b|, max |a - b|)
    over two [N, D] tensors, compared in row chunks on the card."""
    bad, worst = 0, 0.0
    for a in range(0, got.shape[0], chunk):
        x = got[a:a + chunk].to(device, non_blocking=True)
        y = want[a:a + chunk].to(device, non_blocking=True)
        diff = (x - y).abs()
        bad += int((diff > atol + rtol * y.abs()).sum())
        worst = max(worst, float(diff.max()))
    return bad, worst


def equal_rows(torch, got, want, keep, device, chunk=1 << 24):
    """Whether the rows ``keep`` (a bool mask on the card) of two
    [N, D] tensors are equal bit for bit, compared in row chunks on the
    card."""
    for a in range(0, got.shape[0], chunk):
        m = keep[a:a + chunk]
        x = got[a:a + chunk].to(device, non_blocking=True)
        y = want[a:a + chunk].to(device, non_blocking=True)
        if not torch.equal(x[m], y[m]):
            return False
    return True


def host_link_ms(torch, nbytes, device, to_card=True):
    """Median ms of a plain copy of ``nbytes`` between pinned host memory
    and the card (CUDA events), to the card or from it."""
    host = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    card = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    src, dst = (host, card) if to_card else (card, host)
    ms = events_median_ms(
        torch, lambda i: dst.copy_(src, non_blocking=True), TIMED_LAUNCHES)
    del host, card
    return ms


def offload_kernel_rows(torch, lk, spec, batch, device, card):
    """Both offload kernels against their plain versions on one host-
    deduped batch of the phase, as a step of pinned backend ``lk``: the
    gather exact, the write-back within rtol 1e-6 of the
    plain version on the card's copy of the rows (the kernel's rsqrtf
    against torch.rsqrt on the card, which is CUDA's rsqrtf too); then
    each kernel's device ms (profiler, else CUDA events) and event ms,
    L2 flushed before each launch (a step reads rows no earlier launch
    brought in), the plain version's ms on the CPU, the bytes over the host link and
    in device memory, and the bound: each direction's host-link bytes at
    that direction's peak rate (a LINK_PEAK_BYTES pinned copy, measured
    here; the link is full duplex, so the larger of the two times), or
    the device-memory bytes at HBM_BYTES_PER_S if that is longer. The
    gather reads U·D·4 bytes from the host; the write-back reads the
    U·D·4 accumulator bytes and writes 2·U·D·4 back. A plain copy of the
    gather's bytes alone is timed beside them (a copy that small is
    mostly its fixed cost)."""
    import numpy as np
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.ops import offload_kernel as ok
    ids = batch["uniq_ids"]
    ids_cpu = ids.cpu()
    U, D = int(ids.shape[0]), lk.dim
    lr = spec.learning_rate
    rows = ok.offload_gather(lk.table, ids)
    torch.cuda.synchronize()
    plain_rows = ok.offload_gather_plain(lk.table, ids_cpu)
    check(torch.equal(rows.cpu(), plain_rows),
          "offload_gather differs from its plain version")
    _, _, grad = port_fm.grad_body(spec, rows, batch["labels"],
                                   batch["weights"], ids,
                                   batch["local_idx"], batch["vals"])
    acc_rows = ok.offload_gather_plain(lk.acc, ids_cpu).to(device)
    want_acc, want_rows = ok.adagrad_rows(acc_rows, rows, grad, lr)
    ok.offload_adagrad(lk.table, lk.acc, ids, rows, grad, lr)
    torch.cuda.synchronize()
    got_rows = ok.offload_gather_plain(lk.table, ids_cpu).to(device)
    got_acc = ok.offload_gather_plain(lk.acc, ids_cpu).to(device)
    errs = []
    for got, want, what in ((got_rows, want_rows, "rows"),
                            (got_acc, want_acc, "accumulator")):
        diff = (got - want).abs()
        check(bool((diff <= 1e-6 * want.abs()).all()),
              f"offload_adagrad {what} outside rtol 1e-6 of the plain "
              f"version (max abs diff {float(diff.max())})")
        errs.append(float(diff.max()))
    check(not lk.table[-1].any() and not
          ok.offload_gather_plain(lk.table, torch.tensor(
              [spec.vocabulary_size], dtype=torch.int32)).any(),
          "the pad row moved")

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows_bytes = U * D * 4
    # GB/s each way, from copies long enough to show the link's rate.
    h2d_rate, d2h_rate = (
        LINK_PEAK_BYTES / host_link_ms(torch, LINK_PEAK_BYTES, device,
                                       to_card) / 1e6
        for to_card in (True, False))
    rows_copy_ms = host_link_ms(torch, rows_bytes, device)
    out = []
    for name, h2d_bytes, d2h_bytes, hbm_bytes, run, plain in (
            ("offload_gather", rows_bytes, 0, U * 4 + rows_bytes,
             lambda: ok.offload_gather(lk.table, ids),
             lambda: ok.offload_gather_plain(lk.table, ids_cpu)),
            ("offload_adagrad", rows_bytes, 2 * rows_bytes,
             U * 4 + 2 * rows_bytes,
             lambda: ok.offload_adagrad(lk.table, lk.acc, ids, rows, grad,
                                        lr),
             lambda: ok.offload_adagrad_plain(lk.table, lk.acc, ids_cpu,
                                              rows.cpu(), grad.cpu(), lr))):
        launch = Launch(run)
        device_ms, timing = kernel_ms(torch, launch, flush,
                                      (name + "_kernel",))
        ev_ms = event_ms(torch, launch, flush)
        torch.cuda.synchronize()
        plain_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            plain()
            plain_times.append((time.perf_counter() - t0) * 1e3)
        bound_ms = max(h2d_bytes / h2d_rate / 1e6,
                       d2h_bytes / d2h_rate / 1e6,
                       hbm_bytes / HBM_BYTES_PER_S * 1e3)
        out.append({"phase": "kernel", "name": name, "card": card,
                    "U": U, "D": D, "device_ms": device_ms,
                    "device_timing": timing, "event_ms": ev_ms,
                    "plain_ms": sorted(plain_times)[2],
                    "plain_on": "cpu",
                    "host_link_bytes": h2d_bytes + d2h_bytes,
                    "host_to_card_bytes": h2d_bytes,
                    "card_to_host_bytes": d2h_bytes, "hbm_bytes": hbm_bytes,
                    "link_peak_copy_bytes": LINK_PEAK_BYTES,
                    "host_to_card_GBps": h2d_rate,
                    "card_to_host_GBps": d2h_rate,
                    "rows_copy_ms": rows_copy_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "max_abs_err": 0.0 if name == "offload_gather"
                    else max(errs)})
    for row in out:
        emit(row)
    offload_diagnosis(torch, lk, ids, grad, lr, flush, card)
    return out


def offload_diagnosis(torch, lk, ids, grad, lr, flush, card):
    """What bounds the offload kernels, on pinned backend ``lk``'s state,
    a batch's ``ids`` (U host-deduped rows) and ``grad``: event ms of one
    launch alone, L2 flushed before each (event_ms), of
    (a) the gather of the batch's table rows;
    (b) the same gather of U ids inside one 2 MiB span of the table,
        spaced so that no two rows share a 32-byte sector: as many
        requests over the link, on 513 pages of 4 KiB where (a) touches
        about U;
    (c) the write-back (it loads each accumulator element, then stores
        both rows) on the batch's ids, and (c_span) on the span's;
    (e) the gather of the batch's accumulator rows alone;
    each in a forward and a reverse round. The write-back's runs move the
    rows they touch, so this runs after every check of the state."""
    import numpy as np
    from fast_tffm_tpu_torch.ops import offload_kernel as ok
    U, D, R = int(ids.shape[0]), lk.dim, lk.table.shape[0]
    span = 2 << 20
    stride = max(128, span // U)  # bytes between span rows
    first = (R // 2) * D * 4 // span * span // (D * 4) + 1
    span_ids = torch.from_numpy(
        (first + np.arange(U, dtype=np.int64) * stride // (D * 4))
        .astype(np.int32)).to(ids.device)
    rows = ok.offload_gather(lk.table, ids)
    span_rows = ok.offload_gather(lk.table, span_ids)
    arms = [
        ("a_gather", lambda: ok.offload_gather(lk.table, ids)),
        ("b_gather_span", lambda: ok.offload_gather(lk.table, span_ids)),
        ("c_writeback", lambda: ok.offload_adagrad(
            lk.table, lk.acc, ids, rows, grad, lr)),
        ("c_writeback_span", lambda: ok.offload_adagrad(
            lk.table, lk.acc, span_ids, span_rows, grad, lr)),
        ("e_gather_acc", lambda: ok.offload_gather(lk.acc, ids))]
    got = {name: [] for name, _ in arms}
    for order in (arms, arms[::-1]):
        for name, run in order:
            got[name].append(event_ms(torch, Launch(run), flush))
    row = {"phase": "offload_diagnosis", "card": card, "U": U, "D": D,
           "rows": R, "span_bytes": stride * U, "event_ms": got}
    emit(row)
    return row


def offload_reset_check(torch, np, lu, spec, cfg, pinned, host, batches):
    """Admit mode's eviction hook on the pinned backend: a step queues
    its write-back into the page-locked state, and ``reset_rows`` straight
    after it, over a set holding the batch's hottest row, must leave
    exactly 0.0 and ``adagrad_init`` there (the plain expectation: the
    reset waits for the write-back); the next step must then match the
    HostOffloadLookup backend's (the control) on every row the two
    batches touch, at rtol 1e-4 / atol 1e-6."""
    b0, b1 = batches[0], batches[1]
    uniq = b0["uniq_ids"].cpu().numpy()
    real = (b0["vals"] != 0).reshape(-1).cpu().numpy()
    counts = np.bincount(b0["local_idx"].reshape(-1).cpu().numpy()[real],
                         minlength=len(uniq))
    hottest = int(uniq[int(np.argmax(counts))])
    live = uniq[uniq != cfg.pad_id]
    rng = np.random.default_rng(SEED + 30)
    reset = np.unique(np.concatenate([[hottest], rng.choice(
        live, 255, replace=False)])).astype(np.int32)
    legs = [(lk, lu.make_offload_train_step(spec, lk, spec.learning_rate))
            for lk in (pinned, host)]
    t0 = time.perf_counter()
    for lk, step in legs:
        step(**b0)
        lk.reset_rows(reset, cfg.adagrad_init)
        if lk is pinned:
            reset_s = time.perf_counter() - t0
            table, acc = pinned.state()
            idx = torch.from_numpy(reset.astype(np.int64))
            check(not table.index_select(0, idx).any().item()
                  and bool((acc.index_select(0, idx)
                            == np.float32(cfg.adagrad_init)).all()),
                  "pinned reset_rows straight after a step: a reset row "
                  "holds the step's write-back")
    for _, step in legs:
        step(**b1)
    rows = torch.from_numpy(np.unique(np.concatenate(
        [uniq, b1["uniq_ids"].cpu().numpy()])).astype(np.int64))
    worst = 0.0
    for got, want in zip(pinned.state(), host.state()):
        g, w = got.index_select(0, rows), want.index_select(0, rows)
        diff = (g - w).abs()
        check(bool((diff <= 1e-6 + 1e-4 * w.abs()).all()),
              "the step after reset_rows differs from the control's")
        worst = max(worst, float(diff.max()))
    return {"rows": int(len(reset)), "hottest_row": hottest,
            "hottest_row_slots": int(counts.max()),
            "reset_seconds_after_step": reset_s, "next_step_max_abs_err":
                worst}


def offload_start(data):
    """Start the offload phase's two train commands, run A (one epoch)
    and run B (resumed to two) of ``python -m fast_tffm_tpu_torch train``
    with ``lookup = host``, one after the other in subprocesses driven by
    a background thread, so that they run beside the admit phase;
    ``offload_phase`` checks them and does the rest. Returns the
    handle."""
    wd = os.path.join(WORK, "offload")
    os.makedirs(wd)
    free = shutil.disk_usage(wd).free
    check(free >= OFFLOAD_MIN_FREE_BYTES,
          f"{free} bytes free under {wd}; the offload phase needs "
          f"{OFFLOAD_MIN_FREE_BYTES}")
    paths = [write_train_cfg(data[0], epochs, save_steps=0,
                             leg="offload", model="lookup = host",
                             vocab=OFFLOAD_VOCAB, factors=OFFLOAD_FACTORS)
             for epochs in (1, TRAIN_EPOCHS)]
    h = {"wd": wd, "paths": paths, "recs": [], "run_s": [], "errors": [],
         "procs": [], "t0": time.perf_counter()}

    def runner():
        try:
            for run, path in enumerate(paths):
                t0 = time.perf_counter()
                h["recs"].append(run_offload_train(wd, path, run,
                                                   h["procs"]))
                h["run_s"].append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - offload_phase raises
            h["errors"].append(e)

    h["thread"] = threading.Thread(target=runner, name="smoke-offload-runs",
                                   daemon=True)
    h["thread"].start()
    return h


def offload_stop(h):
    """Stop the offload runs' processes (a no-op once finished)."""
    if h is None:
        return
    for proc in h["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    h["thread"].join(timeout=60)


def offload_phase(torch, device, card, train_row, h):
    """``lookup = host`` at config #5's width (2nd-order FM, k = 8, hashed
    ids) with 10^8 rows: a [10^8+1, 9] f32 table and its accumulator,
    7.2 GB of page-locked host state. Run A (one epoch) and run B
    (resumed to two) of ``python -m fast_tffm_tpu_torch train`` in
    subprocesses (``offload_start``'s handle ``h``: they ran beside the
    admit phase); a control run of the device path in process; predict
    of step 32 on both wires against device-lookup predict; both offload
    kernels against their plain versions, and both FM kernels on an
    offload batch; the HostOffloadLookup leg. Returns (the phase's row,
    the offload kernels' rows, the FM forward's and backward's rows)."""
    import dataclasses
    import re
    import numpy as np
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch import lookup as lu
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.ops import offload_kernel as ok
    from fast_tffm_tpu_torch.train import checkpoint_template
    wd, paths, t_phase = h["wd"], h["paths"], h["t0"]
    t_visible = time.perf_counter()
    try:
        cfg = load_config(paths[-1])
        check(cfg.lookup == "host" and cfg.dedup == "auto",
              f"offload config: lookup {cfg.lookup}, dedup {cfg.dedup}")
        spec = port_fm.ModelSpec.from_config(cfg)
        check(spec.dedup == "host", f"dedup = auto resolved to {spec.dedup}")
        steps = -(-TRAIN_LINES // TRAIN_BATCH)
        val_batches = -(-VAL_LINES // TRAIN_BATCH)
        table_bytes = cfg.ckpt_rows * cfg.row_dim * 4

        # Run A: one epoch and its final save at step 16; run B: restore
        # into page-locked memory, resume at epoch 1/2, end at step 32.
        h["thread"].join(timeout=2 * OFFLOAD_RUN_TIMEOUT)
        if h["errors"]:
            raise h["errors"][0]
        check(not h["thread"].is_alive() and len(h["recs"]) == 2,
              "the offload runs did not finish")
        recs, run_s = h["recs"], h["run_s"]
        with open(cfg.log_file) as fh:
            log = fh.read()
        check(log.count("offload lookup [pinned-host (pinned)]: table "
                        f"[{cfg.ckpt_rows}, {cfg.row_dim}] outside HBM") == 2,
              "the runs did not log the pinned offload backend")
        check("restored checkpoint at step 16" in log and
              "resuming interrupted epoch schedule at epoch 1/2" in log,
              "run B did not restore step 16 and resume at epoch 1/2")
        losses, rates, aucs, done = read_train_log(cfg.log_file)
        check([n for n, _ in done] == [steps, 2 * steps],
              f"the offload runs ended at steps {done}")
        mean_loss = [float(np.mean(losses[e])) for e in range(TRAIN_EPOCHS)]
        check(all(np.isfinite(v).all() for v in losses.values())
              and mean_loss[-1] < mean_loss[0],
              f"offload mean loss did not fall: {mean_loss}")
        check(len(aucs) == TRAIN_EPOCHS and aucs[-1] > train_row["auc_floor"],
              f"offload validation AUC {aucs} not above "
              f"{train_row['auc_floor']}")
        for run, r in enumerate(recs):
            want = (steps + val_batches, steps, steps + val_batches, steps)
            got = (r["fm_score"], r["fm_score_bwd"], r["offload_gather"],
                   r["offload_adagrad"])
            check(got == want, f"run {run} launched fm_score, fm_score_bwd, "
                  f"offload_gather, offload_adagrad {got} times, want {want}")
            check(r["mode"] == "pinned" and all(r["page_locked"])
                  and r["registered_bytes"] == r["state_bytes"]
                  == 2 * table_bytes,
                  f"run {run}: state not page-locked: {r}")
            check(r["hbm_peak"] < OFFLOAD_HBM_PEAK,
                  f"run {run}: the card's peak allocated bytes "
                  f"{r['hbm_peak']} not under {OFFLOAD_HBM_PEAK}")
            # In tables' bytes over the RSS before the restore and the
            # backend: the growth once the state is built, the sampled
            # peak up to then (init or restore) and over the whole run.
            peaks = r["rss_peaks_mb"]
            tables = [(mb - r["start"]["host_rss_mb"])
                      / (table_bytes / 2**20) for mb in (
                          r["backend"]["host_rss_mb"],
                          max(peaks.get(k, 0) for k in
                              ("start", "restore", "backend")),
                          max(peaks.values()))]
            (r["rss_growth_tables"], r["rss_init_peak_tables"],
             r["rss_peak_tables"]) = tables
            r["rss_peak_stage"] = max(peaks, key=peaks.get)
            check(1.9 <= tables[0] <= 2.3 and tables[1] <= 3.0
                  and tables[2] <= 3.0,
                  f"run {run}: host RSS grew by {tables[0]} and peaked at "
                  f"{tables[1]} up to the backend, {tables[2]} in all "
                  f"(tables' bytes; want about 2 and at most 3); peaks "
                  f"by stage {peaks}")
        commits = committed_steps_in_log(cfg.log_file)
        check([c["step"] for c in commits] == [steps, 2 * steps],
              f"committed offload steps: {commits}")
        state = {s: sorted(os.listdir(os.path.join(
            cfg.model_file + ".ckpt", str(s)))) for s in (16, 32)}
        check(all(v == ["acc.pt", "meta.json", "table.pt"]
                  for v in state.values()), f"offload steps: {state}")

        # Control: run A's initial table drawn again by the port's host
        # init (a CPU generator: the same numbers), stepped on the card
        # through the device path's train_step_body over run A's stream,
        # in process (no prefetch thread, no wire encoder), timed.
        t0 = time.perf_counter()
        t_host, a_host = lu.init_host_state(cfg, cfg.seed)
        table = t_host[:cfg.num_rows].to(device)
        acc = a_host[:cfg.num_rows].to(device)
        del t_host, a_host
        torch.cuda.synchronize()
        control_init_s = time.perf_counter() - t0
        it = batch_iterator(cfg, cfg.train_files, training=True, epochs=1,
                            seed=cfg.seed, raw_ids=False)
        n_control = 0
        t0 = time.perf_counter()
        try:
            for b in it:
                table, acc, _, _ = port_fm.train_step_body(
                    spec, table, acc, **port_fm.batch_args(b, device))
                n_control += b.num_real
        finally:
            it.close()
        torch.cuda.synchronize()
        control_loop_s = time.perf_counter() - t0
        ckpt = ck.CheckpointState(cfg.model_file)
        stored = ckpt.restore(step=steps, template=checkpoint_template(cfg))
        ckpt.close()
        control = {}
        for name, got in (("table", table), ("acc", acc)):
            bad, worst = compare_chunked(torch, got, stored[name], device)
            control[name] = worst
            check(bad == 0, f"control run {name}: {bad} elements outside "
                  f"rtol 1e-4 / atol 1e-6 of run A's step {steps} (max abs "
                  f"diff {worst})")
        del stored

        # The device path's resident step on this state, beside the
        # offload backend's below.
        batches = []
        it = batch_iterator(cfg, cfg.train_files, training=True, epochs=1,
                            raw_ids=False)
        try:
            for b in it:
                batches.append(port_fm.batch_args(b, device))
                if len(batches) == OFFLOAD_LEG_STEPS:
                    break
        finally:
            it.close()
        device_step_ms = events_median_ms(
            torch, lambda i: port_fm.train_step_body(
                spec, table, acc, **batches[i % len(batches)]),
            RESIDENT_STEPS)
        # Both FM kernels against their plain versions on the shapes the
        # offload step gives them: a host-deduped batch's rows of this
        # table (K = 8, Zipf-skewed, U at the dedup's rung).
        fwd_rows, bwd_rows = train_batch_kernel_rows(
            torch, spec, table, batches[0], device, tag="offload")
        del table, acc
        torch.cuda.empty_cache()

        # Predict of step 32: device lookup, then lookup = host on the
        # padded and the packed wire, equal byte for byte.
        predict_paths, predict_s, predict_launches = {}, {}, {}
        for name, text in (("device", "lookup = device"),
                           ("padded", "lookup = host"),
                           ("packed", "lookup = host")):
            with open(paths[-1]) as fh:
                body = fh.read().replace("lookup = host", text).replace(
                    "score_offload", f"score_offload_{name}")
            if name == "packed":
                body = body.replace("[Train]\n", "[Train]\nwire_format = "
                                    "packed\n")
            p = os.path.join(wd, f"predict_{name}.cfg")
            with open(p, "w") as fh:
                fh.write(body)
            fm_kernel.launches = 0
            ok.gather_launches = 0
            t0 = time.perf_counter()
            rc = cli(["predict", p])
            predict_s[name] = time.perf_counter() - t0
            check(rc == 0, f"offload phase predict ({name}) returned {rc}")
            predict_launches[name] = (fm_kernel.launches, ok.gather_launches)
            predict_paths[name] = os.path.join(load_config(p).score_path,
                                               "val.txt.score")
        check(predict_launches["padded"] == predict_launches["packed"]
              == (val_batches, val_batches)
              and predict_launches["device"] == (val_batches, 0),
              f"predict launches (fm_score, offload_gather): "
              f"{predict_launches}")
        with open(predict_paths["device"], "rb") as fh:
            want = fh.read()
        for name in ("padded", "packed"):
            with open(predict_paths[name], "rb") as fh:
                check(fh.read() == want, f"offload predict ({name}) differs "
                      "from device-lookup predict")
        check(len(want.splitlines()) == VAL_LINES,
              f"{len(want.splitlines())} predict lines for {VAL_LINES}")
        with open(cfg.log_file) as fh:
            log = fh.read()
        check(log.count("offload predict [PinnedHostLookup]: table "
                        f"[{cfg.ckpt_rows}, {cfg.row_dim}] outside HBM")
              == 2, "offload predict did not log its backend")
        shutil.rmtree(os.path.dirname(cfg.model_file))  # the 14.4 GB steps

        # Eight steps of the same batches on the pinned backend and on the
        # HostOffloadLookup leg (a blocking gradient fetch a step), from
        # the same init; then the pinned backend's resident step, and
        # both kernels against their plain versions on its state.
        t0 = time.perf_counter()
        pinned = lu.PinnedHostLookup(cfg, cfg.seed, device=device)
        init_s = time.perf_counter() - t0
        host = lu.HostOffloadLookup(cfg, cfg.seed, device=device)
        legs = {}
        for name, lk in (("pinned", pinned), ("host_offload", host)):
            step = lu.make_offload_train_step(spec, lk, spec.learning_rate)
            legs[name] = events_median_ms(
                torch, lambda i: step(**batches[i]), OFFLOAD_LEG_STEPS - 2)
        leg_err = {}
        for name, got, want in zip(("table", "acc"), pinned.state(),
                                   host.state()):
            bad, worst = compare_chunked(torch, got, want, device)
            leg_err[name] = worst
            check(bad == 0, f"HostOffloadLookup leg {name}: {bad} elements "
                  f"outside rtol 1e-4 / atol 1e-6 of the pinned backend's "
                  f"(max abs diff {worst})")
        reset_row = offload_reset_check(torch, np, lu, spec, cfg, pinned,
                                        host, batches)
        del host
        # The control's loop again with the pinned backend's step (the
        # same stream, batch building and copies): the two paths' rates
        # side by side, the entry point's loop apart.
        step = lu.make_offload_train_step(spec, pinned, spec.learning_rate)
        it = batch_iterator(cfg, cfg.train_files, training=True, epochs=1,
                            seed=cfg.seed, raw_ids=False)
        n_offload = 0
        t0 = time.perf_counter()
        try:
            for b in it:
                step(**port_fm.batch_args(b, device))
                n_offload += b.num_real
        finally:
            it.close()
        torch.cuda.synchronize()
        offload_loop_s = time.perf_counter() - t0
        # The resident offload step: batches on the card, state on the
        # host; its median by CUDA events and its device ms by kernel.
        offload_step_ms = events_median_ms(
            torch, lambda i: step(**batches[i % len(batches)]),
            RESIDENT_STEPS)
        per_kernel, seen = step_kernel_ms(
            torch, lambda i: step(**batches[i % len(batches)]),
            names=OFFLOAD_KERNELS)
        kernel_rows = offload_kernel_rows(torch, pinned, spec, batches[0],
                                          device, card)
        del pinned, step, batches
        torch.cuda.empty_cache()
    finally:
        offload_stop(h)
        shutil.rmtree(wd, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    top = (None if per_kernel is None else
           dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]))
    final = [s for r in recs for s in r["saves"] if s["wait"]]
    row = {"phase": "offload", "card": card, "rows": cfg.num_rows,
           "ckpt_rows": cfg.ckpt_rows, "row_dim": cfg.row_dim,
           "table_bytes": table_bytes, "state_bytes": 2 * table_bytes,
           "reduced": "vocabulary 10^9 -> 10^8 rows (7.2 GB of state "
                      "where config #5 has 72 GB)",
           "lines": TRAIN_LINES, "validation_lines": VAL_LINES,
           "batch_size": TRAIN_BATCH, "steps": 2 * steps,
           "run_seconds": run_s, "phase_seconds": phase_s,
           "visible_seconds": time.perf_counter() - t_visible,
           "epoch_mean_loss": mean_loss, "validation_auc": aucs,
           "auc_floor": train_row["auc_floor"],
           "examples_per_s_loop": (len(rates) * TRAIN_BATCH
                                   / sum(TRAIN_BATCH / r for r in rates)),
           "examples_per_s_train_log": [e for _, e in done],
           "device_path_examples_per_s_inprocess_loop":
               n_control / control_loop_s,
           "examples_per_s_inprocess_loop": n_offload / offload_loop_s,
           "device_path_control_init_seconds": control_init_s,
           "resident_step_ms_median": offload_step_ms,
           "device_path_resident_step_ms_median": device_step_ms,
           "profiled_device_ms_per_step":
               None if per_kernel is None else sum(per_kernel.values()),
           "profiled_kernels_ms_per_step": top,
           "profiled_kernel_launches_seen": seen,
           "pinned_leg_step_ms_median": legs["pinned"],
           "host_offload_leg_step_ms_median": legs["host_offload"],
           "host_offload_leg_max_abs_err": leg_err,
           "reset_rows": reset_row,
           "backend_init_seconds": init_s,
           "backend_seconds_by_run": [r["backend_seconds"] for r in recs],
           "page_locked_bytes": recs[0]["registered_bytes"],
           "torch_is_pinned_by_run": [r["pinned_by_torch"] for r in recs],
           "hbm_peak_bytes_by_run": [r["hbm_peak"] for r in recs],
           "hbm_after_backend_by_run": [r["hbm_after_backend"] for r in recs],
           "host_rss_growth_tables_by_run":
               [r["rss_growth_tables"] for r in recs],
           "host_rss_init_peak_tables_by_run":
               [r["rss_init_peak_tables"] for r in recs],
           "host_rss_peak_tables_by_run": [r["rss_peak_tables"] for r in recs],
           "host_rss_peak_stage_by_run": [r["rss_peak_stage"] for r in recs],
           "host_rss_start_mb_by_run": [r["start"]["host_rss_mb"]
                                        for r in recs],
           "final_save_seconds": [s["seconds"] for s in final],
           "final_save_steps": [s["step"] for s in final],
           "checkpoint_commits": commits,
           "restore_seconds": [s["seconds"] for r in recs
                               for s in r["restores"] if s["step"]],
           "predict_seconds": predict_s,
           "predict_launches": predict_launches,
           "control_max_abs_err": control,
           "fm_score_launches": sum(r["fm_score"] for r in recs)
               + predict_launches["padded"][0]
               + predict_launches["packed"][0],
           "fm_score_bwd_launches": sum(r["fm_score_bwd"] for r in recs),
           "offload_gather_launches": sum(r["offload_gather"] for r in recs)
               + predict_launches["padded"][1]
               + predict_launches["packed"][1],
           "offload_adagrad_launches":
               sum(r["offload_adagrad"] for r in recs)}
    emit(row)
    return row, kernel_rows, fwd_rows, bwd_rows


ADMIT_SAVE_STEPS = 8              # periodic saves at 8, 16, 24, 32: each
# barrier's step (16, 32) is a periodic save's too, and the final save
# after the barrier writes that step anew (its rows were cold-started)
ADMIT_CONTROLS = 2                # in-process control runs of one stream
ADMIT_VOCAB = ("[Vocab]\nvocab_mode = admit\nvocab_admit_threshold = 2\n"
               "vocab_decay = 0.5\nvocab_sketch_mb = 1\n")
ADMIT_REMAP_BATCHES = 8           # batches the remap is timed on


class AdmitTimes:
    """While active, times what admit mode adds to a train command: each
    barrier (seconds, its stats), each row reset on the card (CUDA
    events around ``reset_table_rows``), each remap on the build side,
    and each vocab sidecar write (seconds and bytes)."""

    def __enter__(self):
        import fast_tffm_tpu_torch.checkpoint as ck
        import fast_tffm_tpu_torch.train as tr
        from fast_tffm_tpu_torch.vocab.table import VocabMap, VocabRuntime
        self.barriers, self.resets, self.remaps, self.sidecars = \
            [], [], [], []
        self._orig = (VocabRuntime.barrier, tr.reset_table_rows,
                      VocabMap.remap, ck.write_vocab_sidecar)
        barrier, reset, remap, write = self._orig

        def timed_barrier(rt, *args, **kwargs):
            t0 = time.perf_counter()
            out = barrier(rt, *args, **kwargs)
            self.barriers.append(dict(out, seconds=time.perf_counter() - t0))
            return out

        def timed_reset(table, acc, rows, *args):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            reset(table, acc, rows, *args)
            end.record()
            end.synchronize()
            self.resets.append({"rows": int(len(rows)),
                                "ms": start.elapsed_time(end)})

        def timed_remap(vm, batch):
            t0 = time.perf_counter()
            out = remap(vm, batch)
            self.remaps.append((time.perf_counter() - t0) * 1e3)
            return out

        def timed_write(directory, step, payload):
            t0 = time.perf_counter()
            path = write(directory, step, payload)
            self.sidecars.append({"step": int(step),
                                  "seconds": time.perf_counter() - t0,
                                  "bytes": os.path.getsize(path)})
            return path
        VocabRuntime.barrier = timed_barrier
        tr.reset_table_rows = timed_reset
        VocabMap.remap = timed_remap
        ck.write_vocab_sidecar = timed_write
        return self

    def __exit__(self, *exc):
        import fast_tffm_tpu_torch.checkpoint as ck
        import fast_tffm_tpu_torch.train as tr
        from fast_tffm_tpu_torch.vocab.table import VocabMap, VocabRuntime
        (VocabRuntime.barrier, tr.reset_table_rows, VocabMap.remap,
         ck.write_vocab_sidecar) = self._orig


def copy_step(src_dir, dst_dir, step):
    """A committed step with its manifest and vocab sidecar, into
    another checkpoint directory."""
    os.makedirs(dst_dir, exist_ok=True)
    shutil.copytree(os.path.join(src_dir, str(step)),
                    os.path.join(dst_dir, str(step)))
    for name in (f"manifest-{step}.json", f"vocab-{step}.json.gz"):
        shutil.copy2(os.path.join(src_dir, name),
                     os.path.join(dst_dir, name))


def slot_map(payload):
    """{hashed id: physical row} of a vocab sidecar payload."""
    import base64
    import numpy as np
    keys = np.frombuffer(base64.b64decode(payload["state"]["slot_keys"]),
                         np.int64)
    rows = np.frombuffer(base64.b64decode(payload["state"]["slot_rows"]),
                         np.int32)
    return dict(zip(keys.tolist(), rows.tolist()))


def barrier_lines(log):
    """(where, admitted, evicted, live) of each 'vocab barrier' line."""
    import re
    return [(w, int(a), int(e), int(n)) for w, a, e, n in re.findall(
        r"vocab barrier \((.*?)\): \+(\d+) admitted, -(\d+) evicted, "
        r"(\d+)/\d+ live rows", log)]


def admit_phase(torch, device, card, data, train_row):
    """``vocab_mode = admit`` at config #2's width: run A (the train
    phase's lines, one epoch) and run B (restores step 16 with its slot
    map, one more epoch on lines whose high-cardinality ids run A never
    saw) of ``python -m fast_tffm_tpu_torch train`` in process; the slot
    maps, the freed rows, fmckpt, a control run in process, admit predict
    on both wires, the fixed-mode refusal, a ScorerServer across the
    reload of step 16 to 32 and a torn sidecar's failed reload, and both
    kernels on a remapped batch. Returns (the phase's row, the forward's
    and the backward's kernel rows)."""
    import dataclasses
    import io
    import numpy as np
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.metrics import exact_auc
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.predict import predict
    from fast_tffm_tpu_torch.serve.frontend import make_http_server
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    from fast_tffm_tpu_torch.tools import fmckpt
    from fast_tffm_tpu_torch.train import checkpoint_template
    from fast_tffm_tpu_torch.vocab.sketch import HASH_SPACE
    from fast_tffm_tpu_torch.vocab.table import (COLD_ROW, VocabMap,
                                                 VocabRuntime,
                                                 reset_table_rows)
    data_wd = data[0]
    t_phase = time.perf_counter()
    # Run B's lines: the planted fields' tokens as run A's, the
    # high-cardinality fields' ids new.
    t0 = time.perf_counter()
    model = planted_model(SEED + 4)
    b_train, _ = criteo_lines(TRAIN_LINES, SEED + 21, model, fresh=True)
    b_val, b_logits = criteo_lines(VAL_LINES, SEED + 22, model, fresh=True)
    for name, lines in (("b_train.txt", b_train), ("b_val.txt", b_val)):
        with open(os.path.join(data_wd, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    del b_train
    gen_s = time.perf_counter() - t0
    paths = [write_train_cfg(data_wd, 1, save_steps=ADMIT_SAVE_STEPS,
                             leg="admit", model=ADMIT_VOCAB),
             write_train_cfg(data_wd, 2, save_steps=ADMIT_SAVE_STEPS,
                             leg="admit", model=ADMIT_VOCAB, files="b_")]
    cfg_a, cfg = load_config(paths[0]), load_config(paths[1])
    check(cfg.vocab_mode == "admit" and cfg.vocab_admit_threshold == 2
          and cfg.vocab_decay == 0.5 and cfg.vocab_sketch_mb == 1
          and cfg.vocabulary_size == VOCAB and cfg.dedup == "auto",
          f"admit config: {cfg}")
    spec = port_fm.ModelSpec.from_config(cfg)
    directory = cfg.model_file + ".ckpt"
    serve_model = os.path.join(WORK, "admit_serve", "fm_model")
    serve_dir = serve_model + ".ckpt"
    steps = -(-TRAIN_LINES // TRAIN_BATCH)
    val_batches = -(-VAL_LINES // TRAIN_BATCH)
    floor = train_row["auc_floor"]
    torn_step = 2 * steps + 8  # the serving directory's torn copy

    def ls_verify(step):
        """fmckpt ls's line for ``step`` and verify --mode full of it."""
        out, vout = io.StringIO(), io.StringIO()
        fmckpt.cmd_ls(directory, out=out)
        rc = fmckpt.cmd_verify(directory, mode="full", step=step, out=vout)
        line = next((ln for ln in out.getvalue().splitlines()
                     if ln.strip().startswith(f"step {step} ")), "")
        print(line + "\n" + vout.getvalue(), end="", flush=True)
        check("+VOCAB" in line, f"fmckpt ls does not mark step {step} "
              f"+VOCAB: {line!r}")
        check(rc == 0 and "+vocab crc OK" in vout.getvalue(),
              f"fmckpt verify --step {step}: {vout.getvalue()}")

    # Run A, then run B, through the entry point; the launches of each.
    run_s, launches = [], []
    with AdmitTimes() as times, CheckpointTimes() as ck_times:
        for run, path in enumerate(paths):
            fm_kernel.launches = fm_kernel.bwd_launches = 0
            t0 = time.perf_counter()
            rc = cli(["train", path])
            run_s.append(time.perf_counter() - t0)
            launches.append((fm_kernel.launches, fm_kernel.bwd_launches))
            check(rc == 0, f"admit train ({path}) returned {rc}")
            if run == 0:
                payload16 = ck.read_vocab_sidecar(directory, steps)
                check(payload16 is not None, "run A left no sidecar at 16")
                ls_verify(steps)
                copy_step(directory, serve_dir, steps)
    entry_remaps = list(times.remaps)
    for run, (f, b) in enumerate(launches):
        check(b == steps and f == steps + val_batches,
              f"admit run {run} launched fm_score {f} and fm_score_bwd {b} "
              f"times for {steps} steps and {val_batches} validation "
              "batches")
    with open(cfg.log_file) as fh:
        log = fh.read()
    check(f"restored checkpoint at step {steps}" in log
          and "resuming interrupted epoch schedule at epoch 1/2" in log
          and f"restored vocab admission state at step {steps}: "
              f"{len(slot_map(payload16))} live rows" in log,
          "run B did not restore step 16 with its slot map")
    # Each barrier's step is written twice: its periodic save, then anew
    # by the final save after the barrier moved the slot map.
    commits = sorted(c["step"] for c in committed_steps_in_log(
        cfg.log_file))
    check(commits == sorted(list(range(ADMIT_SAVE_STEPS, 2 * steps + 1,
                                       ADMIT_SAVE_STEPS)) + [steps, 2 * steps]),
          f"admit commits {commits}")
    barriers = barrier_lines(log)
    check([w for w, *_ in barriers] == ["epoch 0", f"final save step "
                                        f"{steps}", "epoch 1",
                                        f"final save step {2 * steps}"],
          f"barriers: {barriers}")
    check(barriers[0][1] >= 1 and barriers[2][2] >= 1
          and barriers[1][1:3] == barriers[3][1:3] == (0, 0),
          f"run A's barrier admitted {barriers[0][1]}, run B's evicted "
          f"{barriers[2][2]} (the final-save barriers must be no-ops)")
    check(all(n <= VOCAB - 1 for *_, n in barriers), f"live rows {barriers}")
    losses, rates, aucs, done = read_train_log(cfg.log_file)
    mean_loss = [float(np.mean(losses[e])) for e in range(2)]
    check(all(np.isfinite(v).all() for v in losses.values())
          and mean_loss[1] < mean_loss[0],
          f"admit mean loss did not fall: {mean_loss}")
    # Run A trains every id through the cold row (nothing is admitted
    # before its epoch's barrier), and its validation sweep follows that
    # barrier, whose newly admitted rows are untrained: its AUC is near
    # chance by design. Run B trains the admitted rows.
    check(len(aucs) == 2 and 0.0 <= aucs[0] <= 1.0 and aucs[1] > floor,
          f"admit validation AUC {aucs}: run B's not above {floor}")
    ls_verify(2 * steps)

    # The rows run B's barrier freed: the rows of the ids it evicted,
    # zero in step 32's table and adagrad_init in its accumulator (no
    # step follows that barrier).
    payload32 = ck.read_vocab_sidecar(directory, 2 * steps)
    map16, map32 = slot_map(payload16), slot_map(payload32)
    check(len(map32) == barriers[2][3] and max(map32.values()) < VOCAB
          and min(map32.values()) >= 1, "step 32's slot rows")
    freed = np.array(sorted(map16[k] for k in set(map16) - set(map32)),
                     np.int64)
    check(len(freed) == barriers[2][2], f"{len(freed)} rows freed, "
          f"{barriers[2][2]} evicted")
    state = ck.CheckpointState(cfg.model_file)
    stored = state.restore(step=2 * steps,
                           template=checkpoint_template(cfg))
    state.close()
    idx = torch.from_numpy(freed)
    check(not stored["table"].index_select(0, idx).any().item()
          and bool((stored["acc"].index_select(0, idx)
                    == np.float32(cfg.adagrad_init)).all()),
          "a freed row is not cold-started in step 32")

    # Control: a fresh VocabRuntime and train_step_body on the card over
    # run A's then run B's streams, the same barriers and the same
    # initial table; timed, beside the same loop in fixed mode.
    def control_loop(vocab, c, firsts=None):
        """The two runs' streams through train_step_body; ``firsts``
        (a list) takes each run's first batch as it was stepped, with
        the numeric features' rows under the map of that moment."""
        gen = torch.Generator(device=device).manual_seed(c.seed)
        table = port_fm.init_table(c, device, gen)
        acc = port_fm.init_accumulator(c, device)
        n, loop_s = 0, 0.0
        for epoch, c_run in enumerate((cfg_a, cfg)):
            c_run = dataclasses.replace(c_run, vocab_mode=c.vocab_mode)
            it = batch_iterator(c_run, c_run.train_files, training=True,
                                epochs=1, seed=c.seed + epoch,
                                raw_ids=True, vocab=vocab)
            t0 = time.perf_counter()
            try:
                for b in it:
                    if vocab is not None:
                        b = vocab.ensure_current(b)
                    if firsts is not None and len(firsts) == epoch:
                        firsts.append((b, vocab.lookup(np.array(
                            numeric_ids(HASH_SPACE), np.int64))))
                    port_fm.train_step_body(spec, table, acc,
                                            **port_fm.batch_args(b, device))
                    if vocab is not None:
                        vocab.note_trained(b)
                    n += b.num_real
            finally:
                it.close()
            if vocab is not None:
                for _ in range(2):  # the epoch's, then the final save's
                    vocab.barrier(lambda rows: reset_table_rows(
                        table, acc, rows, c.adagrad_init))
            torch.cuda.synchronize()
            loop_s += time.perf_counter() - t0
        return table, acc, n / loop_s

    # The control, ADMIT_CONTROLS times. Every id of run A trains
    # through the cold row (some 300,000 slots a batch on one row); the
    # backward sums each row exactly, so two controls must be equal to
    # the bit, and step 32 must equal a control at rtol 1e-4 / atol 1e-6
    # in every element, and to the bit in every row outside the cold
    # row's reach (the rows run B's barrier cold-started or admitted
    # into, the rows no id ever held, the pad row).
    controls = []
    for k in range(ADMIT_CONTROLS):
        rt = VocabRuntime.from_config(cfg)
        firsts = [] if k == 0 else None
        table, acc, eps = control_loop(rt, cfg, firsts)
        check(rt.state_payload() == payload32,
              f"control run {k}'s slot map and payload differ from step "
              "32's")
        if k == 0:
            admit_eps, first_batches = eps, firsts
        controls.append((table, acc))
    trained = torch.tensor([0] + [map32[key] for key in map16
                                  if key in map32], device=device)
    exact = torch.ones(VOCAB + 1, dtype=torch.bool, device=device)
    exact[trained] = False
    control = {"exact_rows": int(exact.sum()),
               "trained_rows": int(trained.numel())}
    for j, name in enumerate(("table", "acc")):
        for k in range(1, ADMIT_CONTROLS):
            check(torch.equal(controls[k][j], controls[0][j]),
                  f"admit control {name}: control run {k} differs from "
                  "control run 0")
        check(equal_rows(torch, controls[0][j], stored[name], exact,
                         device),
              f"admit control {name}: a row outside the cold row's reach "
              "differs from step 32's")
        bad, worst = compare_chunked(torch, controls[0][j], stored[name],
                                     device)
        control[name] = {"outside_tolerance": bad, "max_abs_err": worst}
        check(bad == 0,
              f"admit control {name}: {bad} elements outside rtol 1e-4 / "
              f"atol 1e-6 of step 32, the largest difference {worst}")
    table, firsts = controls[0][0], first_batches
    del controls, acc, exact
    fixed_cfg = dataclasses.replace(cfg, vocab_mode="fixed")
    _t, _a, fixed_eps = control_loop(None, fixed_cfg)
    del _t, _a
    torch.cuda.empty_cache()

    # The remap alone on the build side, on hash-space batches of run
    # B's stream: raw ids (the dedup = device main path) and host-deduped.
    remap_ms = {}
    for name, raw in (("raw_ids", True), ("host_dedup", False)):
        it = batch_iterator(VocabMap.build_cfg(cfg), cfg.train_files,
                            training=False, raw_ids=raw)
        ms = []
        try:
            for k, b in enumerate(it):
                t0 = time.perf_counter()
                rt.remap(b)
                ms.append((time.perf_counter() - t0) * 1e3)
                if k + 1 == ADMIT_REMAP_BATCHES:
                    break
        finally:
            it.close()
        remap_ms[name] = sorted(ms)[len(ms) // 2]

    # Both kernels against their plain versions on each run's first
    # batch as the control stepped it (step 32's table): run A's, every
    # id on the cold row, and run B's under run A's map, its unseen ids
    # on the cold row; the cold row's share of the slots and its count.
    fwd_rows, bwd_rows, cold = [], [], {}
    for tag, (b, numeric) in zip(("admit_run_a", "admit_run_b"), firsts):
        real = b.vals != 0
        cells = int(((b.local_idx == COLD_ROW) & real).sum())
        cold[tag] = {"slots": cells, "share": cells / int(real.sum())}
        f, bw = train_batch_kernel_rows(
            torch, spec, table, port_fm.batch_args(b, device), device,
            tag=tag, numeric=numeric.tolist())
        fwd_rows += f
        bwd_rows += bw
    del table, firsts
    torch.cuda.empty_cache()

    # Admit predict of step 32 over the 65,536 predict lines, padded then
    # packed-wide: equal byte for byte; a fixed-mode predict is refused.
    predict_s, predict_launches, outs = {}, {}, {}
    for wire in ("padded", "packed"):
        pcfg = dataclasses.replace(
            cfg, predict_files=(os.path.join(WORK, "criteo.txt"),),
            score_path=os.path.join(WORK, f"admit_score_{wire}"),
            wire_format=wire)
        fm_kernel.launches = 0
        t0 = time.perf_counter()
        predict(pcfg, device=device)
        predict_s[wire] = time.perf_counter() - t0
        predict_launches[wire] = fm_kernel.launches
        with open(os.path.join(pcfg.score_path, "criteo.txt.score"),
                  "rb") as fh:
            outs[wire] = fh.read()
    check(outs["padded"] == outs["packed"], "admit predict: packed-wide "
          "differs from padded")
    scores = np.array([float(x) for x in outs["padded"].split()])
    check(scores.shape == (PREDICT_LINES,) and np.isfinite(scores).all(),
          f"{scores.shape} admit predict scores")
    del outs
    try:
        predict(dataclasses.replace(cfg, vocab_mode="fixed"), device=device)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "vocab admission sidecar" in refused,
          f"a fixed-mode predict of step 32 was not refused: {refused}")

    # Serving: step 16 published in a directory of its own, step 32
    # published there under client load; then a copy of step 32 whose
    # sidecar has one flipped byte.
    serve_cfg = dataclasses.replace(
        cfg, model_file=serve_model, predict_files=(
            os.path.join(data_wd, "b_val.txt"),), serve_poll_seconds=0.2)
    expected = {}

    def predict_lines(step):
        pcfg = dataclasses.replace(serve_cfg, score_path=os.path.join(
            WORK, f"admit_serve_score{step}"))
        predict(pcfg, device=device)
        with open(os.path.join(pcfg.score_path, "b_val.txt.score")) as fh:
            expected[step] = fh.read().splitlines(keepends=True)

    predict_lines(steps)
    check(fmckpt.main(["publish", serve_model, str(steps)]) == 0,
          "fmckpt publish of step 16 failed")
    fm_kernel.launches = 0
    server = ScorerServer(serve_cfg, device=device)
    httpd = make_http_server(server, 0)
    http_thread = threading.Thread(target=httpd.serve_forever,
                                   name="smoke-admit-http", daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    results, lock, failures = [], threading.Lock(), []
    phase = {"name": "16"}

    def client(k, leg):
        """Requests until RELOAD_ROUNDS of them were sent outside the
        leg ``leg`` (after the swap), or, with ``leg`` None, in all."""
        rng = np.random.default_rng(SEED + 40 + k)
        rounds = 0
        try:
            while rounds < RELOAD_ROUNDS:
                n = int(rng.integers(1, SERVE_MAX_BATCH + 1))
                lo = int(rng.integers(0, len(b_val) - n + 1))
                tag = phase["name"]
                status, body, step = post(
                    port, "\n".join(b_val[lo:lo + n]) + "\n")
                with lock:
                    results.append((lo, n, status, body, step, tag))
                rounds += leg is None or tag != leg
        except Exception as e:  # noqa: BLE001 - reported by the check
            failures.append(repr(e))

    def load(leg):
        threads = [threading.Thread(target=client, args=(k, leg))
                   for k in range(RELOAD_CLIENTS)]
        for th in threads:
            th.start()
        return threads

    try:
        threads = load("16")
        deadline = time.monotonic() + 120
        while len(results) < 4 * RELOAD_CLIENTS and not failures and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        copy_step(directory, serve_dir, 2 * steps)
        t_flip = time.perf_counter()
        check(fmckpt.main(["publish", serve_model, str(2 * steps)]) == 0,
              "fmckpt publish of step 32 failed")
        while server.served_step != 2 * steps and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        flip_to_swap_s = time.perf_counter() - t_flip
        phase["name"] = "32"
        for th in threads:
            th.join(timeout=300)
            check(not th.is_alive(), "an admit serve client hung")
        health = healthz(port)
        check(health["reloads"] == 1 and health["reload_failures"] == 0
              and health["served_step"] == 2 * steps
              and health["flush_errors"] == 0, f"/healthz: {health}")
        # The torn copy: publishing it with fmckpt fails; the pointer
        # moved by hand makes the server's reload fail whole.
        state = ck.CheckpointState(serve_model, adagrad_init=cfg.adagrad_init)
        state.save(torn_step, stored["table"], stored["acc"],
                   vocabulary_size=cfg.vocabulary_size, wait=True,
                   vocab_state=payload32)
        state.close()
        del stored
        vp = ck.vocab_sidecar_path(serve_dir, torn_step)
        with open(vp, "r+b") as fh:
            fh.seek(-6, os.SEEK_END)
            byte = fh.read(1)
            fh.seek(-6, os.SEEK_END)
            fh.write(bytes([byte[0] ^ 0xFF]))
        out = io.StringIO()
        check(fmckpt.cmd_publish(serve_dir, torn_step, out=out) == 1,
              f"fmckpt published the torn step: {out.getvalue()}")
        ck.write_published(serve_dir, torn_step)
        deadline = time.monotonic() + 60
        while server.stats()["reload_failures"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        phase["name"] = "torn"
        for th in load(None):
            th.join(timeout=300)
            check(not th.is_alive(), "an admit serve client hung")
        torn_health = healthz(port)
    finally:
        httpd.shutdown()
        http_thread.join(timeout=60)
        httpd.server_close()
        server.close()
    serve_launches = fm_kernel.launches
    check(not failures, f"admit serve clients failed: {failures[:3]}")
    # The watcher retries the torn step at every poll: each retry fails.
    check(torn_health["reload_failures"] >= 1
          and torn_health["served_step"] == 2 * steps
          and torn_health["published_step"] == torn_step
          and torn_health["reloads"] == 1,
          f"/healthz after the torn sidecar: {torn_health}")
    # Step 32's predict lines: the serve directory's newest intact step
    # once the torn copy is gone.
    shutil.rmtree(os.path.join(serve_dir, str(torn_step)))
    predict_lines(2 * steps)
    seen = {}
    for lo, n, status, body, step, tag in results:
        check(status == 200, f"admit serve answered {status}: {body[:200]}")
        check(step in (str(steps), str(2 * steps))
              and (tag == "16" or step == str(2 * steps)),
              f"X-FM-Step {step} in the {tag} leg")
        check(body == "".join(expected[int(step)][lo:lo + n]).encode(),
              f"admit body for lines [{lo}, {lo + n}) differs from step "
              f"{step}'s predict lines")
        seen[f"{tag}:{step}"] = seen.get(f"{tag}:{step}", 0) + 1
    check(seen.get(f"16:{steps}") and seen.get(f"32:{2 * steps}")
          and seen.get(f"torn:{2 * steps}"), f"responses: {seen}")
    phase_s = time.perf_counter() - t_phase
    saves = [t for t in ck_times.saves]
    row = {"phase": "admit", "card": card, "vocabulary_size": VOCAB,
           "hash_space": HASH_SPACE, "threshold": cfg.vocab_admit_threshold,
           "decay": cfg.vocab_decay, "sketch_mb": cfg.vocab_sketch_mb,
           "lines": [TRAIN_LINES, TRAIN_LINES],
           "validation_lines": [VAL_LINES, VAL_LINES],
           "batch_size": TRAIN_BATCH, "steps": 2 * steps,
           "reduced": "two one-epoch commands of 131,072 lines (run B on "
                      "fresh high-cardinality ids) instead of Criteo-1TB; "
                      "run B's lines not cut (its AUC floor check needs "
                      "its 16 steps)",
           "generate_seconds": gen_s, "run_seconds": run_s,
           "phase_seconds": phase_s, "epoch_mean_loss": mean_loss,
           "validation_auc": aucs, "auc_floor": floor,
           "b_planted_auc": exact_auc(b_logits, np.array(
               [int(ln.split(" ", 1)[0]) for ln in b_val])),
           "barriers": [{"where": w, "admitted": a, "evicted": e,
                         "live": n} for w, a, e, n in barriers],
           "barrier_seconds": [t["seconds"] for t in times.barriers],
           "reset_ms": times.resets, "freed_rows": len(freed),
           "sidecars": times.sidecars,
           "checkpoint_saves": saves, "committed_steps": commits,
           "remap_ms_entry_point_median":
               sorted(entry_remaps)[len(entry_remaps) // 2],
           "remap_ms_by_batch": remap_ms,
           "examples_per_s_train_log": [e for _, e in done],
           "examples_per_s_loop": (len(rates) * TRAIN_BATCH
                                   / sum(TRAIN_BATCH / r for r in rates)),
           "examples_per_s_inprocess_loop_admit": admit_eps,
           "examples_per_s_inprocess_loop_fixed": fixed_eps,
           "admit_over_fixed_loop": admit_eps / fixed_eps,
           "cold_row_by_first_batch": cold,
           "control_max_abs_err": control,
           "predict_seconds_after_load": predict_s,
           "predict_launches": predict_launches,
           "serve_responses": seen, "serve_flip_to_swap_seconds":
               flip_to_swap_s,
           "serve_p50_ms": torn_health["latency_p50_ms"],
           "serve_p99_ms": torn_health["latency_p99_ms"],
           "serve_launches": serve_launches,
           "serve_reload_failures_torn": torn_health["reload_failures"],
           "fm_score_launches": sum(f for f, _ in launches)
               + predict_launches["padded"] + predict_launches["packed"]
               + serve_launches,
           "fm_score_bwd_launches": sum(b for _, b in launches)}
    emit(row)
    return row, fwd_rows, bwd_rows


DIST_WORKERS = 2                  # ranks of the dist phase, both on cuda:0
DIST_SAVE_STEPS = 10              # one periodic save in the epoch's ~16
DIST_HEARTBEAT_SECONDS = 1.0      # lease stale after 4 s
DIST_COLLECTIVE_TIMEOUT = 20.0
DIST_AUC_TOL = 0.03               # tests/test_multiprocess.py's contract
DIST_PREDICT_ATOL = 2e-6          # merged vs single-process predict
DIST_RUN_TIMEOUT = 420            # seconds for one command's processes
DIST_STEP_SEED = SEED + 30        # the step check's starting table
DIST_LOSS_RTOL = 1e-5             # 2-rank step vs one process: the loss
DIST_STATE_RTOL = 1e-4            # ... and the table and accumulator rows
DIST_STATE_ATOL = 1e-6
DIST_SYNC_STEPS = 4               # steps an arm and round of the step
#                                   check's telemetry off/on sync count

# One rank of a dist command in a subprocess: the entry point ``python -m
# fast_tffm_tpu_torch`` calls, with both kernels' launch counts written
# to a JSON file when it returns (each rank is a process of its own).
DIST_RANK = r"""
import json, sys
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.ops import fm_kernel
out_path, argv = sys.argv[1], sys.argv[2:]
rc = main(argv)
with open(out_path, "w") as fh:
    json.dump({"rc": rc, "fm_score": fm_kernel.launches,
               "fm_score_bwd": fm_kernel.bwd_launches}, fh)
sys.exit(rc)
"""


# One rank of the dist phase's step check, a subprocess on cuda:0 beside
# the other rank: joins the group of ``cfg_path``, reads its byte range of
# the UNPADDED train lines as fixed-shape batches (the bucket probed as
# train probes it, no shuffle), counts its lines and batches, and takes
# two sharded train steps from ``init_sharded_state(seed)``: the first
# global step and the last (a rank whose shard ran dry steps the filler,
# as train's lockstep epoch does). The kernel wrappers' inputs in the
# first step are captured as the step gave them: the global [W·U, D] row
# block, ``local_idx`` offset by rank·U, vals and g. Writes the batches,
# losses, the rows the steps touched in this rank's shard, whether every
# other row kept its starting value, and the launch counts to ``out``;
# then the lockstep step's synchronizations with the run's telemetry off
# and on (``testing.telemetry.dist_telemetry_steps``: ``sync_steps``
# steps of each arm over the two batches, in turns).
DIST_STEP_RANK = r"""
import sys
import numpy as np
import torch
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.data.pipeline import (batch_iterator, empty_batch,
                                               probe_uniq_bucket)
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.ops import fm_kernel
from fast_tffm_tpu_torch.parallel.distributed import init_from_cluster
from fast_tffm_tpu_torch.parallel.sharded import (init_sharded_state,
                                                  make_mesh)
from fast_tffm_tpu_torch.testing.telemetry import dist_telemetry_steps
out_path, cfg_path, train_path, rank, seed, sync_steps = sys.argv[1:7]
rank, seed, sync_steps = int(rank), int(seed), int(sync_steps)
cfg = load_config(cfg_path)
world = len(cfg.worker_hosts)
init_from_cluster(cfg, "worker", rank)
mesh = make_mesh(cfg, rank, world)
spec = fm.ModelSpec.from_config(cfg, num_processes=world)
dev = torch.device("cuda:0")
ub = probe_uniq_bucket(cfg, [train_path])
first = last = None
count = lines = 0
for b in batch_iterator(cfg, [train_path], training=False, epochs=1,
                        shard_index=rank, num_shards=world,
                        fixed_shape=True, uniq_bucket=ub, raw_ids=False):
    first = b if first is None else first
    last, count, lines = b, count + 1, lines + b.num_real
counts = mesh.all_gather_host(np.array([count, lines], np.int64),
                              "smoke/counts")
final = (last if count == int(counts[:, 0].max())
         else empty_batch(cfg, uniq_bucket=ub))
table, acc = init_sharded_state(cfg, mesh, seed, dev)
table0 = table.clone()
captured = {}
real_fwd, real_bwd = fm_kernel._scores, fm_kernel.fm_batch_scores_bwd


def capture_fwd(params, local_idx, vals):
    captured["fwd"] = [t.clone() for t in (params, local_idx, vals)]
    return real_fwd(params, local_idx, vals)


def capture_bwd(params, local_idx, vals, g, need_dx):
    captured["bwd"] = [t.clone() for t in (params, local_idx, vals, g)]
    captured["need_dx"] = need_dx
    return real_bwd(params, local_idx, vals, g, need_dx)


out = {"counts": counts, "uniq_bucket": ub}
fm_kernel.launches = fm_kernel.bwd_launches = 0
for s, b in enumerate((first, final)):
    args = fm.batch_args(b, dev)
    args["uniq_ids"] = b.uniq_ids
    if s == 0:
        fm_kernel._scores = capture_fwd
        fm_kernel.fm_batch_scores_bwd = capture_bwd
    try:
        table, acc, loss, _ = fm.sharded_train_step_body(
            spec, mesh, table, acc, **args)
    finally:
        fm_kernel._scores = real_fwd
        fm_kernel.fm_batch_scores_bwd = real_bwd
    out[f"loss{s}"] = float(loss)
    for k in ("labels", "weights", "uniq_ids", "local_idx", "vals"):
        out[f"b{s}/{k}"] = torch.from_numpy(getattr(b, k))
torch.cuda.synchronize()
out["launches"] = [fm_kernel.launches, fm_kernel.bwd_launches]
ids = np.unique(mesh.all_gather_host(np.concatenate(
    [first.uniq_ids, final.uniq_ids]), "smoke/ids"))
ids = torch.from_numpy(ids[(ids >= mesh.lo) & (ids < mesh.hi)]
                       .astype(np.int64)).to(dev)
out["ids"] = ids.cpu()
out["table_rows"] = table[ids - mesh.lo].cpu()
out["acc_rows"] = acc[ids - mesh.lo].cpu()
rest = torch.ones(mesh.rows_per_rank, dtype=torch.bool, device=dev)
rest[ids - mesh.lo] = False
out["rest_unchanged"] = bool(torch.equal(table[rest], table0[rest])) and \
    bool((acc[rest] == cfg.adagrad_init).all())
out["fwd"] = [t.cpu() for t in captured["fwd"]]
out["bwd"] = [t.cpu() for t in captured["bwd"]]
out["need_dx"] = captured["need_dx"]
del table, acc, table0, captured
out["telemetry"] = dist_telemetry_steps(cfg, mesh, dev, [first, final],
                                        steps=sync_steps)
torch.save(out, out_path)
torch.distributed.destroy_process_group()
"""


def write_even_shards(src, dst, ranks):
    """``src``'s lines into ``dst`` with each rank's share of lines (the
    file cut in ``ranks`` equal runs of lines) padded to one byte size by
    trailing spaces on its last line, so that each rank's byte range
    (``shard_byte_range``) holds exactly its run: every rank's epoch is
    whole batches, as run A's is. An uneven cut leaves one rank a final
    batch of a single example, and the loss being each batch's weighted
    mean (in both packages) gives that one example a full step, which
    costs the model most of its AUC (ROADMAP.md §C). Returns the lines a
    rank holds."""
    with open(src) as fh:
        lines = fh.read().splitlines()
    n = len(lines) // ranks
    check(n * ranks == len(lines), f"{len(lines)} lines over {ranks} ranks")
    parts = [lines[r * n:(r + 1) * n] for r in range(ranks)]
    sizes = [sum(len(ln.encode()) + 1 for ln in p) for p in parts]
    for p, size in zip(parts, sizes):
        p[-1] += " " * (max(sizes) - size)
    with open(dst, "w") as fh:
        for p in parts:
            fh.write("\n".join(p) + "\n")
    return n


def write_dist_cfg(wd, data_wd, tag, epochs, save_steps, port, name=None,
                   metrics=None):
    """A config #2 train config for a 2-rank ``dist_train`` over the
    train lines as ``write_even_shards`` wrote them into ``wd`` and
    ``data_wd``'s validation lines, its rendezvous on ``port`` (free,
    below the ephemeral range). ``batch_size`` is a rank's: the global batch,
    the ranks' batches together, is the train phase's 8,192, so the
    epoch takes run A's 16 steps and its AUC compares. ``metrics``: the
    run's telemetry into that ``metrics_file`` (``DIST_TELEMETRY``)."""
    hosts = ",".join(f"localhost:{port - 1000 + i}"
                     for i in range(DIST_WORKERS))
    path = os.path.join(wd, name or f"dist_{tag}.cfg")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = {FACTORS}
model_file = {os.path.join(wd, 'model_' + tag, 'fm_model')}
[Train]
train_files = {os.path.join(wd, 'train_even.txt')}
validation_files = {os.path.join(data_wd, 'val.txt')}
epoch_num = {epochs}
batch_size = {TRAIN_BATCH // DIST_WORKERS}
learning_rate = {TRAIN_LR}
loss_type = logistic
log_steps = 1
save_steps = {save_steps}
{DIST_TELEMETRY.format(path=metrics) if metrics else ''}
[Predict]
predict_files = {os.path.join(data_wd, 'val.txt')}
score_path = {os.path.join(wd, 'score_' + tag)}
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = {DIST_HEARTBEAT_SECONDS}
collective_timeout_seconds = {DIST_COLLECTIVE_TIMEOUT}
cluster_connect_timeout_seconds = 120
""")
    return path


# The multi-process legs' telemetry: each worker's shard of the stream
# (flushed every step, so a killed rank's shard holds every step it
# took), spans and the protocol trace.
DIST_TELEMETRY = """metrics_file = {path}
metrics_flush_steps = 1
trace_spans = true
protocol_trace = true"""


def read_shards(shards, verdict, what, collectives=False, anatomy=False):
    """The port's readers over a run's stream shards, in process (the
    card's machine has no JAX): ``tools/fmstat.py`` exits 0 with health
    ``verdict``, as ``obs.attribution`` reads it;
    ``tools/fmtrace.py --collectives`` finds one sequence on every rank
    (exit 0); ``--anatomy --json`` gives each rank an efficiency in
    (0, 1]. Returns the summary's counters and health events and those
    figures."""
    import contextlib
    import io
    from fast_tffm_tpu_torch.obs import attribution
    from fast_tffm_tpu_torch.tools import fmstat, fmtrace

    def run(main, argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        return rc, out.getvalue(), err.getvalue()

    for path in shards:
        check(os.path.isfile(path), f"{what}: no stream {path}")
    rc, text, _ = run(fmstat.main, list(shards))
    summary = attribution.summarize(list(shards))
    got = attribution.health_verdict(summary)["verdict"]
    check(rc == 0 and got == verdict and f"health: {verdict}" in text,
          f"{what}: fmstat exited {rc} with health {got!r}, not {verdict!r}")
    res = {"verdict": got, "counters": summary["counters"],
           "health_events": summary["health_events"]}
    if collectives:
        rc, _, err = run(fmtrace.main, ["--collectives"] + list(shards))
        check(rc == 0, f"{what}: fmtrace --collectives exited {rc}: {err}")
        res["collectives"] = err.strip()
    if anatomy:
        rc, text, err = run(fmtrace.main,
                            ["--anatomy", "--json"] + list(shards))
        rep = json.loads(text) if rc == 0 else {}
        eff = {int(k): v["efficiency"]
               for k, v in rep.get("ranks", {}).items()}
        check(rc == 0 and len(eff) == len(shards)
              and all(0.0 < e <= 1.0 for e in eff.values()),
              f"{what}: fmtrace --anatomy exited {rc}, efficiency {eff}: "
              f"{(text or err)[:300]}")
        res["anatomy"] = {"efficiency": eff, "verdict": rep["verdict"],
                          "matched_barriers": rep["matched_barriers"]}
    return res


def start_dist(wd, mode, cfg_path, tag):
    """The ranks of one dist command, started together; (processes,
    their log paths, their launch-count JSON paths)."""
    procs, logs, outs = [], [], []
    for i in range(DIST_WORKERS):
        logs.append(os.path.join(wd, f"{tag}_{mode}{i}.log"))
        outs.append(os.path.join(wd, f"{tag}_{mode}{i}.json"))
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DIST_RANK, outs[-1], mode, cfg_path,
                 "dist_train", "worker", str(i)], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=ROOT), stdout=fh,
                stderr=subprocess.STDOUT))
    return procs, logs, outs


def start_step_check(wd, data_wd, port):
    """The step check's ranks (``DIST_STEP_RANK``), started together on
    the unpadded train lines; (processes, log paths, result paths,
    config path)."""
    cfg_path = write_dist_cfg(wd, data_wd, "step", 1, 0, port,
                              name="dist_step.cfg")
    procs, logs, outs = [], [], []
    for i in range(DIST_WORKERS):
        logs.append(os.path.join(wd, f"step{i}.log"))
        outs.append(os.path.join(wd, f"step{i}.pt"))
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DIST_STEP_RANK, outs[-1], cfg_path,
                 os.path.join(data_wd, "train.txt"), str(i),
                 str(DIST_STEP_SEED), str(DIST_SYNC_STEPS)], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=ROOT), stdout=fh,
                stderr=subprocess.STDOUT))
    return procs, logs, outs, cfg_path


def close_enough(got, want, rtol, atol):
    """(every element within atol + rtol·|want|, the largest |error|)."""
    err = (got - want).abs()
    return (bool((err <= atol + rtol * want.abs()).all()),
            float(err.max()) if err.numel() else 0.0)


def dist_step_check(h, torch, device):
    """The step check's verdict, from ``start_step_check``'s ranks: their
    two sharded steps held against the single-process ``train_step_body``
    on the concatenated global batch (``local_idx`` offset by rank·U) on
    the card, from the same starting table — the loss at rtol 1e-5, the
    touched rows of table and accumulator at rtol 1e-4 / atol 1e-6, every
    other row unchanged; the captured kernel inputs equal to that global
    batch's rows; and both kernels against their plain versions on each
    rank's captured inputs. Also reports how the unpadded byte-range split
    fell: each rank's lines and batches and the last global step's weight
    (the short step ROADMAP.md §C describes). Returns (row, forward
    kernel rows, backward kernel rows)."""
    import numpy as np
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.parallel.sharded import (ProcessMesh,
                                                      init_sharded_state,
                                                      offset_local_idx)
    t0 = time.perf_counter()
    procs, logs, outs, cfg_path = h["step"]
    try:
        rcs = [p.wait(timeout=DIST_RUN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * len(procs):
        for path in logs:
            with open(path) as fh:
                print(fh.read()[-4000:], flush=True)
    check(rcs == [0] * len(procs), f"dist step check: ranks exited {rcs}")
    res = [torch.load(p, weights_only=False) for p in outs]
    cfg = load_config(cfg_path)
    W = DIST_WORKERS
    counts = res[0]["counts"]
    check(all(np.array_equal(r["counts"], counts) for r in res)
          and int(counts[:, 1].sum()) == TRAIN_LINES,
          f"the unpadded split's (batches, lines) per rank: {counts}")
    ub = int(res[0]["uniq_bucket"])
    spec = port_fm.ModelSpec.from_config(cfg, num_processes=W)
    table = torch.cat([init_sharded_state(
        cfg, ProcessMesh(rank=r, size=W, rows=cfg.ckpt_rows),
        DIST_STEP_SEED, device)[0] for r in range(W)])
    acc = torch.full_like(table, cfg.adagrad_init)

    def global_args(s):
        out = {}
        for k in ("labels", "weights", "uniq_ids", "local_idx", "vals"):
            parts = [r[f"b{s}/{k}"] for r in res]
            if k == "local_idx":
                parts = [offset_local_idx(p, i, ub)
                         for i, p in enumerate(parts)]
            out[k] = torch.cat(parts).to(device)
        return out

    first = global_args(0)
    gids = first["uniq_ids"].long()
    for r, rr in enumerate(res):
        params, local, vals = (t.to(device) for t in rr["fwd"])
        check(torch.equal(params, table.index_select(0, gids))
              and torch.equal(local, offset_local_idx(
                  rr["b0/local_idx"], r, ub).to(device))
              and torch.equal(vals, rr["b0/vals"].to(device)),
              f"rank {r}'s forward kernel got other inputs than the global "
              f"batch's [{W}·{ub}, {table.shape[1]}] row block and its "
              f"offset local_idx")
        check(all(torch.equal(a, b) for a, b in zip(rr["bwd"][:3], rr["fwd"]))
              and not rr["need_dx"], f"rank {r}'s backward kernel got "
              f"other inputs than its forward")
        check(rr["launches"] == [2, 2],
              f"rank {r} launched (fm_score, fm_score_bwd) "
              f"{rr['launches']} times in two steps")
    losses, loss_err, weights = [], 0.0, []
    for s in range(2):
        args = first if s == 0 else global_args(s)
        weights.append(float(args["weights"].sum()))
        table, acc, loss, _ = port_fm.train_step_body(spec, table, acc,
                                                      **args)
        losses.append(float(loss))
        for r, rr in enumerate(res):
            err = abs(rr[f"loss{s}"] - losses[-1])
            loss_err = max(loss_err, err)
            check(err <= DIST_LOSS_RTOL * abs(losses[-1]),
                  f"step {s}: rank {r}'s loss {rr[f'loss{s}']} against the "
                  f"single-process step's {losses[-1]}")
    del first
    state_err = 0.0
    for r, rr in enumerate(res):
        ids = rr["ids"].to(device)
        for key, want in (("table_rows", table), ("acc_rows", acc)):
            ok, err = close_enough(rr[key].to(device),
                                   want.index_select(0, ids),
                                   DIST_STATE_RTOL, DIST_STATE_ATOL)
            state_err = max(state_err, err)
            check(ok, f"rank {r}'s {key} after two steps differ from the "
                      f"single-process step's by {err}")
        check(rr["rest_unchanged"], f"rank {r} changed rows no step touched")
    touched = sum(len(rr["ids"]) for rr in res)
    del table, acc
    torch.cuda.empty_cache()
    # The lockstep step makes as many synchronizations with the run's
    # telemetry on (spans, step anatomy, the protocol trace) as off.
    tele = [rr["telemetry"] for rr in res]
    for r, t in enumerate(tele):
        check(t["on"]["syncs"] == t["off"]["syncs"]
              and t["collectives_traced"] > 0,
              f"rank {r}'s lockstep step: synchronizations with the "
              f"telemetry off {t['off']['syncs']} "
              f"({t['off'].get('sync_sites')}), on {t['on']['syncs']} "
              f"({t['on'].get('sync_sites')}), {t['collectives_traced']} "
              "collectives traced")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    fwd_rows, bwd_rows = [], []
    for r, rr in enumerate(res):
        params, local, vals, g = (t.to(device) for t in rr["bwd"])
        fwd_rows.append(fwd_kernel_row(torch, params, local, vals, None,
                                       batch=f"dist_rank{r}"))
        bwd_rows += bwd_kernel_rows(torch, params, local, vals, g, flush,
                                    need_dx_cases=(False,),
                                    batch=f"dist_rank{r}")
    del flush
    row = {"lines_per_rank_unpadded": counts[:, 1].tolist(),
           "batches_per_rank_unpadded": counts[:, 0].tolist(),
           "uniq_bucket": ub, "step_weights": weights,
           "last_step_weight": weights[-1], "step_losses": losses,
           "loss_max_abs_err": loss_err, "state_max_abs_err": state_err,
           "touched_rows": touched,
           "step_check_seconds": time.perf_counter() - t0,
           "step_fm_score_launches": [rr["launches"][0] for rr in res],
           "step_fm_score_bwd_launches": [rr["launches"][1] for rr in res],
           "telemetry_sync_check": [
               {"rank": r, "steps": DIST_SYNC_STEPS,
                "syncs_off": t["off"]["syncs"], "syncs_on": t["on"]["syncs"],
                "sync_sites": t["on"]["sync_sites"],
                "step_ms_off": t["off"]["ms"], "step_ms_on": t["on"]["ms"],
                "collectives_traced": t["collectives_traced"]}
               for r, t in enumerate(tele)]}
    print(f"dist step check: 2-rank step vs single-process step on the "
          f"global batch, loss err {loss_err:.3g}, rows err {state_err:.3g} "
          f"over {touched} touched rows; unpadded split: lines "
          f"{row['lines_per_rank_unpadded']}, batches "
          f"{row['batches_per_rank_unpadded']}, the last global step "
          f"weighs {weights[-1]:g} of {weights[0]:g} and takes a full "
          f"step", flush=True)
    print(f"dist step telemetry: the lockstep step ({DIST_SYNC_STEPS} steps "
          f"an arm and round) makes "
          f"{[t['off']['syncs'] for t in tele]} synchronizations with the "
          f"telemetry off and {[t['on']['syncs'] for t in tele]} on, rank by "
          f"rank (sites {tele[0]['on']['sync_sites']}); step ms off "
          f"{[t['off']['median_ms'] for t in tele]}, on "
          f"{[t['on']['median_ms'] for t in tele]}", flush=True)
    return row, fwd_rows, bwd_rows


def finish_dist(procs, logs, outs, what):
    """Wait for every rank (bounded); returns (logs' text, launches)."""
    try:
        rcs = [p.wait(timeout=DIST_RUN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in logs:
        with open(path) as fh:
            texts.append(fh.read())
    if rcs != [0] * len(procs):
        for t in texts:
            print(t[-4000:], flush=True)
    check(rcs == [0] * len(procs), f"{what}: ranks exited {rcs}")
    launches = []
    for path in outs:
        with open(path) as fh:
            launches.append(json.load(fh))
    return texts, launches


def wait_log(path, pattern, procs, what, timeout=DIST_RUN_TIMEOUT):
    """Wait until the log at ``path`` matches ``pattern`` while every
    process of ``procs`` runs."""
    import re
    deadline = time.monotonic() + timeout
    while True:
        with open(path) as fh:
            if re.search(pattern, fh.read()):
                return
        check(all(p.poll() is None for p in procs)
              and time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.05)


def kill_run(procs, logs):
    """SIGKILL worker 1 of the kill run a few steps into its epoch 1 (loss
    lines land at the epoch barrier: the chief's validation line marks
    epoch 1's start); returns (the survivor's exit code, seconds from the
    kill to its exit, the WorkerLostError line or None)."""
    import re
    import signal
    wait_log(logs[0], "epoch 0 validation AUC", procs,
             "the kill run's epoch 0")
    time.sleep(0.5)
    check(procs[1].poll() is None, "worker 1 exited before the kill")
    procs[1].send_signal(signal.SIGKILL)
    t_kill = time.perf_counter()
    budget = DIST_COLLECTIVE_TIMEOUT + 4 * DIST_HEARTBEAT_SECONDS
    try:
        rc0 = procs[0].wait(timeout=budget + 30)
    except subprocess.TimeoutExpired:
        rc0 = None
    detect_s = time.perf_counter() - t_kill
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    with open(logs[0]) as fh:
        lost = re.search(r"WorkerLostError: .*process 1 \(", fh.read())
    return rc0, detect_s, budget, lost


def dist_start(data):
    """Start phase 15's two dist runs (``dist_finish`` completes the
    phase): run A, two ranks on cuda:0 training one epoch of the train
    phase's lines, and the kill run, whose worker 1 a background thread
    SIGKILLs in its epoch 1. They run beside the phases in between: their
    card work is their first ~25 s, and the rest is run A's chief writing
    its ``.npz``."""
    from fast_tffm_tpu_torch.config import load_config
    data_wd = data[0]
    wd = os.path.join(WORK, "dist")
    os.makedirs(wd)
    h = {"wd": wd, "data_wd": data_wd, "t0": time.perf_counter(),
         "kill_result": []}
    h["per_rank"] = write_even_shards(os.path.join(data_wd, "train.txt"),
                                      os.path.join(wd, "train_even.txt"),
                                      DIST_WORKERS)
    # One block of free ports for the three jobs' rendezvous: the kill
    # run starts with run A, and the predict starts while run A's chief
    # still holds its port.
    port = free_port_block(4)
    h["metrics"] = [os.path.join(wd, f"{kind}.metrics.jsonl")
                    for kind in ("train", "predict")]
    h["cfg_path"] = write_dist_cfg(wd, data_wd, "a", 1, DIST_SAVE_STEPS,
                                   port, metrics=h["metrics"][0])
    h["cfg"] = load_config(h["cfg_path"])
    kill_cfg = write_dist_cfg(wd, data_wd, "kill", 3, 0, port + 1)
    h["predict_cfg"] = write_dist_cfg(wd, data_wd, "a", 1, DIST_SAVE_STEPS,
                                      port + 2, name="dist_a_predict.cfg",
                                      metrics=h["metrics"][1])
    h["train_a"] = start_dist(wd, "train", h["cfg_path"], "a")
    h["kill"] = start_dist(wd, "train", kill_cfg, "kill")
    h["step"] = start_step_check(wd, data_wd, port + 3)

    def killer():
        try:
            h["kill_result"].append(kill_run(*h["kill"][:2]))
        except BaseException as e:  # noqa: BLE001 - dist_finish raises it
            h["kill_result"].append(e)

    h["killer"] = threading.Thread(target=killer, name="smoke-dist-kill",
                                   daemon=True)
    h["killer"].start()
    return h


def dist_stop(h):
    """Stop every process of the dist runs (a no-op once finished)."""
    if h is None:
        return
    for p in h["train_a"][0] + h["kill"][0] + h["step"][0]:
        if p.poll() is None:
            p.kill()
            p.wait()
    h["killer"].join(timeout=60)


def dist_finish(h, torch, device, card, train_row):
    """Phase 15, started by ``dist_start``: ``python -m
    fast_tffm_tpu_torch train|predict <cfg> dist_train worker <i>`` with
    two ranks on cuda:0 (two processes, each with its CUDA context and a
    [ckpt_rows/2, 17] table shard and accumulator, talking over gloo) at
    config #2's width: one epoch of the train phase's lines (each rank
    its byte range, one periodic save), the validation lines split
    alike; the 2-rank predict of its final step against a single-process
    predict of the same step; and the kill run's survivor."""
    import io
    import re
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.tools import fmckpt
    t_visible = time.perf_counter()
    wd, cfg, cfg_path = h["wd"], h["cfg"], h["cfg_path"]
    train_a, per_rank, t0 = h["train_a"], h["per_rank"], h["t0"]
    try:
        h["killer"].join(timeout=DIST_RUN_TIMEOUT)
        check(h["kill_result"] and not isinstance(h["kill_result"][0],
                                                  BaseException),
              f"the kill run failed: {h['kill_result']}")
        rc0, detect_s, budget, lost = h["kill_result"][0]
        check(rc0 not in (None, 0) and lost is not None
              and detect_s <= budget,
              f"the survivor exited {rc0} after {detect_s:.1f}s (budget "
              f"{budget}s), naming process 1: {lost is not None}")
        # The final step is durable before the chief logs the final AUC
        # and starts its export.
        try:
            wait_log(train_a[1][0], r"final validation AUC", train_a[0],
                     "the dist train's final save")
        except SmokeFailure:
            for log in train_a[1]:
                with open(log) as fh:
                    print(f"----- {log} -----\n{fh.read()[-6000:]}",
                          flush=True)
            raise
        directory = cfg.model_file + ".ckpt"
        verify_out = io.StringIO()
        t1 = time.perf_counter()
        verify_rc = fmckpt.cmd_verify(directory, mode="full",
                                      out=verify_out)
        verify_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        plogs, plaunches = finish_dist(
            *start_dist(wd, "predict", h["predict_cfg"], "a"),
            "dist predict")
        predict_s = time.perf_counter() - t1
        single_cfg = os.path.join(wd, "single.cfg")
        with open(cfg_path) as fh:
            text = fh.read()
        score_dir = cfg.score_path
        with open(single_cfg, "w") as fh:
            fh.write(re.sub(r"\[Cluster\].*", "", text, flags=re.S).replace(
                f"score_path = {score_dir}",
                f"score_path = {score_dir}_single"))
        t1 = time.perf_counter()
        check(cli(["predict", single_cfg]) == 0,
              "single-process predict failed")
        single_s = time.perf_counter() - t1
        logs, launches = finish_dist(*train_a, "dist train")
        train_s = time.perf_counter() - t0
        step_row, fwd_rows, bwd_rows = dist_step_check(h, torch, device)
    finally:
        dist_stop(h)
    # The ranks' telemetry (a shard each), read by the port's readers:
    # the train shards' examples are the epoch's, the predict shards' the
    # validation lines', one collective sequence on both ranks, and the
    # step anatomy aligned on the lockstep's barrier spans.
    t1 = time.perf_counter()
    shards = [[m, m + ".p1"] for m in h["metrics"]]
    tele = {"train": read_shards(shards[0], "OK", "the dist train's streams",
                                 collectives=True, anatomy=True),
            "predict": read_shards(shards[1], "OK",
                                   "the dist predict's streams",
                                   collectives=True)}
    check(tele["train"]["counters"].get("train/examples") == TRAIN_LINES
          and tele["predict"]["counters"].get("predict/examples")
          == VAL_LINES,
          f"the shards' train/examples "
          f"{tele['train']['counters'].get('train/examples')} (want "
          f"{TRAIN_LINES}), predict/examples "
          f"{tele['predict']['counters'].get('predict/examples')} (want "
          f"{VAL_LINES})")
    anat = tele["train"]["anatomy"]
    tele_row = {"verdicts": [tele[k]["verdict"] for k in tele],
                "train_examples": tele["train"]["counters"]["train/examples"],
                "predict_examples":
                    tele["predict"]["counters"]["predict/examples"],
                "collectives": [tele[k]["collectives"] for k in tele],
                "anatomy": anat, "readers_seconds": time.perf_counter() - t1}
    print(f"dist anatomy: {anat['verdict']}", flush=True)
    print(f"dist telemetry: {card}; train shards {tele_row['verdicts'][0]}, "
          f"train/examples {tele_row['train_examples']} (the epoch's "
          f"{TRAIN_LINES}); predict shards {tele_row['verdicts'][1]}, "
          f"predict/examples {tele_row['predict_examples']}; "
          f"{tele_row['collectives'][0]} (train), "
          f"{tele_row['collectives'][1]} (predict); anatomy over "
          f"{anat['matched_barriers']} barriers, efficiency "
          f"{anat['efficiency']}; read in "
          f"{tele_row['readers_seconds']:.2f}s", flush=True)
    for i, text in enumerate(logs):
        check(f"multi-process training: rank {i} of {DIST_WORKERS} on "
              f"cuda:0" in text, f"worker {i}'s log names no cuda:0")
        check(launches[i]["fm_score"] > 0 and launches[i]["fm_score_bwd"] > 0,
              f"worker {i} launched fm_score {launches[i]['fm_score']} and "
              f"fm_score_bwd {launches[i]['fm_score_bwd']} times")
    steps = [[(int(s), float(v)) for s, v in re.findall(
        r"step (\d+) epoch \d+ loss ([0-9.]+)", t)] for t in logs]
    check(steps[0] == steps[1] and len(steps[0]) >= 4,
          f"the workers' step losses differ: {steps}")
    losses = [v for _, v in steps[0]]
    half = len(losses) // 2
    check(np.mean(losses[half:]) < np.mean(losses[:half]),
          f"the loss did not fall: {losses}")
    m = re.search(r"final validation AUC ([0-9.]+) over (\d+)", logs[0])
    check(m is not None and int(m.group(2)) == VAL_LINES,
          "no final validation AUC over every validation line in worker "
          "0's log")
    auc = float(m.group(1))
    run_a_auc = train_row["validation_auc"][0]
    check(auc > train_row["auc_floor"]
          and abs(auc - run_a_auc) <= DIST_AUC_TOL,
          f"2-worker validation AUC {auc} against run A's {run_a_auc} "
          f"(tolerance {DIST_AUC_TOL}) and the floor "
          f"{train_row['auc_floor']}")
    workers = []
    for text in logs:
        w = re.search(r"worker (\d) of \d: (\d+) steps, (\d+) local "
                      r"examples, loop ([0-9.]+) local examples/sec, "
                      r"([0-9.]+) ms a step, export ([0-9.]+)s", text)
        check(w is not None, "a worker's summary line is missing")
        workers.append({"worker": int(w.group(1)), "steps": int(w.group(2)),
                        "local_examples": int(w.group(3)),
                        "loop_examples_per_s": float(w.group(4)),
                        "step_ms": float(w.group(5)),
                        "export_seconds": float(w.group(6))})
    check([w["local_examples"] for w in workers]
          == [per_rank] * DIST_WORKERS,
          f"the workers stepped {[w['local_examples'] for w in workers]} "
          f"examples, not {per_rank} each")
    check(os.path.isfile(cfg.model_file + ".npz"),
          "the chief wrote no .npz export")
    state = fmckpt.scan(directory)
    final_step = steps[0][-1][0]
    saved = [DIST_SAVE_STEPS, final_step]
    check([s["step"] for s in state["steps"]] == saved,
          f"fmckpt ls of the chief's checkpoint: {state}")
    check(verify_rc == 0 and verify_out.getvalue().count(": OK (full check")
          == len(saved), f"fmckpt verify --mode full: {verify_out.getvalue()}")
    check(all(p["fm_score"] > 0 for p in plaunches),
          f"predict ranks launched fm_score {plaunches}")
    check(sorted(os.listdir(score_dir)) == ["val.txt.score"],
          f"score directory after the merge: {os.listdir(score_dir)}")
    merged = np.loadtxt(os.path.join(score_dir, "val.txt.score"))
    single = np.loadtxt(os.path.join(score_dir + "_single", "val.txt.score"))
    check(merged.shape == single.shape == (VAL_LINES,),
          f"{merged.shape} merged scores, {single.shape} single")
    predict_err = float(np.abs(merged - single).max())
    check(predict_err <= DIST_PREDICT_ATOL,
          f"merged predict differs from single-process by {predict_err}")
    row = {"phase": "dist", "card": card, "workers": DIST_WORKERS,
           "backend": "gloo", "lines": TRAIN_LINES,
           "validation_lines": VAL_LINES,
           "batch_size_per_rank": TRAIN_BATCH // DIST_WORKERS,
           "note": "correctness-run figures, not a benchmark",
           "seconds": time.perf_counter() - t0,
           "visible_seconds": time.perf_counter() - t_visible,
           "train_seconds": train_s, "predict_seconds": predict_s,
           "single_predict_seconds": single_s,
           "fmckpt_verify_full_seconds": verify_s,
           "steps": final_step, "losses": losses,
           "validation_auc": auc, "run_a_auc": run_a_auc,
           "auc_gap": abs(auc - run_a_auc),
           "predict_max_abs_err": predict_err,
           "workers_figures": workers,
           "fm_score_launches": [w["fm_score"] for w in launches],
           "fm_score_bwd_launches": [w["fm_score_bwd"] for w in launches],
           "predict_fm_score_launches": [p["fm_score"] for p in plaunches],
           "kill_exit_code": rc0, "kill_detect_seconds": detect_s,
           "kill_budget_seconds": budget,
           "kill_message": lost.group(0)[:200], "telemetry": tele_row,
           **step_row}
    print(f"dist: {DIST_WORKERS} workers on cuda:0 (gloo), "
          f"{row['seconds']:.1f}s for the phase, {row['visible_seconds']:.1f}s"
          f" of it after the phases it ran beside (correctness run, not a "
          f"benchmark); loop examples/s "
          f"{[w['loop_examples_per_s'] for w in workers]}, step ms "
          f"{[w['step_ms'] for w in workers]}, export "
          f"{workers[0]['export_seconds']:.2f}s; fm_score launches "
          f"{row['fm_score_launches']}, fm_score_bwd "
          f"{row['fm_score_bwd_launches']}; AUC {auc:.6f} vs run A "
          f"{run_a_auc:.6f}; predict max err {predict_err:.3g}; killed "
          f"worker 1 detected in {detect_s:.1f}s (rc {rc0})", flush=True)
    emit(row)
    return row, fwd_rows, bwd_rows


ELASTIC_EPOCHS = 2
ELASTIC_SAVE_STEPS = 8            # the 2-rank epoch 0 saves at 8 and 16;
#                                   the kill follows step 8's commit
ELASTIC_RUN_TIMEOUT = 900         # seconds for the leg's processes
ELASTIC_LEASE_FILES = ["commit-2.json", "grow-2.json", "reform-2-0",
                       "reform-2-1"]

# One process of an elastic leg (a rank or the joiner): the entry point
# with both kernels' launch counts, the sessions it entered (their
# membership and the counts at their start), each checkpoint restore's
# and save's seconds, and per session the inputs of its first forward
# kernel call (``first_fwd``: a validation sweep's, in a session that
# steps nothing) and of its first train step's forward and backward
# (``fwd``, ``bwd``), written when it returns.
ELASTIC_RANK = r"""
import json, sys, time
import torch
from fast_tffm_tpu_torch import train as port_train
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.checkpoint import CheckpointState
from fast_tffm_tpu_torch.ops import fm_kernel
out_path, argv = sys.argv[1], sys.argv[2:]
sessions, restores, saves, captured = [], [], [], []
real_session, real_restore, real_save = port_train._train_session, \
    CheckpointState.restore, CheckpointState.save
real_fwd, real_bwd = fm_kernel._scores, fm_kernel.fm_batch_scores_bwd


def session(cfg, device, init_state, logger, shard_index, num_shards,
            members, *rest):
    sessions.append({"shard_index": shard_index, "num_shards": num_shards,
                     "members": list(members),
                     "launches_at_start": [fm_kernel.launches,
                                           fm_kernel.bwd_launches]})
    captured.append({})
    return real_session(cfg, device, init_state, logger, shard_index,
                        num_shards, members, *rest)


# Copies of a forward's inputs; of a whole table (a raw-ids sweep) only
# the rows the batch reads, local_idx renumbered into them.
def kept(params, local_idx, vals):
    if params.shape[0] > local_idx.numel():
        rows, idx = torch.unique(local_idx, return_inverse=True)
        return [params.index_select(0, rows),
                idx.view_as(local_idx).to(local_idx.dtype), vals.clone()]
    return [t.detach().clone() for t in (params, local_idx, vals)]


def capture_fwd(params, local_idx, vals):
    if captured and "bwd" not in captured[-1]:
        if "first_fwd" not in captured[-1]:
            # The session's first call as it ran: a raw-ids sweep's
            # resident table whole, never a compacted copy.
            captured[-1]["first_fwd"] = [
                t.detach().clone() for t in (params, local_idx, vals)]
        # The step's, at its backward.
        captured[-1]["last_fwd"] = kept(params, local_idx, vals)
    return real_fwd(params, local_idx, vals)


def capture_bwd(params, local_idx, vals, g, need_dx):
    if captured and "bwd" not in captured[-1]:
        captured[-1]["fwd"] = captured[-1].pop("last_fwd")
        captured[-1]["bwd"] = [t.detach().clone()
                               for t in (params, local_idx, vals, g)]
        captured[-1]["need_dx"] = need_dx
    return real_bwd(params, local_idx, vals, g, need_dx)


def restore(self, *args, **kwargs):
    t = time.perf_counter()
    try:
        return real_restore(self, *args, **kwargs)
    finally:
        restores.append(time.perf_counter() - t)


def save(self, step, *args, **kwargs):
    t = time.perf_counter()
    try:
        return real_save(self, step, *args, **kwargs)
    finally:
        saves.append({"step": int(step), "wait": bool(kwargs.get("wait")),
                      "seconds": time.perf_counter() - t,
                      "session": len(sessions) - 1})


port_train._train_session = session
CheckpointState.restore = restore
CheckpointState.save = save
fm_kernel._scores = capture_fwd
fm_kernel.fm_batch_scores_bwd = capture_bwd
rc = main(argv)
torch.save([{k: ([t.cpu() for t in v] if isinstance(v, list) else v)
             for k, v in c.items() if k != "last_fwd"} for c in captured],
           out_path + ".pt")
with open(out_path, "w") as fh:
    json.dump({"rc": rc, "fm_score": fm_kernel.launches,
               "fm_score_bwd": fm_kernel.bwd_launches,
               "sessions": sessions, "restore_seconds": restores,
               "saves": saves}, fh)
sys.exit(rc)
"""


def start_elastic_proc(wd, tag, argv):
    """One process of an elastic leg (``ELASTIC_RANK``) logging to
    ``<wd>/<tag>.log``; (process, log path, result path)."""
    log, out = os.path.join(wd, f"{tag}.log"), os.path.join(wd, f"{tag}.json")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", ELASTIC_RANK, out, *argv], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=fh,
            stderr=subprocess.STDOUT)
    return proc, log, out


def log_time(path, pattern):
    """The wall time of the first line of the log at ``path`` matching
    ``pattern`` (the logger's asctime, local time with milliseconds)."""
    import re
    with open(path) as fh:
        m = re.search(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) .*"
                      + pattern, fh.read(), re.M)
    check(m is not None, f"no line matching {pattern!r} in {path}")
    return time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")) + \
        int(m.group(2)) / 1e3


def elastic_start(dist_wd):
    """Start the ``dist`` phase's elastic leg (``elastic_finish``
    completes it): two ranks of ``python -m fast_tffm_tpu_torch train
    <cfg> dist_train worker <i>`` on cuda:0 with ``elastic = grow`` over
    the padded train lines, two epochs, a periodic save every 8 steps; a
    background thread SIGKILLs rank 1 once step 8 is committed, then
    starts ``train <cfg> --join``. It runs beside the stream phase, whose
    card is mostly idle."""
    from fast_tffm_tpu_torch.config import load_config
    wd = os.path.join(WORK, "elastic")
    os.makedirs(wd)
    shutil.copyfile(os.path.join(dist_wd, "train_even.txt"),
                    os.path.join(wd, "train_even.txt"))
    port = free_port_block(4)
    cfg_path = write_dist_cfg(wd, os.path.join(WORK, "train"), "elastic",
                              ELASTIC_EPOCHS, ELASTIC_SAVE_STEPS, port,
                              metrics=os.path.join(wd, "metrics.jsonl"))
    with open(cfg_path, "a") as fh:
        fh.write("elastic = grow\njoin_timeout_seconds = 600\n")
    h = {"wd": wd, "cfg_path": cfg_path, "cfg": load_config(cfg_path),
         "t0": time.perf_counter(), "events": []}
    h["ranks"] = [start_elastic_proc(wd, f"rank{i}", [
        "train", cfg_path, "dist_train", "worker", str(i)])
        for i in range(DIST_WORKERS)]

    def killer():
        import signal
        try:
            procs = [r[0] for r in h["ranks"]]
            log0 = h["ranks"][0][1]
            # The save at 16 waits for step 8's write, so the kill lands
            # in epoch 0: the survivor restores 8 or 16, both epoch 0's.
            # It may land in that save's gather to the chief, which the
            # survivor abandons at collective_timeout_seconds.
            wait_log(log0, f"checkpoint step {ELASTIC_SAVE_STEPS} committed",
                     procs, "the elastic leg's committed step",
                     ELASTIC_RUN_TIMEOUT)
            procs[1].send_signal(signal.SIGKILL)
            h["t_kill"] = time.time()
            h["joiner"] = start_elastic_proc(wd, "joiner", [
                "train", cfg_path, "--join"])
            h["events"].append("started")
        except BaseException as e:  # noqa: BLE001 - elastic_finish raises
            h["events"].append(e)

    h["killer"] = threading.Thread(target=killer, name="smoke-elastic-kill",
                                   daemon=True)
    h["killer"].start()
    return h


def elastic_stop(h):
    """Stop every process of the leg (a no-op once finished)."""
    if h is None:
        return
    h["killer"].join(timeout=60)
    for proc, _, _ in h["ranks"] + ([h["joiner"]] if "joiner" in h else []):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def lease_files_left(cfg, survivor_log):
    """The lease directory after a grow: generation 2's files, and a
    ``worker-<i>.stacks`` forensic dump exactly when the survivor's
    deadline guard abandoned a collective pending on the dead peer (a
    kill that landed in a save's gather). Returns the listing."""
    left = sorted(os.listdir(cfg.model_file + ".hb"))
    stacks = [f for f in left if f.endswith(".stacks")]
    abandoned = "abandoned for the elastic reform" in survivor_log
    check([f for f in left if f not in stacks] == ELASTIC_LEASE_FILES
          and bool(stacks) == abandoned,
          f"the lease directory holds {left}, not generation 2's files"
          f" (the survivor {'did' if abandoned else 'did not'} abandon a "
          "collective)")
    return left


def elastic_finish(h, torch, device, card, train_row):
    """The elastic leg's verdict, from ``elastic_start``'s processes: the
    survivor names process 1, shrinks to generation 1 and trains alone,
    admits the joiner at the epoch boundary (generation 2), and both end
    at the exactly-once step s0 + (a single-process pass) + (a 2-rank
    pass), epoch ``ELASTIC_EPOCHS``, with the validation AUC over the
    floor and the lease directory holding only generation 2's files;
    both kernels launched in both processes, and each post-reform
    session's first step's kernel inputs (the survivor's lone and grown
    sessions, the joiner's) held against the plain versions. Returns
    (row, forward kernel rows, backward kernel rows)."""
    import re
    from fast_tffm_tpu_torch.tools import fmckpt
    t_visible = time.perf_counter()
    wd, cfg = h["wd"], h["cfg"]
    try:
        h["killer"].join(timeout=ELASTIC_RUN_TIMEOUT)
        check(h["events"] == ["started"],
              f"the elastic leg's kill failed: {h['events']}")
        procs = [h["ranks"][0], h["joiner"]]
        deadline = time.monotonic() + ELASTIC_RUN_TIMEOUT
        rcs = []
        for proc, _, _ in procs:
            try:
                rcs.append(proc.wait(timeout=max(1.0, deadline
                                                 - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        rc1 = h["ranks"][1][0].wait(timeout=60)
        texts = []
        for _, log, _ in h["ranks"] + [h["joiner"]]:
            with open(log) as fh:
                texts.append(fh.read())
        if rcs != [0, 0]:
            for t in texts:
                print(t[-4000:], flush=True)
        check(rcs == [0, 0] and rc1 == -9,
              f"the elastic leg: survivor and joiner exited {rcs}, the "
              f"killed rank {rc1}")
        seconds = time.perf_counter() - h["t0"]
    finally:
        elastic_stop(h)
    surv, _, joiner = texts
    res = []
    for _, _, out in procs:
        with open(out) as fh:
            res.append(json.load(fh))
    caps = [torch.load(out + ".pt", weights_only=False)
            for _, _, out in procs]
    # The survivor named the dead process, shrank, then grew.
    lost = re.search(r"worker lost \(collective .*process 1 \(", surv)
    check(lost is not None and "worker lost" in surv,
          "the survivor's log names no lost process 1")
    i_shrink = surv.find("elastic reform generation 1: survivors [0]")
    i_grow = surv.find("elastic grow generation 2: members [0, 1] "
                       "(admitted [1])")
    check(0 <= i_shrink < i_grow,
          "no shrink to generation 1 then grow to generation 2 in the "
          "survivor's log")
    check("join: admitted into generation 2 as rank 1 of 2 (worker slot 1)"
          in joiner, "the joiner's log shows no admission into slot 1")
    restores = [int(s) for s in re.findall(r"restored checkpoint at step "
                                           r"(\d+)", surv)]
    check(len(restores) == 2, f"the survivor restored {restores}")
    s0, barrier = restores
    resumed = re.findall(r"resuming interrupted epoch schedule at epoch "
                         r"(\d+)/", surv)
    check(resumed == ["1"], f"the survivor resumed epochs {resumed}: the "
                            "shrink's restore is epoch 0's")
    per_pass_one = -(-TRAIN_LINES // (TRAIN_BATCH // DIST_WORKERS))
    per_pass_two = -(-TRAIN_LINES // TRAIN_BATCH)
    want = s0 + per_pass_one + (ELASTIC_EPOCHS - 1) * per_pass_two
    done = [int(re.search(r"training done: (\d+) steps", t).group(1))
            for t in (surv, joiner)]
    check(barrier == s0 + per_pass_one and done == [want, want],
          f"steps: restored {s0}, the barrier at {barrier}, done at {done}; "
          f"exactly once wants {s0} + {per_pass_one} + "
          f"{ELASTIC_EPOCHS - 1} x {per_pass_two} = {want}")
    state = fmckpt.scan(cfg.model_file + ".ckpt")
    final = state["steps"][-1]
    check(final["step"] == want and final["epoch"] == ELASTIC_EPOCHS,
          f"the final checkpoint step {final}")
    m = re.search(r"final validation AUC ([0-9.]+) over (\d+)", surv)
    check(m is not None and int(m.group(2)) == VAL_LINES
          and float(m.group(1)) > train_row["auc_floor"],
          f"the elastic leg's final validation AUC: "
          f"{m.group(0) if m else None} (floor {train_row['auc_floor']})")
    auc = float(m.group(1))
    left = lease_files_left(cfg, surv)
    tele = elastic_telemetry(cfg, "the elastic leg")
    for name, r in (("survivor", res[0]), ("joiner", res[1])):
        check(r["fm_score"] > 0 and r["fm_score_bwd"] > 0,
              f"the {name} launched fm_score {r['fm_score']} and "
              f"fm_score_bwd {r['fm_score_bwd']} times")
    check([s["num_shards"] for s in res[0]["sessions"]] == [2, 1, 2]
          and [s["num_shards"] for s in res[1]["sessions"]] == [2],
          f"sessions: survivor {res[0]['sessions']}, joiner "
          f"{res[1]['sessions']}")
    # Both kernels launched in every session, before and after each
    # reform: the counts at each session's start and at the end rise.
    marks = [s["launches_at_start"] for s in res[0]["sessions"]] + [
        [res[0]["fm_score"], res[0]["fm_score_bwd"]]]
    per_session = [[b - a for a, b in zip(m0, m1)]
                   for m0, m1 in zip(marks, marks[1:])]
    check(all(n > 0 for counts in per_session for n in counts),
          f"the survivor's (fm_score, fm_score_bwd) launches per session: "
          f"{per_session}")
    # Each post-reform session's first step, on the card, against the
    # plain versions.
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    fwd_rows, bwd_rows = [], []
    for tag, cap in (("elastic_survivor_shrunk", caps[0][1]),
                     ("elastic_survivor_grown", caps[0][2]),
                     ("elastic_joiner", caps[1][0])):
        check("fwd" in cap and "bwd" in cap and not cap["need_dx"],
              f"{tag}: no kernel inputs captured")
        params, local, vals, g = (t.to(device) for t in cap["bwd"])
        check(all(torch.equal(a.to(device), b) for a, b in
                  zip(cap["fwd"], (params, local, vals))),
              f"{tag}: the backward got other inputs than the forward")
        fwd_rows.append(fwd_kernel_row(torch, params, local, vals, None,
                                       batch=tag))
        bwd_rows += bwd_kernel_rows(torch, params, local, vals, g, flush,
                                    need_dx_cases=(False,), batch=tag)
    del flush
    t_lost = log_time(h["ranks"][0][1], r"worker lost \(collective")
    t_recovered = log_time(h["ranks"][0][1], "elastic recovery complete: 1 "
                           "survivor")
    t_ticket = log_time(h["joiner"][1], "join: ticket ")
    t_admitted = log_time(h["joiner"][1], "join: admitted into generation")
    t_plan = log_time(h["ranks"][0][1], "elastic grow: admitting")
    t_grown = log_time(h["ranks"][0][1], "elastic recovery complete: 2 "
                       "member")
    launches = {
        "survivor": [res[0]["fm_score"], res[0]["fm_score_bwd"]],
        "joiner": [res[1]["fm_score"], res[1]["fm_score_bwd"]],
        "survivor_per_session": per_session}
    row = {"phase": "dist_elastic", "card": card, "workers": DIST_WORKERS,
           "backend": "gloo", "elastic": "grow", "lines": TRAIN_LINES,
           "batch_size_per_rank": TRAIN_BATCH // DIST_WORKERS,
           "epochs": ELASTIC_EPOCHS,
           "note": "correctness-run figures, not a benchmark",
           "seconds": seconds,
           "visible_seconds": time.perf_counter() - t_visible,
           "restored_step": s0, "barrier_step": barrier, "final_step": want,
           "validation_auc": auc, "auc_floor": train_row["auc_floor"],
           "kill_to_detection_seconds": t_lost - h["t_kill"],
           "detection_to_recovery_seconds": t_recovered - t_lost,
           "restore_seconds_survivor": res[0]["restore_seconds"],
           "restore_seconds_joiner": res[1]["restore_seconds"],
           "ticket_to_admission_seconds": t_admitted - t_ticket,
           "grow_plan_to_recovery_seconds": t_grown - t_plan,
           "fm_score_launches": [res[0]["fm_score"], res[1]["fm_score"]],
           "fm_score_bwd_launches": [res[0]["fm_score_bwd"],
                                     res[1]["fm_score_bwd"]],
           "launches": launches, "lease_files": left, "telemetry": tele}
    print(f"dist elastic: {card}; kill to detection "
          f"{row['kill_to_detection_seconds']:.2f}s, detection to recovery "
          f"{row['detection_to_recovery_seconds']:.2f}s, restores "
          f"{[round(x, 2) for x in res[0]['restore_seconds']]}s (survivor) "
          f"{[round(x, 2) for x in res[1]['restore_seconds']]}s (joiner), "
          f"ticket to admission {row['ticket_to_admission_seconds']:.2f}s; "
          f"steps {s0} -> {barrier} -> {want}, AUC {auc:.6f}; launches "
          f"(fm_score, fm_score_bwd) survivor {launches['survivor']}, "
          f"joiner {launches['joiner']}; {seconds:.1f}s for the leg, "
          f"{row['visible_seconds']:.1f}s of it after the phase it ran "
          f"beside; telemetry: {tele['verdict']}, {tele['worker_lost']} "
          f"worker_lost naming process 1, recoveries {tele['recoveries']}",
          flush=True)
    emit(row)
    return row, fwd_rows, bwd_rows


def elastic_telemetry(cfg, what):
    """An elastic leg's streams after a kill, a shrink and a grow: the
    chief's (``cfg.metrics_file``) holds ``health: worker_lost`` naming
    process 1 alone (``cluster/workers_lost`` 1) and an
    ``elastic_recovered`` of kind ``shrink`` then one of kind ``grow``;
    the port's fmstat reads the chief's and worker 1's shard (the killed
    rank's run, then the joiner's) as ``RECOVERED (gen 2, 2 workers)``.
    Returns the figures with the counters."""
    from fast_tffm_tpu_torch.obs.sink import read_events
    chief = [e for e in read_events(cfg.metrics_file) if e["event"] ==
             "health"]
    lost = [e for e in chief if e.get("status") == "worker_lost"]
    named = sorted({p["process_index"] for e in lost for p in e["lost"]})
    kinds = [e["kind"] for e in chief
             if e.get("status") == "elastic_recovered"]
    check(lost and named == [1] and kinds == ["shrink", "grow"],
          f"{what}: the chief's stream holds {len(lost)} worker_lost "
          f"naming {named} and recoveries {kinds}")
    res = read_shards([cfg.metrics_file, cfg.metrics_file + ".p1"],
                      "RECOVERED (gen 2, 2 workers)", what)
    check(res["counters"].get("cluster/workers_lost") == 1
          and res["counters"].get("cluster/elastic_recoveries") == 2,
          f"{what}: cluster counters {res['counters']}")
    return {"verdict": res["verdict"], "worker_lost": len(lost),
            "worker_lost_labels": [e["label"] for e in lost],
            "recoveries": kinds,
            "train_examples": res["counters"].get("train/examples")}


DSTREAM_SHARDS = 4                # of 32,768 lines: 8 batches of a rank's
#                                   4,096 each, so no batch spans two shards
DSTREAM_FINAL_STEP = 16           # shards 0-1 paired in 8 steps, 2-3 in 8
DSTREAM_RUN_TIMEOUT = 600         # seconds for any one wait of the leg
DSTREAM_COLLECTIVE_TIMEOUT = 60.0  # beside phases 13-14 the host is busy;
#                                   a dead peer is named by the lease


def write_dstream_cfg(wd, data_wd, port, auc_floor):
    """Config #2's model in ``run_mode = stream`` across 2 ranks on
    cuda:0 (``elastic = grow``): a rank's batch 4,096, publishes every
    ``STREAM_PUBLISH_SECONDS`` through the gate at ``auc_floor``, no
    periodic saves (each publish saves)."""
    hosts = ",".join(f"localhost:{port - 1000 + i}"
                     for i in range(DIST_WORKERS))
    path = os.path.join(wd, "dist_stream.cfg")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = {FACTORS}
model_file = {os.path.join(wd, 'model', 'fm_model')}
[Train]
run_mode = stream
stream_dir = {os.path.join(wd, 'stream')}
stream_poll_seconds = {STREAM_POLL_SECONDS}
publish_interval_seconds = {STREAM_PUBLISH_SECONDS}
publish_min_auc = {auc_floor!r}
validation_files = {os.path.join(data_wd, 'val.txt')}
batch_size = {TRAIN_BATCH // DIST_WORKERS}
learning_rate = {TRAIN_LR}
loss_type = logistic
log_steps = 1
save_steps = 0
{DIST_TELEMETRY.format(path=os.path.join(wd, 'metrics.jsonl'))}
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = {DIST_HEARTBEAT_SECONDS}
collective_timeout_seconds = {DSTREAM_COLLECTIVE_TIMEOUT}
cluster_connect_timeout_seconds = 120
elastic = grow
join_timeout_seconds = {DSTREAM_RUN_TIMEOUT}
""")
    return path


def stage_shards(sd, ks, shards, done_times):
    """Shards ``ks`` written in torn appends (``write_shard``) under dot
    names no reader lists, their ``.done`` markers, then renamed into
    place one right after the other: both ranks' owned shards appear in
    one discovery, sealed, so their batches pair step by step."""
    hidden = [write_shard(sd, k, shards[k], done_times, hidden=True)
              for k in ks]
    for path in hidden:
        head, name = os.path.split(path)
        os.rename(path, os.path.join(head, name[1:]))


def dstream_start(train_data, train_row):
    """Start the ``dist_stream`` leg (``dstream_finish`` completes it):
    shards 0-1 of the train lines staged, then two ranks of ``python -m
    fast_tffm_tpu_torch train <cfg> dist_train worker <i>`` on cuda:0 in
    ``run_mode = stream`` with ``elastic = grow``. A background thread waits
    until ``published`` names step 8, SIGKILLs rank 1 while both idle in
    the flags window, waits for the survivor's recovery (the lone
    survivor restores step 8), starts ``train <cfg> --join`` and waits
    for its admission at a publish settle, stages shards 2-3 and, once
    step 16 is published, writes ``STOP``. It runs beside phases 13-14,
    whose card is mostly idle."""
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch.config import load_config
    wd = os.path.join(WORK, "dist_stream")
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    with open(os.path.join(train_data[0], "train.txt")) as fh:
        lines = fh.read().splitlines()
    per = len(lines) // DSTREAM_SHARDS
    check(per == 8 * (TRAIN_BATCH // DIST_WORKERS),
          f"{per} lines a shard: not 8 batches of a rank's")
    shards = [lines[k * per:(k + 1) * per] for k in range(DSTREAM_SHARDS)]
    del lines
    cfg_path = write_dstream_cfg(wd, train_data[0], free_port_block(4),
                                 train_row["auc_floor"])
    cfg = load_config(cfg_path)
    directory = cfg.model_file + ".ckpt"
    h = {"wd": wd, "cfg_path": cfg_path, "cfg": cfg,
         "t0": time.perf_counter(), "events": [], "done_times": {},
         "shard_lines": per}
    stage_shards(sd, (0, 1), shards, h["done_times"])
    h["ranks"] = [start_elastic_proc(wd, f"rank{i}", [
        "train", cfg_path, "dist_train", "worker", str(i)])
        for i in range(DIST_WORKERS)]

    def published(step):
        return (ck.read_published(directory) or -1) >= step

    def stage():
        import signal
        try:
            procs = [r[0] for r in h["ranks"]]
            log0 = h["ranks"][0][1]
            half = DSTREAM_FINAL_STEP // 2
            wait_until(lambda: published(half), f"step {half} published",
                       procs[0], DSTREAM_RUN_TIMEOUT)
            procs[1].send_signal(signal.SIGKILL)
            h["t_kill"] = time.time()
            wait_log(log0, "elastic recovery complete: 1 survivor", procs[:1],
                     "the survivor's shrink", DSTREAM_RUN_TIMEOUT)
            h["joiner"] = start_elastic_proc(wd, "joiner", [
                "train", cfg_path, "--join"])
            wait_log(log0, "input shards re-balanced",
                     [procs[0], h["joiner"][0]], "the joiner's admission",
                     DSTREAM_RUN_TIMEOUT)
            stage_shards(sd, (2, 3), shards, h["done_times"])
            wait_until(lambda: published(DSTREAM_FINAL_STEP),
                       f"step {DSTREAM_FINAL_STEP} published", procs[0],
                       DSTREAM_RUN_TIMEOUT)
            open(os.path.join(sd, "STOP"), "w").close()
            h["events"].append("stopped")
        except BaseException as e:  # noqa: BLE001 - dstream_finish raises
            h["events"].append(e)

    h["stager"] = threading.Thread(target=stage, name="smoke-dstream",
                                   daemon=True)
    h["stager"].start()
    return h


def dstream_stop(h):
    """Stop every process of the leg (a no-op once finished)."""
    if h is None:
        return
    h["stager"].join(timeout=60)
    for proc, _, _ in h["ranks"] + ([h["joiner"]] if "joiner" in h else []):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dstream_finish(h, torch, device, card, train_row):
    """The ``dist_stream`` leg's verdict, from ``dstream_start``'s
    processes: the survivor names process 1, reforms alone (generation
    1) and restores step 8 with the merged watermark, admits the joiner
    at a publish settle (generation 2); both exit 0 at step 16, the
    final watermark covers every byte and line of the 4 shards (each
    sealed), the joiner stepped shard 3 (ledger index 3 is rank 1's),
    the final AUC clears the floor and lies within 0.03 of run A's; per
    session of each process its (fm_score, fm_score_bwd) launches, the
    forward in every session, the backward one a step; both kernels
    against their plain versions on the post-reform sessions' captured
    inputs (the lone survivor's first sweep batch, the grown ranks'
    first step). Returns (row, forward kernel rows, backward kernel
    rows)."""
    import re
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch.tools import fmckpt
    t_visible = time.perf_counter()
    wd, cfg = h["wd"], h["cfg"]
    try:
        h["stager"].join(timeout=DSTREAM_RUN_TIMEOUT)
        check(h["events"] == ["stopped"],
              f"the dist stream leg's staging thread failed: "
              f"{h['events']}")
        procs = [h["ranks"][0], h["joiner"]]
        deadline = time.monotonic() + DSTREAM_RUN_TIMEOUT
        rcs = []
        for proc, _, _ in procs:
            try:
                rcs.append(proc.wait(timeout=max(1.0, deadline
                                                 - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        rc1 = h["ranks"][1][0].wait(timeout=60)
        texts = []
        for _, log, _ in h["ranks"] + [h["joiner"]]:
            with open(log) as fh:
                texts.append(fh.read())
        if rcs != [0, 0]:
            for t in texts:
                print(t[-4000:], flush=True)
        check(rcs == [0, 0] and rc1 == -9,
              f"the dist stream leg: survivor and joiner exited {rcs}, the "
              f"killed rank {rc1}")
        seconds = time.perf_counter() - h["t0"]
    finally:
        dstream_stop(h)
    surv, _, joiner = texts
    res = []
    for _, _, out in procs:
        with open(out) as fh:
            res.append(json.load(fh))
    caps = [torch.load(out + ".pt", weights_only=False)
            for _, _, out in procs]
    half = DSTREAM_FINAL_STEP // 2
    lost = re.search(r"worker lost \(collective .*process 1 \(", surv)
    check(lost is not None, "the survivor's log names no lost process 1")
    i_shrink = surv.find("elastic reform generation 1: survivors [0]")
    i_grow = surv.find("elastic grow generation 2: members [0, 1] "
                       "(admitted [1])")
    check(0 <= i_shrink < i_grow and "input shards re-balanced" in surv,
          "no shrink to generation 1 then grow to generation 2 in the "
          "survivor's log")
    check("join: admitted into generation 2 as rank 1 of 2 (worker slot 1)"
          in joiner, "the joiner's log shows no admission into slot 1")
    restores = re.findall(r"restored checkpoint at step (\d+)", surv)
    check(restores == [str(half)] * 2
          and re.findall(r"restored checkpoint at step (\d+)", joiner)
          == [str(half)], f"restores: survivor {restores}")
    done = [re.findall(r"training done: (\d+) steps", t)
            for t in (surv, joiner)]
    check(done == [[str(DSTREAM_FINAL_STEP)]] * 2,
          f"the survivor and the joiner ended at {done}, not step "
          f"{DSTREAM_FINAL_STEP}")
    state = fmckpt.scan(cfg.model_file + ".ckpt")
    final = state["steps"][-1]["step"]
    check(final == DSTREAM_FINAL_STEP, f"the final checkpoint step {final}")
    # Exactly once: the final watermark covers every byte and line.
    wm = ck.read_watermark(cfg.model_file + ".ckpt", final)
    names = [os.path.basename(f["path"]) for f in wm["files"]]
    check(names == [f"part-{k:05d}" for k in range(DSTREAM_SHARDS)],
          f"the final watermark's ledger {names}")
    for f in wm["files"]:
        size = os.path.getsize(f["path"])
        check(f["bytes"] == size and f["lines"] == h["shard_lines"]
              and not f["dead"] and os.path.exists(f["path"] + ".done"),
              f"the final watermark's entry {f} against {size} bytes, "
              f"{h['shard_lines']} lines and a .done marker")
    inputs = [re.findall(r"stream input: (\d+) batches, (\d+) examples", t)
              for t in (surv, joiner)]
    # The sessions that ended cleanly: the survivor's grown one read
    # shard 2, the joiner's shard 3 (the first session ended in the
    # kill, the lone one read nothing).
    one = ("8", str(h["shard_lines"]))
    check(inputs == [[one], [one]],
          f"stream input lines: survivor {inputs[0]}, joiner {inputs[1]}")
    m = re.search(r"final validation AUC ([0-9.]+) over (\d+)", surv)
    auc = float(m.group(1)) if m else float("nan")
    run_a_auc = train_row["validation_auc"][0]
    check(m is not None and int(m.group(2)) == VAL_LINES
          and auc >= train_row["auc_floor"]
          and abs(auc - run_a_auc) <= DIST_AUC_TOL,
          f"the dist stream leg's final validation AUC "
          f"{m.group(0) if m else None} against run A's {run_a_auc} "
          f"(tolerance {DIST_AUC_TOL}) and the floor "
          f"{train_row['auc_floor']}")
    left = lease_files_left(cfg, surv)
    # Exactly once by the telemetry too: train/examples summed over the
    # chief's stream, the killed rank's and the joiner's (one .p1) is
    # every line written.
    tele = elastic_telemetry(cfg, "the dist stream leg")
    check(tele["train_examples"] == DSTREAM_SHARDS * h["shard_lines"],
          f"the dist stream leg's shards count {tele['train_examples']} "
          f"train/examples, not {DSTREAM_SHARDS * h['shard_lines']}")
    check([s["num_shards"] for s in res[0]["sessions"]] == [2, 1, 2]
          and [s["num_shards"] for s in res[1]["sessions"]] == [2],
          f"sessions: survivor {res[0]['sessions']}, joiner "
          f"{res[1]['sessions']}")
    per_session = []
    for r in res:
        marks = [s["launches_at_start"] for s in r["sessions"]] + [
            [r["fm_score"], r["fm_score_bwd"]]]
        per_session.append([[b - a for a, b in zip(m0, m1)]
                            for m0, m1 in zip(marks, marks[1:])])
    # The forward in every session (steps and sweeps); the backward once
    # a step: 8 steps in each 2-rank session, none alone (the shards
    # after the kill arrive once the joiner is in).
    check(all(f > 0 for sess in per_session for f, _ in sess)
          and [b for _, b in per_session[0]] == [half, 0, half]
          and [b for _, b in per_session[1]] == [half],
          f"(fm_score, fm_score_bwd) launches per session: survivor "
          f"{per_session[0]}, joiner {per_session[1]}")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    fwd_rows, bwd_rows = [], []
    lone = caps[0][1]
    check("first_fwd" in lone, "dstream_survivor_lone: no sweep captured")
    resident = [t.to(device) for t in lone.pop("first_fwd")]
    check(resident[0].shape[0] >= VOCAB + 1,
          f"dstream_survivor_lone: the sweep read a {list(resident[0].shape)}"
          " table, not the resident one")
    fwd_rows.append(fwd_kernel_row(
        torch, *resident, None, batch="dstream_survivor_lone_sweep",
        table_rows=int(resident[0].shape[0])))
    del resident
    for tag, cap in (("dstream_survivor_grown", caps[0][2]),
                     ("dstream_joiner", caps[1][0])):
        check("fwd" in cap and "bwd" in cap and not cap["need_dx"],
              f"{tag}: no step's kernel inputs captured")
        params, local, vals, g = (t.to(device) for t in cap["bwd"])
        check(all(torch.equal(a.to(device), b) for a, b in
                  zip(cap["fwd"], (params, local, vals))),
              f"{tag}: the backward got other inputs than the forward")
        fwd_rows.append(fwd_kernel_row(torch, params, local, vals, None,
                                       batch=tag))
        bwd_rows += bwd_kernel_rows(torch, params, local, vals, g, flush,
                                    need_dx_cases=(False,), batch=tag)
    del flush
    log0, logj = h["ranks"][0][1], h["joiner"][1]
    t_lost = log_time(log0, r"worker lost \(collective")
    t_recovered = log_time(log0, "elastic recovery complete: 1 survivor")
    t_ticket = log_time(logj, "join: ticket ")
    t_admitted = log_time(logj, "join: admitted into generation")
    sweeps = [(int(a), float(b)) for a, b in re.findall(
        r"publish quality eval at step (\d+): .*\(([0-9.]+)s\)", surv)]
    saves = [(sv["step"], sv["seconds"]) for sv in res[0]["saves"]
             if sv["wait"]]
    launches = {"survivor": [res[0]["fm_score"], res[0]["fm_score_bwd"]],
                "joiner": [res[1]["fm_score"], res[1]["fm_score_bwd"]],
                "survivor_per_session": per_session[0],
                "joiner_per_session": per_session[1]}
    row = {"phase": "dist_stream", "card": card, "workers": DIST_WORKERS,
           "backend": "gloo", "elastic": "grow", "run_mode": "stream",
           "shards": DSTREAM_SHARDS, "shard_lines": h["shard_lines"],
           "batch_size_per_rank": TRAIN_BATCH // DIST_WORKERS,
           "note": "correctness-run figures, not a benchmark",
           "seconds": seconds,
           "visible_seconds": time.perf_counter() - t_visible,
           "final_step": final, "validation_auc": auc,
           "run_a_auc": run_a_auc, "auc_floor": train_row["auc_floor"],
           "kill_to_detection_seconds": t_lost - h["t_kill"],
           "detection_to_recovery_seconds": t_recovered - t_lost,
           "restore_seconds_survivor": res[0]["restore_seconds"],
           "restore_seconds_joiner": res[1]["restore_seconds"],
           "ticket_to_admission_seconds": t_admitted - t_ticket,
           "publish_sweep_seconds": sweeps,
           "publish_and_final_save_seconds": saves,
           "fm_score_launches": [res[0]["fm_score"], res[1]["fm_score"]],
           "fm_score_bwd_launches": [res[0]["fm_score_bwd"],
                                     res[1]["fm_score_bwd"]],
           "launches": launches, "lease_files": left, "telemetry": tele}
    sweep_s = [x for _, x in sweeps] or [float("nan")]
    save_s = [x for _, x in saves] or [float("nan")]
    print(f"dist stream: {card}; kill to detection "
          f"{row['kill_to_detection_seconds']:.2f}s, detection to recovery "
          f"{row['detection_to_recovery_seconds']:.2f}s, restores "
          f"{[round(x, 2) for x in res[0]['restore_seconds']]}s (survivor) "
          f"{[round(x, 2) for x in res[1]['restore_seconds']]}s (joiner), "
          f"ticket to admission {row['ticket_to_admission_seconds']:.2f}s; "
          f"{len(sweeps)} publish sweeps {min(sweep_s):.2f}-"
          f"{max(sweep_s):.2f}s, {len(saves)} waited saves "
          f"{min(save_s):.2f}-{max(save_s):.2f}s; steps {half} -> "
          f"{final}, AUC {auc:.6f} (run A {run_a_auc:.6f}); launches "
          f"(fm_score, fm_score_bwd) survivor {launches['survivor']}, "
          f"joiner {launches['joiner']}; {seconds:.1f}s for the leg, "
          f"{row['visible_seconds']:.1f}s of it after the phases it ran "
          f"beside; telemetry: {tele['verdict']}, train/examples "
          f"{tele['train_examples']} over the 3 runs' shards", flush=True)
    emit(row)
    return row, fwd_rows, bwd_rows


CONFIG1_TRAIN_LINES = 131072      # of config #1's 1,000,000
CONFIG1_TEST_LINES = 32768        # of its 100,000
CONFIG1_SEED = 17                 # tools/criteo_bench.py's default
CONFIG1_VOCAB = 1 << 22           # hashed, a [2^22+1, 9] table
CONFIG1_FACTORS = 8
CONFIG1_L = 48                    # max_features_per_example = bucket_ladder
CONFIG1_BATCH = 1024              # of 8,192: 256 steps, not 32, at this depth
CONFIG1_EPOCHS = 2
CONFIG1_LR = 0.05
CONFIG1_LAMBDA = 1e-6             # factor_lambda = bias_lambda
CONFIG1_AUC_TOL = 0.015           # tests/test_criteo_like.py's parity bound
CONFIG1_ORACLE_FLOOR = 0.80
CONFIG1_HOST_TIMEOUT = 600        # seconds for the host side's process

# The config1 leg's host side, in a process of its own so that it runs
# beside the card-bound phases: the port's synth draws the train and
# test files (data.json marks them written), parses them with the
# port's C++ block parse and trains the independent NumPy SGD-FM on
# them (oracle.json, oracle.npy).
CONFIG1_HOST = r"""
import json, os, sys, time
import numpy as np
from fast_tffm_tpu_torch.data import synth
from fast_tffm_tpu_torch.metrics import exact_auc
a = json.loads(sys.argv[1])
wd = a["wd"]


def dump(name, obj):
    tmp = os.path.join(wd, name + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, os.path.join(wd, name))


train, test = os.path.join(wd, "train.txt"), os.path.join(wd, "test.txt")
t0 = time.perf_counter()
meta = synth.write_dataset(train, test, a["n_train"], a["n_test"],
                           seed=a["seed"])
dump("data.json", dict(meta, generate_seconds=time.perf_counter() - t0))
t0 = time.perf_counter()
tr = synth.parse_file_blocks(train, a["vocab"], a["batch"])
te = synth.parse_file_blocks(test, a["vocab"], a["batch"])
parse_s = time.perf_counter() - t0
t0 = time.perf_counter()
scores = synth.numpy_fm_train_predict(
    tr, te, a["vocab"], k=a["k"], lr=a["lr"], epochs=a["epochs"],
    factor_lambda=a["lam"], bias_lambda=a["lam"], L=a["L"])
oracle_s = time.perf_counter() - t0
labels = np.concatenate([b.labels for b in te])
np.save(os.path.join(wd, "oracle.npy"), scores)
dump("oracle.json", {"parse_seconds": parse_s, "oracle_seconds": oracle_s,
                     "oracle_auc": exact_auc(scores, labels),
                     "test_examples": int(len(labels))})
"""


def config1_start():
    """Start the config1 leg's host side (``CONFIG1_HOST``: the data,
    its parse and the NumPy oracle) in a process of its own; returns the
    handle ``config1_phase`` waits on."""
    wd = os.path.join(WORK, "config1")
    os.makedirs(wd)
    out = open(os.path.join(wd, "host.out"), "w")
    args = {"wd": wd, "n_train": CONFIG1_TRAIN_LINES,
            "n_test": CONFIG1_TEST_LINES, "seed": CONFIG1_SEED,
            "vocab": CONFIG1_VOCAB, "k": CONFIG1_FACTORS, "lr": CONFIG1_LR,
            "lam": CONFIG1_LAMBDA, "epochs": CONFIG1_EPOCHS,
            "batch": CONFIG1_BATCH, "L": CONFIG1_L}
    proc = subprocess.Popen(
        [sys.executable, "-c", CONFIG1_HOST, json.dumps(args)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=out,
        stderr=subprocess.STDOUT)
    return {"wd": wd, "proc": proc, "out": out, "t0": time.perf_counter()}


def config1_stop(h):
    """Stop the host side's process (a no-op once finished)."""
    if h is None:
        return
    if h["proc"].poll() is None:
        h["proc"].kill()
    h["proc"].wait()
    h["out"].close()


def config1_wait(h, name):
    """``name``'s JSON from the host side, once written."""
    path = os.path.join(h["wd"], name)
    deadline = time.monotonic() + CONFIG1_HOST_TIMEOUT
    while not os.path.exists(path):
        if h["proc"].poll() is not None and not os.path.exists(path):
            with open(os.path.join(h["wd"], "host.out")) as fh:
                tail = fh.read()[-2000:]
            raise SmokeFailure(f"the config1 host side exited "
                               f"{h['proc'].returncode} before {name}: "
                               f"{tail}")
        check(time.monotonic() < deadline, f"timed out waiting for {name}")
        time.sleep(0.1)
    with open(path) as fh:
        return json.load(fh)


def config1_phase(torch, device, card, h):
    """BASELINE config #1's AUC parity on the card: ``python -m
    fast_tffm_tpu_torch train`` then ``predict`` (in process) at its
    published width and settings (tools/criteo_bench.py: order-2 FM, k
    = 8, hashed ids into 2^22, L = 48, lr 0.05, lambdas 1e-6, init range
    0.01, logistic loss, 2 epochs, no shuffle) on the port's synth draws
    at seed 17, against the port's NumPy SGD-FM oracle trained on the
    same parsed blocks at the same B, k, lr, lambdas and epochs
    (``config1_start``'s process). Cut to size: 131,072 train / 32,768
    test lines instead of 1,000,000 / 100,000, and B = 1,024 instead of
    8,192 (at this depth 8,192 leaves 32 steps, where the oracle reaches
    only ~0.59). The card's test AUC must lie within 0.015 of the
    oracle's (the reference's bound), the oracle's reach 0.80, the
    card's stay below the generator's Bayes ceiling; fm_score launches
    every train step and predict batch, fm_score_bwd every step; both
    kernels against their plain versions on the first train step's
    captured inputs at (1,024, 48, 8). Returns (row, forward kernel
    rows, backward kernel rows)."""
    import numpy as np
    from fast_tffm_tpu_torch import train as train_mod
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.metrics import exact_auc
    from fast_tffm_tpu_torch.ops import fm_kernel
    t_leg = time.perf_counter()
    wd = h["wd"]
    data = config1_wait(h, "data.json")
    wait_data_s = time.perf_counter() - t_leg
    train, test = os.path.join(wd, "train.txt"), os.path.join(wd, "test.txt")
    cfg_path = os.path.join(wd, "config1.cfg")
    with open(cfg_path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {CONFIG1_VOCAB}
hash_feature_id = True
factor_num = {CONFIG1_FACTORS}
model_file = {os.path.join(wd, 'model', 'ck')}
log_file = {os.path.join(wd, 'ck.log')}

[Train]
train_files = {train}
epoch_num = {CONFIG1_EPOCHS}
batch_size = {CONFIG1_BATCH}
learning_rate = {CONFIG1_LR}
factor_lambda = {CONFIG1_LAMBDA}
bias_lambda = {CONFIG1_LAMBDA}
init_value_range = 0.01
loss_type = logistic
max_features_per_example = {CONFIG1_L}
bucket_ladder = {CONFIG1_L}
shuffle = False
log_steps = 1

[Predict]
predict_files = {test}
score_path = {os.path.join(wd, 'score')}
""")
    cfg = load_config(cfg_path)
    captured, export_s = {}, []
    bwd, save_npz = fm_kernel.fm_batch_scores_bwd, train_mod.save_npz

    def capture_bwd(params, local_idx, vals, g, need_dx):
        if not captured:  # the first train step's kernel inputs
            captured.update(params=params.detach().clone(),
                            local=local_idx.clone(), vals=vals.clone(),
                            g=g.clone())
        return bwd(params, local_idx, vals, g, need_dx)

    def timed_npz(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return save_npz(*args, **kwargs)
        finally:
            export_s.append(time.perf_counter() - t0)

    fm_kernel.fm_batch_scores_bwd, train_mod.save_npz = capture_bwd, timed_npz
    try:
        fm_kernel.launches = 0
        fm_kernel.bwd_launches = 0
        t0 = time.perf_counter()
        rc = cli(["train", cfg_path])
        train_s = time.perf_counter() - t0
        fwd_launches, bwd_launches = (fm_kernel.launches,
                                      fm_kernel.bwd_launches)
    finally:
        fm_kernel.fm_batch_scores_bwd, train_mod.save_npz = bwd, save_npz
    check(rc == 0, f"config1 train returned {rc}")
    losses, rates, _, done = read_train_log(cfg.log_file)
    steps = CONFIG1_EPOCHS * -(-CONFIG1_TRAIN_LINES // CONFIG1_BATCH)
    check([n for n, _ in done] == [steps],
          f"config1 train ended at steps {done}, not {steps}")
    check(fwd_launches == steps and bwd_launches == steps,
          f"config1 train launched fm_score {fwd_launches} and "
          f"fm_score_bwd {bwd_launches} times for {steps} steps")
    check(len(rates) == steps and sorted(losses) == [0, 1]
          and np.mean(losses[1]) < np.mean(losses[0]),
          f"config1 epoch losses did not fall: {len(rates)} rates, "
          f"{ {e: float(np.mean(v)) for e, v in losses.items()} }")
    check(len(export_s) == 1 and os.path.isfile(cfg.model_file + ".npz"),
          f"config1 train exported {len(export_s)} .npz files")
    loop_eps = steps * CONFIG1_BATCH / sum(CONFIG1_BATCH / r for r in rates)

    fm_kernel.launches = 0
    t0 = time.perf_counter()
    rc = cli(["predict", cfg_path])
    predict_s = time.perf_counter() - t0
    predict_launches = fm_kernel.launches
    check(rc == 0, f"config1 predict returned {rc}")
    test_batches = -(-CONFIG1_TEST_LINES // CONFIG1_BATCH)
    check(predict_launches == test_batches,
          f"config1 predict launched fm_score {predict_launches} times "
          f"for {test_batches} batches")
    with open(os.path.join(cfg.score_path, "test.txt.score")) as fh:
        scores = np.array([float(x) for x in fh.read().split()])
    labels = np.loadtxt(test, usecols=0)
    check(scores.shape == (CONFIG1_TEST_LINES,)
          and np.isfinite(scores).all(),
          f"{scores.shape} config1 scores for {CONFIG1_TEST_LINES} lines")
    card_auc = exact_auc(scores, labels)

    t0 = time.perf_counter()
    oracle = config1_wait(h, "oracle.json")
    wait_oracle_s = time.perf_counter() - t0
    h["proc"].wait(timeout=60)
    check(h["proc"].returncode == 0,
          f"the config1 host side exited {h['proc'].returncode}")
    oracle_auc = oracle["oracle_auc"]
    check(oracle["test_examples"] == CONFIG1_TEST_LINES,
          f"the oracle scored {oracle['test_examples']} test lines")
    check(oracle_auc >= CONFIG1_ORACLE_FLOOR,
          f"the oracle's AUC {oracle_auc} is below {CONFIG1_ORACLE_FLOOR}")
    check(abs(card_auc - oracle_auc) < CONFIG1_AUC_TOL,
          f"config1 AUC on the card {card_auc} vs the oracle's "
          f"{oracle_auc}: not within {CONFIG1_AUC_TOL}")
    check(card_auc < data["bayes_auc"],
          f"config1 AUC {card_auc} not below the Bayes ceiling "
          f"{data['bayes_auc']}")

    # Both kernels against their plain versions on the first train
    # step's inputs: the forward with L2 warm, as in the step; the
    # backward flushed, need_dx off (the step never asks for dvals).
    check(bool(captured), "no train step's kernel inputs were captured")
    params, local = captured["params"], captured["local"]
    vals, g = captured["vals"], captured["g"]
    check(tuple(local.shape) == (CONFIG1_BATCH, CONFIG1_L)
          and params.shape[1] == CONFIG1_FACTORS + 1,
          f"the captured batch is {tuple(local.shape)} over "
          f"{tuple(params.shape)} rows")
    fwd_rows = [fwd_kernel_row(torch, params, local, vals, None,
                               batch="config1_train")]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    bwd_rows = bwd_kernel_rows(torch, params, local, vals, g, flush,
                               need_dx_cases=(False,),
                               batch="config1_train")
    del flush, captured, params, local, vals, g
    shutil.rmtree(os.path.join(wd, "model"))
    torch.cuda.empty_cache()
    row = {"phase": "config1", "card": card,
           "train_lines": CONFIG1_TRAIN_LINES,
           "test_lines": CONFIG1_TEST_LINES, "seed": CONFIG1_SEED,
           # The draws at a seed follow numpy's version (its samplers).
           "numpy": np.__version__,
           "vocabulary_size": CONFIG1_VOCAB, "factor_num": CONFIG1_FACTORS,
           "L": CONFIG1_L, "batch_size": CONFIG1_BATCH,
           "epochs": CONFIG1_EPOCHS, "steps": steps,
           "test_auc": card_auc, "oracle_auc": oracle_auc,
           "auc_gap": card_auc - oracle_auc, "bayes_auc": data["bayes_auc"],
           "positive_rate_test": data["positive_rate_test"],
           "epoch_mean_loss": [float(np.mean(losses[e])) for e in (0, 1)],
           "generate_seconds": data["generate_seconds"],
           "parse_seconds": oracle["parse_seconds"],
           "oracle_seconds": oracle["oracle_seconds"],
           "host_side_seconds": time.perf_counter() - h["t0"],
           "wait_for_data_seconds": wait_data_s,
           "wait_for_oracle_seconds": wait_oracle_s,
           "train_entry_seconds": train_s,
           "predict_entry_seconds": predict_s,
           "export_seconds": export_s[0],
           "examples_per_s_loop": loop_eps,
           "examples_per_s_train_log": [e for _, e in done],
           "fm_score_launches": fwd_launches,
           "fm_score_bwd_launches": bwd_launches,
           "predict_launches": predict_launches,
           "leg_seconds": time.perf_counter() - t_leg}
    print(f"config1: {card}; test AUC {card_auc:.6f} on the card, oracle "
          f"{oracle_auc:.6f} (gap {card_auc - oracle_auc:+.6f}, bound "
          f"{CONFIG1_AUC_TOL}), Bayes ceiling {data['bayes_auc']:.6f}; "
          f"generate {data['generate_seconds']:.2f}s, parse "
          f"{oracle['parse_seconds']:.2f}s, oracle "
          f"{oracle['oracle_seconds']:.2f}s (beside the card's phases); "
          f"train {train_s:.2f}s (export {export_s[0]:.2f}s), predict "
          f"{predict_s:.2f}s, loop {loop_eps:.0f} examples/s; launches "
          f"fm_score {fwd_launches} + {predict_launches}, fm_score_bwd "
          f"{bwd_launches}; {row['leg_seconds']:.1f}s for the leg",
          flush=True)
    emit(row)
    return row, fwd_rows, bwd_rows


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="chip_smoke.py", description="On-card smoke run of the port.")
    parser.add_argument("--out", metavar="DIR",
                        help="also write a JSON summary of every phase to "
                             "DIR/chip_smoke.json")
    args = parser.parse_args(argv)
    out_dir = args.out
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data import cparser
    from fast_tffm_tpu_torch.data.parser import parse_lines
    from fast_tffm_tpu_torch.data.pipeline import make_device_batch
    from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
    from fast_tffm_tpu_torch.ops import build
    from fast_tffm_tpu_torch.tools import fmckpt

    device = torch.device("cuda")
    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # 2. build: the parser (g++) beside the kernels (one nvcc each)
    t0 = time.perf_counter()

    def build_parser():
        built = not os.path.isfile(cparser.library_path())
        t = time.perf_counter()
        cparser._load()
        return built, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=1) as pool:
        parser_build = pool.submit(build_parser)
        build.build_all(build.SOURCES,
                        log=lambda text: print(text, end="", flush=True))
        parser_built, parser_s = parser_build.result()
    build.load_fm_score()
    build.load_fm_score_bwd()
    build.load_offload_rows()
    print(f"parser library {'built' if parser_built else 'found'} and "
          f"loaded in {parser_s:.2f}s: {cparser.library_path()}")
    print(f"build+load seconds {time.perf_counter() - t0:.2f}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    dist = elastic = dstream = offload = config1 = None
    free = shutil.disk_usage(WORK).free
    print(f"free bytes under {WORK}: {free}", flush=True)
    check(free >= MIN_FREE_BYTES, f"{free} bytes free under {WORK}; the "
          f"checkpoint phases need {MIN_FREE_BYTES}")
    try:
        # pipeline: the train phase's lines through the three streams
        train_data = write_train_data()
        pipeline_row = pipeline_phase(
            load_config(write_train_cfg(train_data[0], TRAIN_EPOCHS)),
            parser_s, smi)
        # config #1's data and oracle (host) go on beside phases 3-5b
        config1 = config1_start()

        cfg_path = os.path.join(WORK, "smoke.cfg")
        write_cfg(cfg_path)
        cfg = load_config(cfg_path)
        gen = torch.Generator(device=device).manual_seed(SEED)
        tables = {}
        for K in sorted({k for _, _, k in KERNEL_SHAPES}):
            t = torch.randn((VOCAB + 1, K + 1), generator=gen,
                            device=device) * 0.1
            t[-1] = 0.0
            tables[K] = t
        table = tables[FACTORS]
        table_cpu = table.cpu().numpy()
        t0 = time.perf_counter()
        step_dir = save_checkpoint_from_numpy(cfg, table_cpu, None,
                                              SERVE_STEP)
        save_s = time.perf_counter() - t0
        check(fmckpt.main(["publish", cfg.model_file,
                           str(SERVE_STEP)]) == 0, "fmckpt publish failed")
        step_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        emit({"phase": "checkpoint", "card": smi, "step": SERVE_STEP,
              "bytes": step_bytes, "save_and_verify_seconds": save_s})

        lines, _ = criteo_lines(PREDICT_LINES, SEED + 3)
        with open(os.path.join(WORK, "criteo.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
        first = make_device_batch(parse_lines(
            lines[:PREDICT_BATCH], cfg.vocabulary_size, hash_feature_id=True,
            max_features_per_example=cfg.max_features_per_example,
            keep_empty=True), cfg)
        predict_batch = tuple(torch.from_numpy(a).to(device)
                              for a in (first.local_idx, first.vals))

        # 3. kernel vs plain version
        kernel_rows = kernel_phase(torch, tables, predict_batch, device)
        bwd_rows = bwd_kernel_phase(torch, tables, device)
        del tables, table, predict_batch
        torch.cuda.empty_cache()

        # 4. predict
        predict_row, score_lines = predict_phase(
            torch, cfg, cfg_path, table_cpu, lines, device, smi)

        # 5. serve
        serve_row = serve_phase(torch, cfg, lines, score_lines, device, smi)
        # 5b. predict and serve on the packed wire
        packed_serving_row = packed_serving_phase(torch, cfg, lines,
                                                  score_lines, device, smi)
        del lines, score_lines, table_cpu
        shutil.rmtree(os.path.dirname(cfg.model_file))  # disk for phase 6
        # 5c. config #1: train -> predict on the card against the oracle
        config1_row, fwd_config1_rows, bwd_config1_rows = config1_phase(
            torch, device, smi, config1)
        kernel_rows += fwd_config1_rows
        bwd_rows += bwd_config1_rows

        # 6. train
        train_row, fwd_train_rows, bwd_train_rows, train_cfg, val_lines = \
            train_phase(torch, device, smi, train_data)
        kernel_rows += fwd_train_rows
        bwd_rows += bwd_train_rows
        # 6b. the telemetry's cost on the card, the OOM wrap, pre-flight
        telemetry_row = telemetry_phase(torch, device, smi, train_cfg)

        # 7. hot reload, then the fleet over the same steps, 8. quarantine
        reload_row, reload_lines = reload_phase(torch, train_cfg, val_lines,
                                                device, smi)
        torch.cuda.empty_cache()  # the replicas' tables are their own
        fleet_row = fleet_phase(write_train_cfg(train_data[0], TRAIN_EPOCHS),
                                val_lines, reload_lines, serve_row, smi)
        del reload_lines
        quarantine_row = quarantine_phase(train_cfg, smi)
        shutil.rmtree(os.path.dirname(train_cfg.model_file))  # disk for 9
        # 15 starts here: the dist runs go on beside phases 9-11
        dist = dist_start(train_data)

        # 9. train with dedup = host
        host_row, fwd_host_rows, bwd_host_rows = host_dedup_phase(
            torch, device, smi, train_data[0], train_row)
        kernel_rows += fwd_host_rows
        bwd_rows += bwd_host_rows

        # 10. train on the packed wire; bytes and H2D per batch
        packed_train_row = packed_train_phase(torch, device, smi,
                                              train_data[0], train_row)
        # 11. FFM and order 3
        ffm_data_s = write_ffm_data(train_data[0])
        ffm_row = model_leg(torch, device, smi, train_data[0], "ffm",
                            train_row)
        ffm_row["generate_seconds"] = ffm_data_s
        order3_row = model_leg(torch, device, smi, train_data[0], "order3",
                               train_row)
        # 15. dist_train: two ranks on the card, the table row-sharded
        dist_row, fwd_dist_rows, bwd_dist_rows = dist_finish(
            dist, torch, device, smi, train_row)
        kernel_rows += fwd_dist_rows
        bwd_rows += bwd_dist_rows
        # 15b. the elastic leg (kill, shrink, --join, grow) goes on beside
        # phase 12; disk for it: the dist runs' models
        for name in os.listdir(dist["wd"]):
            if name.startswith("model"):
                shutil.rmtree(os.path.join(dist["wd"], name))
        elastic = elastic_start(dist["wd"])
        # 12. the stream run mode, its watermark and the gated publish
        for name in os.listdir(train_data[0]):  # disk for the phase
            if name.startswith("model"):
                shutil.rmtree(os.path.join(train_data[0], name))
        stream_row = stream_phase(torch, device, smi, train_data, train_row)
        elastic_row, fwd_elastic_rows, bwd_elastic_rows = elastic_finish(
            elastic, torch, device, smi, train_row)
        kernel_rows += fwd_elastic_rows
        bwd_rows += bwd_elastic_rows
        shutil.rmtree(elastic["wd"])  # disk for phase 13
        shutil.rmtree(os.path.join(WORK, "stream_phase"))
        # 15c. the multi-process stream (kill, shrink, --join at a publish
        # settle, grow) goes on beside phases 13-14
        dstream = dstream_start(train_data, train_row)
        # 13. lookup = host: its two train commands go on beside phase 14
        offload = offload_start(train_data)
        # 14. vocab_mode = admit: the slot map, its barriers and sidecar
        admit_row, fwd_admit_rows, bwd_admit_rows = admit_phase(
            torch, device, smi, train_data, train_row)
        kernel_rows += fwd_admit_rows
        bwd_rows += bwd_admit_rows
        # 13. lookup = host: the runs' checks, then the rest in process
        offload_row, offload_rows, fwd_offload_rows, bwd_offload_rows = \
            offload_phase(torch, device, smi, train_row, offload)
        kernel_rows += fwd_offload_rows
        bwd_rows += bwd_offload_rows
        dstream_row, fwd_dstream_rows, bwd_dstream_rows = dstream_finish(
            dstream, torch, device, smi, train_row)
        kernel_rows += fwd_dstream_rows
        bwd_rows += bwd_dstream_rows
    finally:
        dist_stop(dist)
        elastic_stop(elastic)
        dstream_stop(dstream)
        offload_stop(offload)
        config1_stop(config1)
        shutil.rmtree(WORK, ignore_errors=True)

    head = next(r for r in kernel_rows if r["batch"] == "uniform" and
                (r["B"], r["L"], r["K"]) == HEADLINE_SHAPE)
    # The backward's headline row is the train batch, need_dx off: the
    # input the train step gives it (the step never asks for dvals).
    bwd_head = next(r for r in bwd_train_rows if r["batch"] == "train"
                    and not r["need_dx"] and r["l2"] == "cold")
    kernels = {"kernels": [{
        "name": "fm_score", "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/fm_score.cu",
        "replaces": "fast_tffm_tpu/ops/pallas_fm.py:63",
        "launches": (predict_row["launches"] + serve_row["launches"]
                     + train_row["fm_score_launches"]
                     + train_row["predict_launches"]
                     + reload_row["launches"]
                     + fleet_row["launches"]
                     + host_row["fm_score_launches"]
                     + packed_serving_row["predict_packed-wide_launches"]
                     + packed_serving_row["predict_packed-narrow_launches"]
                     + packed_serving_row["serve_launches"]
                     + packed_train_row["fm_score_launches"]
                     + stream_row["fm_score_launches"]
                     + stream_row["serve_launches"]
                     + offload_row["fm_score_launches"]
                     + admit_row["fm_score_launches"]
                     + sum(dist_row["fm_score_launches"])
                     + sum(dist_row["predict_fm_score_launches"])
                     + sum(elastic_row["fm_score_launches"])
                     + sum(dstream_row["fm_score_launches"])
                     + config1_row["fm_score_launches"]
                     + config1_row["predict_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape_BLK": list(HEADLINE_SHAPE),
        "device_ms": head["device_ms"],
        "device_timing": head["device_timing"],
        "predict_launches": predict_row["launches"],
        "serve_launches": serve_row["launches"],
        "train_launches": train_row["fm_score_launches"],
        "train_predict_launches": train_row["predict_launches"],
        "reload_launches": reload_row["launches"],
        "fleet_launches": fleet_row["launches"],
        "train_host_launches": host_row["fm_score_launches"],
        "packed_predict_launches":
            packed_serving_row["predict_packed-wide_launches"]
            + packed_serving_row["predict_packed-narrow_launches"],
        "packed_serve_launches": packed_serving_row["serve_launches"],
        "train_packed_launches": packed_train_row["fm_score_launches"],
        "stream_train_launches": stream_row["fm_score_launches"],
        "stream_serve_launches": stream_row["serve_launches"],
        "offload_launches": offload_row["fm_score_launches"],
        "admit_launches": admit_row["fm_score_launches"],
        "dist_train_launches": dist_row["fm_score_launches"],
        "dist_predict_launches": dist_row["predict_fm_score_launches"],
        "dist_elastic_launches": elastic_row["fm_score_launches"],
        "dist_stream_launches": dstream_row["fm_score_launches"],
        "config1_train_launches": config1_row["fm_score_launches"],
        "config1_predict_launches": config1_row["predict_launches"]}, {
        "name": "fm_score_bwd", "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/fm_score_bwd.cu",
        "replaces": "fast_tffm_tpu/ops/pallas_fm.py:75",
        "launches": (train_row["fm_score_bwd_launches"]
                     + host_row["fm_score_bwd_launches"]
                     + packed_train_row["fm_score_bwd_launches"]
                     + stream_row["fm_score_bwd_launches"]
                     + offload_row["fm_score_bwd_launches"]
                     + admit_row["fm_score_bwd_launches"]
                     + sum(dist_row["fm_score_bwd_launches"])
                     + sum(elastic_row["fm_score_bwd_launches"])
                     + sum(dstream_row["fm_score_bwd_launches"])
                     + config1_row["fm_score_bwd_launches"]),
        "train_launches": train_row["fm_score_bwd_launches"],
        "train_host_launches": host_row["fm_score_bwd_launches"],
        "train_packed_launches": packed_train_row["fm_score_bwd_launches"],
        "stream_train_launches": stream_row["fm_score_bwd_launches"],
        "offload_launches": offload_row["fm_score_bwd_launches"],
        "admit_launches": admit_row["fm_score_bwd_launches"],
        "dist_train_launches": dist_row["fm_score_bwd_launches"],
        "dist_elastic_launches": elastic_row["fm_score_bwd_launches"],
        "dist_stream_launches": dstream_row["fm_score_bwd_launches"],
        "config1_train_launches": config1_row["fm_score_bwd_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": bwd_head["ms"], "plain_ms": bwd_head["plain_ms"],
        "bound_ms": bwd_head["bound_ms"], "bound_by": bwd_head["bound_by"],
        "library_ms": None,
        "shape_BLK": [bwd_head["B"], bwd_head["L"], bwd_head["K"]],
        "device_ms": bwd_head["device_ms"],
        "device_timing": bwd_head["device_timing"], "need_dx": False,
        "batch": "train"}] + [{
        "name": r["name"], "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/offload_rows.cu",
        "replaces": ("fast_tffm_tpu/lookup.py:421"
                     if r["name"] == "offload_gather"
                     else "fast_tffm_tpu/lookup.py:428"),
        "launches": offload_row[r["name"] + "_launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_timing": r["device_timing"], "event_ms": r["event_ms"],
        "plain_on": r["plain_on"], "U": r["U"], "D": r["D"],
        "host_link_bytes": r["host_link_bytes"],
        "host_to_card_bytes": r["host_to_card_bytes"],
        "card_to_host_bytes": r["card_to_host_bytes"],
        "hbm_bytes": r["hbm_bytes"],
        "host_to_card_GBps": r["host_to_card_GBps"],
        "card_to_host_GBps": r["card_to_host_GBps"]}
        for r in offload_rows]}
    # The host's speed: the script's seconds beside run A's command's.
    script_s = time.perf_counter() - t_script
    print(f"script seconds {script_s:.1f}; run A's train command "
          f"{train_row['entry_seconds']:.2f}s; telemetry checks: run A's "
          f"stream {train_row['telemetry']['check_seconds']:.2f}s, the "
          f"in-process phase {telemetry_row['seconds']:.2f}s; config1 leg "
          f"{config1_row['leg_seconds']:.2f}s; {smi}", flush=True)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "pipeline": pipeline_row,
                       "kernel": kernel_rows,
                       "kernel_bwd": bwd_rows, "predict": predict_row,
                       "serve": serve_row, "train": train_row,
                       "telemetry": telemetry_row,
                       "script_seconds": script_s,
                       "reload": reload_row, "fleet": fleet_row,
                       "quarantine": quarantine_row,
                       "train_host": host_row,
                       "packed_serving": packed_serving_row,
                       "train_packed": packed_train_row,
                       "train_ffm": ffm_row, "train_order3": order3_row,
                       "stream": stream_row, "offload": offload_row,
                       "admit": admit_row, "dist": dist_row,
                       "dist_elastic": elastic_row,
                       "dist_stream": dstream_row,
                       "config1": config1_row,
                       "kernel_offload": offload_rows, **kernels}, fh,
                      indent=1)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
