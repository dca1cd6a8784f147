"""INI config surface compatible with the reference's ``sample.cfg``.

The PyTorch port's own copy of ``fast_tffm_tpu/config.py``: the same
``FmConfig`` fields, defaults and validation errors, and the same INI
loader (unknown keys raise ``KeyError: unknown config key``, with a
"(this key belongs in [X])" hint for a known key in the wrong section),
so one config file loads in both packages. Comments below describe each
knob as the JAX package implements it; the port serves a subset and
refuses the rest (``train.check_train_supported`` and ``__main__.py``;
keys it accepts without effect are logged: ``utils/ignored.py``).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Tuple


def _split_ints(raw: str) -> Tuple[int, ...]:
    """Comma/whitespace-separated int list (bucket_ladder)."""
    return tuple(int(x) for x in raw.replace(",", " ").split())


def _split_files(raw: str) -> Tuple[str, ...]:
    """Comma/whitespace-separated file list (globs allowed) -> tuple."""
    out = []
    for part in raw.replace(",", " ").split():
        if part:
            out.append(part)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FmConfig:
    # --- [General] ---------------------------------------------------------
    vocabulary_size: int = 1 << 20
    # Reference: table is split into `vocabulary_block_num` blocks round-
    # robined across parameter servers (SURVEY §2 "Model parameters"). Here
    # the analogue is the number of row shards of the mesh table; kept for
    # config compatibility, the mesh decides actual sharding.
    vocabulary_block_num: int = 1
    hash_feature_id: bool = False
    factor_num: int = 8
    model_file: str = "./model/fm_model"
    log_file: str = ""
    # Extensions beyond upstream (BASELINE.json configs #3/#4):
    model_type: str = "fm"          # "fm" | "ffm"
    order: int = 2                  # >= 2; order>2 uses the ANOVA kernel
    field_num: int = 0              # > 0 required for model_type == "ffm"
    # Embedding-lookup backend (BASELINE config #5; lookup.py):
    # "device" keeps table+accumulator as (mesh-shardable) jax arrays with
    # gather/update fused into the train-step jit; "host" stores them in
    # host RAM (tables too big for device memory) and ships only the
    # batch's [U, D] gathered rows / row gradients across the boundary.
    lookup: str = "device"          # "device" | "host"

    # --- [Train] -----------------------------------------------------------
    train_files: Tuple[str, ...] = ()
    weight_files: Tuple[str, ...] = ()
    validation_files: Tuple[str, ...] = ()
    # Weight sidecars for validation_files (parallel lists, same format
    # as weight_files). Without this a weighted job trains weighted but
    # validates unweighted — loss and AUC would disagree about what an
    # example is worth. Extension knob (the reference has no AUC at all).
    validation_weight_files: Tuple[str, ...] = ()
    epoch_num: int = 1
    batch_size: int = 1024
    learning_rate: float = 0.01
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0
    init_value_range: float = 0.01
    loss_type: str = "logistic"     # "logistic" | "mse"
    queue_size: int = 10000
    # Reference knob (reader/shuffle thread count). Parsing here is one
    # GIL-releasing C++ pass, so the honest analogue is input-pipeline
    # LOOKAHEAD: this many batches are prepared ahead of the device
    # (prefetch_depth clamps it to [2, 8]).
    shuffle_threads: int = 1
    # Parallel host data plane (README "Data plane"): batch-build
    # workers fanning the parse->hash->dedup->pack stage across host
    # cores behind a bounded ORDERED ring — the emitted batch stream is
    # bit-identical to host_threads = 1 for the same config/seed, so
    # this is a pure throughput knob. 0 = auto (min(4, host cores));
    # 1 = the serial pipeline (pre-parallel behavior). Resolved by
    # data/pipeline.resolve_host_threads; distinct from the C++
    # parser's internal feed parse threads (bench reports both).
    host_threads: int = 0
    shuffle: bool = True
    seed: int = 0
    adagrad_init: float = 0.1       # TF Adagrad accumulator init default
    save_steps: int = 0             # 0 = save only at end
    log_steps: int = 100
    # Reference knob (SURVEY Appendix A [L]): summary-writer cadence.
    # > 0 writes TensorBoard scalars (train loss, examples/sec,
    # validation AUC) every this many steps to <model_file>.tb/
    # (utils/summaries.py; buffered and flushed at epoch barriers —
    # no mid-stream device fetches up to the 1024-entry safety cap,
    # one bulk fetch per cap hit beyond it). 0 = off.
    save_summaries_steps: int = 0
    # Cap per-epoch validation at this many batches PER INPUT SHARD
    # (process) — 0 = full sweep. At Criteo-1TB scale an every-epoch
    # full validation pass costs a complete extra data sweep. The unit
    # is per-shard in every topology (a P-process job samples up to
    # P x this many batches, one cap per worker's shard).
    validation_max_batches: int = 0
    # Static-shape bucketing (TPU-specific; SURVEY §7 hard part #1):
    max_features_per_example: int = 256   # hard cap on nnz/example (truncate)
    bucket_ladder: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    # Fixed unique-row count per batch in multi-process (fixed-shape)
    # training. 0 = auto: measured from the data at startup
    # (data/pipeline.probe_uniq_bucket). Overfull batches spill safely.
    uniq_bucket: int = 0
    # "auto" = the measured regime matrix (ops/kernel_choice.py,
    # BASELINE.md "Kernel-choice matrix"): the fused Pallas kernel
    # exactly where it measured faster (2nd-order FM on TPU, device
    # dedup, bucket width >= 64), XLA everywhere else — resolved per
    # bucket at trace time. Explicit values always win; re-measure on
    # new hardware with tools/kernel_probe.py.
    kernel: str = "auto"            # "auto" | "xla" | "pallas"
    # Where the per-batch unique-id pass runs. "host": the pipeline
    # dedups and ships (uniq_ids, local_idx) — required by mesh,
    # multi-process, and offload paths. "device": the pipeline ships raw
    # ids and the jitted step runs jnp.unique on the chip — ~40% less
    # host->device traffic per step for ~3 us of TPU sort (single-device
    # jit only). "auto" picks device where it applies. Resolved in
    # ModelSpec.from_config.
    dedup: str = "auto"             # "auto" | "host" | "device"
    # Wire format (README "Wire format"; fast_tffm_tpu/wire.py): how a
    # built batch crosses the host->device boundary. "padded" (default)
    # ships the fixed-shape [B, L] rectangles exactly as today —
    # bit-identical to every prior release. "packed" ships the CSR
    # substance instead — flat values + per-example lengths (+ the
    # dedup'd uniq table) bucketed to a power-of-two flat ladder — and
    # the jitted step/score programs rebuild the padded rectangles
    # on-device (models/fm.unpack seam), cutting per-step H2D bytes by
    # the batch's padding-waste fraction. Single-device jit paths only
    # (mesh / multi-process lockstep / offload TRAIN assemble padded
    # global arrays and resolve back to padded with a warning —
    # wire.resolve_wire is the one resolution point).
    wire_format: str = "padded"     # "padded" | "packed"
    # Wire dtypes (requires wire_format = packed): "wide" keeps f32
    # values/weights on the wire — bit-identical math. "narrow" ships
    # values and weights as float16 (ids are int32 end-to-end already)
    # and upcasts to f32 on device before any model math — about half
    # the value bytes for one rounding step on the inputs (training
    # tolerances, not bit-parity; labels stay f32).
    wire_dtypes: str = "wide"       # "wide" | "narrow"
    # Profiling (SURVEY §5 "Tracing": reference has none; we dump a
    # TensorBoard/Perfetto trace of a steady-state step window on demand):
    profile_dir: str = ""           # empty = profiling off
    profile_start_step: int = 5     # skip compile/warmup steps
    profile_num_steps: int = 10
    # Run telemetry (obs/; README "Observability"). Off by default.
    # metrics_file: JSONL event stream path; "auto" means
    # <model_file>.metrics.jsonl; multi-process runs write
    # <metrics_file>.p<i> per non-chief worker (merged at read time by
    # tools/fmstat). metrics_flush_steps: host-event flush cadence in
    # steps (device scalars still wait for epoch barriers — a flush
    # adds file I/O only, never a device fetch); 0 = epoch-only.
    metrics_file: str = ""
    metrics_flush_steps: int = 100
    # Span timeline tracing (obs/trace.py; needs metrics_file). Off by
    # default: spans are host-only events at per-batch/per-step cadence
    # — cheap, but a months-long run doesn't want them unrequested.
    # Export the stream with tools/fmtrace for ui.perfetto.dev.
    trace_spans: bool = False
    # Collective-protocol tracing (parallel/liveness.py; needs
    # metrics_file). Every guarded collective emits a `collective`
    # event (sequence number + label); `fmtrace --collectives` diffs
    # the per-rank streams — the runtime oracle for fmlint R014. Env
    # fallback: FM_PROTOCOL_TRACE=1.
    protocol_trace: bool = False
    # Step-anatomy join keys (obs/anatomy.py; README "Step anatomy").
    # On (default), the lockstep/step producers stamp window/step ids
    # and host-side phase counters into the telemetry stream — near-zero
    # cost (ids ride spans that trace_spans already gates; the phase
    # counters are host perf_counter pairs, no device fetch) — and the
    # chief emits pre-aggregated anatomy/* gauges at barrier flushes so
    # `fmstat` can render the EFFICIENCY section from the JSONL alone.
    # `fmtrace --anatomy` needs a trace_spans = true run for the full
    # clock-aligned critical-path report. Off: no ids, no anatomy/*.
    anatomy: bool = True
    # Run-health watchdog (obs/health.py; needs metrics_file). > 0:
    # a daemon thread emits a `health: stalled` event and dumps
    # all-thread stacks to <metrics_file>.stacks when no train/predict
    # step lands for this many seconds. 0 (default) = off.
    watchdog_stall_seconds: float = 0.0
    # HBM pressure threshold (obs/memory.py; README "Memory
    # observability"; needs metrics_file). > 0: a metrics flush whose
    # ledger live bytes cross this fraction of the device capacity
    # emits one `health: hbm_pressure` event per episode (re-armed
    # when live drops back below) — the early-warning signal before a
    # RESOURCE_EXHAUSTED. Inert when the backend reports no capacity
    # (CPU container). 0 (default) = off.
    mem_pressure_fraction: float = 0.0
    # Data-plane fault tolerance (README "Fault tolerance").
    # What a malformed input line does to the run (data/badlines.py):
    # "error" (default) aborts on the first bad line — the historical
    # behavior; "skip" drops the line, counts it (pipeline/bad_lines)
    # and emits rate-limited `health: bad_input` events; "quarantine"
    # additionally appends the raw line + file/lineno to
    # <metrics_file>.quarantine (<model_file>.quarantine when metrics
    # are off).
    bad_line_policy: str = "error"  # "error" | "skip" | "quarantine"
    # Circuit breaker for skip/quarantine: once bad lines exceed this
    # fraction of scanned lines (and a small absolute floor, so one
    # early bad line can't trip a tiny sample), the run aborts naming
    # the worst file — silent corpus rot must not train a garbage
    # model.
    max_bad_fraction: float = 0.01
    # Transient-IO retry (utils/retry.py): extra attempts after the
    # first for retryable errors (OSError/TimeoutError minus the
    # definitely-fatal missing-path family) on pipeline file
    # opens/reads, weight-sidecar reads, and checkpoint save/restore.
    # Backoff is io_backoff_seconds * 2^k with seeded jitter; retries
    # count io/retries in the metrics stream. 0 = fail fast.
    io_retries: int = 2
    io_backoff_seconds: float = 0.1
    # Checkpoint integrity verification before restore (checkpoint.py;
    # README "Checkpoint integrity & fallback"): "size" (default)
    # checks per-file byte counts against the save-time
    # manifest-<step>.json (catches torn/truncated writes for one stat
    # per file), "full" additionally re-hashes every byte (crc32;
    # catches silent bit rot at the cost of reading the whole
    # checkpoint once), "off" skips verification. A step that fails —
    # or raises during restore — is quarantined (renamed
    # corrupt-<step>, never deleted) and restore falls back to the
    # newest older intact step. Inspect with: python -m tools.fmckpt
    ckpt_verify: str = "size"       # "off" | "size" | "full"
    # Streaming / online learning (README "Streaming / online
    # learning"; data/stream.py + train.py). run_mode = epochs keeps
    # the historical fixed-schedule behavior; run_mode = stream follows
    # ``stream_dir`` (a directory, or a glob pattern) for arriving
    # libsvm shards and trains ONE continuous arrival-ordered pass
    # that survives indefinitely: new files are picked up every
    # ``stream_poll_seconds``, growing files are tailed with the torn
    # trailing line held back until more bytes arrive or the file is
    # sealed, and the durable stream position (per-file byte/line
    # watermark) rides every checkpoint so a restart resumes with no
    # example duplicated or skipped. ``epoch_num``/``shuffle`` have no
    # effect in stream mode (an online pass is arrival-ordered by
    # design); a ``STOP`` marker file in the stream directory ends the
    # run once every sealed byte is consumed.
    run_mode: str = "epochs"        # "epochs" | "stream"
    stream_dir: str = ""            # directory or glob of arriving shards
    stream_poll_seconds: float = 2.0
    # When an arriving file counts as SEALED (complete, safe to consume
    # through EOF): "done" requires a ``<file>.done`` marker; "quiet"
    # seals after the file's mtime has been quiet for
    # 3 x stream_poll_seconds; "auto" (default) accepts either signal.
    seal_policy: str = "auto"       # "auto" | "done" | "quiet"
    # Stream-mode checkpoint publishing: every this many seconds, save,
    # settle the integrity manifest, verify the step, and atomically
    # repoint the ``published`` pointer file in <model_file>.ckpt/ that
    # a serving process can watch (fmckpt ls shows it). 0 = no
    # publishing (periodic save_steps saves still apply).
    publish_interval_seconds: float = 0.0
    # Per-publish quality gate (README "SLOs & quality gate";
    # obs/quality.py). With ``validation_files`` set on a stream run,
    # every publish settle runs a validation sweep (AUC + loss +
    # calibration ride the same score fetches — zero extra device
    # traffic) and these thresholds decide whether the ``published``
    # pointer may move: a regressed model NEVER reaches serving — the
    # pointer stays on the last passing step, a ``health: gate_held``
    # event fires, and fmstat's verdict reads GATE-HELD.
    # publish_min_auc: absolute floor — hold the publish when the
    # sweep's AUC is below this (also the only check on the very first
    # publish, when no prior published AUC exists). 0 = off.
    publish_min_auc: float = 0.0
    # publish_max_auc_drop: relative guard — hold when AUC fell more
    # than this below the AUC of the last SUCCESSFUL publish. 0 = off.
    publish_max_auc_drop: float = 0.0
    # Whether the per-publish validation sweep runs at all. "auto"
    # (default) enables it exactly when the run declared a quality
    # objective — a gate knob above, or slo_min_auc — so a pre-existing
    # stream config with validation_files pays NO new per-publish cost
    # until it opts into quality observability; "on" forces the sweep
    # (gauges without a gate); "off" disables it (rejected when a gate
    # is configured — the gate's decision IS the sweep).
    publish_quality_eval: str = "auto"  # "auto" | "on" | "off"

    # --- [SLO] -------------------------------------------------------------
    # Declarative service-level objectives (README "SLOs & quality
    # gate"; obs/slo.py). Each knob declares one objective over the
    # metrics stream; 0 (the default) leaves that objective unset. The
    # configured spec is stamped into the run's metrics as ``slo/*``
    # gauges, so ``python -m tools.fmstat slo <metrics.jsonl>`` renders
    # the per-objective PASS/FAIL table from the JSONL alone — the one
    # operator answer to "is this deployment healthy".
    # Freshness: the last published checkpoint must be at most this
    # many seconds old at the final metrics flush.
    slo_publish_staleness_seconds: float = 0.0
    # Latency: the serving request-latency p99 must be at most this.
    slo_p99_ms: float = 0.0
    # Quality: the latest quality/validation AUC must be at least this.
    slo_min_auc: float = 0.0
    # Input health: bad lines / scanned lines must be at most this.
    slo_max_bad_fraction: float = 0.0

    # --- [Vocab] -----------------------------------------------------------
    # Unbounded-vocabulary admission (README "Unbounded vocabulary";
    # fast_tffm_tpu/vocab/). "fixed" (default) is the historical
    # behavior — feature ids mod straight into the vocabulary_size
    # table, bit-identical to every prior release. "admit" hashes ids
    # into a large fixed space (2^30) and admits only ids whose
    # sketched frequency crossed vocab_admit_threshold into private
    # table rows; everything else shares one cold row (row 0), so the
    # device table stays exactly vocabulary_size rows and batch shapes
    # never move however many distinct ids the stream carries.
    # Single-process only (the slot map is host state).
    vocab_mode: str = "fixed"       # "fixed" | "admit"
    # Sketched-frequency floor for admission AND eviction: an id is
    # admitted once its count-min estimate reaches this (unit: batches
    # the id appeared in), and a live row is evicted at a barrier once
    # its decayed estimate falls below it.
    vocab_admit_threshold: float = 2.0
    # Per-barrier decay factor on every sketch counter (epoch
    # boundary / publish settle): recency-weights the frequency so a
    # formerly-hot id ages out instead of squatting its row forever.
    # 1.0 = no decay (admission is then pure lifetime frequency).
    vocab_decay: float = 0.5
    # Count-min sketch budget in MB of float32 counters (4 hash rows).
    # Bigger = fewer collisions = less over-admission; ~1 MB covers a
    # ~10^5-id working set comfortably.
    vocab_sketch_mb: float = 1.0

    # --- [Predict] ---------------------------------------------------------
    predict_files: Tuple[str, ...] = ()
    score_path: str = "./score"

    # --- [Serve] -----------------------------------------------------------
    # Online serving (README "Serving"; fast_tffm_tpu/serve/): a
    # long-lived scorer process that loads the ``published`` checkpoint
    # step, micro-batches concurrent requests under a latency budget,
    # and hot-reloads when the pointer moves. ``run_tffm.py serve``.
    # Bind address for the stdlib HTTP front end. The default is
    # loopback-only (safe out of the box); a real deployment — one
    # server per host behind a load balancer — sets 0.0.0.0 (or the
    # host's LB-facing interface) so off-host health checks and
    # traffic can reach it.
    serve_host: str = "127.0.0.1"
    # TCP port for the stdlib HTTP front end (POST /score, GET
    # /healthz). 0 = pick an ephemeral port (logged at startup).
    serve_port: int = 7070
    # Admission-queue flush cap: a micro-batch flushes as soon as this
    # many examples are queued (or the wait budget expires). Also sizes
    # the pre-compiled batch-width ladder (powers of two up to this),
    # and bounds a single request's example count.
    serve_max_batch: int = 256
    # How long the first request in an admission window waits for
    # company before the micro-batch flushes anyway — the knob that
    # trades p50 latency for batching efficiency. 0 = flush immediately
    # (every request scores alone).
    serve_max_wait_ms: float = 5.0
    # Hot-reload poll cadence: how often the server re-reads the
    # ``published`` pointer file looking for a newly published step.
    serve_poll_seconds: float = 2.0
    # Seeded per-replica jitter on the reload poll, as a fraction of
    # serve_poll_seconds: each tick waits poll * (1 ± U(0, jitter)),
    # seeded by the replica's port, so N replicas never stat the
    # shared pointer file in lockstep (thundering herd on a network
    # filesystem). 0 = fixed cadence.
    serve_poll_jitter: float = 0.2
    # --- serving fleet (README "Serving fleet"; serve/fleet.py) ------
    # Replica count for ``run_tffm.py serve --replicas N`` (the CLI
    # flag overrides this knob). Replica i binds serve_port + i, the
    # failover proxy binds serve_proxy_port. 1 = the single-process
    # scorer, no supervisor or proxy.
    serve_replicas: int = 1
    # TCP port for the fleet's reverse proxy (the client-facing front
    # door: POST /score with retry/failover, GET /healthz aggregated
    # over the fleet). 0 = ephemeral (logged at startup).
    serve_proxy_port: int = 7080
    # How many times the proxy re-sends an idempotent POST /score to a
    # DIFFERENT ready replica after a connection-refused / timeout /
    # 5xx, before the client sees a 503. 0 = no retries.
    serve_retry_budget: int = 1
    # Session-affinity header: requests carrying this header hash
    # (rendezvous) onto one replica, so a user's burst coalesces into
    # one micro-batch flush instead of spraying the fleet. Empty
    # string disables affinity routing.
    serve_affinity_header: str = "X-FM-Affinity"
    # Fraction of proxy traffic directed at the canary replica (the
    # last replica, serving the ``published-canary`` pointer) when a
    # canary step is published. 0 = no canary traffic split.
    serve_canary_fraction: float = 0.0
    # Shadow mode: duplicate sampled traffic to the canary replica in
    # the background, score and COMPARE (proxy/canary_score_delta
    # gauge) but never return canary scores to clients. Implies the
    # canary replica receives no primary traffic.
    serve_canary_shadow: bool = False
    # Supervisor restart backoff base: a dead replica restarts after
    # this many seconds, doubling per consecutive failure (capped at
    # 16x), reset once the replica reports healthy again.
    serve_restart_backoff_seconds: float = 1.0
    # Who drives hot reloads: "poll" (default) — the in-process
    # watcher reloads when the pointer moves; "external" — the
    # watcher only records the pointer (gauges stay fresh) and an
    # external coordinator (the fleet supervisor's staggered-reload
    # protocol) triggers reloads via POST /reload.
    serve_reload_mode: str = "poll"
    # Which pointer file this scorer follows: "published" (default)
    # or "canary" (the ``published-canary`` pointer, falling back to
    # ``published`` until a canary step exists). The fleet supervisor
    # sets "canary" on the canary replica.
    serve_pointer: str = "published"
    # Bound on concurrently in-flight proxied /score requests: beyond
    # it the proxy sheds with 503 + Retry-After instead of wedging an
    # unbounded pile of connection threads.
    serve_proxy_max_inflight: int = 64
    # Supervisor health-poll cadence: how often each replica's
    # /healthz is read for the alive/ready split (restart decisions
    # ride "alive", proxy routing rides "ready").
    serve_health_poll_seconds: float = 0.5

    # --- [Cluster] ---------------------------------------------------------
    # Reference: ps_hosts/worker_hosts for the TF1 PS runtime (SURVEY §3.2).
    # Here retained for CLI compatibility; mapped onto jax.distributed
    # coordinator/process env (parallel/distributed.py).
    ps_hosts: Tuple[str, ...] = ()
    worker_hosts: Tuple[str, ...] = ()
    # Cluster bring-up budget (parallel/distributed.py): total seconds
    # a worker keeps retrying to reach the jax.distributed coordinator
    # before raising (naming the coordinator address and this process).
    # Generous by default: the coordinator pod/task often boots LAST,
    # and a worker that gives up in seconds turns a routine staggered
    # start into a failed job — but a worker must never hang forever
    # on a coordinator that will never come up.
    cluster_connect_timeout_seconds: float = 300.0
    # Compute-plane fault tolerance (README "Elastic multi-host";
    # parallel/liveness.py). Deadline on every blocking host collective
    # (lockstep window allgathers, restore broadcasts, barrier syncs):
    # on expiry the liveness table is consulted, a `health: worker_lost`
    # diagnosis names the peers that stopped heartbeating, stacks are
    # dumped, and a WorkerLostError is raised instead of hanging
    # forever. 0 = no deadline (the historical hang-forever behavior).
    collective_timeout_seconds: float = 300.0
    # Heartbeat-lease renewal interval: each worker renews a lease file
    # in <model_file>.hb/ on a daemon thread (liveness = process alive,
    # not making progress); a peer is presumed lost once its lease is
    # ~4 intervals old. The lease's monitor thread is also what
    # enforces collective_timeout_seconds on a BLOCKED collective, and
    # its presence is what allows jax's own abort-all-survivors death
    # detection to be replaced. 0 disables the layer entirely: jax's
    # native detection stays on (survivors abort ~100s after a task
    # death instead of diagnosing and recovering), and the deadline
    # guard only converts collectives that RAISE. elastic = shrink
    # requires it.
    heartbeat_seconds: float = 5.0
    # What survivors do on WorkerLostError: "off" fails fast with the
    # named-worker diagnosis; "shrink" tears down the distributed
    # client, reforms the cluster from the surviving membership,
    # redistributes the lost worker's input shards, restores from the
    # last verified checkpoint, and continues. "grow" implies shrink
    # AND additionally heals the cluster back toward full capacity:
    # a replacement launched with `run_tffm.py train <cfg> --join`
    # publishes a join-request lease in <model_file>.hb/, and the
    # running cluster admits it at the next safe barrier (epoch
    # boundary in run_mode = epochs, publish settle in run_mode =
    # stream) through a generation-bumped reform — the newcomer comes
    # up through the full durable-state path (verified restore,
    # chief-broadcast watermark/vocab) and input shards re-balance
    # over the new membership.
    elastic: str = "off"            # "off" | "shrink" | "grow"
    # Elastic GROW rendezvous (elastic = grow): how long a grow reform
    # waits for every PLANNED joiner to announce + heartbeat before
    # committing membership without the missing ones — a joiner that
    # dies mid-rendezvous must never wedge the incumbents. Floored at
    # runtime by the lease staleness window so a dead joiner is
    # visibly dead before it is dropped.
    join_settle_seconds: float = 5.0
    # The joiner's (`--join`) total budget to be admitted by a running
    # cluster before giving up with an actionable error.
    # 0 = use cluster_connect_timeout_seconds.
    join_timeout_seconds: float = 0.0

    def __post_init__(self):
        if self.order < 2:
            raise ValueError(f"order must be >= 2, got {self.order}")
        if self.model_type not in ("fm", "ffm"):
            raise ValueError(f"unknown model_type {self.model_type!r}")
        if self.model_type == "ffm":
            if self.field_num <= 0:
                raise ValueError("model_type=ffm requires field_num > 0")
            if self.order != 2:
                raise ValueError("ffm supports order=2 only")
            # The field-bucketed scorer's biggest intermediate is
            # [B, F, F, k] (ops/interaction.py); warn before a config
            # quietly asks for a multi-GB tensor per step.
            ffm_bytes = (self.batch_size * self.field_num ** 2
                         * self.factor_num * 4)
            if ffm_bytes > 2 << 30:
                import warnings
                warnings.warn(
                    f"ffm intermediate [batch_size, field_num^2, "
                    f"factor_num] is {ffm_bytes / 2**30:.1f} GB per step "
                    f"(B={self.batch_size}, F={self.field_num}, "
                    f"k={self.factor_num}); reduce batch_size or "
                    "field_num to fit device memory")
        if self.loss_type not in ("logistic", "mse"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        if self.kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.dedup not in ("auto", "host", "device"):
            raise ValueError(f"unknown dedup {self.dedup!r}")
        if self.dedup == "device" and self.lookup == "host":
            raise ValueError(
                "dedup = device requires lookup = device: the host-offload "
                "backend gathers rows on the host and needs the host-side "
                "unique pass")
        if self.lookup not in ("device", "host"):
            raise ValueError(f"unknown lookup {self.lookup!r}")
        if self.wire_format not in ("padded", "packed"):
            raise ValueError(f"unknown wire_format {self.wire_format!r} "
                             "(want padded | packed)")
        if self.wire_dtypes not in ("wide", "narrow"):
            raise ValueError(f"unknown wire_dtypes {self.wire_dtypes!r} "
                             "(want wide | narrow)")
        if self.wire_dtypes == "narrow" and self.wire_format != "packed":
            raise ValueError(
                "wire_dtypes = narrow requires wire_format = packed: "
                "the padded rectangles are the bit-identical legacy "
                "layout — narrowing them silently would betray the "
                "wide-default parity contract")
        if self.factor_num <= 0:
            raise ValueError("factor_num must be positive")
        if self.vocabulary_size <= 0:
            raise ValueError("vocabulary_size must be positive")
        lad = self.bucket_ladder
        if not lad or any(b <= 0 for b in lad) or list(lad) != sorted(
                set(lad)):
            raise ValueError(
                f"bucket_ladder must be a strictly increasing tuple of "
                f"positive ints, got {lad}")
        ub = self.uniq_bucket
        if ub and (ub < 64 or ub & (ub - 1)):
            raise ValueError(
                f"uniq_bucket must be 0 (auto) or a power of two >= 64 "
                f"(mesh sharding divides the unique axis), got {ub}")
        if self.validation_weight_files and not self.validation_files:
            raise ValueError(
                "validation_weight_files given without validation_files")
        # Sidecar lists must pair 1:1 with their data lists. Globs
        # expand at iteration time, so an exact config-time length check
        # is only sound when no entry is a pattern — but that's the
        # common case, and catching it here beats dying at the first
        # validation sweep hours into a run.
        for files, sidecars, name in (
                (self.train_files, self.weight_files, "weight_files"),
                (self.validation_files, self.validation_weight_files,
                 "validation_weight_files")):
            literal = not any(
                c in f for f in files + sidecars for c in "*?[")
            if (sidecars and literal and files
                    and len(sidecars) != len(files)):
                raise ValueError(
                    f"{name} must pair 1:1 with its data files "
                    f"({len(sidecars)} sidecars vs {len(files)} files)")
        if self.validation_max_batches < 0:
            raise ValueError(
                f"validation_max_batches must be >= 0 (0 = full sweep), "
                f"got {self.validation_max_batches}")
        if self.metrics_flush_steps < 0:
            raise ValueError(
                f"metrics_flush_steps must be >= 0 (0 = flush at epoch "
                f"barriers only), got {self.metrics_flush_steps}")
        if self.watchdog_stall_seconds < 0:
            raise ValueError(
                f"watchdog_stall_seconds must be >= 0 (0 = watchdog "
                f"off), got {self.watchdog_stall_seconds}")
        if not 0.0 <= self.mem_pressure_fraction <= 1.0:
            raise ValueError(
                f"mem_pressure_fraction must be in [0, 1] (0 = off), "
                f"got {self.mem_pressure_fraction}")
        if self.bad_line_policy not in ("error", "skip", "quarantine"):
            raise ValueError(
                f"unknown bad_line_policy {self.bad_line_policy!r} "
                "(want error | skip | quarantine)")
        if not 0.0 <= self.max_bad_fraction <= 1.0:
            raise ValueError(
                f"max_bad_fraction must be in [0, 1], got "
                f"{self.max_bad_fraction}")
        if self.host_threads < 0:
            raise ValueError(
                f"host_threads must be >= 0 (0 = auto, 1 = serial), "
                f"got {self.host_threads}")
        if self.io_retries < 0:
            raise ValueError(
                f"io_retries must be >= 0 (0 = fail fast), got "
                f"{self.io_retries}")
        if self.io_backoff_seconds < 0:
            raise ValueError(
                f"io_backoff_seconds must be >= 0, got "
                f"{self.io_backoff_seconds}")
        if self.ckpt_verify not in ("off", "size", "full"):
            raise ValueError(
                f"unknown ckpt_verify {self.ckpt_verify!r} "
                "(want off | size | full)")
        if self.run_mode not in ("epochs", "stream"):
            raise ValueError(
                f"unknown run_mode {self.run_mode!r} "
                "(want epochs | stream)")
        if self.seal_policy not in ("auto", "done", "quiet"):
            raise ValueError(
                f"unknown seal_policy {self.seal_policy!r} "
                "(want auto | done | quiet)")
        if self.stream_poll_seconds <= 0:
            raise ValueError(
                f"stream_poll_seconds must be > 0, got "
                f"{self.stream_poll_seconds}")
        if self.publish_interval_seconds < 0:
            raise ValueError(
                f"publish_interval_seconds must be >= 0 (0 = no "
                f"publishing), got {self.publish_interval_seconds}")
        if self.run_mode == "stream":
            if not self.stream_dir:
                raise ValueError(
                    "run_mode = stream requires stream_dir (a "
                    "directory or glob of arriving libsvm shards)")
            if self.train_files:
                raise ValueError(
                    "train_files is set but run_mode = stream consumes "
                    "stream_dir; drop train_files (or run_mode) — a "
                    "silently untrained corpus is always a config "
                    "mistake")
            if self.weight_files:
                raise ValueError(
                    "run_mode = stream does not support weight_files: "
                    "weight sidecars pair lines to a FIXED corpus, "
                    "which an append-only stream is not")
        elif self.stream_dir:
            raise ValueError(
                "stream_dir is set but run_mode is 'epochs'; set "
                "run_mode = stream (or drop stream_dir) — a silently "
                "ignored stream directory is always a config mistake")
        for knob in ("publish_min_auc", "publish_max_auc_drop"):
            v = getattr(self, knob)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{knob} must be in [0, 1] (0 = gate check off), "
                    f"got {v}")
        if self.publish_min_auc or self.publish_max_auc_drop:
            # The gate evaluates a validation sweep at publish settles;
            # without a corpus to sweep (or publishes to gate) the
            # knobs would be silently inert — always a config mistake.
            if self.run_mode != "stream":
                raise ValueError(
                    "publish_min_auc/publish_max_auc_drop gate stream-"
                    "mode publishes; set run_mode = stream (epoch-mode "
                    "runs never publish, so the gate would silently "
                    "never run)")
            if not self.validation_files:
                raise ValueError(
                    "publish_min_auc/publish_max_auc_drop need "
                    "validation_files: the gate's decision IS a "
                    "validation sweep at each publish settle")
            if self.publish_interval_seconds <= 0:
                raise ValueError(
                    "publish_min_auc/publish_max_auc_drop need "
                    "publish_interval_seconds > 0: the gate rides "
                    "publish settles, and a never-publishing stream "
                    "has nothing to gate")
        if self.publish_quality_eval not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown publish_quality_eval "
                f"{self.publish_quality_eval!r} (want auto | on | off)")
        if (self.publish_quality_eval == "off"
                and (self.publish_min_auc or self.publish_max_auc_drop)):
            raise ValueError(
                "publish_quality_eval = off conflicts with the publish "
                "gate knobs: the gate's decision IS the per-publish "
                "validation sweep")
        if self.publish_quality_eval == "on":
            if self.run_mode != "stream" or not self.validation_files \
                    or self.publish_interval_seconds <= 0:
                raise ValueError(
                    "publish_quality_eval = on needs run_mode = "
                    "stream, validation_files, and "
                    "publish_interval_seconds > 0: the sweep runs at "
                    "publish settles over the validation corpus")
        if self.slo_publish_staleness_seconds < 0:
            raise ValueError(
                f"slo_publish_staleness_seconds must be >= 0 (0 = "
                f"objective unset), got "
                f"{self.slo_publish_staleness_seconds}")
        if self.slo_p99_ms < 0:
            raise ValueError(
                f"slo_p99_ms must be >= 0 (0 = objective unset), got "
                f"{self.slo_p99_ms}")
        if not 0.0 <= self.slo_min_auc <= 1.0:
            raise ValueError(
                f"slo_min_auc must be in [0, 1] (0 = objective unset), "
                f"got {self.slo_min_auc}")
        if not 0.0 <= self.slo_max_bad_fraction <= 1.0:
            raise ValueError(
                f"slo_max_bad_fraction must be in [0, 1] (0 = "
                f"objective unset), got {self.slo_max_bad_fraction}")
        if self.vocab_mode not in ("fixed", "admit"):
            raise ValueError(
                f"unknown vocab_mode {self.vocab_mode!r} "
                "(want fixed | admit)")
        if self.vocab_admit_threshold < 1:
            raise ValueError(
                f"vocab_admit_threshold must be >= 1 (a count floor), "
                f"got {self.vocab_admit_threshold}")
        if not 0.0 < self.vocab_decay <= 1.0:
            raise ValueError(
                f"vocab_decay must be in (0, 1] (1 = no decay), got "
                f"{self.vocab_decay}")
        if self.vocab_sketch_mb <= 0:
            raise ValueError(
                f"vocab_sketch_mb must be > 0, got "
                f"{self.vocab_sketch_mb}")
        if self.vocab_mode == "admit" and self.vocabulary_size < 2:
            raise ValueError(
                "vocab_mode = admit needs vocabulary_size >= 2: row 0 "
                "is the shared cold row, admitted ids get the rest")
        if (self.vocab_mode == "admit" and self.run_mode == "stream"
                and self.publish_interval_seconds <= 0):
            raise ValueError(
                "vocab_mode = admit with run_mode = stream needs "
                "publish_interval_seconds > 0: admission/eviction "
                "barriers ride publish settles, so a never-publishing "
                "stream would never admit a single id — the whole run "
                "would silently train through the shared cold row")
        if not self.serve_host:
            raise ValueError(
                "serve_host must be a bind address (127.0.0.1 for "
                "loopback-only, 0.0.0.0 for all interfaces)")
        if not 0 <= self.serve_port <= 65535:
            raise ValueError(
                f"serve_port must be in [0, 65535] (0 = ephemeral), "
                f"got {self.serve_port}")
        if self.serve_max_batch < 1:
            raise ValueError(
                f"serve_max_batch must be >= 1, got "
                f"{self.serve_max_batch}")
        if self.serve_max_wait_ms < 0:
            raise ValueError(
                f"serve_max_wait_ms must be >= 0 (0 = flush "
                f"immediately), got {self.serve_max_wait_ms}")
        if self.serve_poll_seconds <= 0:
            raise ValueError(
                f"serve_poll_seconds must be > 0, got "
                f"{self.serve_poll_seconds}")
        if not 0.0 <= self.serve_poll_jitter < 1.0:
            raise ValueError(
                f"serve_poll_jitter must be in [0, 1) (a fraction of "
                f"serve_poll_seconds), got {self.serve_poll_jitter}")
        if self.serve_replicas < 1:
            raise ValueError(
                f"serve_replicas must be >= 1, got "
                f"{self.serve_replicas}")
        if self.serve_replicas > 1 and self.serve_port == 0:
            raise ValueError(
                "serve_replicas > 1 needs an explicit serve_port: "
                "replica i binds serve_port + i, so an ephemeral base "
                "port cannot lay out the fleet")
        if not 0 <= self.serve_proxy_port <= 65535:
            raise ValueError(
                f"serve_proxy_port must be in [0, 65535] (0 = "
                f"ephemeral), got {self.serve_proxy_port}")
        if self.serve_retry_budget < 0:
            raise ValueError(
                f"serve_retry_budget must be >= 0 (0 = no retries), "
                f"got {self.serve_retry_budget}")
        if not 0.0 <= self.serve_canary_fraction <= 1.0:
            raise ValueError(
                f"serve_canary_fraction must be in [0, 1], got "
                f"{self.serve_canary_fraction}")
        if ((self.serve_canary_fraction > 0 or self.serve_canary_shadow)
                and self.serve_replicas < 2):
            raise ValueError(
                "canary scoring (serve_canary_fraction > 0 or "
                "serve_canary_shadow) needs serve_replicas >= 2: the "
                "canary is one replica of the fleet, and the rest must "
                "still carry primary traffic")
        if self.serve_restart_backoff_seconds <= 0:
            raise ValueError(
                f"serve_restart_backoff_seconds must be > 0, got "
                f"{self.serve_restart_backoff_seconds}")
        if self.serve_reload_mode not in ("poll", "external"):
            raise ValueError(
                f"unknown serve_reload_mode {self.serve_reload_mode!r} "
                "(want poll | external)")
        if self.serve_pointer not in ("published", "canary"):
            raise ValueError(
                f"unknown serve_pointer {self.serve_pointer!r} "
                "(want published | canary)")
        if self.serve_proxy_max_inflight < 1:
            raise ValueError(
                f"serve_proxy_max_inflight must be >= 1, got "
                f"{self.serve_proxy_max_inflight}")
        if self.serve_health_poll_seconds <= 0:
            raise ValueError(
                f"serve_health_poll_seconds must be > 0, got "
                f"{self.serve_health_poll_seconds}")
        if self.cluster_connect_timeout_seconds <= 0:
            raise ValueError(
                f"cluster_connect_timeout_seconds must be > 0, got "
                f"{self.cluster_connect_timeout_seconds}")
        if self.collective_timeout_seconds < 0:
            raise ValueError(
                f"collective_timeout_seconds must be >= 0 (0 = no "
                f"deadline), got {self.collective_timeout_seconds}")
        if self.heartbeat_seconds < 0:
            raise ValueError(
                f"heartbeat_seconds must be >= 0 (0 = liveness off), "
                f"got {self.heartbeat_seconds}")
        if self.elastic not in ("off", "shrink", "grow"):
            raise ValueError(
                f"unknown elastic {self.elastic!r} "
                "(want off | shrink | grow)")
        if self.elastic != "off" and not self.heartbeat_seconds:
            raise ValueError(
                f"elastic = {self.elastic} requires heartbeat_seconds "
                "> 0: membership (survivors AND joiners) is decided "
                "from the heartbeat leases in <model_file>.hb/")
        if self.join_settle_seconds <= 0:
            raise ValueError(
                f"join_settle_seconds must be > 0, got "
                f"{self.join_settle_seconds}")
        if self.join_timeout_seconds < 0:
            raise ValueError(
                f"join_timeout_seconds must be >= 0 (0 = the "
                f"cluster_connect budget), got "
                f"{self.join_timeout_seconds}")
        if (self.elastic == "grow" and self.run_mode == "stream"
                and self.publish_interval_seconds <= 0):
            raise ValueError(
                "elastic = grow with run_mode = stream requires "
                "publish_interval_seconds > 0: a streaming cluster "
                "admits joiners at publish settles (the stream's safe "
                "barriers) — a never-publishing stream would never "
                "admit a replacement worker")
        if self.weight_files and not self.train_files:
            # Mirror of the validation_weight_files check above: a
            # sidecar list with nothing to pair against is always a
            # config mistake, and catching it here beats a silent
            # no-op (or a late pipeline error) downstream.
            raise ValueError("weight_files given without train_files")
        if ub and self.max_features_per_example >= ub:
            raise ValueError(
                f"uniq_bucket ({ub}) must exceed max_features_per_example "
                f"({self.max_features_per_example}): one example alone "
                "may otherwise overflow the unique-row budget mid-run")

    @property
    def row_dim(self) -> int:
        """Per-row parameter count: k latent factors (× fields for FFM) + 1
        linear weight. Mirrors the reference's `[vocab, factor_num + 1]`
        table layout (SURVEY §2 "Model parameters")."""
        k = self.factor_num
        if self.model_type == "ffm":
            return k * self.field_num + 1
        return k + 1

    @property
    def prefetch_depth(self) -> int:
        """Input-pipeline lookahead in batches (data/pipeline.prefetch),
        mapped from the reference's ``shuffle_threads`` knob."""
        return max(2, min(self.shuffle_threads, 8))

    @property
    def pad_id(self) -> int:
        """Sentinel row index used for padding; one extra dead row is
        appended to the table so padded positions gather zeros and their
        gradients land harmlessly (and are masked out of the reg term)."""
        return self.vocabulary_size

    @property
    def num_rows(self) -> int:
        return self.vocabulary_size + 1

    @property
    def ckpt_rows(self) -> int:
        """Table rows as stored in checkpoints and on any mesh: num_rows
        rounded up to a multiple of 4096. The fixed multiple makes the
        stored shape divisible by every power-of-two device mesh (TPU
        slices are powers of two; make_mesh enforces it), so checkpoints
        restore row-sharded on ANY topology without ever assembling the
        table on one host — jax shardings require evenly divisible dims.
        The pad rows sit past pad_id: no feature id can reach them."""
        return -(-self.num_rows // 4096) * 4096


_GENERAL_KEYS = {
    "vocabulary_size": int,
    "vocabulary_block_num": int,
    "hash_feature_id": bool,
    "factor_num": int,
    "model_file": str,
    "log_file": str,
    "model_type": str,
    "order": int,
    "field_num": int,
    "lookup": str,
    "dedup": str,
}
_TRAIN_KEYS = {
    "train_files": _split_files,
    "weight_files": _split_files,
    "validation_files": _split_files,
    "validation_weight_files": _split_files,
    "epoch_num": int,
    "batch_size": int,
    "learning_rate": float,
    "factor_lambda": float,
    "bias_lambda": float,
    "init_value_range": float,
    "loss_type": str,
    "queue_size": int,
    "shuffle_threads": int,
    "host_threads": int,
    "shuffle": bool,
    "seed": int,
    "adagrad_init": float,
    "save_steps": int,
    "log_steps": int,
    "save_summaries_steps": int,
    "validation_max_batches": int,
    "max_features_per_example": int,
    "bucket_ladder": _split_ints,
    "uniq_bucket": int,
    "kernel": str,
    "dedup": str,  # accepted in [General] too (model-level knob)
    "wire_format": str,
    "wire_dtypes": str,
    "profile_dir": str,
    "profile_start_step": int,
    "profile_num_steps": int,
    "metrics_file": str,
    "metrics_flush_steps": int,
    "trace_spans": bool,
    "protocol_trace": bool,
    "anatomy": bool,
    "watchdog_stall_seconds": float,
    "mem_pressure_fraction": float,
    "bad_line_policy": str,
    "max_bad_fraction": float,
    "io_retries": int,
    "io_backoff_seconds": float,
    "ckpt_verify": str,
    "run_mode": str,
    "stream_dir": str,
    "stream_poll_seconds": float,
    "seal_policy": str,
    "publish_interval_seconds": float,
    "publish_min_auc": float,
    "publish_max_auc_drop": float,
    "publish_quality_eval": str,
}
_SLO_KEYS = {
    "slo_publish_staleness_seconds": float,
    "slo_p99_ms": float,
    "slo_min_auc": float,
    "slo_max_bad_fraction": float,
}
_VOCAB_KEYS = {
    "vocab_mode": str,
    "vocab_admit_threshold": float,
    "vocab_decay": float,
    "vocab_sketch_mb": float,
}
_PREDICT_KEYS = {
    "predict_files": _split_files,
    "score_path": str,
}
_SERVE_KEYS = {
    "serve_host": str,
    "serve_port": int,
    "serve_max_batch": int,
    "serve_max_wait_ms": float,
    "serve_poll_seconds": float,
    "serve_poll_jitter": float,
    "serve_replicas": int,
    "serve_proxy_port": int,
    "serve_retry_budget": int,
    "serve_affinity_header": str,
    "serve_canary_fraction": float,
    "serve_canary_shadow": bool,
    "serve_restart_backoff_seconds": float,
    "serve_reload_mode": str,
    "serve_pointer": str,
    "serve_proxy_max_inflight": int,
    "serve_health_poll_seconds": float,
}
_CLUSTER_KEYS = {
    "ps_hosts": _split_files,
    "worker_hosts": _split_files,
    "cluster_connect_timeout_seconds": float,
    "collective_timeout_seconds": float,
    "heartbeat_seconds": float,
    "elastic": str,
    "join_settle_seconds": float,
    "join_timeout_seconds": float,
}


def load_config(path: str) -> FmConfig:
    """Read a reference-style INI file into an FmConfig.

    Unknown keys raise, so typos in configs fail loudly (the reference's
    ConfigParser silently ignores them; failing loudly is strictly safer
    and costs no compatibility for valid configs).
    """
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(path)

    kwargs = {}
    # The one section->keys mapping: drives both the consume loop and
    # the wrong-section hint, so the two cannot diverge.
    sections = {"General": _GENERAL_KEYS, "Train": _TRAIN_KEYS,
                "SLO": _SLO_KEYS, "Vocab": _VOCAB_KEYS,
                "Predict": _PREDICT_KEYS, "Serve": _SERVE_KEYS,
                "Cluster": _CLUSTER_KEYS}

    def consume(section: str, keys):
        if not cp.has_section(section):
            return
        for name, raw in cp.items(section):
            if name not in keys:
                # A key that exists in ANOTHER section is the common
                # miss (e.g. the lookup/kernel/dedup extension knobs
                # live in [General]); name the right home in the error.
                home = next((s for s, k in sections.items()
                             if name in k), None)
                hint = (f" (this key belongs in [{home}])"
                        if home else "")
                raise KeyError(
                    f"unknown config key [{section}] {name}{hint}")
            conv = keys[name]
            if conv is bool:
                kwargs[name] = cp.getboolean(section, name)
            else:
                kwargs[name] = conv(raw)

    for section, keys in sections.items():
        consume(section, keys)
    cfg = FmConfig(**kwargs)
    # Reference knobs accepted for config compatibility but with no effect
    # here — tell the user instead of silently ignoring a tuned value.
    import warnings
    if cfg.vocabulary_block_num > 1:
        warnings.warn(
            f"vocabulary_block_num = {cfg.vocabulary_block_num} is accepted "
            "for compatibility but has no effect: the reference used it to "
            "partition the table across parameter servers; here the device "
            "mesh decides row sharding (parallel/sharded.py)")
    return cfg


def apply_env_overrides(cfg: FmConfig) -> FmConfig:
    """Per-process one-off overrides from ``FM_<KNOB>`` env vars —
    the convention run_tffm.py applies to every CLI run, and the
    fleet supervisor uses to steer each replica child (its own
    ``serve_port``, its metrics shard, external reload mode, the
    canary pointer) without writing N config files. Every variable
    name maps to a real knob (fmlint R009 pins this), and the values
    go through dataclasses.replace, so they get the same
    ``__post_init__`` validation a config file does."""
    updates = {}
    v = os.environ.get("FM_METRICS_FILE")
    if v:
        updates["metrics_file"] = v
    v = os.environ.get("FM_TRACE_SPANS", "")
    if v.strip().lower() in ("1", "true", "yes", "on"):
        updates["trace_spans"] = True
    v = os.environ.get("FM_WATCHDOG_STALL_SECONDS")
    if v:
        updates["watchdog_stall_seconds"] = float(v)
    v = os.environ.get("FM_SERVE_PORT")
    if v:
        updates["serve_port"] = int(v)
    v = os.environ.get("FM_SERVE_RELOAD_MODE")
    if v:
        updates["serve_reload_mode"] = v
    v = os.environ.get("FM_SERVE_POINTER")
    if v:
        updates["serve_pointer"] = v
    return dataclasses.replace(cfg, **updates) if updates else cfg
