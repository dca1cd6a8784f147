"""Attribution analysis over a metrics JSONL stream — a copy of
``fast_tffm_tpu/obs/attribution.py`` over the port's registry and sink,
held to the original by ``tests/test_torch_obs_readers.py`` (same
summaries, verdicts and rendered text on the same streams).

The bench learned this lesson first: a single throughput number that
moves is undiagnosable until it's broken into host-only / device-only /
transfer-only ceilings (bench.py's ``host_only``/``device_only``/
``h2d_only``). This module computes the same style of breakdown from a
run's (or bench's) JSONL event stream, so a production train/predict
run is diagnosable with the exact vocabulary the bench artifacts use:
a host-bound vs device/transfer-bound vs pause-bound verdict.

Pure functions over parsed events, shared by ``tools/fmstat.py`` (the
CLI) and the tests.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from fast_tffm_tpu_torch.obs.registry import Histogram, MetricsRegistry
from fast_tffm_tpu_torch.obs.sink import read_events

# Verdict thresholds over the train-loop time split. Above HOST_BOUND
# of loop wall spent waiting on the input pipeline, the host is the
# bottleneck (the bench's host_only ceiling binding); above PAUSE_BOUND
# in checkpoint/summary pauses, cadence knobs are. Otherwise the time
# is in dispatched device work + H2D, which host-side timing cannot
# split further — the verdict says so rather than guessing.
HOST_BOUND_FRACTION = 0.4
PAUSE_BOUND_FRACTION = 0.3


def _run_key(rec: Dict[str, Any]) -> tuple:
    run = rec.get("run") or {}
    return (run.get("pid"), run.get("process_index"),
            run.get("start_time"))


def summarize(paths: Sequence[str]) -> Dict[str, Any]:
    """Merge one or more metrics files (a run + its per-worker shards)
    into a single summary: final cumulative counters/hists folded
    across runs, gauges per process, scalars in arrival order."""
    last_metrics: Dict[tuple, Dict[str, Any]] = {}
    scalars: List[Dict[str, Any]] = []
    metas: List[Dict[str, Any]] = []
    health_events: List[Dict[str, Any]] = []
    crash_events: List[Dict[str, Any]] = []
    n_events = 0
    n_spans = 0
    run_starts = 0
    run_ends = 0
    for path in paths:
        # Health/crash state is scoped to each file's LATEST run: the
        # sink appends, so a fixed metrics path accumulates runs — an
        # old crash must not brand every later clean rerun CRASHED.
        # Each run_start resets the file-local view; the last segment
        # is what this file contributes.
        f_health: List[Dict[str, Any]] = []
        f_crash: List[Dict[str, Any]] = []
        f_started = 0
        f_ended = 0
        for rec in read_events(path):
            n_events += 1
            ev = rec.get("event")
            if ev == "metrics":
                # cumulative snapshots: the last one per run carries
                # everything before it
                last_metrics[_run_key(rec)] = rec
            elif ev == "scalar":
                scalars.append(rec)
            elif ev == "run_start":
                metas.append(rec.get("meta") or {})
                f_health, f_crash = [], []
                f_started, f_ended = 1, 0
            elif ev == "run_end":
                f_ended = 1
            elif ev == "health":
                f_health.append(rec)
            elif ev == "crash":
                f_crash.append(rec)
            elif ev == "span":
                n_spans += 1
        health_events.extend(f_health)
        crash_events.extend(f_crash)
        run_starts += f_started
        run_ends += f_ended

    merged = MetricsRegistry()
    gauges_by_proc: Dict[Any, Dict[str, float]] = {}
    for key, rec in last_metrics.items():
        for name, v in (rec.get("counters") or {}).items():
            merged.count(name, v)
        for name, s in (rec.get("hists") or {}).items():
            h = merged.histogram(name, bounds=s["bounds"])
            h.merge(Histogram.from_summary(s))
        proc = (rec.get("run") or {}).get("process_index", 0)
        for name, v in (rec.get("gauges") or {}).items():
            gauges_by_proc.setdefault(proc, {})[name] = v
    snap = merged.snapshot()
    # Flat gauge view: single-process reads naturally; multi-process
    # keeps the chief's values flat and everything per-process too.
    flat_gauges = dict(gauges_by_proc.get(0, {}))
    return {
        "meta": metas[0] if metas else {},
        "metas": metas,
        "runs": len(last_metrics),
        "events": n_events,
        "spans": n_spans,
        "run_starts": run_starts,
        "run_ends": run_ends,
        "health_events": health_events,
        "crash_events": crash_events,
        "counters": snap["counters"],
        "hists": snap["hists"],
        "gauges": flat_gauges,
        "gauges_by_process": gauges_by_proc,
        "scalars": scalars,
    }


def _frac(num: Optional[float], den: Optional[float]) -> Optional[float]:
    if not num or not den:
        return None
    return num / den


def wire_mode(gauges: Dict[str, Any]) -> Optional[str]:
    """The active wire format + dtype mode (README "Wire format") from
    the stream's ``wire/*`` gauges — ``"packed-narrow"`` etc. None on a
    pre-wire stream (no gauge): the mode is then unknown, not assumed
    padded, so old files never claim a mode they never stamped."""
    p = gauges.get("wire/packed")
    if p is None:
        return None
    fmt = "packed" if p else "padded"
    dt = "narrow" if gauges.get("wire/narrow") else "wide"
    return f"{fmt}-{dt}"


def attribution(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The host/device/transfer split + verdict for one summary.

    Two sources, same table: a bench stream carries explicit ceiling
    gauges (``bench/host_only`` etc. — measured in isolation); a
    train/predict stream carries the loop-time split (input wait,
    pauses, step time) and the H2D byte rate.
    """
    c = summary.get("counters", {})
    g = summary.get("gauges", {})
    h = summary.get("hists", {})

    step = h.get("train/step_seconds") or {}
    loop_s = step.get("sum") or 0.0
    steps = c.get("train/steps") or step.get("count") or 0
    examples = c.get("train/examples", 0)
    input_wait = c.get("train/input_wait_seconds", 0.0)
    pauses = (c.get("train/checkpoint_pause_seconds", 0.0)
              + c.get("train/summary_pause_seconds", 0.0)
              + c.get("train/validation_seconds", 0.0))
    h2d_bytes = c.get("train/h2d_bytes", 0.0)
    # The wire-format pair (README "Wire format"): actual bytes
    # dispatched vs the padded layout's logical size — the
    # packed-vs-padded savings ratio, observable per run. Old streams
    # (pre-wire) carry no logical counter; treat it as equal.
    h2d_logical = c.get("train/h2d_bytes_logical", h2d_bytes)

    out: Dict[str, Any] = {
        "examples": examples,
        "steps": steps,
        "loop_seconds": loop_s,
        "examples_per_sec": _frac(examples, loop_s + pauses),
        "loop_examples_per_sec": _frac(examples, loop_s),
        "step_p50_s": step.get("p50"),
        "step_p99_s": step.get("p99"),
        "input_wait_fraction": _frac(input_wait, loop_s),
        "pause_seconds": pauses,
        "pause_fraction": _frac(pauses, loop_s + pauses),
        "h2d_bytes_per_sec": _frac(h2d_bytes, loop_s),
        # Bytes-per-example on the wire: the lever the packed format
        # pulls (ROADMAP item 2) — actual dispatched bytes, the padded
        # layout's logical bytes, and their ratio (>= 2x at the
        # default config is the packed acceptance bar).
        "h2d_bytes_per_example": _frac(h2d_bytes, examples),
        "h2d_logical_bytes_per_example": _frac(h2d_logical, examples),
        "wire_savings_ratio": _frac(h2d_logical, h2d_bytes),
        "wire_format": wire_mode(g),
        # Parallel host data plane (README "Data plane"): configured
        # build workers, their summed build seconds over the
        # consumer-observed build+wait time (values near the worker
        # count = the fan-out is real; near 1 = the plane added no
        # overlap), and the ordered ring's last-seen occupancy (full =
        # consumer-bound, empty = builders can't keep up).
        "host_threads": g.get("pipeline/host_threads"),
        "host_build_concurrency": _frac(
            c.get("pipeline/worker_build_seconds"),
            c.get("pipeline/build_seconds")),
        "ring_occupancy": g.get("pipeline/ring_occupancy"),
        "dedup_hit_rate": dedup_hit_rate(c),
        "padding_waste_fraction": padding_waste(c),
        "parse_errors": c.get("pipeline/parse_errors", 0),
        # Fault-tolerance accounting (README "Fault tolerance"): lines
        # skipped under bad_line_policy, and transient-IO retries paid.
        "bad_lines": c.get("pipeline/bad_lines", 0),
        "io_retries": c.get("io/retries", 0),
        # State-plane accounting (README "Checkpoint integrity &
        # fallback"): saves committed, restores that fell back past a
        # bad step, and step dirs quarantined (corrupt-<step>).
        "checkpoint_saves": c.get("checkpoint/saves", 0),
        "checkpoint_fallbacks": c.get("checkpoint/fallbacks", 0),
        "checkpoint_quarantined": c.get("checkpoint/quarantined_steps",
                                        0),
        # Compute-plane accounting (README "Elastic multi-host"):
        # peers that stopped heartbeating, elastic shrink recoveries,
        # and cluster bring-ups that exhausted their retry budget.
        "workers_lost": c.get("cluster/workers_lost", 0),
        "elastic_recoveries": c.get("cluster/elastic_recoveries", 0),
        "bringup_failures": c.get("cluster/bringup_failures", 0),
        # Streaming run mode (README "Streaming / online learning"):
        # discovery/seal/damage counters plus the freshness gauges the
        # STALE PUBLISH health verdict reads.
        "stream_files_discovered": c.get("stream/files_discovered", 0),
        "stream_files_sealed": c.get("stream/files_sealed", 0),
        "stream_truncated_files": c.get("stream/truncated_files", 0),
        "stream_deleted_files": c.get("stream/deleted_files", 0),
        "stream_publishes": c.get("stream/publishes", 0),
        "stream_publish_failures": c.get("stream/publish_failures", 0),
        "stream_watermark_lag_seconds": g.get(
            "stream/watermark_lag_seconds"),
        "stream_last_publish_age_seconds": g.get(
            "stream/last_publish_age_seconds"),
        "stream_publish_interval_seconds": g.get(
            "stream/publish_interval_seconds"),
        # Vocabulary admission (README "Unbounded vocabulary";
        # vocab_mode = admit): cumulative distinct-id observations and
        # how many of them hit the shared cold row, plus barrier
        # admission/eviction totals and the live-row/sketch gauges the
        # COLD-ROW SATURATION verdict reads.
        "vocab_ids": c.get("vocab/ids", 0),
        "vocab_cold_ids": c.get("vocab/cold_ids", 0),
        "vocab_cold_hit_rate": _frac(c.get("vocab/cold_ids"),
                                     c.get("vocab/ids")),
        "vocab_admitted": c.get("vocab/admitted_rows", 0),
        "vocab_evicted": c.get("vocab/evicted_rows", 0),
        "vocab_candidates_dropped": c.get("vocab/candidates_dropped",
                                          0),
        "vocab_live_rows": g.get("vocab/live_rows"),
        "vocab_sketch_fill": g.get("vocab/sketch_fill"),
        # Per-publish quality loop + gate (README "SLOs & quality
        # gate"; obs/quality.py): sweep count/cost, the latest quality
        # gauges, and how often the gate held the published pointer.
        "quality_evals": c.get("quality/evals", 0),
        "quality_eval_seconds": c.get("quality/eval_seconds", 0.0),
        "quality_examples": c.get("quality/examples", 0),
        "quality_gate_held": c.get("quality/gate_held", 0),
        "quality_auc": g.get("quality/auc"),
        "quality_loss": g.get("quality/loss"),
        "quality_calibration": g.get("quality/calibration"),
    }

    # Serving (README "Serving"; fast_tffm_tpu/serve/): request/latency
    # accounting plus the served-vs-published step pair the STALE MODEL
    # health verdict reads.
    lat = h.get("serve/request_latency_ms") or {}
    qd = h.get("serve/queue_depth") or {}
    out["serve_requests"] = c.get("serve/requests", 0)
    out["serve_examples"] = c.get("serve/examples", 0)
    out["serve_flushes"] = c.get("serve/flushes", 0)
    out["serve_flush_errors"] = c.get("serve/flush_errors", 0)
    out["serve_padded_examples"] = c.get("serve/padded_examples", 0)
    out["serve_reloads"] = c.get("serve/reloads", 0)
    out["serve_reload_failures"] = c.get("serve/reload_failures", 0)
    out["serve_latency_p50_ms"] = lat.get("p50")
    out["serve_latency_p99_ms"] = lat.get("p99")
    out["serve_queue_depth_p90"] = qd.get("p90")
    out["serve_served_step"] = g.get("serve/served_step")
    out["serve_published_step"] = g.get("serve/published_step")

    # Serving fleet (README "Serving fleet"; serve/fleet.py): the
    # supervisor's aggregate counts plus the proxy's routing
    # accounting — the FLEET render section and the FLEET DEGRADED
    # verdict read these.
    out["fleet_replicas"] = g.get("fleet/replicas")
    out["fleet_ready"] = g.get("fleet/ready")
    out["fleet_alive"] = g.get("fleet/alive")
    out["fleet_restarts"] = c.get("fleet/restarts", 0)
    out["fleet_reloads"] = c.get("fleet/reloads", 0)
    out["fleet_reload_failures"] = c.get("fleet/reload_failures", 0)
    out["proxy_requests"] = c.get("proxy/requests", 0)
    out["proxy_retries"] = c.get("proxy/retries", 0)
    out["proxy_shed_503"] = c.get("proxy/shed_503", 0)
    out["proxy_unrouted_503"] = c.get("proxy/unrouted_503", 0)
    out["proxy_canary_requests"] = c.get("proxy/canary_requests", 0)
    out["proxy_canary_score_delta"] = g.get("proxy/canary_score_delta")

    # Predict-path stats (a predict stream has no train loop at all;
    # both can coexist in one file — e.g. train-then-predict appends).
    p_ex = c.get("predict/examples", 0)
    p_s = c.get("predict/seconds", 0.0)
    depth = h.get("predict/fetch_depth") or {}
    out["predict_examples"] = p_ex
    out["predict_examples_per_sec"] = _frac(p_ex, p_s)
    out["predict_fetch_depth_p90"] = depth.get("p90")
    # Predict attribution (ISSUE 10 satellite): per-stage busy seconds
    # over the sweep wall — parse/build on the pipeline thread(s), D2H
    # bulk fetches (+ in-order delivery) on the fetch worker, score
    # writes on the writer thread. The stages OVERLAP by design (the
    # streaming scorer's whole point), so the shares are independent
    # utilizations that may sum past 1; the stage whose share
    # approaches 1 is the sweep's bound — a named verdict instead of
    # the old fetch-depth guess. predict/seconds is counted once per
    # sweep, so these are honest wall fractions — but ONLY on a
    # predict-only stream (loop_s == 0, the same gate the verdict
    # uses): a combined train-then-predict file feeds
    # pipeline/build_seconds and fetch/d2h_seconds from the train
    # loop and its validation sweeps too, which would inflate the
    # shares past any meaning.
    if p_s and p_ex and loop_s <= 0:
        out["predict_parse_share"] = _frac(
            c.get("pipeline/build_seconds"), p_s)
        out["predict_d2h_share"] = _frac(
            c.get("fetch/d2h_seconds"), p_s)
        out["predict_write_share"] = _frac(
            c.get("predict/write_seconds"), p_s)
    else:
        out["predict_parse_share"] = None
        out["predict_d2h_share"] = None
        out["predict_write_share"] = None

    # Bench ceilings, when the stream carries them (bench.py emits
    # these; a production run can be laid side by side with them).
    ceilings = {k.split("/", 1)[1]: v for k, v in g.items()
                if k.startswith("bench/")}
    if ceilings:
        out["ceilings"] = ceilings
        out["verdict"] = _bench_verdict(ceilings)
        return out

    iw = out["input_wait_fraction"]
    pf = out["pause_fraction"]
    if loop_s <= 0 and p_ex:
        out["verdict"] = _predict_verdict(out)
        return out
    if loop_s <= 0:
        out["verdict"] = "no train-loop data"
    elif iw is not None and iw > HOST_BOUND_FRACTION:
        # Host-parallel efficiency rides the host-bound verdict: a
        # host-bound run whose build concurrency already matches its
        # worker count needs MORE workers (or a faster parser); one
        # far below it has idle workers — a different fix.
        hp = ""
        ht = out.get("host_threads")
        conc = out.get("host_build_concurrency")
        if ht:
            hp = (f"; host_threads={ht:.0f}, build concurrency "
                  f"{conc:.1f}x" if conc is not None
                  else f"; host_threads={ht:.0f}")
        out["verdict"] = (f"host-bound: {iw:.0%} of the loop waits on "
                          f"the input pipeline{hp}")
    elif pf is not None and pf > PAUSE_BOUND_FRACTION:
        out["verdict"] = (f"pause-bound: {pf:.0%} of run time in "
                          "checkpoint/summary/validation pauses")
    else:
        # Name the active wire format + dtype mode in the
        # transfer-bound verdict: the first question at this verdict
        # is "how many bytes per example is the wire shipping, and is
        # the packed format on" (README "Wire format").
        wm = out.get("wire_format")
        wtag = f", wire {wm}" if wm else ""
        out["verdict"] = ("device/transfer-bound: the loop keeps the "
                          "dispatch stream full (host wait "
                          f"{iw:.0%}{wtag})" if iw is not None else
                          f"device/transfer-bound{wtag}")
    return out


# A predict stage whose busy share of the sweep wall exceeds this is
# named the bound; below it the sweep's time is in score dispatch +
# device compute, which host-side timing cannot split further.
PREDICT_STAGE_BOUND_FRACTION = 0.5

# Cold-row saturation floor (vocab_mode = admit): when more than this
# fraction of the run's distinct-id observations landed on the shared
# cold row, the table is too small for the stream's hot set — most of
# what the model sees trains one communal embedding. The VOCAB section
# names it and the fix (raise vocabulary_size, or lower
# vocab_admit_threshold so the hot set actually admits).
COLD_SATURATION_FRACTION = 0.5


def vocab_verdict(att: Dict[str, Any]) -> Optional[str]:
    """The VOCAB section's verdict line, or None while admission is
    healthy. Only meaningful on a stream that ran admission at all
    (vocab/ids > 0)."""
    rate = att.get("vocab_cold_hit_rate")
    if rate is None or not att.get("vocab_ids"):
        return None
    if rate > COLD_SATURATION_FRACTION:
        return (f"COLD-ROW SATURATION: {rate:.0%} of distinct-id "
                "observations hit the shared cold row — the hot set "
                "outgrew the table; raise vocabulary_size or lower "
                "vocab_admit_threshold")
    return None


def _predict_verdict(att: Dict[str, Any]) -> str:
    """Verdict for a predict-only stream, from the per-stage busy
    shares (parse / D2H / write over sweep wall — ISSUE 10): the stage
    saturating the wall is the bound, BY NAME. Streams without the
    stage counters (pre-refactor files) fall back to the fetch-depth
    heuristic: the output-order buffer (ChunkedFetcher) backs up
    exactly when D2H transfer lags scoring (BASELINE.md "Predict-path
    rate")."""
    rate = att.get("predict_examples_per_sec")
    base = (f"predict: {rate:,.0f} examples/sec over "
            f"{att['predict_examples']:,.0f} examples"
            if rate else "predict stream without rate data")
    stages = [(name, att.get(key)) for name, key in
              (("parse", "predict_parse_share"),
               ("d2h", "predict_d2h_share"),
               ("write", "predict_write_share"))]
    known = [(n, v) for n, v in stages if v is not None]
    if known:
        name, share = max(known, key=lambda kv: kv[1])
        detail = ", ".join(f"{n} {v:.0%}" for n, v in known)
        if share > PREDICT_STAGE_BOUND_FRACTION:
            return (base + f" — {name}-bound: {share:.0%} of the sweep "
                    f"wall is {name} ({detail})")
        return (base + " — score/dispatch-bound: no host stage "
                f"saturates the sweep ({detail})")
    p90 = att.get("predict_fetch_depth_p90")
    from fast_tffm_tpu_torch.utils.fetch import FETCH_CHUNK_BATCHES
    if p90 is not None and p90 >= FETCH_CHUNK_BATCHES:
        return (base + " — transfer-bound: the output-order buffer "
                f"sits at {p90:.0f} batches (>= the {FETCH_CHUNK_BATCHES}"
                "-batch fetch chunk), scores wait on D2H")
    return base + " — host/scoring-bound (output-order buffer shallow)"


def _bench_verdict(ceil: Dict[str, float]) -> str:
    e2e = ceil.get("e2e")
    named = [(k, v) for k, v in ceil.items()
             if k in ("host_only", "device_only", "h2d_only") and v]
    if not e2e or not named:
        return "bench stream without e2e/ceiling gauges"
    # The binding constraint is the smallest ceiling; whichever ceiling
    # sits nearest the e2e number names the bottleneck (bench.py's
    # reading rule).
    name, v = min(named, key=lambda kv: abs(kv[1] - e2e))
    label = {"host_only": "host-bound",
             "device_only": "device-bound",
             "h2d_only": "transfer-bound"}[name]
    return (f"{label}: e2e {e2e:,.0f} ex/s tracks the {name} ceiling "
            f"({v:,.0f} ex/s)")


# Every `health: <kind>` event the codebase can emit, by status
# string. This is the read-side catalog: health_verdict maps each kind
# into a verdict or a detail note below, the README's health-event
# table documents each row, and fmlint R012 gates all three against
# the emit sites — a new health kind cannot land without its fmstat
# mapping and its catalog row.
HEALTH_KINDS = frozenset({
    "stalled", "recovered", "nonfinite_loss", "preempted",
    "worker_lost", "elastic_recovered", "ckpt_fallback", "bad_input",
    "collective_slow", "cluster_bringup_failed", "gate_held",
    "join_refused", "hbm_pressure",
})


def health_verdict(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The run-health verdict line for one merged summary (obs/health):
    ``{"verdict": "OK" | "PREEMPTED" | "DEGRADED (N workers lost)" |
    "STALLED" | "NONFINITE" | "CRASHED", "detail": ...}``. Read purely
    from explicit stream events — severity order CRASHED > NONFINITE >
    PREEMPTED > DEGRADED > STALLED, because a crash ends the run while
    a survived stall merely delayed it; a preemption (train's SIGTERM/
    SIGINT save-and-exit path emits ``health: preempted``) is a CLEAN
    exit that must not read as a crash — the run saved, and a restart
    resumes it; and a DEGRADED run (``health: worker_lost`` diagnoses
    from the collective deadline guard, usually paired with
    ``elastic_recovered``) finished its work on a shrunken cluster —
    healed, but never silently green: the operator should know N
    workers' capacity is gone and the dead workers' shard streams end
    without a run_end. A run that RECOVERED from a bad checkpoint
    (``health: ckpt_fallback``) reads as ``OK (ckpt fallback xN)``. A
    stream that never wrote its run_end gets flagged in the detail
    either way (a hard-killed run writes no crash event; a live run
    hasn't finished — the reader knows which one it is holding)."""
    crashes = summary.get("crash_events") or []
    health = summary.get("health_events") or []
    stalls = [h for h in health if h.get("status") == "stalled"]
    fallbacks = [h for h in health
                 if h.get("status") == "ckpt_fallback"]
    recoveries = [h for h in health if h.get("status") == "recovered"]
    nonfin = [h for h in health
              if str(h.get("status", "")).startswith("nonfinite")]
    preempts = [h for h in health if h.get("status") == "preempted"]
    lost_events = [h for h in health
                   if h.get("status") == "worker_lost"]
    elastic = [h for h in health
               if h.get("status") == "elastic_recovered"]
    holds = [h for h in health if h.get("status") == "gate_held"]
    bad_inputs = [h for h in health if h.get("status") == "bad_input"]
    slow = [h for h in health
            if h.get("status") == "collective_slow"]
    bringup = [h for h in health
               if h.get("status") == "cluster_bringup_failed"]
    refused = [h for h in health
               if h.get("status") == "join_refused"]
    unclosed = (summary.get("run_starts", 0)
                > summary.get("run_ends", 0))
    notes = []
    if unclosed:
        notes.append("stream has no run_end (hard kill, still "
                     "running, or a lost worker's shard)")
    if bad_inputs:
        notes.append(f"{len(bad_inputs)} bad_input episode(s) — lines "
                     "skipped/quarantined under bad_line_policy")
    if slow:
        notes.append(f"{len(slow)} collective_slow episode(s) — the "
                     "cluster was healthy but slow at a deadline")
    if bringup:
        notes.append("cluster bring-up exhausted its retry budget "
                     "(cluster_bringup_failed)")
    if refused:
        notes.append(f"{len(refused)} join_refused event(s) — a "
                     "joiner was turned away at the grow rendezvous "
                     "(stale generation, or a slot race lost)")
    unknown = sorted({str(h.get("status", "")) for h in health}
                     - HEALTH_KINDS - {""})
    if unknown:
        notes.append(f"unrecognized health kind(s): "
                     f"{', '.join(unknown)} — update fmstat's catalog")
    if crashes:
        first = crashes[0]
        err = str(first.get("error", "?"))
        return {"verdict": "CRASHED",
                "detail": "; ".join(
                    [f"{len(crashes)} crash event(s); first: {err[:120]}"]
                    + notes)}
    if nonfin:
        names = sorted({str(h.get("name", "?")) for h in nonfin})
        lo = min((h.get("step_first") or 0) for h in nonfin)
        hi = max((h.get("step_last") or 0) for h in nonfin)
        return {"verdict": "NONFINITE",
                "detail": "; ".join(
                    [f"non-finite {', '.join(names)} over steps "
                     f"{lo}..{hi}"] + notes)}
    if preempts:
        last = preempts[-1]
        return {"verdict": "PREEMPTED",
                "detail": "; ".join(
                    [f"preemption signalled at step "
                     f"{last.get('step', '?')} (epoch "
                     f"{last.get('epoch', '?')}); the run saved and "
                     "exited cleanly — restart to resume"] + notes)}
    if lost_events:
        lost_ids = sorted(
            {int(p.get("process_index", -1))
             for h in lost_events for p in (h.get("lost") or [])}
            | {int(p) for h in elastic for p in (h.get("lost") or [])})
        n = max(len(lost_ids), 1)
        who = (", ".join(f"process {p}" for p in lost_ids)
               if lost_ids else "unnamed peer(s)")
        last_el = elastic[-1] if elastic else None
        cap = (last_el or {}).get("capacity")
        el_members = (last_el or {}).get("members") or []
        if last_el is not None and cap and len(el_members) == int(cap):
            # The LAST elastic event restored FULL membership (grow
            # healed the cluster, or every "lost" worker rejoined):
            # rendering DEGRADED here would be actively wrong — the
            # job finished at capacity. Never silently green though:
            # the healing story stays in the detail.
            gen = int(last_el.get("generation", 0))
            joined = sorted(int(p) for p in
                            (last_el.get("joined") or []))
            return {"verdict": f"RECOVERED (gen {gen}, "
                               f"{len(el_members)} workers)",
                    "detail": "; ".join(
                        [f"lost {who}, then elastic recovery x"
                         f"{len(elastic)} healed the cluster back to "
                         f"full membership ({len(el_members)}/"
                         f"{int(cap)} workers"
                         + (f", replacement(s) {joined} admitted"
                            if joined else "")
                         + f") — the run finished at capacity"]
                        + notes)}
        if elastic:
            gens = max(int(h.get("generation", 0)) for h in elastic)
            members = (elastic[-1].get("members") or [])
            how = (f"elastic shrink recovered x{len(elastic)} "
                   f"(generation {gens}, {len(members)} survivor(s)); "
                   "the run continued on the shrunken cluster")
        else:
            how = ("no elastic recovery recorded — the run failed "
                   "fast with the diagnosis (elastic = off) or was "
                   "still recovering")
        return {"verdict": f"DEGRADED ({n} worker"
                           f"{'s' if n != 1 else ''} lost)",
                "detail": "; ".join(
                    [f"collective deadline guard / heartbeat monitor "
                     f"lost {who}; {how}"] + notes)}
    if stalls:
        worst = max(float(h.get("stalled_seconds") or 0) for h in stalls)
        rec = (f", recovered x{len(recoveries)}" if recoveries
               else ", NOT recovered")
        return {"verdict": "STALLED",
                "detail": "; ".join(
                    [f"{len(stalls)} stall episode(s), worst "
                     f"{worst:.1f}s without progress{rec}; stacks: "
                     f"{stalls[0].get('stacks_file', '?')}"] + notes)}
    if holds:
        # Ranked below STALLED (the run itself is healthy — its DATA
        # or MODEL regressed) and above STALE PUBLISH (a long hold is
        # the usual cause of one; name the cause, not the symptom).
        last = holds[-1]
        why = "; ".join(last.get("reasons") or []) or \
            "validation quality regressed"
        return {"verdict": f"GATE-HELD (x{len(holds)})",
                "detail": "; ".join(
                    [f"publish gate held the pointer {len(holds)} "
                     f"time(s), last at step {last.get('step', '?')} "
                     f"(AUC {_fmt(last.get('auc'))}): {why}. Serving "
                     "continues on the last passing step; inspect the "
                     "input burst (quarantine sidecar, quality/auc "
                     "timeline) — publishes resume when validation "
                     "recovers"] + notes)}
    pressures = [h for h in health if h.get("status") == "hbm_pressure"]
    if pressures:
        # Ranked below DEGRADED/STALLED/GATE-HELD (the run is making
        # progress and its quality is fine — it is close to a capacity
        # wall) and above STALE PUBLISH (a pressured device is about
        # to become a failing reload/publish; name the cause first).
        last = pressures[-1]
        owners = last.get("owners") or {}
        top = (max(owners.items(), key=lambda kv: kv[1])
               if owners else None)
        top_note = (f"; largest owner {top[0]} "
                    f"({_fmt(top[1] / 2**20)} MB)" if top else "")
        return {"verdict": f"HBM-PRESSURE (x{len(pressures)})",
                "detail": "; ".join(
                    [f"{len(pressures)} pressure episode(s): live "
                     f"device bytes reached "
                     f"{_fmt(100 * float(last.get('fraction') or 0))}% "
                     f"of capacity (threshold "
                     f"{_fmt(100 * float(last.get('threshold') or 0))}"
                     f"%){top_note}. Size a fix before the OOM: python "
                     "-m tools.fmstat capacity <cfg> --what-if "
                     "vocabulary_size=...,dtype=f16,shards=K"] + notes)}
    deg = fleet_degraded(summary)
    if deg is not None:
        # Ranked above STALE PUBLISH / STALE MODEL: a fleet running
        # below strength is an availability incident NOW (one more
        # death may zero the ready set), while staleness is a
        # freshness problem — and a dead replica is often exactly why
        # a reload hasn't landed, so name the cause first.
        ready, total = deg
        return {"verdict": f"FLEET DEGRADED ({ready}/{total} ready)",
                "detail": "; ".join(
                    [f"{total - ready} of {total} serving replicas "
                     "not ready at the last flush — the proxy routes "
                     "around them while the supervisor restarts "
                     "(capped backoff) or drains a reload; check "
                     "fleet/restarts and the per-replica rows "
                     "(python -m tools.fmstat <supervisor metrics>)"]
                    + notes)}
    stale = stale_publish(summary)
    if stale is not None:
        # Checked BEFORE the unclosed-stream heuristic: a live stream
        # run legitimately has no run_end yet, and "the scorer is
        # being starved of fresh checkpoints" is the actionable
        # diagnosis there — a crashed stream run with no crash event
        # still reads STALE PUBLISH + the no-run_end note.
        age, interval = stale
        return {"verdict": "STALE PUBLISH",
                "detail": "; ".join(
                    [f"last published checkpoint is {age:.0f}s old, "
                     f"over 3x the {interval:.0f}s publish interval — "
                     "scorers are reloading stale state; check the "
                     "stream run's save/verify path"] + notes)}
    lag = stale_model(summary)
    if lag is not None:
        # Same placement rationale as STALE PUBLISH: a live serving
        # run legitimately has no run_end yet, and "the scorer is
        # serving older state than the pointer names" is the
        # actionable diagnosis — the reload loop is failing (verify
        # failures, a GC'd step, a dead watcher), not the publisher.
        served, published = lag
        return {"verdict": "STALE MODEL",
                "detail": "; ".join(
                    [f"serving checkpoint step {served:.0f} while the "
                     f"published pointer names step {published:.0f} — "
                     "the hot-reload loop is not landing; check "
                     "serve/reload_failures and the step's integrity "
                     "(python -m tools.fmckpt verify)"] + notes)}
    if unclosed:
        return {"verdict": "CRASHED", "detail": notes[0]}
    if fallbacks:
        steps = ", ".join(str(h.get("step", "?")) for h in fallbacks)
        quars = [h.get("quarantined") for h in fallbacks
                 if h.get("quarantined")]
        where = f"; quarantined: {quars[-1]}" if quars else ""
        return {"verdict": f"OK (ckpt fallback x{len(fallbacks)})",
                "detail": "; ".join(
                    [f"restore quarantined bad checkpoint step(s) "
                     f"{steps} and fell back to an older step — the "
                     f"run then completed cleanly{where}; reclaim "
                     "space with `python -m tools.fmckpt gc`"] + notes)}
    if notes:
        return {"verdict": "OK",
                "detail": "; ".join(["run_end present"] + notes)}
    return {"verdict": "OK", "detail": "no health/crash events; "
            "run_end present"}


def stale_publish(summary: Dict[str, Any]
                  ) -> Optional[Tuple[float, float]]:
    """(publish age, configured interval) when the stream run's last
    publish is older than STALE_PUBLISH_MULTIPLE x the interval at the
    final metrics flush, else None. Only meaningful for streams that
    publish (interval gauge present and > 0)."""
    g = summary.get("gauges", {})
    interval = g.get("stream/publish_interval_seconds")
    age = g.get("stream/last_publish_age_seconds")
    if not interval or age is None:
        return None
    if age > STALE_PUBLISH_MULTIPLE * interval:
        return float(age), float(interval)
    return None


# Publish-freshness ceiling, in intervals: past this the health verdict
# flips to STALE PUBLISH (the serving fleet is reloading old state).
STALE_PUBLISH_MULTIPLE = 3.0


def fleet_degraded(summary: Dict[str, Any]
                   ) -> Optional[Tuple[int, int]]:
    """(ready, total) when a fleet supervisor's last flush shows
    fewer ready replicas than the fleet size, else None. Only
    meaningful for fleet streams (the fleet/replicas gauge present) —
    the supervisor flushes eagerly on every ready-count edge, so a
    mid-incident snapshot carries the degradation window."""
    g = summary.get("gauges", {})
    total = g.get("fleet/replicas")
    ready = g.get("fleet/ready")
    if not total or ready is None:
        return None
    if ready < total:
        return int(ready), int(total)
    return None


def fleet_table(summary: Dict[str, Any]) -> List[str]:
    """Per-replica rows from the SUPERVISOR's gauges
    (``fleet/replica<i>_alive/_ready/_step/_queue_depth``): liveness
    and readiness split (the restart-vs-route distinction), the step
    each replica serves (a stagger or canary in flight shows as a
    step spread), and its admission-queue depth at the last flush."""
    g = summary.get("gauges", {})
    idx = sorted({int(k.split("_", 1)[0][len("fleet/replica"):])
                  for k in g
                  if k.startswith("fleet/replica")
                  and k.split("_", 1)[0][len("fleet/replica"):]
                  .isdigit()})
    rows = []
    for i in idx:
        alive = g.get(f"fleet/replica{i}_alive")
        ready = g.get(f"fleet/replica{i}_ready")
        step = g.get(f"fleet/replica{i}_step")
        depth = g.get(f"fleet/replica{i}_queue_depth")
        flag = ("ready" if ready else
                ("alive" if alive else "DOWN"))
        rows.append(
            f"r{i}: {flag:<6} step={_fmt(step)} "
            f"queue={_fmt(depth)}")
    return rows


def stale_model(summary: Dict[str, Any]
                ) -> Optional[Tuple[float, float]]:
    """(served step, published step) when a serving stream's last
    flush shows the served checkpoint LAGGING the published pointer —
    the reload loop failed to land the new step — else None. Only
    meaningful for serve streams (both gauges present); a healthy
    server's final flush always has served == published."""
    g = summary.get("gauges", {})
    served = g.get("serve/served_step")
    published = g.get("serve/published_step")
    if served is None or published is None:
        return None
    if published > served:
        return float(served), float(published)
    return None


def dedup_hit_rate(counters: Dict[str, float]) -> Optional[float]:
    """Fraction of feature occurrences deduplicated away by the host
    unique pass (1 - uniq_rows/nnz). None in raw-ids mode (the unique
    set never exists host-side)."""
    nnz = counters.get("pipeline/feature_nnz")
    uniq = counters.get("pipeline/uniq_rows")
    if not nnz or uniq is None:
        return None
    return max(0.0, 1.0 - uniq / nnz)


def padding_waste(counters: Dict[str, float]) -> Optional[float]:
    """Fraction of shipped [B, L] feature slots that are padding."""
    slots = counters.get("pipeline/feature_slots")
    nnz = counters.get("pipeline/feature_nnz")
    if not slots:
        return None
    return max(0.0, 1.0 - (nnz or 0.0) / slots)


def worker_table(summary: Dict[str, Any]) -> List[str]:
    """Per-worker liveness rows (one line per process that published
    ``worker/*`` gauges — multi-process runs with the heartbeat lease
    on): last heartbeat age at the final flush, lockstep windows
    completed, and examples processed. A worker named lost by a
    ``health: worker_lost`` diagnosis is flagged LOST — its row
    freezes at whatever its shard file last flushed."""
    lost_ids = set()
    for h in summary.get("health_events") or []:
        if h.get("status") == "worker_lost":
            for p in h.get("lost") or []:
                # fmlint: disable=R001 -- parsed JSON event fields,
                # host values only (this is the offline read side)
                lost_ids.add(int(p.get("process_index", -1)))
        elif h.get("status") == "elastic_recovered":
            # fmlint: disable=R001 -- parsed JSON event fields
            lost_ids.update(int(p) for p in h.get("lost") or [])
            # A grow recovery re-admits a slot a shrink once lost:
            # events are read in stream order, so the replacement's
            # row (fresh heartbeats and all) drops the LOST flag.
            # fmlint: disable=R001 -- parsed JSON event fields
            lost_ids -= {int(p) for p in h.get("joined") or []}
    rows = []
    for proc in sorted(summary.get("gauges_by_process", {})):
        g = summary["gauges_by_process"][proc]
        if not any(k.startswith("worker/") for k in g):
            continue
        age = g.get("worker/heartbeat_age_seconds")
        age_s = ("-" if age is None or age < 0
                 else f"{age:.1f}s")
        flag = "  LOST" if proc in lost_ids else ""
        rows.append(
            f"p{proc}: hb age {age_s}  windows "
            f"{_fmt(g.get('worker/windows', 0))}  examples "
            f"{_fmt(g.get('worker/examples', 0))}{flag}")
    return rows


# The EFFICIENCY section's gauge surface (README "Step anatomy"): the
# per-process anatomy/* gauges telemetry.anatomy_gauges pre-aggregates
# at barrier flushes — phase seconds split into local work vs
# cross-rank coordination waits. The verdict here works from the JSONL
# alone; the straggler-wait vs transport split needs the trace replay
# (fmtrace --anatomy).
ANATOMY_LOCAL_PHASES = (
    ("input wait", "anatomy/input_wait_seconds"),
    ("host build", "anatomy/host_build_seconds"),
    ("h2d", "anatomy/h2d_seconds"),
    ("dispatch", "anatomy/dispatch_seconds"),
    ("window fill", "anatomy/window_fill_seconds"),
    ("d2h fetch", "anatomy/fetch_seconds"),
)
ANATOMY_WAIT_PHASES = (
    ("flags wait", "anatomy/flags_wait_seconds"),
    ("lockstep allgather", "anatomy/allgather_seconds"),
)


def efficiency_table(summary: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Per-worker efficiency rows from the pre-aggregated anatomy/*
    gauges: efficiency = the fraction of step wall NOT parked in
    cross-rank coordination waits (flags allgather + lockstep
    allgather). None when no process published coordination waits
    (single-process runs, anatomy off, or pre-anatomy streams) — the
    section only exists where there is a cluster to explain. The
    straggler is the rank that waits LEAST: everyone else's wait is
    time spent waiting for it."""
    ranks: Dict[Any, Dict[str, Any]] = {}
    for proc in sorted(summary.get("gauges_by_process") or {}):
        g = summary["gauges_by_process"][proc]
        wall = g.get("anatomy/step_wall_seconds")
        if not wall:
            continue
        wait = sum(g.get(key) or 0.0 for _, key in ANATOMY_WAIT_PHASES)
        if wait <= 0:
            continue
        phases = {label: g.get(key) or 0.0
                  for label, key in (ANATOMY_LOCAL_PHASES
                                     + ANATOMY_WAIT_PHASES)}
        ex = g.get("anatomy/examples") or 0.0
        ranks[proc] = {
            "wall_seconds": wall,
            "wait_seconds": wait,
            "wait_fraction": wait / wall,
            "efficiency": max(0.0, 1.0 - wait / wall),
            "examples_per_sec": (ex / wall) if wall else None,
            "phases": phases,
        }
    if not ranks:
        return None
    straggler = min(ranks, key=lambda p: ranks[p]["wait_fraction"])
    wall_tot = sum(r["wall_seconds"] for r in ranks.values())
    wait_tot = sum(r["wait_seconds"] for r in ranks.values())
    wait_frac = wait_tot / wall_tot if wall_tot else 0.0
    local = {label: v
             for label, v in ranks[straggler]["phases"].items()
             if label not in dict(ANATOMY_WAIT_PHASES)}
    dom = max(local, key=local.get) if any(local.values()) else None
    verdict = (f"collective wait {wait_frac:.0%} of step"
               + (f"; rank {straggler} is the straggler"
                  f" (its dominant local phase: {dom})"
                  if len(ranks) > 1 and dom else ""))
    return {
        "ranks": ranks,
        "straggler_rank": straggler if len(ranks) > 1 else None,
        "wait_fraction": wait_frac,
        "efficiency": max(0.0, 1.0 - wait_frac),
        "verdict": verdict,
    }


def memory_table(summary: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Device-memory rows from the mem/* ledger gauges (obs/memory.py;
    chief view — the ledger is per-process and the flat gauges are
    process 0's). None for pre-ledger streams — the MEMORY section
    only exists where a ledger wrote gauges."""
    g = summary.get("gauges", {})
    if g.get("mem/live_bytes") is None and g.get("mem/peak_bytes") is None:
        return None
    totals = ("mem/live_bytes", "mem/peak_bytes", "mem/capacity_bytes",
              "mem/host_live_bytes", "mem/device_in_use_bytes")
    owners = {k[len("mem/"):-len("_bytes")]: v
              for k, v in g.items()
              if k.startswith("mem/") and k.endswith("_bytes")
              and k not in totals}
    return {
        "owners": owners,
        "live_bytes": g.get("mem/live_bytes"),
        "peak_bytes": g.get("mem/peak_bytes"),
        "host_live_bytes": g.get("mem/host_live_bytes"),
        "capacity_bytes": g.get("mem/capacity_bytes"),
        "utilization_fraction": g.get("mem/utilization_fraction"),
        "pressure_events":
            (summary.get("counters") or {}).get("mem/pressure_events"),
        "reload_peak_bytes": g.get("serve/reload_peak_bytes"),
    }


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if 0 < abs(v) < 0.01 or abs(v) >= 1e6:
            return f"{v:.3g}"
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    return str(v)


def render(summary: Dict[str, Any]) -> str:
    """Human-readable attribution table for one merged summary — the
    fmstat output body."""
    att = attribution(summary)
    meta = summary.get("meta", {})
    lines = []
    head = [f"kind={meta.get('kind', '?')}",
            f"backend={meta.get('backend', '?')}",
            f"devices={meta.get('device_count', '?')}",
            f"processes={meta.get('process_count', '?')}",
            f"config={meta.get('config_hash', '?')}",
            f"git={meta.get('git_rev', '?')}"]
    lines.append("run: " + " ".join(head))
    lines.append(f"files merged: {summary.get('runs', 0)} run stream(s), "
                 f"{summary.get('events', 0)} events, "
                 f"{summary.get('spans', 0)} spans")
    hv = health_verdict(summary)
    lines.append(f"health: {hv['verdict']} — {hv['detail']}")
    lines.append("")
    rows = [
        ("examples", att["examples"]),
        ("steps", att["steps"]),
        ("examples/sec (incl pauses)", att["examples_per_sec"]),
        ("examples/sec (loop only)", att["loop_examples_per_sec"]),
        ("step p50 / p99 (s)",
         f"{_fmt(att['step_p50_s'])} / {_fmt(att['step_p99_s'])}"),
        ("input-wait fraction", att["input_wait_fraction"]),
        ("pause seconds (ckpt/summary/val)", att["pause_seconds"]),
        ("h2d bytes/sec", att["h2d_bytes_per_sec"]),
        ("h2d bytes/example (wire / padded)",
         f"{_fmt(att['h2d_bytes_per_example'])} / "
         f"{_fmt(att['h2d_logical_bytes_per_example'])}"),
        ("wire format (packed savings x)",
         f"{att['wire_format'] or '?'} "
         f"({_fmt(att['wire_savings_ratio'])})"),
        ("host threads / build concurrency",
         f"{_fmt(att['host_threads'])} / "
         f"{_fmt(att['host_build_concurrency'])}"),
        ("ring occupancy (last)", att["ring_occupancy"]),
        ("dedup hit rate", att["dedup_hit_rate"]),
        ("padding-waste fraction", att["padding_waste_fraction"]),
        ("parse errors", att["parse_errors"]),
        ("bad lines skipped", att["bad_lines"]),
        ("io retries", att["io_retries"]),
        ("checkpoint saves", att["checkpoint_saves"]),
        ("ckpt fallbacks / quarantined steps",
         f"{_fmt(att['checkpoint_fallbacks'])} / "
         f"{_fmt(att['checkpoint_quarantined'])}"),
        ("workers lost / elastic recoveries",
         f"{_fmt(att['workers_lost'])} / "
         f"{_fmt(att['elastic_recoveries'])}"),
    ]
    if att["predict_examples"]:
        rows += [
            ("predict examples", att["predict_examples"]),
            ("predict examples/sec",
             att["predict_examples_per_sec"]),
            ("predict fetch-depth p90 (batches)",
             att["predict_fetch_depth_p90"]),
            # Per-stage busy share of the sweep wall (stages overlap;
            # the one near 1.0 is the bound — see _predict_verdict).
            ("predict parse / d2h / write share",
             f"{_fmt(att['predict_parse_share'])} / "
             f"{_fmt(att['predict_d2h_share'])} / "
             f"{_fmt(att['predict_write_share'])}"),
        ]
    for k, v in rows:
        lines.append(f"  {k:<34} {_fmt(v)}")
    if att["stream_files_discovered"] or att[
            "stream_publish_interval_seconds"]:
        lines.append("  STREAMING (run_mode = stream):")
        age = att["stream_last_publish_age_seconds"]
        interval = att["stream_publish_interval_seconds"]
        for k, v in (
                ("watermark lag (s)",
                 att["stream_watermark_lag_seconds"]),
                ("files discovered / sealed",
                 f"{_fmt(att['stream_files_discovered'])} / "
                 f"{_fmt(att['stream_files_sealed'])}"),
                ("files truncated / deleted",
                 f"{_fmt(att['stream_truncated_files'])} / "
                 f"{_fmt(att['stream_deleted_files'])}"),
                ("publishes (failed)",
                 f"{_fmt(att['stream_publishes'])} "
                 f"({_fmt(att['stream_publish_failures'])})"),
                ("last publish age / interval (s)",
                 f"{_fmt(age)} / {_fmt(interval)}"),
        ):
            lines.append(f"    {k:<32} {v}")
    if att["quality_evals"] or att["quality_gate_held"]:
        lines.append("  QUALITY (per-publish eval + gate):")
        evs = att["quality_evals"]
        secs = att["quality_eval_seconds"]
        per = (secs / evs) if evs else None
        for k, v in (
                ("quality AUC (latest)", att["quality_auc"]),
                ("quality loss (latest)", att["quality_loss"]),
                ("calibration (pred/label)",
                 att["quality_calibration"]),
                ("evals (examples swept)",
                 f"{_fmt(evs)} ({_fmt(att['quality_examples'])})"),
                ("eval cost (s/eval)", per),
                ("publishes gate-held", att["quality_gate_held"]),
        ):
            lines.append(f"    {k:<32} {_fmt(v)}")
    if att["vocab_ids"] or att["vocab_live_rows"] is not None:
        lines.append("  VOCAB (vocab_mode = admit):")
        for k, v in (
                ("live rows", att["vocab_live_rows"]),
                ("admitted / evicted (barriers)",
                 f"{_fmt(att['vocab_admitted'])} / "
                 f"{_fmt(att['vocab_evicted'])}"),
                ("cold-row hit rate",
                 att["vocab_cold_hit_rate"]),
                ("sketch fill", att["vocab_sketch_fill"]),
                ("candidates dropped",
                 att["vocab_candidates_dropped"]),
        ):
            lines.append(f"    {k:<32} {_fmt(v)}")
        vv = vocab_verdict(att)
        if vv is not None:
            lines.append(f"    {vv}")
    if att["serve_requests"] or att["serve_served_step"] is not None:
        lines.append("  SERVING (run_tffm.py serve):")
        for k, v in (
                ("requests / examples",
                 f"{_fmt(att['serve_requests'])} / "
                 f"{_fmt(att['serve_examples'])}"),
                ("request latency p50 / p99 (ms)",
                 f"{_fmt(att['serve_latency_p50_ms'])} / "
                 f"{_fmt(att['serve_latency_p99_ms'])}"),
                ("micro-batch flushes (errors)",
                 f"{_fmt(att['serve_flushes'])} "
                 f"({_fmt(att['serve_flush_errors'])})"),
                ("padded examples (ladder waste)",
                 att["serve_padded_examples"]),
                ("queue depth p90",
                 att["serve_queue_depth_p90"]),
                ("hot reloads (failed)",
                 f"{_fmt(att['serve_reloads'])} "
                 f"({_fmt(att['serve_reload_failures'])})"),
                ("served / published step",
                 f"{_fmt(att['serve_served_step'])} / "
                 f"{_fmt(att['serve_published_step'])}"),
        ):
            lines.append(f"    {k:<32} {_fmt(v)}")
        hh = summary.get("hists") or {}
        stages = [hh.get(f"serve/{n}_ms") or {}
                  for n in ("queue_wait", "pad", "device", "reply")]
        if any(s.get("count") for s in stages):
            lines.append(
                f"    {'flush queue/pad/device/reply':<32} "
                + " / ".join(_fmt(s.get('p50')) for s in stages)
                + " ms (p50)")
    if att.get("fleet_replicas"):
        lines.append("  FLEET (serve --replicas):")
        for k, v in (
                ("replicas alive / ready / total",
                 f"{_fmt(att['fleet_alive'])} / "
                 f"{_fmt(att['fleet_ready'])} / "
                 f"{_fmt(att['fleet_replicas'])}"),
                ("restarts", att["fleet_restarts"]),
                ("staggered reloads (failed)",
                 f"{_fmt(att['fleet_reloads'])} "
                 f"({_fmt(att['fleet_reload_failures'])})"),
                ("proxy requests (retries)",
                 f"{_fmt(att['proxy_requests'])} "
                 f"({_fmt(att['proxy_retries'])})"),
                ("proxy 503s shed / unrouted",
                 f"{_fmt(att['proxy_shed_503'])} / "
                 f"{_fmt(att['proxy_unrouted_503'])}"),
        ):
            lines.append(f"    {k:<32} {_fmt(v)}")
        if att["proxy_canary_requests"] or \
                att["proxy_canary_score_delta"] is not None:
            lines.append(
                f"    {'canary requests / score delta':<32} "
                f"{_fmt(att['proxy_canary_requests'])} / "
                f"{_fmt(att['proxy_canary_score_delta'])}")
        for row in fleet_table(summary):
            lines.append(f"    {row}")
    mem = memory_table(summary)
    if mem:
        lines.append("  MEMORY (device ledger):")
        for name, v in sorted(mem["owners"].items(),
                              key=lambda kv: -(kv[1] or 0)):
            lines.append(f"    {name:<32} {_fmt(v / 2**20)} MB")
        live = mem["live_bytes"]
        peak = mem["peak_bytes"]
        lines.append(
            f"    {'live / peak (MB)':<32} "
            f"{_fmt(live / 2**20 if live is not None else None)} / "
            f"{_fmt(peak / 2**20 if peak is not None else None)}")
        cap = mem["capacity_bytes"]
        if cap:
            util = mem["utilization_fraction"]
            lines.append(
                f"    {'capacity (MB) / utilization':<32} "
                f"{_fmt(cap / 2**20)} / "
                f"{_fmt(util) if util is not None else '-'}")
        if mem["host_live_bytes"]:
            lines.append(f"    {'host-resident (MB)':<32} "
                         f"{_fmt(mem['host_live_bytes'] / 2**20)}")
        if mem["reload_peak_bytes"]:
            lines.append(f"    {'serve reload peak (MB)':<32} "
                         f"{_fmt(mem['reload_peak_bytes'] / 2**20)}")
        if mem["pressure_events"]:
            lines.append(f"    {'pressure episodes':<32} "
                         f"{_fmt(mem['pressure_events'])}")
    eff = efficiency_table(summary)
    if eff:
        lines.append("  EFFICIENCY (step anatomy):")
        for proc, r in eff["ranks"].items():
            top = sorted(((v / r["wall_seconds"], label)
                          for label, v in r["phases"].items() if v),
                         reverse=True)[:3]
            phases = ", ".join(f"{label} {frac:.0%}"
                               for frac, label in top)
            lines.append(
                f"    p{proc}: efficiency {r['efficiency']:.2f}  "
                f"wall {r['wall_seconds']:.1f}s  "
                f"rate {_fmt(r['examples_per_sec'])}/s  [{phases}]")
        lines.append(f"    {eff['verdict']}")
    worker_rows = worker_table(summary)
    if worker_rows:
        lines.append("  workers (per-process liveness):")
        for row in worker_rows:
            lines.append(f"    {row}")
    if "ceilings" in att:
        lines.append("  bench ceilings (examples/sec):")
        for k in ("e2e", "host_only", "device_only", "h2d_only"):
            if k in att["ceilings"]:
                lines.append(f"    {k:<32} "
                             f"{_fmt(att['ceilings'][k])}")
    lines.append("")
    lines.append(f"verdict: {att['verdict']}")
    return "\n".join(lines)
