"""Cross-rank step anatomy: the clock-aligned critical-path profiler
(README "Step anatomy"; ``fmtrace --anatomy`` is the CLI) — a copy of
``fast_tffm_tpu/obs/anatomy.py``, held to the original by
``tests/test_torch_obs_readers.py``. The port's ranks post the barrier
spans (``BARRIER_SPANS``) at the JAX package's program points: the
epoch lockstep's and the stream lockstep's flags all-gathers and the
lockstep score window's.

``bench.py --multihost`` says a 2-process cluster runs at ~0.2x
per-worker efficiency; this module says WHERE the other 80% goes. The
telemetry stream already records every ingredient — per-rank ``span``
events (obs/trace.py), per-rank ``collective`` seq events
(parallel/liveness.py), lockstep counters — but each rank stamps spans
with its OWN clocks, so the streams cannot be compared directly. The
pipeline here:

1. **Clock alignment** (``align_clocks``): the collective protocol
   guarantees every rank posts the same barrier collectives in the
   same order (fmlint R014 statically, ``fmtrace --collectives`` at
   runtime), so the k-th occurrence of a barrier span name on every
   rank brackets the SAME barrier. All ranks leave a barrier at
   (nearly) the same true instant — the RELEASE edge (span end) is
   the sync point. Per rank we least-squares fit ``offset + drift``
   of its wall clock against rank 0 over all matched release edges.
   Accuracy is bounded by the release skew of the transport itself
   (the residual is reported; sub-millisecond on localhost gloo,
   looser over real networks — see the README caveats).

2. **Phase accounts** (``build_report``): per rank, span durations
   fold into named phases — host (input wait + batch build), H2D,
   step dispatch (async enqueue backpressure: the previous program
   still executing), lockstep window fill / score dispatch / D2H
   fetch — and every matched barrier's wait splits on the aligned
   clock into *straggler wait* (my arrival -> the last rank's
   arrival: waiting on a PEER) vs *transport* (last arrival ->
   release: waiting on the COLLECTIVE itself, which on CPU+gloo also
   absorbs the previous step's still-queued device program).

3. **Critical path** (``build_report`` -> ``render``): per-worker
   efficiency recomputed from the phases (the fraction of wall NOT
   parked in cross-rank coordination), the overlap fraction, a
   straggler ranking (which rank arrives last, how often, and its
   dominant phase — the "why"), and a one-line verdict naming the
   dominant phase of the slowest rank.

Pure functions over parsed JSONL events — shared by
the ``fmtrace --anatomy`` CLI and the synthetic-clock tests, exactly
like tools/fmtrace's converter. The pre-aggregated ``anatomy/*``
gauges the chief emits at barriers (obs/telemetry.anatomy_gauges) are
the no-trace-replay fallback fmstat's EFFICIENCY section reads; this
module is the full-resolution instrument.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from fast_tffm_tpu_torch.obs.sink import read_events

# Barrier span names: every rank posts these in the same order (the
# collective protocol), so the k-th occurrence on every rank brackets
# the same barrier — the join that needs no stamped id (the stamped
# step/wid fields ride along for labeling and sanity checks).
BARRIER_SPANS = ("train/step_flags", "stream/step_flags",
                 "lockstep/allgather")

# Span name -> phase label for the per-rank duration accounts.
PHASE_SPANS = {
    "train/h2d": "h2d",
    "train/step": "step dispatch",
    "lockstep/window_fill": "window fill",
    "lockstep/score_dispatch": "score dispatch",
    "lockstep/score_fetch": "d2h fetch",
}

# Phases that are cross-rank coordination: time a rank would not pay
# running alone. Efficiency = 1 - coordination/wall.
WAIT_PHASES = ("straggler wait", "transport")


def events_by_rank(paths: Sequence[str]
                   ) -> Dict[int, List[Dict[str, Any]]]:
    """Parse metrics JSONL files into per-rank event lists, keyed by
    the process index each file's run_start announces (the same
    convention as tools/fmtrace). File order is emission order within
    a rank — the occurrence-index join relies on it."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    for path in paths:
        pid = 0
        events: List[Dict[str, Any]] = []
        for rec in read_events(path):
            if rec.get("event") == "run_start":
                meta = rec.get("meta") or {}
                # fmlint: disable=R001 -- parsed JSON event field
                pid = int(meta.get("process_index") or 0)
            events.append(rec)
        out.setdefault(pid, []).extend(events)
    return out


def _barrier_edges(events: Sequence[Dict[str, Any]]
                   ) -> Dict[str, List[Tuple[float, float, Any]]]:
    """One rank's barrier spans, grouped by name in emission order:
    (start, end, stamped id) per occurrence. start/end are the rank's
    OWN wall clock (span ts / ts+dur)."""
    out: Dict[str, List[Tuple[float, float, Any]]] = {}
    for rec in events:
        if rec.get("event") != "span":
            continue
        name = rec.get("name")
        if name not in BARRIER_SPANS:
            continue
        # fmlint: disable=R001 -- parsed JSON event fields
        ts = float(rec.get("ts", rec.get("t", 0.0)))
        # fmlint: disable=R001 -- parsed JSON event fields
        dur = float(rec.get("dur", 0.0))
        out.setdefault(name, []).append(
            (ts, ts + dur, rec.get("step", rec.get("wid"))))
    return out


class ClockFit:
    """One rank's wall clock mapped onto rank 0's: aligned(t) =
    t + offset + drift * (t - t_ref). Rank 0 is the identity fit."""

    __slots__ = ("offset", "drift", "t_ref", "sync_points",
                 "residual_rms")

    def __init__(self, offset: float = 0.0, drift: float = 0.0,
                 t_ref: float = 0.0, sync_points: int = 0,
                 residual_rms: float = 0.0):
        self.offset = offset
        self.drift = drift
        self.t_ref = t_ref
        self.sync_points = sync_points
        self.residual_rms = residual_rms

    def aligned(self, t: float) -> float:
        return t + self.offset + self.drift * (t - self.t_ref)


def _fit(pairs: Sequence[Tuple[float, float]]) -> ClockFit:
    """Least-squares offset+drift over (rank_t, rank0_t) release-edge
    pairs: regress y = rank0_t - rank_t on x = rank_t - t_ref. One
    pair pins offset only; zero pairs is the identity (the caller
    flags it via sync_points == 0)."""
    if not pairs:
        return ClockFit()
    t_ref = sum(t for t, _ in pairs) / len(pairs)
    xs = [t - t_ref for t, _ in pairs]
    ys = [t0 - t for t, t0 in pairs]
    my = sum(ys) / len(ys)
    var = sum(x * x for x in xs)
    drift = (sum(x * (y - my) for x, y in zip(xs, ys)) / var
             if var > 1e-9 else 0.0)
    fit = ClockFit(offset=my, drift=drift, t_ref=t_ref,
                   sync_points=len(pairs))
    res = [y - (fit.offset + fit.drift * x) for x, y in zip(xs, ys)]
    fit.residual_rms = (sum(r * r for r in res) / len(res)) ** 0.5
    return fit


def align_clocks(ranks: Dict[int, List[Dict[str, Any]]]
                 ) -> Dict[int, ClockFit]:
    """Per-rank clock fits against rank 0 (or the lowest rank present)
    from the matched barrier release edges."""
    pids = sorted(ranks)
    edges = {pid: _barrier_edges(ranks[pid]) for pid in pids}
    ref = pids[0]
    fits = {ref: ClockFit(t_ref=0.0, sync_points=sum(
        len(v) for v in edges[ref].values()))}
    for pid in pids[1:]:
        pairs: List[Tuple[float, float]] = []
        for name, mine in edges[pid].items():
            ref_edges = edges[ref].get(name) or []
            for k in range(min(len(mine), len(ref_edges))):
                pairs.append((mine[k][1], ref_edges[k][1]))
        fits[pid] = _fit(pairs)
    return fits


def _phase_totals(events: Sequence[Dict[str, Any]]
                  ) -> Tuple[Dict[str, float], float, float]:
    """One rank's summed span durations by phase, plus the first span
    start and last span end (its OWN clock)."""
    totals: Dict[str, float] = {}
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    for rec in events:
        if rec.get("event") != "span":
            continue
        name = rec.get("name")
        # fmlint: disable=R001 -- parsed JSON event fields
        ts = float(rec.get("ts", rec.get("t", 0.0)))
        # fmlint: disable=R001 -- parsed JSON event fields
        dur = float(rec.get("dur", 0.0))
        phase = PHASE_SPANS.get(name)
        if phase is not None:
            totals[phase] = totals.get(phase, 0.0) + dur
        if name in PHASE_SPANS or name in BARRIER_SPANS:
            t_first = ts if t_first is None else min(t_first, ts)
            t_last = (ts + dur if t_last is None
                      else max(t_last, ts + dur))
    return totals, t_first or 0.0, t_last or 0.0


def _rank_examples(events: Sequence[Dict[str, Any]]) -> float:
    """The rank's cumulative example count from its LAST metrics
    event (counters are cumulative, so last wins)."""
    ex = 0.0
    for rec in events:
        if rec.get("event") != "metrics":
            continue
        c = rec.get("counters") or {}
        # fmlint: disable=R001 -- parsed JSON event field
        ex = float(c.get("train/examples",
                         c.get("predict/examples", 0.0)) or 0.0)
    return ex


def build_report(ranks: Dict[int, List[Dict[str, Any]]],
                 baseline_eps: Optional[float] = None
                 ) -> Dict[str, Any]:
    """The full anatomy report for per-rank event lists (the testable
    core; ``report(paths)`` is the file-reading wrapper).

    ``baseline_eps`` — a single-process examples/sec rate (e.g. the
    1-worker leg of ``bench.py --multihost``) — unlocks the absolute
    per-worker efficiency: useful compute time (examples /
    baseline_eps) over wall. Host spans alone cannot see stalls
    INSIDE the dispatched step program (the gradient allreduce runs
    in-program on multi-host), so without a baseline the report's
    ``efficiency`` is coordination efficiency — the host-visible
    barrier waits only."""
    if not ranks:
        return {"error": "no events — pass the chief metrics file "
                         "plus its .p<i> shards from a trace_spans "
                         "run"}
    fits = align_clocks(ranks)
    pids = sorted(ranks)
    edges = {pid: _barrier_edges(ranks[pid]) for pid in pids}

    # Split every matched barrier into straggler wait vs transport on
    # the aligned clock.
    straggler = {pid: 0.0 for pid in pids}
    transport = {pid: 0.0 for pid in pids}
    last_arrivals = {pid: 0 for pid in pids}
    per_barrier_wait: Dict[str, float] = {}
    names = set()
    for pid in pids:
        names.update(edges[pid])
    matched = 0
    for name in sorted(names):
        n = min(len(edges[pid].get(name) or []) for pid in pids)
        for k in range(n):
            arr = {pid: fits[pid].aligned(edges[pid][name][k][0])
                   for pid in pids}
            rel = {pid: fits[pid].aligned(edges[pid][name][k][1])
                   for pid in pids}
            last = max(arr.values())
            last_pid = max(pids, key=lambda p: arr[p])
            last_arrivals[last_pid] += 1
            matched += 1
            for pid in pids:
                s = max(0.0, last - arr[pid])
                t = max(0.0, rel[pid] - last)
                straggler[pid] += s
                transport[pid] += t
                per_barrier_wait[name] = (
                    per_barrier_wait.get(name, 0.0) + s + t)

    rank_rows: Dict[int, Dict[str, Any]] = {}
    for pid in pids:
        totals, t0, t1 = _phase_totals(ranks[pid])
        wall = max(1e-12, fits[pid].aligned(t1) - fits[pid].aligned(t0))
        phases = dict(totals)
        phases["straggler wait"] = straggler[pid]
        phases["transport"] = transport[pid]
        accounted = sum(phases.values())
        # Spans nest / overlap (train/h2d rides inside the step wall,
        # the lockstep fetch overlaps the next window's dispatch): the
        # fraction of accounted time beyond wall is the overlap the
        # protocol already wins.
        overlap = max(0.0, (accounted - wall) / accounted
                      if accounted > 0 else 0.0)
        phases["host (input+build+other)"] = max(0.0, wall - accounted)
        coord = straggler[pid] + transport[pid]
        eff = max(0.0, 1.0 - coord / wall)
        local = {k: v for k, v in phases.items()
                 if k not in WAIT_PHASES}
        dominant_local = (max(local, key=local.get) if local else "?")
        dominant = (max(phases, key=phases.get) if phases else "?")
        examples = _rank_examples(ranks[pid])
        rank_rows[pid] = {
            "wall_seconds": wall,
            "phases": phases,
            "efficiency": eff,
            "overlap_fraction": overlap,
            "last_arrivals": last_arrivals[pid],
            "dominant_phase": dominant,
            "dominant_local_phase": dominant_local,
            "examples": examples,
        }
        if baseline_eps:
            # Absolute per-worker efficiency: the time a lone worker
            # at the baseline rate would need for this rank's
            # examples, over the wall it actually took. The gap to
            # the coordination efficiency above is the stall INSIDE
            # the dispatched program.
            rank_rows[pid]["efficiency_vs_single"] = max(
                0.0, (examples / baseline_eps) / wall)

    # The straggler: the rank the others wait for most often. Its
    # dominant LOCAL phase is the why (its waits are a symptom).
    straggler_pid = max(pids, key=lambda p: last_arrivals[p])
    wall_mean = (sum(r["wall_seconds"] for r in rank_rows.values())
                 / len(rank_rows))
    s_tot = sum(straggler.values())
    t_tot = sum(transport.values())
    wall_tot = sum(r["wall_seconds"] for r in rank_rows.values())
    s_frac = s_tot / wall_tot if wall_tot else 0.0
    t_frac = t_tot / wall_tot if wall_tot else 0.0
    top_barrier = (max(per_barrier_wait, key=per_barrier_wait.get)
                   if per_barrier_wait else None)
    bar_label = (top_barrier or "collective").split("/")[-1]
    if top_barrier and s_frac >= t_frac and s_frac > 0.15:
        verdict = (
            f"{bar_label} straggler-wait {s_frac:.0%} of step; rank "
            f"{straggler_pid} "
            f"{rank_rows[straggler_pid]['dominant_local_phase']} is "
            f"the straggler")
    elif top_barrier and t_frac > 0.15:
        verdict = (
            f"{bar_label} transport {t_frac:.0%} of step (ranks "
            "arrive together; the wall is the collective itself — on "
            "CPU/gloo this also absorbs the previous step's queued "
            "device program)")
    else:
        dom = max(rank_rows[straggler_pid]["phases"],
                  key=rank_rows[straggler_pid]["phases"].get)
        frac = (rank_rows[straggler_pid]["phases"][dom]
                / rank_rows[straggler_pid]["wall_seconds"])
        if dom == "step dispatch" and len(pids) > 1:
            # The dominant time is inside the dispatched XLA program,
            # where the gradient allreduce runs on multi-host — host
            # spans cannot split that stall from compute. A baseline
            # rate (--baseline-eps / bench --multihost) quantifies it.
            verdict = (
                f"step dispatch {frac:.0%} of step — the wall is "
                "inside the dispatched program (in-program gradient "
                "allreduce + compute; host-visible barrier waits are "
                f"only {s_frac + t_frac:.0%})")
        else:
            verdict = (f"{dom} {frac:.0%} of step; no dominant "
                       "collective wait")
    eff_all = (sum(r["efficiency"] for r in rank_rows.values())
               / len(rank_rows))
    eff_single = None
    if baseline_eps and rank_rows:
        eff_single = (sum(r["efficiency_vs_single"]
                          for r in rank_rows.values())
                      / len(rank_rows))
        verdict += (f"; vs single-process rate, per-worker "
                    f"efficiency {eff_single:.2f}")
    return {
        "ranks": {pid: rank_rows[pid] for pid in pids},
        "clock": {pid: {
            "offset_ms": fits[pid].offset * 1e3,
            "drift_ppm": fits[pid].drift * 1e6,
            "sync_points": fits[pid].sync_points,
            "residual_ms": fits[pid].residual_rms * 1e3,
        } for pid in pids},
        "matched_barriers": matched,
        "top_barrier": top_barrier,
        "straggler_rank": straggler_pid,
        "straggler_wait_fraction": s_frac,
        "transport_fraction": t_frac,
        "efficiency": eff_all,
        "efficiency_vs_single": eff_single,
        "wall_seconds_mean": wall_mean,
        "verdict": verdict,
    }


def report(paths: Sequence[str],
           baseline_eps: Optional[float] = None) -> Dict[str, Any]:
    """File-reading entry point for ``fmtrace --anatomy``."""
    return build_report(events_by_rank(paths),
                        baseline_eps=baseline_eps)


def render(rep: Dict[str, Any]) -> str:
    """The human report, one string (the CLI prints it verbatim)."""
    if "error" in rep:
        return rep["error"]
    lines: List[str] = []
    lines.append("STEP ANATOMY  (clock-aligned critical path; "
                 f"{rep['matched_barriers']} matched barriers)")
    for pid, c in sorted(rep["clock"].items()):
        lines.append(
            f"  rank {pid} clock: offset {c['offset_ms']:+.3f} ms, "
            f"drift {c['drift_ppm']:+.1f} ppm, "
            f"{c['sync_points']} sync points, "
            f"residual {c['residual_ms']:.3f} ms rms")
    for pid, r in sorted(rep["ranks"].items()):
        vs = ("" if "efficiency_vs_single" not in r else
              f" ({r['efficiency_vs_single']:.2f} vs single)")
        lines.append(
            f"  rank {pid}: wall {r['wall_seconds']:.3f} s, "
            f"efficiency {r['efficiency']:.2f}{vs}, overlap "
            f"{r['overlap_fraction']:.0%}, last-to-arrive "
            f"{r['last_arrivals']}x")
        wall = r["wall_seconds"]
        for phase, v in sorted(r["phases"].items(),
                               key=lambda kv: -kv[1]):
            if v <= 0:
                continue
            lines.append(
                f"    {phase:<28s} {v:9.3f} s  {v / wall:6.1%}")
    lines.append(
        f"  straggler: rank {rep['straggler_rank']} "
        f"(straggler-wait {rep['straggler_wait_fraction']:.0%}, "
        f"transport {rep['transport_fraction']:.0%} of step)")
    lines.append(f"  verdict: {rep['verdict']}")
    return "\n".join(lines)
