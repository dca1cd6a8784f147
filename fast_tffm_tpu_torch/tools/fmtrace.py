"""fmtrace — export a run's metrics JSONL stream to Perfetto.

The port's copy of the JAX package's ``tools/fmtrace``, over the port's
obs/ modules, with the same output text and exit codes (held by
``tests/test_torch_obs_readers.py``); it reads the streams of either
package.

    python -m fast_tffm_tpu_torch.tools.fmtrace <metrics.jsonl> [more shards...] [-o out.json]
    python -m fast_tffm_tpu_torch.tools.fmtrace --collectives <metrics.jsonl> <metrics>.p*
    python -m fast_tffm_tpu_torch.tools.fmtrace --anatomy [--json] <metrics.jsonl> <metrics>.p*

The second form skips the Perfetto export and diffs the per-rank
collective sequences a ``protocol_trace = true`` run records (exit 1
naming the first mismatching rank/position/label) — the runtime oracle
for fmlint's R014 protocol checker, and the first diagnostic for a
hung multi-host cluster.

The third form renders the cross-rank step-anatomy report
(obs/anatomy.py; README "Step anatomy"): clock-aligned phase accounts,
straggler-wait vs transport split of every matched barrier, per-worker
efficiency recomputed from the phases, and a named verdict. Needs a
``trace_spans = true`` run (all shards together); ``--json`` emits the
machine-readable report instead of the table.

Converts the obs/ telemetry stream (spans, gauges, scalars, health and
crash events) into Chrome trace-event JSON loadable in ui.perfetto.dev
(or chrome://tracing). Pass a multi-process run's chief file plus its
``.p<i>`` worker shards together (a glob works): each process becomes
its own Perfetto process track (pid = process index), and each
span-emitting thread (main loop, prefetch, fetcher, watchdog) its own
row within it — so a cluster's timeline reads as one aligned picture,
wall-clock synced across workers.

Mapping:

- ``span`` events -> complete ("X") slices: ``ts`` is the span's wall
  start, ``dur`` its measured duration, extra span fields ride in
  ``args``.
- ``metrics`` events -> counter ("C") tracks for every numeric gauge
  (examples/sec and friends), sampled at the flush cadence.
- ``scalar`` events (loss, validation AUC) -> counter tracks too.
  Their timestamp is EMISSION time (the epoch barrier that fetched
  them), not the step's wall time — the step number is in ``args``.
- ``health`` / ``crash`` / ``run_start`` / ``run_end`` -> instant
  ("i") markers, so a stall or crash is visible in place on the
  timeline.

Pure functions over parsed events — shared by the CLI
and tests.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Optional, Sequence

from fast_tffm_tpu_torch.obs.sink import read_events
from fast_tffm_tpu_torch.tools.streams import expand_stream_args


def _us(t: float) -> float:
    """Seconds -> the microseconds the trace-event format speaks."""
    return t * 1e6


# Counter-track unit suffixes, checked in order against the metric
# name: Perfetto counter tracks have no unit axis, so the unit rides
# in the track name (a bytes track next to a seconds track is
# otherwise two unlabeled squiggles).
_UNIT_RULES = (
    ("_ms", "ms"),
    ("seconds", "s"),
    ("bytes", "B"),
    ("per_sec", "1/s"),
    ("examples", "examples"),
    ("fraction", "ratio"),  # mem/utilization_fraction and kin
)


def counter_track(name: str) -> str:
    """The Perfetto track name for a counter/gauge: the metric name
    plus its unit in brackets when the name declares one."""
    for frag, unit in _UNIT_RULES:
        if frag in name:
            return f"{name} [{unit}]"
    return name


class _TidMap:
    """Stable small ints per (pid, thread-name), plus the metadata
    events that name the rows in the UI. tid 0 is reserved for the
    per-process counter tracks."""

    def __init__(self):
        self._map: Dict[tuple, int] = {}
        self.meta: List[Dict[str, Any]] = []

    def tid(self, pid: int, name: Optional[str]) -> int:
        name = name or "main"
        key = (pid, name)
        t = self._map.get(key)
        if t is None:
            t = self._map[key] = len(
                [k for k in self._map if k[0] == pid]) + 1
            self.meta.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                "args": {"name": name}})
        return t


def to_trace_events(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """The traceEvents list for one run's files (chief + shards)."""
    out: List[Dict[str, Any]] = []
    tids = _TidMap()
    named_pids = set()
    # Last value per (pid -> counter track): re-emitted at run_end so
    # a short run's single-sample counters still render as a line
    # (Perfetto draws nothing for a one-point counter track).
    last_counters: Dict[int, Dict[str, float]] = {}
    # protocol_trace collective events, for cross-rank flow arrows.
    collectives: List[Dict[str, Any]] = []
    for path in paths:
        pid = 0  # until a run_start announces the real process index
        for rec in read_events(path):
            ev = rec.get("event")
            t = rec.get("t", 0.0)
            if ev == "run_start":
                meta = rec.get("meta") or {}
                pid = int(meta.get("process_index") or 0)
                if pid not in named_pids:
                    named_pids.add(pid)
                    out.append({
                        "ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0,
                        "args": {"name": f"worker {pid} "
                                         f"({meta.get('kind', '?')})"}})
                out.append(_instant("run_start", t, pid))
            elif ev == "span":
                extra = {k: v for k, v in rec.items()
                         if k not in ("event", "t", "name", "ts", "dur",
                                      "tid")}
                out.append({
                    "ph": "X", "cat": "span", "name": rec.get("name", "?"),
                    "pid": pid, "tid": tids.tid(pid, rec.get("tid")),
                    "ts": _us(rec.get("ts", t)),
                    "dur": _us(rec.get("dur", 0.0)),
                    "args": extra,
                })
            elif ev == "metrics":
                for name, v in (rec.get("gauges") or {}).items():
                    if isinstance(v, (int, float)) and math.isfinite(v):
                        track = counter_track(name)
                        out.append({
                            "ph": "C", "name": track, "pid": pid,
                            "tid": 0, "ts": _us(t),
                            "args": {"value": v}})
                        last_counters.setdefault(pid, {})[track] = v
            elif ev == "scalar":
                val = rec.get("value")
                if isinstance(val, (int, float)) and math.isfinite(val):
                    # args holds ONLY the value: every args key of a
                    # "C" event is its own plotted series, so a step
                    # number here would stack a huge second series
                    # that flattens the one being shown.
                    track = counter_track(rec.get("name", "scalar"))
                    out.append({
                        "ph": "C", "name": track,
                        "pid": pid, "tid": 0, "ts": _us(t),
                        "args": {"value": val}})
                    last_counters.setdefault(pid, {})[track] = val
            elif ev == "collective":
                collectives.append({
                    "pid": pid, "t": t,
                    "seq": rec.get("seq", 0),
                    "label": str(rec.get("label", "?"))})
            elif ev == "health":
                out.append(_instant(
                    f"health: {rec.get('status', '?')}", t, pid,
                    args={k: v for k, v in rec.items()
                          if k not in ("event", "t")}))
            elif ev == "crash":
                out.append(_instant(
                    "crash: " + str(rec.get("error", "?"))[:120], t, pid,
                    args={"step": rec.get("step")}))
            elif ev == "run_end":
                # Close every counter track with its last value at the
                # run's end so short runs draw a visible line instead
                # of a single invisible point.
                for track, v in sorted(
                        (last_counters.get(pid) or {}).items()):
                    out.append({
                        "ph": "C", "name": track, "pid": pid,
                        "tid": 0, "ts": _us(t),
                        "args": {"value": v}})
                out.append(_instant("run_end", t, pid))
    out.extend(_collective_flows(collectives, tids))
    out.extend(tids.meta)
    # Stable paint order: metadata first, then by timestamp.
    out.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return out


def _collective_flows(collectives: List[Dict[str, Any]],
                      tids: "_TidMap") -> List[Dict[str, Any]]:
    """Cross-rank flow arrows between matched collective events: the
    same seq on every rank IS the same collective (the protocol-trace
    invariant fmtrace --collectives checks), so each seq becomes one
    Perfetto flow threading every rank's marker slice. The arrows make
    a lagging rank visually obvious: its slice sits to the right and
    every arrow into it slopes."""
    out: List[Dict[str, Any]] = []
    by_seq: Dict[Any, List[Dict[str, Any]]] = {}
    for c in collectives:
        by_seq.setdefault(c["seq"], []).append(c)
    for seq, group in sorted(by_seq.items(),
                             key=lambda kv: str(kv[0])):
        group.sort(key=lambda c: c["t"])
        for c in group:
            # A tiny slice per rank (flows bind to slices, not
            # instants), on a dedicated per-process row.
            tid = tids.tid(c["pid"], "collectives")
            out.append({
                "ph": "X", "cat": "collective",
                "name": c["label"], "pid": c["pid"], "tid": tid,
                "ts": _us(c["t"]), "dur": 50.0,
                "args": {"seq": seq}})
        if len(group) < 2:
            continue
        for i, c in enumerate(group):
            ph = ("s" if i == 0
                  else "f" if i == len(group) - 1 else "t")
            ev = {
                "ph": ph, "cat": "collective",
                "name": c["label"], "id": int(seq),
                "pid": c["pid"],
                "tid": tids.tid(c["pid"], "collectives"),
                "ts": _us(c["t"]) + 1.0}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return out


def _instant(name: str, t: float, pid: int,
             args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    rec = {"ph": "i", "s": "p", "name": name, "pid": pid, "tid": 0,
           "ts": _us(t)}
    if args:
        rec["args"] = args
    return rec


def collective_sequences(paths: Sequence[str]
                         ) -> Dict[int, List[str]]:
    """Per-rank ordered collective label sequences from the
    ``collective`` events a run under ``protocol_trace = true`` (or
    ``FM_PROTOCOL_TRACE=1``) emits — process index -> labels ordered
    by the emitting rank's own sequence counter."""
    raw: Dict[int, List[tuple]] = {}
    for path in paths:
        pid = 0  # until a run_start announces the real process index
        for rec in read_events(path):
            ev = rec.get("event")
            if ev == "run_start":
                meta = rec.get("meta") or {}
                pid = int(meta.get("process_index") or 0)
            elif ev == "collective":
                raw.setdefault(pid, []).append(
                    (int(rec.get("seq", 0)),
                     str(rec.get("label", "?"))))
    return {pid: [label for _, label in sorted(entries)]
            for pid, entries in raw.items()}


def diff_collectives(seqs: Dict[int, List[str]],
                     out=None) -> int:
    """The protocol-divergence verdict fmlint R014 proves statically,
    checked against a real run: 0 when every rank posted the
    bit-identical collective sequence, 1 with the first mismatching
    (rank, position, label) pair named otherwise. The first divergent
    entry IS the deadlock diagnosis: the rank whose label differs (or
    whose stream ended early) is the one whose peers are parked."""
    out = out if out is not None else sys.stderr
    if not seqs:
        print("no collective events found — was the run traced? "
              "(protocol_trace = true, or FM_PROTOCOL_TRACE=1)",
              file=out)
        return 1
    pids = sorted(seqs)
    n = max(len(seqs[p]) for p in pids)
    for i in range(n):
        at = {p: (seqs[p][i] if i < len(seqs[p]) else None)
              for p in pids}
        if len(set(at.values())) > 1:
            print(f"collective sequences DIVERGE at position {i}:",
                  file=out)
            for p in pids:
                label = at[p] if at[p] is not None else \
                    "<end of sequence>"
                print(f"  rank {p}: {label}", file=out)
            return 1
    print(f"{len(pids)} rank(s), {n} collective(s) each — "
          "sequences identical", file=out)
    return 0


def convert(paths: Sequence[str], out_path: str) -> int:
    """Write the Perfetto JSON for ``paths``; returns the event count."""
    events = to_trace_events(paths)
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fmtrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="+",
                    help="metrics JSONL file(s); pass the chief file "
                         "plus its .p<i> worker shards (globs ok)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <first file>.trace.json)")
    ap.add_argument("--collectives", action="store_true",
                    help="diff the per-rank collective sequences "
                         "(protocol_trace runs) instead of exporting "
                         "a Perfetto trace; exit 1 on divergence")
    ap.add_argument("--anatomy", action="store_true",
                    help="render the cross-rank step-anatomy report "
                         "(obs/anatomy.py) from a trace_spans run's "
                         "shards instead of exporting a trace")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="with --anatomy: emit the machine-readable "
                         "report instead of the table")
    ap.add_argument("--baseline-eps", type=float, default=None,
                    help="with --anatomy: a single-process "
                         "examples/sec rate (e.g. bench.py "
                         "--multihost's 1-worker leg); unlocks "
                         "absolute per-worker efficiency = useful "
                         "compute time / wall, which also counts "
                         "stalls inside the dispatched program")
    args = ap.parse_args(argv)
    # Shared glob + fail-loudly-on-unreadable policy (tools/streams.py).
    files = expand_stream_args(args.files)
    if args.anatomy:
        from fast_tffm_tpu_torch.obs import anatomy
        rep = anatomy.report(files, baseline_eps=args.baseline_eps)
        if args.as_json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            print(anatomy.render(rep))
        return 1 if "error" in rep else 0
    if args.collectives:
        return diff_collectives(collective_sequences(files))
    out_path = args.out or files[0] + ".trace.json"
    n = convert(files, out_path)
    print(f"wrote {n} trace events from {len(files)} file(s) to "
          f"{out_path}\nopen in https://ui.perfetto.dev (Open trace "
          "file)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
