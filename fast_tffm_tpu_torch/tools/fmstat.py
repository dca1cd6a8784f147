"""fmstat — summarize, tail, follow, or SLO-check a metrics stream.

The port's copy of the JAX package's ``tools/fmstat``, over the port's
obs/ modules, with the same output text and exit codes (held by
``tests/test_torch_obs_readers.py``); it reads the streams of either
package.

The read-side of the obs/ telemetry subsystem:

    python -m fast_tffm_tpu_torch.tools.fmstat <metrics.jsonl> [more shards...]
    python -m fast_tffm_tpu_torch.tools.fmstat --json <metrics.jsonl>
    python -m fast_tffm_tpu_torch.tools.fmstat --tail <metrics.jsonl>
    python -m fast_tffm_tpu_torch.tools.fmstat --follow '<metrics.jsonl>*'
    python -m fast_tffm_tpu_torch.tools.fmstat slo <metrics.jsonl> [shards...] [--json]
    python -m fast_tffm_tpu_torch.tools.fmstat capacity <cfg> [--kind serve]
        [--what-if vocabulary_size=N,dtype=f16,shards=K]

Summary mode merges every given file (a multi-process run's chief file
plus its ``.p<i>`` worker shards — pass a glob) through the registry's
merge rules (counters add, histograms bucket-merge, gauges per
process) and renders the same attribution table bench.py's breakdown
teaches: examples/sec, step-time quantiles, input-wait / pause /
transfer split, dedup hit rate, padding waste, and a host-bound vs
device/transfer-bound vs pause-bound verdict. Multi-worker runs with
the heartbeat lease on additionally get a per-worker liveness table
(last heartbeat age, lockstep windows, examples; LOST flag on workers
named by a ``worker_lost`` diagnosis) and the
``DEGRADED (N workers lost)`` health verdict (README "Elastic
multi-host"). Streaming runs (``run_mode = stream``) get a STREAMING
section — watermark lag, files discovered/sealed/truncated/deleted,
publishes, last-publish age — and the health verdict reads
``STALE PUBLISH`` when the last publish age exceeds 3x the configured
interval (the serving fleet is reloading stale state). A replica
supervisor's stream (``serve --replicas N``; README "Serving fleet")
grows a FLEET section — per-replica alive/ready/step/queue rows plus
proxy traffic, retry, and shed counters — and the health verdict
reads ``FLEET DEGRADED (k/N ready)`` while any replica is down or
warming (ranked above the staleness verdicts: a capacity gap is more
urgent than a stale pointer). ``--json``
emits the merged summary + attribution as one JSON object for
scripting. ``--tail`` follows a live file and pretty-prints events as
they land. ``--follow`` re-renders the full summary + verdict on a
poll interval as the stream grows — the "watch a live soak" mode —
re-expanding the file globs each poll so per-worker ``.p<i>`` shards
appearing mid-run join the merge. The ``slo`` subcommand evaluates
the run's declared service-level objectives (the ``slo/*`` gauges the
[SLO] config section stamps into the stream, or ``--config <file>``)
and prints a per-objective PASS/FAIL table (``--json`` for the
machine form), exiting non-zero on any FAIL — the one scriptable
"is this deployment healthy" answer (README "SLOs & quality gate").
The ``capacity`` subcommand is the planner's CLI (obs/memory.py;
README "Memory observability"): predicted per-owner resident device
bytes for a config — before the run exists — against device capacity,
with ``--what-if`` overrides for the sharding/quantization frontiers;
exits non-zero on an EXCEEDS verdict. Runs with the ledger on grow a
MEMORY section here and an ``HBM-PRESSURE`` health verdict.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from fast_tffm_tpu_torch.obs.attribution import (attribution, health_verdict,
                                           render, summarize)
from fast_tffm_tpu_torch.tools.streams import expand_stream_args


def _tail(path: str, out=sys.stdout) -> None:  # pragma: no cover - loop
    """Follow a live metrics file; one formatted line per event."""
    with open(path, "r", encoding="utf-8") as fh:
        while True:
            line = fh.readline()
            if not line:
                time.sleep(0.5)
                continue
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail mid-write; the rest follows
            out.write(_format_event(rec) + "\n")
            out.flush()


def _format_event(rec: dict) -> str:
    ev = rec.get("event", "?")
    if ev == "metrics":
        c = rec.get("counters", {})
        g = rec.get("gauges", {})
        eps = g.get("train/examples_per_sec_window") or g.get(
            "predict/examples_per_sec")
        bits = [f"step={rec.get('step')}"]
        if eps:
            bits.append(f"ex/s={eps:,.0f}")
        for key, label in (("train/examples", "examples"),
                           ("pipeline/parse_errors", "parse_errs"),
                           ("pipeline/spilled_batches", "spills")):
            if c.get(key):
                bits.append(f"{label}={c[key]:,.0f}")
        return f"[metrics] {' '.join(bits)}"
    if ev == "scalar":
        return (f"[scalar]  {rec.get('name')} step={rec.get('step')} "
                f"value={rec.get('value'):.6g}")
    if ev == "run_start":
        m = rec.get("meta", {})
        return (f"[run]     kind={m.get('kind')} backend={m.get('backend')} "
                f"devices={m.get('device_count')} config="
                f"{m.get('config_hash')} git={m.get('git_rev')}")
    return f"[{ev}] " + json.dumps(
        {k: v for k, v in rec.items() if k not in ("event",)},
        default=str)[:200]


def _expand_tolerant(patterns) -> list:
    """Glob expansion that tolerates not-yet-existing inputs — the
    --follow seam (a live run's worker shards appear over time; the
    strict expand_stream_args policy would kill the watch loop on the
    very race it exists to observe). Literal paths are kept only once
    they exist."""
    import glob as globlib
    import os
    files = []
    for p in patterns:
        hits = sorted(globlib.glob(p))
        if hits:
            files.extend(hits)
        elif os.path.exists(p):
            files.append(p)
    return files


def _follow(patterns, interval: float = 2.0, out=sys.stdout,
            iterations=None) -> int:
    """Poll-based live summary: re-expand the globs, re-merge, and
    re-render the full table + verdict every ``interval`` seconds
    until interrupted (``iterations`` bounds the loop for tests)."""
    n = 0
    while iterations is None or n < iterations:
        files = _expand_tolerant(patterns)
        if files:
            try:
                body = render(summarize(files))
            except OSError as e:
                body = f"(stream unreadable this poll: {e})"
        else:
            body = f"waiting for {' '.join(patterns)} ..."
        if out.isatty():
            out.write("\x1b[2J\x1b[H")  # clear + home: a live panel
        stamp = time.strftime("%H:%M:%S")
        out.write(f"-- fmstat --follow {stamp} "
                  f"({len(files)} file(s)) --\n{body}\n")
        out.flush()
        n += 1
        if iterations is None or n < iterations:
            time.sleep(interval)
    return 0


def main_slo(argv=None) -> int:
    """The ``fmstat slo`` subcommand: PASS/FAIL table per declared
    objective; exit 1 on any FAIL."""
    from fast_tffm_tpu_torch.obs.slo import (SloSpec, evaluate_slos, overall,
                                       render_slo, results_json)
    ap = argparse.ArgumentParser(
        prog="fmstat slo",
        description="evaluate a run's declared SLOs over its metrics "
                    "stream (README 'SLOs & quality gate')")
    ap.add_argument("files", nargs="+",
                    help="metrics JSONL file(s); globs ok")
    ap.add_argument("--json", action="store_true",
                    help="emit the spec + per-objective results as "
                         "JSON")
    ap.add_argument("--config", default="",
                    help="read the SLO spec from this config file "
                         "instead of the stream's slo/* gauges")
    ap.add_argument("--allow-skip", action="store_true",
                    help="exit 0 even when a configured objective had "
                         "no supporting data (default: exit 2 — a "
                         "declared objective that was never measured "
                         "must not read green in a monitor)")
    args = ap.parse_args(argv)
    files = expand_stream_args(args.files)
    summary = summarize(files)
    if args.config:
        from fast_tffm_tpu_torch.config import load_config
        spec = SloSpec.from_config(load_config(args.config))
    else:
        spec = SloSpec.from_summary(summary)
    results = evaluate_slos(spec, summary)
    if args.json:
        out = results_json(spec, results)
        out["health"] = health_verdict(summary)
        print(json.dumps(out, default=str))
    else:
        print(render_slo(spec, results))
        hv = health_verdict(summary)
        print(f"health: {hv['verdict']} — {hv['detail']}")
    if overall(results) == "FAIL":
        return 1
    # SKIP (and an EMPTY spec) are visible in the output, but at the
    # exit-code level (the scriptable surface) neither may read green:
    # an unmeasured declared objective — or a stream that carries no
    # slo/* gauges at all because the metrics file was rotated or
    # truncated — is exactly when a monitor wired to this command must
    # fire, not stay silent.
    if args.allow_skip:
        return 0
    if not results or any(r.status == "SKIP" for r in results):
        return 2
    return 0


def main_capacity(argv=None) -> int:
    """The ``fmstat capacity`` subcommand: predict resident device
    bytes per owner from a CONFIG (no stream needed — sizing happens
    before the run exists) against the device capacity, with --what-if
    overrides for the capacity frontiers (sharded tables, f16/int8
    resident tables). Exit 1 on an EXCEEDS verdict — scriptable as a
    deploy gate."""
    from fast_tffm_tpu_torch.obs.memory import (parse_what_if, plan,
                                          render_plan)
    ap = argparse.ArgumentParser(
        prog="fmstat capacity",
        description="predict per-owner resident device bytes for a "
                    "config against device capacity (README 'Memory "
                    "observability')")
    ap.add_argument("config", help="config file to size")
    ap.add_argument("--kind", choices=("train", "serve"),
                    default="train",
                    help="which resident set to plan: the train "
                         "session's (table+optimizer+wire) or the "
                         "server's (table + old+new reload transient)")
    ap.add_argument("--what-if", default="", dest="what_if",
                    metavar="K=V[,K=V...]",
                    help="overrides: vocabulary_size, factor_num, "
                         "field_num, batch_size, "
                         "max_features_per_example, dtype "
                         "(f32|f16|bf16|int8, resident table only), "
                         "shards (per-device share under row "
                         "sharding)")
    ap.add_argument("--capacity-bytes", type=int, default=0,
                    help="assume this device capacity instead of "
                         "asking the backend (sizing for a target "
                         "chip from a dev box)")
    ap.add_argument("--json", action="store_true",
                    help="emit the plan as JSON")
    args = ap.parse_args(argv)
    from fast_tffm_tpu_torch.config import load_config
    cfg = load_config(args.config)
    overrides = parse_what_if(args.what_if)
    p = plan(cfg, args.kind, overrides)
    if args.capacity_bytes:
        p["capacity_bytes"] = args.capacity_bytes
        p["utilization_fraction"] = (p["total_bytes"]
                                     / float(args.capacity_bytes))
        p["verdict"] = ("EXCEEDS"
                        if p["total_bytes"] > args.capacity_bytes
                        else "FITS")
    if args.json:
        print(json.dumps(p, default=str))
    else:
        print(render_plan(p))
    return 1 if p["verdict"] == "EXCEEDS" else 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "slo":
        return main_slo(argv[1:])
    if argv and argv[0] == "capacity":
        return main_capacity(argv[1:])
    ap = argparse.ArgumentParser(
        prog="fmstat", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="+",
                    help="metrics JSONL file(s); globs ok — pass a "
                         "run's worker shards together to merge them")
    ap.add_argument("--json", action="store_true",
                    help="emit merged summary + attribution as JSON")
    ap.add_argument("--tail", action="store_true",
                    help="follow the (first) file, print events live")
    ap.add_argument("--follow", action="store_true",
                    help="re-render the merged summary + verdict as "
                         "the stream grows (globs re-expanded each "
                         "poll, so worker shards join live)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--follow poll interval in seconds")
    args = ap.parse_args(argv)
    if args.follow:
        try:
            return _follow(args.files, interval=args.interval)
        except KeyboardInterrupt:
            return 0
    # Shared glob + fail-loudly-on-unreadable policy (tools/streams.py).
    files = expand_stream_args(args.files)
    if args.tail:
        try:
            _tail(files[0])
        except KeyboardInterrupt:
            return 0
        return 0
    summary = summarize(files)
    if args.json:
        out = dict(summary)
        out.pop("scalars", None)
        out["attribution"] = attribution(summary)
        out["health"] = health_verdict(summary)
        print(json.dumps(out, default=str))
        return 0
    print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
