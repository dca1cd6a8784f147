"""The port's readers against the JAX package's: ``obs/attribution.py``,
``obs/anatomy.py``, ``tools/fmstat.py`` and ``tools/fmtrace.py`` are
copies, and on the same streams they must give the JAX modules' output
text for text and exit code for exit code: summaries, attribution,
health verdicts, the rendered table, the Perfetto export, ``--json``,
``slo``, ``--collectives`` and the ``--anatomy`` report.

The streams are the JAX tests' own synthetic inputs
(``tests/test_anatomy.py``'s clock-skewed rank streams, the EFFICIENCY
shards, ``tests/test_fleet.py``'s FLEET section, the multi-worker
Perfetto round trip of ``tests/test_health_trace.py``), and streams the
two packages' telemetry writes through the same calls: spans and
gauges of two workers, the health events of a shrink and a grow, a
crash, a stall, a doctored protocol trace. The real runs' streams are
read in ``test_torch_obs_dist.py`` and ``test_torch_obs_fleet.py``."""

import json
import os
import sys
import time
import types

import pytest

import fast_tffm_tpu.obs.health as j_health
import fast_tffm_tpu.obs.telemetry as j_tel
import fast_tffm_tpu.obs.trace as j_trace
import fast_tffm_tpu.parallel.liveness as j_live
import fast_tffm_tpu_torch.obs.health as p_health
import fast_tffm_tpu_torch.obs.telemetry as p_tel
import fast_tffm_tpu_torch.obs.trace as p_trace
import fast_tffm_tpu_torch.parallel.liveness as p_live
from fast_tffm_tpu.obs import anatomy as j_anatomy
from fast_tffm_tpu.obs import attribution as j_attr
from fast_tffm_tpu_torch.obs import anatomy as p_anatomy
from fast_tffm_tpu_torch.obs import attribution as p_attr
from fast_tffm_tpu_torch.tools import fmstat as p_fmstat
from fast_tffm_tpu_torch.tools import fmtrace as p_fmtrace
from tools import fmstat as j_fmstat
from tools import fmtrace as j_fmtrace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_anatomy as jt_anatomy  # noqa: E402
import test_fleet as jt_fleet  # noqa: E402

# Each package's telemetry modules, by side.
SIDES = {side: types.SimpleNamespace(tel=t, health=h, live=lv, trace=tr)
         for side, t, h, lv, tr in (
             ("jax", j_tel, j_health, j_live, j_trace),
             ("port", p_tel, p_health, p_live, p_trace))}


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=repr)


# -- anatomy: the JAX tests' synthetic rank streams -------------------------

def _in_program_ranks():
    """tests/test_anatomy.py::test_in_program_wall_verdict's streams."""
    b0, b1, l0, l1 = [], [], [], []
    for k in range(10):
        t = 0.1 * k
        l0.append(("train/step", t, 0.08))
        l1.append(("train/step", t, 0.08))
        b0.append(("train/step_flags", t + 0.085, t + 0.09))
        b1.append(("train/step_flags", t + 0.085, t + 0.09))
    return {0: jt_anatomy._rank_events(0, jt_anatomy._clock(0.0, 0.0),
                                       b0, l0),
            1: jt_anatomy._rank_events(1, jt_anatomy._clock(0.0, 0.0),
                                       b1, l1)}


def _baseline_ranks():
    """test_baseline_eps_prices_the_in_program_stall's streams."""
    ranks = jt_anatomy._straggler_streams()
    for pid in (0, 1):
        ranks[pid].append({"event": "metrics", "t": 2.1, "step": 20,
                           "counters": {"train/examples": 400.0},
                           "gauges": {}, "hists": {}})
    return ranks


def _lockstep_ranks():
    """Both barrier kinds of the lockstep sweep (a validation window
    after the steps), rank 1 late at the window's all-gather."""
    b0, b1, l0, l1 = [], [], [], []
    for k in range(6):
        t = 0.1 * k
        b0.append(("train/step_flags", t + 0.01, t + 0.02))
        b1.append(("train/step_flags", t + 0.015, t + 0.02))
        l0.append(("train/step", t + 0.02, 0.05))
        l1.append(("train/step", t + 0.02, 0.05))
    for k in range(4):
        t = 1.0 + 0.05 * k
        b0.append(("lockstep/allgather", t, t + 0.02))
        b1.append(("lockstep/allgather", t + 0.018, t + 0.02))
        l0 += [("lockstep/window_fill", t - 0.01, 0.01),
               ("lockstep/score_dispatch", t + 0.02, 0.01),
               ("lockstep/score_fetch", t + 0.03, 0.005)]
        l1 += [("lockstep/window_fill", t - 0.01, 0.028),
               ("lockstep/score_dispatch", t + 0.02, 0.01),
               ("lockstep/score_fetch", t + 0.03, 0.005)]
    return {0: jt_anatomy._rank_events(0, jt_anatomy._clock(0.0, 0.0),
                                       b0, l0),
            1: jt_anatomy._rank_events(1, jt_anatomy._clock(0.2, 1e-4),
                                       b1, l1)}


ANATOMY_CASES = {
    "skewed_straggler": (lambda: jt_anatomy._straggler_streams(
        offset=3.7, drift=50e-6), None),
    "straggler": (jt_anatomy._straggler_streams, None),
    "cli_offset": (lambda: jt_anatomy._straggler_streams(offset=1.25),
                   None),
    "transport": (lambda: jt_anatomy._straggler_streams(
        late=0.0, transport=0.03), None),
    "baseline_eps": (_baseline_ranks, 1000.0),
    "in_program": (_in_program_ranks, None),
    "lockstep_windows": (_lockstep_ranks, None),
    "empty": (dict, None),
}


@pytest.mark.parametrize("case", sorted(ANATOMY_CASES))
def test_anatomy_report_is_the_jax_modules(case):
    build, eps = ANATOMY_CASES[case]
    j = j_anatomy.build_report(build(), baseline_eps=eps)
    p = p_anatomy.build_report(build(), baseline_eps=eps)
    assert _dump(p) == _dump(j)
    assert p_anatomy.render(p) == j_anatomy.render(j)


def test_anatomy_reports_say_what_the_jax_tests_say():
    rep = p_anatomy.build_report(jt_anatomy._straggler_streams(
        offset=3.7, drift=50e-6))
    assert rep["straggler_rank"] == 1
    assert rep["clock"][1]["offset_ms"] == pytest.approx(-3700.0, abs=1.0)
    assert rep["top_barrier"] == "train/step_flags"
    assert "transport" in p_anatomy.build_report(
        jt_anatomy._straggler_streams(late=0.0, transport=0.03))["verdict"]
    assert "inside the dispatched program" in p_anatomy.build_report(
        _in_program_ranks())["verdict"]
    assert "error" in p_anatomy.build_report({})
    assert p_anatomy.BARRIER_SPANS == j_anatomy.BARRIER_SPANS


# -- streams on disk --------------------------------------------------------

def _write(tmp_path, ranks):
    return jt_anatomy._write_streams(tmp_path, ranks)


def _efficiency_files(tmp_path):
    """test_fmstat_renders_efficiency_section's two shards."""
    paths = []
    for pid in (0, 1):
        p = str(tmp_path / ("m.jsonl" if pid == 0 else f"m.jsonl.p{pid}"))
        with open(p, "w") as fh:
            fh.write(json.dumps(
                {"event": "run_start", "t": 0.0,
                 "meta": {"kind": "train", "process_index": pid}}) + "\n")
            fh.write(json.dumps(
                {"event": "metrics", "t": 10.0, "step": 100,
                 "run": {"kind": "train", "process_index": pid},
                 "counters": {"train/examples": 640.0},
                 "gauges": jt_anatomy._proc_gauges(
                     10.0, 4.0 - 3.0 * pid, 1.0, 640.0),
                 "hists": {}}) + "\n")
        paths.append(p)
    return paths


def _written(side, tmp_path, body, workers=2, **tel_kw):
    """Streams the ``side`` package's telemetry writes: one
    ``RunTelemetry`` a worker (the chief ``m.jsonl``, worker p its
    ``.p<p>``), active while ``body(p, tel, mods)`` runs (``mods``: the
    side's telemetry modules), closed after; ``body`` returns the step
    the stream closes at."""
    mods = SIDES[side]
    paths = []
    for p in range(workers):
        path = str(tmp_path / ("m.jsonl" if p == 0 else f"m.jsonl.p{p}"))
        tel = mods.tel.RunTelemetry(
            path, meta={"kind": "train", "process_index": p,
                        "process_count": workers}, **tel_kw)
        with mods.tel.activate(tel):
            step = body(p, tel, mods)
        tel.close(step)
        paths.append(path)
    return paths


def _spans_and_gauges(p, tel, m):
    """test_fmtrace_roundtrip_multiworker's body."""
    with m.trace.span("train/step", step=1):
        time.sleep(0.002)
    with m.trace.span("checkpoint/save"):
        pass
    tel.set("train/examples_per_sec_window", 1000.0 + p)
    return 1


def _lost_then_recovered(grow):
    def body(p, tel, m):
        tel.count("train/examples", 64.0)
        tel.set("worker/heartbeat_age_seconds", 0.1)
        if p == 0:
            dead = m.live.PeerInfo(1, host="h", pid=7, age_seconds=4.5)
            m.health.emit_worker_lost([dead], label="train/step_flags",
                                      error="RuntimeError: Connection "
                                            "reset")
            m.health.emit_worker_lost([dead], label="heartbeat_monitor")
            m.health.emit_elastic_recovery(1, [0], [1], capacity=2)
            if grow:
                m.health.emit_elastic_recovery(2, [0, 1], [], joined=[1],
                                               capacity=2, kind="grow")
        tel.maybe_flush(1)
        return 4
    return body


def _crash(p, tel, m):
    tel.count("train/examples", 32.0)
    try:
        raise ValueError("bad batch")
    except ValueError as e:
        if p == 1:
            tel.record_crash(e, 3)
    return 3


def _stalled(p, tel, m):
    tel.sink.emit("health", {"status": "stalled", "step": 5,
                             "seconds_since_beat": 12.0})
    tel.sink.emit("health", {"status": "recovered", "step": 5,
                             "outage_seconds": 13.0})
    return 5


def _collectives(doctor):
    def body(p, tel, m):
        for i, label in enumerate(("train/step_flags", "rows/gather",
                                   "grads/all_reduce", "train/step_flags")):
            if doctor and p == 1 and i == 2:
                continue  # one collective removed from worker 1's shard
            tel.sink.emit("collective", {"seq": i + 1, "label": label,
                                         "op": "all_gather"})
        return 1
    return body


def _join_refused(p, tel, m):
    if p == 0:
        m.live.emit_join_refused(3, 1, "announce into an unplanned generation")
    return 1


def _bringup_failed(p, tel, m):
    tel.count("cluster/bringup_failures")
    tel.sink.emit("health", {"status": "cluster_bringup_failed",
                             "coordinator": "localhost:25000",
                             "process_index": p, "attempts": 3,
                             "timeout_seconds": 5.0,
                             "error": "RuntimeError: refused"})
    return 0


STREAM_CASES = {
    # (builder(side, tmp_path) -> files, written by each side?)
    "efficiency": (lambda side, t: _efficiency_files(t), False),
    "fleet_degraded": (lambda side, t: [jt_fleet._fleet_metrics_file(
        t, ready=2, total=3)], False),
    "fleet_ok": (lambda side, t: [jt_fleet._fleet_metrics_file(
        t, ready=3, total=3)], False),
    "skewed_straggler": (lambda side, t: _write(
        t, jt_anatomy._straggler_streams(offset=1.25)), False),
    "lockstep_windows": (lambda side, t: _write(t, _lockstep_ranks()),
                         False),
    "spans_and_gauges": (lambda side, t: _written(
        side, t, _spans_and_gauges, trace_spans=True), True),
    "shrink": (lambda side, t: _written(
        side, t, _lost_then_recovered(grow=False), flush_steps=1), True),
    "shrink_then_grow": (lambda side, t: _written(
        side, t, _lost_then_recovered(grow=True), flush_steps=1), True),
    "crash": (lambda side, t: _written(side, t, _crash), True),
    "stalled": (lambda side, t: _written(side, t, _stalled), True),
    "join_refused": (lambda side, t: _written(side, t, _join_refused),
                     True),
    "bringup_failed": (lambda side, t: _written(side, t, _bringup_failed),
                       True),
    "collectives": (lambda side, t: _written(side, t, _collectives(False)),
                    True),
    "collectives_doctored": (lambda side, t: _written(
        side, t, _collectives(True)), True),
}

# The stream a case is read from: the JAX package's and the port's, for
# a case both packages write; the one file otherwise.
READ_CASES = sorted(f"{case}-{side}"
                    for case, (_, both) in STREAM_CASES.items()
                    for side in (("jax", "port") if both else ("jax",)))


def _files(tmp_path, name):
    case, side = name.rsplit("-", 1)
    d = tmp_path / side
    d.mkdir()
    return STREAM_CASES[case][0](side, d)


def _both(capsys, argv, j_main, p_main):
    """(rc, (stdout, stderr)) of the JAX tool and of the port's on
    ``argv``."""
    capsys.readouterr()  # what writing the streams logged
    out = []
    for main in (j_main, p_main):
        rc = main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, (cap.out, cap.err)))
    return out


@pytest.mark.parametrize("name", READ_CASES)
def test_summary_attribution_and_verdict_are_the_jax_modules(tmp_path,
                                                            name):
    files = _files(tmp_path, name)
    j, p = j_attr.summarize(files), p_attr.summarize(files)
    assert _dump(p) == _dump(j)
    assert _dump(p_attr.attribution(p)) == _dump(j_attr.attribution(j))
    assert p_attr.health_verdict(p) == j_attr.health_verdict(j)
    assert p_attr.render(p) == j_attr.render(j)
    assert p_attr.fleet_degraded(p) == j_attr.fleet_degraded(j)
    assert p_attr.fleet_table(p) == j_attr.fleet_table(j)
    assert _dump(p_attr.efficiency_table(p)) == \
        _dump(j_attr.efficiency_table(j))


@pytest.mark.parametrize("name", READ_CASES)
def test_fmstat_prints_and_exits_as_the_jax_tool(tmp_path, capsys, name):
    files = _files(tmp_path, name)
    for argv in (files, ["--json"] + files, ["slo"] + files,
                 ["slo", "--json", "--allow-skip"] + files):
        (jrc, jout), (prc, pout) = _both(capsys, argv, j_fmstat.main,
                                         p_fmstat.main)
        assert (prc, pout) == (jrc, jout), argv


@pytest.mark.parametrize("name", READ_CASES)
def test_fmtrace_prints_and_exits_as_the_jax_tool(tmp_path, capsys, name):
    files = _files(tmp_path, name)
    for argv in (["--collectives"] + files, ["--anatomy"] + files,
                 ["--anatomy", "--json"] + files,
                 ["--anatomy", "--baseline-eps", "1000"] + files):
        (jrc, jout), (prc, pout) = _both(capsys, argv, j_fmtrace.main,
                                         p_fmtrace.main)
        assert (prc, pout) == (jrc, jout), argv
    docs = []
    for side, main in (("jax", j_fmtrace.main), ("port", p_fmtrace.main)):
        out = str(tmp_path / f"{side}.trace.json")
        assert main(files + ["-o", out]) == 0
        with open(out) as fh:
            docs.append(json.load(fh))
    assert docs[1] == docs[0]


def test_the_readers_give_the_verdicts_the_jax_tests_name(tmp_path,
                                                          capsys):
    def verdict(files):
        return p_attr.health_verdict(p_attr.summarize(files))["verdict"]
    (tmp_path / "a").mkdir()
    assert verdict([jt_fleet._fleet_metrics_file(
        tmp_path / "a", ready=2, total=3)]) == "FLEET DEGRADED (2/3 ready)"
    (tmp_path / "b").mkdir()
    ok = [jt_fleet._fleet_metrics_file(tmp_path / "b", ready=3, total=3)]
    assert verdict(ok) == "OK"
    assert p_attr.fleet_table(p_attr.summarize(ok))[0].startswith(
        "r0: ready")
    assert "FLEET (serve --replicas)" in p_attr.render(
        p_attr.summarize(ok))
    for case, want in (("shrink", "DEGRADED (1 worker lost)"),
                       ("shrink_then_grow", "RECOVERED (gen 2, 2 workers)")):
        d = tmp_path / case
        d.mkdir()
        assert verdict(STREAM_CASES[case][0]("port", d)) == want
    d = tmp_path / "eff"
    d.mkdir()
    assert p_fmstat.main(_efficiency_files(d)) == 0
    assert "EFFICIENCY (step anatomy):" in capsys.readouterr().out
    d = tmp_path / "coll"
    d.mkdir()
    files = STREAM_CASES["collectives_doctored"][0]("port", d)
    assert p_fmtrace.main(["--collectives"] + files) == 1
    assert "DIVERGE at position 2" in capsys.readouterr().err
