"""The port's copies of the JAX package's telemetry modules — the sink,
spans, the watchdog, the crash and checkpoint-fallback events, the SLO
spec and verdicts, the Prometheus text and the per-run helpers — held to
the originals on the same inputs: the same events, byte for byte where
the JAX function writes text (clocks pinned)."""

import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.obs import health as jhealth
from fast_tffm_tpu.obs import prom as jprom
from fast_tffm_tpu.obs import quality as jquality
from fast_tffm_tpu.obs import sink as jsink
from fast_tffm_tpu.obs import slo as jslo
from fast_tffm_tpu.obs import telemetry as jtel
from fast_tffm_tpu.obs import trace as jtrace
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.obs import health as phealth
from fast_tffm_tpu_torch.obs import prom as pprom
from fast_tffm_tpu_torch.obs import quality as pquality
from fast_tffm_tpu_torch.obs import sink as psink
from fast_tffm_tpu_torch.obs import slo as pslo
from fast_tffm_tpu_torch.obs import telemetry as ptel
from fast_tffm_tpu_torch.obs import trace as ptrace
from fast_tffm_tpu_torch.utils import fetch as pfetch
from fast_tffm_tpu_torch.utils import summaries as psummaries

torch.set_num_threads(1)

META = {"kind": "train", "config_hash": "abc", "backend": "cpu"}


@pytest.fixture
def frozen(monkeypatch):
    """Pin the wall and monotonic clocks the sinks and spans read."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(time, "perf_counter", lambda: 12.5)


def _drive_sink(mod, path, scalars):
    s = mod.JsonlSink(str(path), meta=META)
    s.emit("health", {"status": "x", "n": np.int64(3),
                      "arr": np.arange(3, dtype=np.int32)})
    s.emit_metrics(4, {"counters": {"a": 1.0}, "gauges": {"g": 0.5},
                       "hists": {}})
    s.flush()
    for i, v in enumerate(scalars):
        s.add_scalar("train/loss" if i % 2 == 0 else "validation/auc",
                     i + 1, v)
    s.barrier()
    s.emit("span", {"name": "late"})
    recent = s.recent_snapshot()
    s.close()
    s.emit("span", {"name": "after close"})  # dropped by both
    return recent


@pytest.mark.parametrize("values", [
    [0.5, 0.75, 0.25, 1.0],
    [float("nan"), 0.5, float("inf"), float("nan")],
    [1.0, float("nan"), 2.0],
])
def test_sink_writes_the_same_bytes(tmp_path, frozen, values):
    jrec = _drive_sink(jsink, tmp_path / "j.jsonl",
                       [jnp.float32(v) for v in values])
    prec = _drive_sink(psink, tmp_path / "p.jsonl",
                       [torch.tensor(v, dtype=torch.float32)
                        for v in values])
    j = (tmp_path / "j.jsonl").read_bytes()
    p = (tmp_path / "p.jsonl").read_bytes()
    assert p == j
    assert json.dumps(prec, default=str) == json.dumps(jrec, default=str)
    events = list(psink.read_events(str(tmp_path / "p.jsonl")))
    assert events[-1]["event"] == "run_end"
    bad = [e for e in events if e.get("status") == "nonfinite_loss"]
    assert len(bad) == (1 if any(not math.isfinite(v)
                                 for v in values[::2]) else 0)


def test_read_events_tolerates_a_torn_tail(tmp_path):
    path = tmp_path / "m.jsonl"
    path.write_text('{"event": "run_start"}\n\n{"event": "metrics", '
                    '"step": 2}\n{"event": "scal')
    assert list(psink.read_events(str(path))) == \
        list(jsink.read_events(str(path)))


def test_scalar_buffer_is_one_fetch_per_device(monkeypatch):
    # Tensors of one device and dtype go in one stack; host numbers pass.
    calls = []
    real = torch.stack

    def stack(ts, *a, **k):
        calls.append(len(ts))
        return real(ts, *a, **k)

    monkeypatch.setattr(torch, "stack", stack)
    vals = [torch.tensor(1.5), 2, torch.tensor(3.5),
            torch.tensor(4.0, dtype=torch.float64)]
    assert pfetch.fetch_floats(vals) == [1.5, 2.0, 3.5, 4.0]
    assert sorted(calls) == [1, 2]


def test_scalar_buffer_cap_forces_one_drain(tmp_path):
    s = psink.JsonlSink(str(tmp_path / "m.jsonl"))
    for i in range(psink.SCALAR_BUFFER_MAX):
        s.add_scalar("train/loss", i, torch.tensor(0.5))
    assert s._scalars == []
    s.close()
    n = sum(1 for e in psink.read_events(str(tmp_path / "m.jsonl"))
            if e["event"] == "scalar")
    assert n == psink.SCALAR_BUFFER_MAX == jsink.SCALAR_BUFFER_MAX


@pytest.mark.parametrize("trace_spans", [False, True])
def test_spans_match(tmp_path, frozen, trace_spans):
    out = {}
    for tag, tel_mod, trace_mod in (("j", jtel, jtrace),
                                    ("p", ptel, ptrace)):
        assert trace_mod.span("x") is trace_mod._NULL  # no run: no-op
        path = tmp_path / f"{tag}.jsonl"
        tel = tel_mod.RunTelemetry(str(path), META,
                                   trace_spans=trace_spans)
        with tel_mod.activate(tel):
            assert trace_mod.anatomy_on()
            with trace_mod.span("train/step", step=3):
                with trace_mod.span("train/h2d", bytes=10):
                    pass
            with pytest.raises(KeyError):
                with trace_mod.span("checkpoint/save", step=4):
                    raise KeyError("boom")
        tel.close()
        out[tag] = path.read_bytes()
    assert out["p"] == out["j"]
    names = [e.get("name") for e in psink.read_events(
        str(tmp_path / "p.jsonl")) if e["event"] == "span"]
    assert names == (["train/h2d", "train/step", "checkpoint/save"]
                     if trace_spans else [])


def _watchdog_events(mod, path):
    clock = [100.0]
    sink = (jsink if mod is jhealth else psink).JsonlSink(str(path))
    w = mod.Watchdog(sink, stall_seconds=5.0,
                     stacks_path=str(path) + ".stacks",
                     clock=lambda: clock[0])
    got = []
    for dt, beat in ((1, 1), (3, None), (6, None), (2, None), (1, 2),
                     (1, 3), (9, None), (1, None), (0.5, 4)):
        clock[0] += dt
        if beat is not None:
            w.beat(beat)
        got.append(w.check())
    w.stop()
    sink.close()
    events = [{k: v for k, v in e.items() if k not in ("t",
                                                       "stacks_file")}
              for e in psink.read_events(str(path))
              if e["event"] == "health"]
    return got, events, w.stall_events


def test_watchdog_under_a_fake_clock_matches(tmp_path):
    j = _watchdog_events(jhealth, tmp_path / "j.jsonl")
    p = _watchdog_events(phealth, tmp_path / "p.jsonl")
    assert p == j
    assert p[0].count("stalled") == 2 and p[2] == 2
    with open(str(tmp_path / "p.jsonl") + ".stacks") as fh:
        assert fh.read().count("==== stall after") == 2
    assert phealth.MIN_POLL_SECONDS == jhealth.MIN_POLL_SECONDS


def test_watchdog_thread_carries_the_port_prefix(tmp_path):
    sink = psink.JsonlSink(str(tmp_path / "m.jsonl"))
    w = phealth.Watchdog(sink, 60.0, str(tmp_path / "m.stacks")).start()
    try:
        assert w._thread.name == "fmt-watchdog"
    finally:
        w.stop()
        sink.close()


def _crash_and_fallback(tel_mod, health_mod, path):
    tel = tel_mod.RunTelemetry(str(path), META)
    with tel_mod.activate(tel):
        tel.count("train/steps", 3)
        health_mod.emit_ckpt_fallback(7, "manifest mismatch" * 30,
                                      "/x/corrupt-7")
        try:
            raise RuntimeError("mid-epoch")
        except RuntimeError as e:
            tel.record_crash(e, step=5)
    tel.close()
    ev = [e for e in psink.read_events(str(path))
          if e["event"] in ("health", "crash")]
    for e in ev:
        e.pop("t")
        for r in e.get("recent_events", ()):
            r.pop("t")
        if "traceback" in e:
            e["traceback"] = e["traceback"].splitlines()[-1]
    return ev


def test_crash_and_ckpt_fallback_events_match(tmp_path):
    j = _crash_and_fallback(jtel, jhealth, tmp_path / "j.jsonl")
    p = _crash_and_fallback(ptel, phealth, tmp_path / "p.jsonl")
    assert p == j
    assert [e.get("status", e["event"]) for e in p] == ["ckpt_fallback",
                                                        "crash"]
    exc = ValueError("x" * 9000)
    assert phealth.format_crash(exc) == jhealth.format_crash(exc)


def test_worker_events_match_and_no_op_without_a_run(tmp_path):
    @dataclasses.dataclass
    class Lost:
        process_index: int
        host: str = "h"
        pid: int = 1
        age_seconds: float = 2.0

    phealth.emit_worker_lost([Lost(1)], "x")  # no active run: no-op
    out = {}
    for tag, tel_mod, h in (("j", jtel, jhealth), ("p", ptel, phealth)):
        tel = tel_mod.RunTelemetry(str(tmp_path / f"{tag}.jsonl"), META)
        with tel_mod.activate(tel):
            h.emit_worker_lost([Lost(1)], "train/step_flags", 8.0, "gone")
            h.emit_worker_lost([Lost(1)], "again")
            h.emit_elastic_recovery(2, [0, 1], [], joined=[1],
                                    capacity=2, kind="grow")
        out[tag] = (tel.registry.snapshot()["counters"], [
            {k: v for k, v in e.items() if k != "t"}
            for e in psink.read_events(str(tmp_path / f"{tag}.jsonl"))
            if e["event"] == "health"])
        tel.close()
    assert out["p"] == out["j"]


def _flush_cadence(tel_mod, path, monkeypatch):
    clock = iter(np.arange(10.0, 100.0, 0.5))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    tel = tel_mod.RunTelemetry(str(path), META, flush_steps=2)
    for step in range(1, 6):
        tel.train_step(0.01 * step, 32, 4096, 8192)
        tel.count("pipeline/build_seconds", 0.002)
        tel.count("train/input_wait_seconds", 0.001)
        tel.maybe_flush(step)
    tel.count("train/epochs")
    tel.barrier_flush(5)
    tel.close(step=5)
    return [e for e in psink.read_events(str(path))
            if e["event"] == "metrics"]


def test_flush_cadence_and_anatomy_gauges_match(tmp_path, monkeypatch):
    j = _flush_cadence(jtel, tmp_path / "j.jsonl", monkeypatch)
    p = _flush_cadence(ptel, tmp_path / "p.jsonl", monkeypatch)
    for e in j + p:
        e.pop("t")
    assert p == j
    assert [e["step"] for e in p] == [2, 4, 5, 5]
    assert p[-1]["gauges"]["anatomy/steps"] == 5.0
    assert ptel.ANATOMY_PHASES == jtel.ANATOMY_PHASES


@pytest.mark.parametrize("kw", [
    {}, {"vocabulary_size": 1 << 10, "factor_num": 4,
         "bucket_ladder": (8, 16)},
    {"metrics_file": "auto", "trace_spans": True, "slo_p99_ms": 5.0},
    {"model_type": "ffm", "field_num": 3},
])
def test_config_hash_and_metrics_path_match(kw):
    j, p = JaxConfig(**kw), FmConfig(**kw)
    assert ptel.config_hash(p) == jtel.config_hash(j)
    for idx in (None, 0, 2):
        assert ptel.resolve_metrics_path(p, process_index=idx) == \
            jtel.resolve_metrics_path(j, process_index=idx if idx is not
                                      None else 0)
    assert ptel.resolve_metrics_path(FmConfig(metrics_file="auto",
                                              model_file="m/x")) == \
        "m/x.metrics.jsonl"


def test_sample_cfg_hash_matches():
    from fast_tffm_tpu.config import load_config as jload
    assert ptel.config_hash(load_config("sample.cfg")) == \
        jtel.config_hash(jload("sample.cfg"))


def test_run_meta_fields():
    j = jtel.run_meta(JaxConfig(), "train", process_index=0,
                      process_count=1)
    p = ptel.run_meta(FmConfig(), "train")
    assert set(p) == set(j)
    assert p["backend"] == "cpu" and p["process_index"] == 0
    assert p["process_count"] == 1 and p["config_hash"] == \
        j["config_hash"]
    assert ptel.run_meta(FmConfig(), "serve", device="cpu")["backend"] \
        == "cpu"


def test_make_telemetry_knobs(tmp_path):
    assert ptel.make_telemetry(FmConfig(), "train") is None
    cfg = FmConfig(metrics_file=str(tmp_path / "m.jsonl"),
                   metrics_flush_steps=3, trace_spans=True, anatomy=False,
                   watchdog_stall_seconds=30.0, mem_pressure_fraction=0.5)
    tel = ptel.make_telemetry(cfg, "train", device="cpu")
    try:
        assert (tel.flush_steps, tel.trace_spans, tel.anatomy,
                tel.mem_pressure_fraction) == (3, True, False, 0.5)
        assert tel.watchdog is not None
        assert tel.watchdog._thread.name == "fmt-watchdog"
    finally:
        tel.close()
    assert tel.watchdog._thread is None


def test_batch_payload_bytes_and_pipeline_batch_match(tmp_path):
    from fast_tffm_tpu.data.pipeline import DeviceBatch as JBatch
    from fast_tffm_tpu_torch.data.pipeline import DeviceBatch as PBatch
    rng = np.random.default_rng(3)
    args = {"a": np.zeros((4, 8), np.int32), "b": np.ones(5, np.float32),
            "c": 7}
    assert ptel.batch_payload_bytes(args) == jtel.batch_payload_bytes(args)
    idx = rng.integers(0, 6, (4, 8)).astype(np.int32)
    uniq = np.asarray([0, 1, 2, 3, 4, 9], np.int32)
    fields = dict(labels=np.ones(4, np.float32),
                  weights=np.ones(4, np.float32), local_idx=idx,
                  vals=np.ones((4, 8), np.float32), num_real=3)
    snaps = []
    for tel_mod, B in ((jtel, JBatch), (ptel, PBatch)):
        tel = tel_mod.RunTelemetry(str(tmp_path / f"{id(B)}.jsonl"), META)
        tel.pipeline_batch(B(uniq_ids=uniq, **fields), 9,
                           build_seconds=0.5)
        tel.pipeline_batch(B(uniq_ids=None, **fields), 5)
        snaps.append(tel.registry.snapshot())
        tel.close()
    assert snaps[1] == snaps[0]


def test_quality_emitters_match(tmp_path):
    out = []
    for tel_mod, q in ((jtel, jquality), (ptel, pquality)):
        tel = tel_mod.RunTelemetry(str(tmp_path / f"{id(q)}.jsonl"), META)
        stats = q.QualityStats("logistic")
        stats.update(np.asarray([0.5, -1.0, 2.0]), np.asarray([1., 0, 1]),
                     np.ones(3))
        q.emit_quality(tel, 8, 0.75, stats, 3, 0.25)
        q.emit_quality(None, 8, 0.75, stats, 3, 0.25)
        q.emit_gate_held(tel, {"step": 8, "auc": 0.5, "baseline": 0.7,
                               "reasons": ["AUC low"]})
        snap = tel.registry.snapshot()
        tel.close()
        out.append((snap, [
            {k: v for k, v in e.items() if k != "t"}
            for e in psink.read_events(str(tmp_path / f"{id(q)}.jsonl"))
            if e["event"] in ("health", "scalar")]))
    assert out[1] == out[0]


SNAPSHOTS = [
    {"counters": {}, "gauges": {}, "hists": {}},
    {"counters": {"serve/requests": 3.0, "io/retries/open": 1.0},
     "gauges": {"serve/ready": 1.0, "weird name-x": float("nan"),
                "neg": float("-inf"), "big": 1.5e300, "f": 0.1},
     "hists": {"serve/request_latency_ms": {
         "bounds": [0.5, 1.0, 2.5], "counts": [1, 0, 2, 1],
         "count": 4, "sum": 9.25}}},
]


@pytest.mark.parametrize("snap", SNAPSHOTS)
def test_prometheus_text_matches(snap):
    assert pprom.prometheus_text(snap) == jprom.prometheus_text(snap)
    assert pprom.PROM_CONTENT_TYPE == jprom.PROM_CONTENT_TYPE
    assert pprom.metric_name("a/b.c") == jprom.metric_name("a/b.c")


def test_prometheus_text_of_a_live_registry():
    from fast_tffm_tpu.obs.registry import MetricsRegistry as JReg
    from fast_tffm_tpu_torch.obs.registry import MetricsRegistry as PReg
    regs = []
    for R in (JReg, PReg):
        r = R()
        r.count("serve/requests", 2)
        r.set("serve/ready", 1.0)
        for v in (0.3, 1.2, 7.0, 400.0):
            r.observe("serve/request_latency_ms", v,
                      bounds=(0.5, 1.0, 5.0, 100.0))
        regs.append(r.snapshot())
    assert pprom.prometheus_text(regs[1]) == jprom.prometheus_text(regs[0])


SLO_CFGS = [
    {},
    {"slo_p99_ms": 5.0, "slo_min_auc": 0.7},
    {"slo_publish_staleness_seconds": 30.0, "slo_max_bad_fraction": 0.01,
     "slo_p99_ms": 50.0, "slo_min_auc": 0.9},
]

SUMMARIES = [
    {"gauges": {}, "counters": {}, "hists": {}},
    {"gauges": {"quality/auc": 0.8, "stream/last_publish_age_seconds": 40.0,
                "validation/auc": 0.6},
     "counters": {"pipeline/bad_lines": 3.0, "train/examples": 1000.0,
                  "pipeline/examples": 2000.0},
     "hists": {"serve/request_latency_ms": {"count": 10, "p99": 4.0,
                                            "p50": 1.0}}},
    {"gauges": {"validation/auc": 0.95,
                "stream/last_publish_age_seconds": 1.0},
     "counters": {"pipeline/bad_lines": 50.0, "pipeline/examples": 100.0},
     "hists": {"serve/request_latency_ms": {"count": 3, "p99": 80.0}}},
]


@pytest.mark.parametrize("kw", SLO_CFGS)
@pytest.mark.parametrize("summary", SUMMARIES)
def test_slo_verdicts_match(kw, summary):
    jspec = jslo.SloSpec.from_config(JaxConfig(**kw))
    pspec = pslo.SloSpec.from_config(FmConfig(**kw))
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    jres = jslo.evaluate_slos(jspec, summary)
    pres = pslo.evaluate_slos(pspec, summary)
    assert [dataclasses.asdict(r) for r in pres] == \
        [dataclasses.asdict(r) for r in jres]
    assert pslo.overall(pres) == jslo.overall(jres)
    assert pslo.render_slo(pspec, pres) == jslo.render_slo(jspec, jres)
    assert json.dumps(pslo.results_json(pspec, pres), sort_keys=True) == \
        json.dumps(jslo.results_json(jspec, jres), sort_keys=True)


@pytest.mark.parametrize("kw", SLO_CFGS)
def test_slo_gauges_roundtrip_match(kw, tmp_path):
    from fast_tffm_tpu.obs.registry import MetricsRegistry as JReg
    from fast_tffm_tpu_torch.obs.registry import MetricsRegistry as PReg
    jr, pr = JReg(), PReg()
    jslo.SloSpec.from_config(JaxConfig(**kw)).emit_gauges(jr)
    pslo.SloSpec.from_config(FmConfig(**kw)).emit_gauges(pr)
    assert pr.snapshot() == jr.snapshot()
    back = pslo.SloSpec.from_summary(pr.snapshot())
    assert back == pslo.SloSpec.from_config(FmConfig(**kw))
    assert back.empty == (not kw)


class _Writer:
    def __init__(self):
        self.rows, self.flushes, self.closed = [], 0, False

    def add_scalar(self, tag, value, global_step):
        self.rows.append((tag, global_step, value))

    def flush(self):
        self.flushes += 1

    def close(self):
        self.closed = True


def test_summaries_buffer_and_fetch_once():
    w = _Writer()
    s = psummaries.ScalarSummaries("tb", w)
    s.add("train/loss", 4, torch.tensor(0.25))
    s.add("train/examples_per_sec", 4, 100.0)
    assert w.rows == []  # nothing read before the barrier
    s.flush()
    assert w.rows == [("train/loss", 4, 0.25),
                      ("train/examples_per_sec", 4, 100.0)]
    s.close()
    assert w.closed and w.flushes == 1  # an empty buffer writes nothing
    assert psummaries.SUMMARY_BUFFER_MAX == 1024


def test_make_summaries_off_and_on(tmp_path):
    assert psummaries.make_summaries(FmConfig()) is None
    cfg = FmConfig(save_summaries_steps=2,
                   model_file=str(tmp_path / "m" / "fm"))
    try:
        import torch.utils.tensorboard  # noqa: F401
    except Exception:  # noqa: BLE001 - no tensorboard: the warning path
        with pytest.warns(UserWarning, match="summaries are disabled"):
            assert psummaries.make_summaries(cfg) is None
        return
    s = psummaries.make_summaries(cfg)
    assert s.logdir == cfg.model_file + ".tb"
    s.add("train/loss", 2, torch.tensor(1.0))
    s.close()


def test_make_summaries_warns_without_the_writer(tmp_path, monkeypatch):
    import builtins
    real = builtins.__import__

    def refuse(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", refuse)
    cfg = FmConfig(save_summaries_steps=2,
                   model_file=str(tmp_path / "m" / "fm"))
    with pytest.warns(UserWarning, match="summaries are disabled"):
        assert psummaries.make_summaries(cfg) is None
