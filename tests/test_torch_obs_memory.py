"""The port's memory ledger and capacity planner (obs/memory.py) against
the JAX package's on the same inputs — sizing, what-if parsing, plans
and their text, the ledger and its gauges, the pressure episodes, the
OOM wrap — and the ledger a real port run registers: the plan within
10% of it for train and serve, the pre-flight refusal and the pressure
event driven by ``FM_FAKE_HBM_BYTES``."""

import os

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.obs import memory as jmem
from fast_tffm_tpu_torch.checkpoint import CheckpointState
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.lookup import memory_report
from fast_tffm_tpu_torch.obs import memory as pmem
from fast_tffm_tpu_torch.obs.sink import read_events
from fast_tffm_tpu_torch.obs.telemetry import RunTelemetry
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.train import train

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_ledgers(monkeypatch):
    monkeypatch.delenv(pmem.FAKE_CAPACITY_ENV, raising=False)
    jmem.LEDGER.reset()
    pmem.LEDGER.reset()
    pmem.bind_device(None)
    yield
    jmem.LEDGER.reset()
    pmem.LEDGER.reset()
    pmem.bind_device(None)


CFGS = [
    {},
    {"vocabulary_size": 1 << 20, "factor_num": 16, "batch_size": 8192,
     "max_features_per_example": 64},
    {"model_type": "ffm", "field_num": 4, "factor_num": 4},
    {"lookup": "host", "vocabulary_size": 100_000},
]
WHAT_IFS = ["", "vocabulary_size=2000000", "dtype=f16,shards=4",
            "factor_num=32, batch_size=64,max_features_per_example=8",
            "dtype=int8"]


@pytest.mark.parametrize("kw", CFGS)
def test_table_bytes_matches(kw):
    j, p = JaxConfig(**kw), FmConfig(**kw)
    assert pmem.table_bytes(p) == jmem.table_bytes(j)
    assert pmem.table_bytes(p, rows=p.ckpt_rows) == \
        jmem.table_bytes(j, rows=j.ckpt_rows)
    assert pmem.table_bytes(rows=7, dim=3, dtype_bytes=2) == 42


@pytest.mark.parametrize("spec", WHAT_IFS + [" , vocabulary_size = 5 ,"])
def test_parse_what_if_matches(spec):
    assert pmem.parse_what_if(spec) == jmem.parse_what_if(spec)


@pytest.mark.parametrize("spec", ["vocabulary_size", "dtype=f64",
                                  "shards=four"])
def test_parse_what_if_refusals_match(spec):
    with pytest.raises(ValueError) as want:
        jmem.parse_what_if(spec)
    with pytest.raises(ValueError) as got:
        pmem.parse_what_if(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cap", [None, "100000", str(1 << 40)])
@pytest.mark.parametrize("spec", WHAT_IFS)
@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("kw", CFGS)
def test_plan_and_render_match(kw, kind, spec, cap, monkeypatch):
    if cap is not None:
        monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, cap)
    j = jmem.plan(JaxConfig(**kw), kind, jmem.parse_what_if(spec))
    p = pmem.plan(FmConfig(**kw), kind, pmem.parse_what_if(spec))
    assert p == j
    assert pmem.render_plan(p) == jmem.render_plan(j)


def _ledger_ops(mod):
    L = mod.LEDGER
    out = []
    L.register("table", 4000)
    L.register("adagrad_acc", 4000)
    out.append((L.live_bytes(), L.peak_bytes(), mod.ledger_gauges()))
    L.register("wire_buffers", 512)
    L.register("prefetch_batches", 900, host=True)
    L.register("offload_table", 10_000, host=True)
    out.append((L.live_bytes(), L.owners(), L.host_owners(),
                mod.render_ledger(), mod.ledger_gauges()))
    L.register("table", 100)  # an owner shrinks; the peak stays
    L.release("wire_buffers")
    L.register("offload_table", 300)  # host -> device
    out.append((L.live_bytes(), L.peak_bytes(), L.owners(),
                L.host_owners(), mod.render_ledger(), mod.ledger_gauges()))
    out.append([L.begin_pressure_episode(), L.begin_pressure_episode()])
    L.end_pressure_episode()
    out.append(L.begin_pressure_episode())
    L.reset()
    out.append((mod.ledger_gauges(), mod.render_ledger()))
    return out


@pytest.mark.parametrize("cap", [None, "20000"])
def test_ledger_and_gauges_match(cap, monkeypatch):
    if cap is not None:
        monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, cap)
    assert _ledger_ops(pmem) == _ledger_ops(jmem)


def test_seam_on_the_cpu_and_the_fake_capacity(monkeypatch):
    assert pmem.device_memory_stats() is None
    assert pmem.device_capacity_bytes() is None
    pmem.bind_device("cpu")
    assert pmem.device_memory_stats() is None
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, "4096")
    pmem.LEDGER.register("table", 1000)
    assert pmem.device_memory_stats() == {"bytes_limit": 4096,
                                          "bytes_in_use": 1000}
    assert pmem.device_capacity_bytes() == 4096
    rep = memory_report()
    assert rep["device_limit_mb"] == 0 and rep["device_in_use_mb"] == 0
    monkeypatch.delenv(pmem.FAKE_CAPACITY_ENV)
    rep = memory_report()
    assert rep["device_limit_mb"] is None and rep["device_peak_mb"] is None


class _Tel:
    def __init__(self, frac):
        self.mem_pressure_fraction = frac
        self.counts = {}
        self.events = []
        self.sink = self

    def count(self, name, n=1.0):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def emit(self, event, fields):
        self.events.append((event, fields))

    def flush(self):
        pass


def _pressure(mod):
    tel = _Tel(0.5)
    for live in (100, 600, 700, 100, 800, 900):
        mod.LEDGER.register("table", live)
        mod.maybe_emit_pressure(tel)
    mod.maybe_emit_pressure(_Tel(0.0))
    return tel.counts, tel.events


def test_pressure_episodes_match(monkeypatch):
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, "1000")
    p = _pressure(pmem)
    assert p == _pressure(jmem)
    assert p[0] == {"mem/pressure_events": 2.0}


@pytest.mark.parametrize("exc", [
    RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    RuntimeError("Resource exhausted while allocating"),
    ValueError("fine"), KeyError("x"),
])
def test_is_oom_matches_on_the_jax_spellings(exc):
    assert pmem.is_oom(exc) == jmem.is_oom(exc)


def test_is_oom_knows_the_cards_error():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert pmem.is_oom(oom)
    assert pmem.is_oom(RuntimeError("CUDA out of memory. Tried"))
    assert pmem.is_oom(pmem.HbmExhaustedError("x"))
    assert not pmem.is_oom(RuntimeError("CUDA error: misaligned address"))


def test_oom_guard_names_the_owners_and_passes_the_rest():
    pmem.LEDGER.register("table", 3 << 30)
    pmem.LEDGER.register("adagrad_acc", 3 << 30)
    with pytest.raises(pmem.HbmExhaustedError) as ei:
        with pmem.oom_guard("train/step"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    msg = str(ei.value)
    assert msg.startswith("device out of memory at train/step")
    assert "table" in msg and "adagrad_acc" in msg and "6.00 GB" in msg
    assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)
    with pytest.raises(pmem.HbmExhaustedError) as again:
        with pmem.oom_guard("outer"):
            with pmem.oom_guard("inner"):
                raise RuntimeError("RESOURCE_EXHAUSTED")
    assert "at inner" in str(again.value)  # never wrapped twice
    with pytest.raises(KeyError):
        with pmem.oom_guard("train/step"):
            raise KeyError("not an OOM")


def test_preflight_refusal_matches(monkeypatch):
    kw = dict(vocabulary_size=100_000, factor_num=8)
    pmem.preflight_capacity(FmConfig(**kw), "train")  # no capacity: no-op
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, "65536")
    for kind in ("train", "serve"):
        with pytest.raises(ValueError) as want:
            jmem.preflight_capacity(JaxConfig(**kw), kind)
        with pytest.raises(ValueError) as got:
            pmem.preflight_capacity(FmConfig(**kw), kind)
        # The breakdown is the JAX package's; the hint names the port's
        # planner (fmstat capacity is not ported).
        assert str(got.value).split("\nexplore")[0] == \
            str(want.value).split("\nexplore")[0]
        assert "parse_what_if" in str(got.value)
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, str(1 << 34))
    pmem.preflight_capacity(FmConfig(**kw), "train")


def _corpus(path, n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            ids = rng.integers(0, vocab, int(rng.integers(1, 16)))
            fh.write(f"{int(rng.integers(0, 2))} "
                     + " ".join(f"{i}:1" for i in ids) + "\n")


def _train_cfg(tmp_path, **kw):
    _corpus(str(tmp_path / "train.txt"), 128, 4000)
    base = dict(vocabulary_size=4000, factor_num=8, batch_size=32,
                learning_rate=0.1, epoch_num=1, shuffle=False,
                max_features_per_example=16, bucket_ladder=(8, 16),
                train_files=(str(tmp_path / "train.txt"),),
                model_file=str(tmp_path / "m" / "fm"),
                metrics_file="auto", metrics_flush_steps=2, log_steps=0)
    base.update(kw)
    return FmConfig(**base)


def test_train_preflight_refuses_before_any_allocation(tmp_path,
                                                      monkeypatch):
    cfg = _train_cfg(tmp_path, vocabulary_size=100_000)
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, "65536")
    with pytest.raises(ValueError, match="predicted device total"):
        train(cfg, device="cpu")
    assert not os.path.exists(cfg.model_file + ".ckpt")
    events = list(read_events(cfg.model_file + ".metrics.jsonl"))
    (crash,) = [e for e in events if e["event"] == "crash"]
    assert "predicted resident device memory" in crash["error"]
    assert [e["event"] for e in events[-2:]] == ["metrics", "run_end"]


def test_plan_within_10pct_of_the_live_ledger_train(tmp_path):
    cfg = _train_cfg(tmp_path)
    train(cfg, device="cpu")
    live = max(e["gauges"].get("mem/live_bytes", 0.0)
               for e in read_events(cfg.model_file + ".metrics.jsonl")
               if e["event"] == "metrics")
    assert live > 0
    p = pmem.plan(cfg, "train")
    assert p["total_bytes"] == pytest.approx(live, rel=0.10)
    assert p["owners"]["table"] == pmem.table_bytes(cfg)
    # The session released its owners (the peak watermark stays).
    assert pmem.LEDGER.owners() == {}
    assert pmem.LEDGER.peak_bytes() >= live


def test_hbm_pressure_fires_once_in_a_train_run(tmp_path, monkeypatch):
    cfg = _train_cfg(tmp_path, mem_pressure_fraction=0.5)
    # Capacity under twice the live bytes: every flush is past 0.5.
    live = 2 * pmem.table_bytes(cfg)
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, str(int(live * 1.5)))
    train(cfg, device="cpu")
    events = list(read_events(cfg.model_file + ".metrics.jsonl"))
    hp = [e for e in events if e.get("status") == "hbm_pressure"]
    assert len(hp) == 1
    assert set(hp[0]["owners"]) >= {"table", "adagrad_acc"}
    assert hp[0]["capacity_bytes"] == int(live * 1.5)
    last = [e for e in events if e["event"] == "metrics"][-1]
    assert last["counters"]["mem/pressure_events"] == 1.0
    assert last["gauges"]["mem/capacity_bytes"] == int(live * 1.5)


def _served(tmp_path):
    cfg = FmConfig(vocabulary_size=4000, factor_num=4,
                   max_features_per_example=16, bucket_ladder=(8, 16),
                   serve_max_batch=8, serve_poll_seconds=60.0,
                   model_file=str(tmp_path / "m" / "fm"))
    rng = np.random.default_rng(0)
    table = torch.from_numpy((rng.standard_normal(
        (cfg.num_rows, cfg.row_dim)) * 0.01).astype(np.float32))
    ckpt = CheckpointState(cfg.model_file)
    for step in (1, 2):
        ckpt.save(step, table, torch.full_like(table, 0.1),
                  vocabulary_size=cfg.vocabulary_size, wait=True)
    ckpt.publish_step(1)
    ckpt.close()
    return cfg


def test_plan_within_10pct_of_the_live_ledger_serve(tmp_path):
    cfg = _served(tmp_path)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        live = pmem.LEDGER.owners()
        p = pmem.plan(cfg, "serve")
        assert live["serve_table"] == pytest.approx(
            p["owners"]["serve_table"], rel=0.10)
        assert "serve_reload_table" not in live
        assert server.reload_step(2)
        g = server._reg.snapshot()["gauges"]
        assert g["serve/reload_peak_bytes"] == 2 * live["serve_table"]
        assert g["serve/served_step"] == 2.0
    finally:
        server.close()
    assert pmem.LEDGER.owners() == {}


def test_serve_startup_and_reload_refusals(tmp_path, monkeypatch):
    cfg = _served(tmp_path)
    monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, "1000")
    with pytest.raises(ValueError, match="predicted device total"):
        ScorerServer(cfg, device="cpu", watch=False)
    # A capacity the table fits alone, but not beside a second one: the
    # reload is a counted failure and the old step keeps serving.
    tb = pmem.table_bytes(cfg)
    monkeypatch.delenv(pmem.FAKE_CAPACITY_ENV)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        monkeypatch.setenv(pmem.FAKE_CAPACITY_ENV, str(int(tb * 1.5)))
        assert not server.reload_step(2)
        assert server.served_step == 1
        c = server._reg.snapshot()["counters"]
        assert c["serve/reload_failures"] == 1.0
    finally:
        server.close()


def test_mem_gauges_read_no_device_value(tmp_path, monkeypatch):
    # The ledger's gauges are host arithmetic: a flush between steps
    # never calls into a tensor.
    tel = RunTelemetry(str(tmp_path / "m.jsonl"), {}, flush_steps=1)
    pmem.LEDGER.register("table", torch.zeros(10, 4).nbytes)
    calls = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append(1) or 0.0)
    tel.maybe_flush(1)
    tel.close()
    assert calls == []
    g = [e for e in read_events(str(tmp_path / "m.jsonl"))
         if e["event"] == "metrics"][0]["gauges"]
    assert g["mem/table_bytes"] == 160.0
