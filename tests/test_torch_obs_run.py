"""Run parity of the telemetry stream: the same small config (a few
hundred lines, k = 4, vocabulary 2^10) and the same starting table go
through the JAX package's ``train``, ``predict`` and one ``ScorerServer``
(in a subprocess on one CPU device) and through the port's, each with
``metrics_file``; the stream run mode and admit mode as well. Both
streams hold the same event kinds, the same counter, gauge and histogram
names (histograms with the same bucket bounds), the same spans and the
same counts of input and steps; the port's readers
(``obs/attribution.py``, ``tools/fmstat.py``) read the port's stream
with the verdict they give the JAX one, and in one case the JAX
package's own ``tools.fmstat`` reads it too, with the same output. Then the health events a port run writes: a NaN loss, a crash
mid-epoch, a checkpoint walk-back."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu.obs.sink import read_events as jax_read_events
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.obs import attribution
from fast_tffm_tpu_torch.obs.sink import read_events
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.tools.fmstat import main as fmstat_main
from fast_tffm_tpu_torch.train import train
from tools.fmstat import main as jax_fmstat_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
REQUESTS = 3  # serve requests a leg sends

# Counts of input and steps that must be equal between the packages.
COUNTS = ("pipeline/batches", "pipeline/examples",
          "pipeline/example_capacity", "pipeline/feature_slots",
          "pipeline/feature_nnz", "pipeline/uniq_rows", "pipeline/bad_lines",
          "pipeline/bytes_fed", "pipeline/lines_parsed", "train/steps",
          "train/examples", "train/h2d_bytes", "train/h2d_bytes_logical",
          "train/checkpoints", "train/epochs", "checkpoint/saves",
          "predict/batches", "predict/examples", "serve/requests",
          "serve/examples", "serve/flushes", "stream/files_discovered",
          "stream/files_sealed", "vocab/ids", "vocab/cold_ids",
          "vocab/admitted_rows", "vocab/evicted_rows",
          "vocab/candidates_dropped")

_JAX_LEGS = r'''
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
assert jax.device_count() == 1, jax.devices()
import fast_tffm_tpu.train as jax_train
from fast_tffm_tpu.config import FmConfig
from fast_tffm_tpu.predict import predict
from fast_tffm_tpu.serve.server import ScorerServer
from tools.fmckpt import main as fmckpt
legs = json.load(open(sys.argv[1]))
table0 = np.load(sys.argv[2])
jax_train.init_table = lambda cfg, seed=0: jnp.asarray(table0)


def cfg_of(kw):
    return FmConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in kw.items()})


for leg in legs:
    cfg = cfg_of(leg["cfg"])
    jax_train.train(cfg)
    if leg.get("predict"):
        predict(cfg)
    if leg.get("serve"):
        step = max(int(d) for d in __import__("os").listdir(
            cfg.model_file + ".ckpt") if d.isdigit())
        assert fmckpt(["publish", cfg.model_file, str(step)]) == 0
        server = ScorerServer(dataclasses.replace(
            cfg, metrics_file=leg["serve"]), watch=False)
        try:
            for lines in leg["requests"]:
                server.score_lines(lines, timeout=60)
        finally:
            server.close()
'''


def _corpus(rng, n, vocab=1000):
    lines = []
    for _ in range(n):
        feats = " ".join(
            f"{int(rng.integers(0, vocab))}:{rng.uniform(0.5, 1.5):.3f}"
            for _ in range(int(rng.integers(1, 12))))
        lines.append(f"{int(rng.integers(0, 2))} {feats}")
    return lines


def _write(path, lines):
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _base(data):
    return dict(vocabulary_size=1 << 10, factor_num=4, batch_size=32,
                epoch_num=2, learning_rate=0.1, train_files=(data["train"],),
                validation_files=(data["val"],),
                predict_files=(data["val"],), metrics_file="auto",
                metrics_flush_steps=2, log_steps=2, save_steps=3,
                trace_spans=True, max_features_per_example=16,
                bucket_ladder=(8, 16), dedup="device", host_threads=1,
                slo_p99_ms=50.0, slo_min_auc=0.5)


def _legs(wd, side, data):
    base = _base(data)
    d = os.path.join(wd, side)
    return [
        {"name": "epochs", "predict": True,
         "serve": os.path.join(d, "serve.jsonl"),
         "requests": data["requests"],
         "cfg": dict(base, model_file=os.path.join(d, "e", "fm"),
                     score_path=os.path.join(d, "e", "score"))},
        {"name": "stream",
         "cfg": dict(base, model_file=os.path.join(d, "s", "fm"),
                     run_mode="stream", stream_dir=data["stream"],
                     stream_poll_seconds=0.05, seal_policy="done",
                     train_files=())},
        {"name": "admit",
         "cfg": dict(base, model_file=os.path.join(d, "a", "fm"),
                     vocabulary_size=64, vocab_mode="admit",
                     hash_feature_id=True, epoch_num=2)},
    ]


def _cfg(kw):
    return FmConfig(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("obs_run"))
    rng = np.random.default_rng(14)
    lines = _corpus(rng, 300)
    data = {"train": os.path.join(wd, "train.txt"),
            "val": os.path.join(wd, "val.txt"),
            "stream": os.path.join(wd, "stream"),
            "requests": [lines[i:i + 5] for i in range(0, 5 * REQUESTS, 5)]}
    _write(data["train"], lines[:240])
    _write(data["val"], lines[240:])
    os.makedirs(data["stream"])
    for k in range(2):
        path = os.path.join(data["stream"], f"part-{k:03d}")
        _write(path, lines[k * 100:(k + 1) * 100])
        open(path + ".done", "w").close()
    open(os.path.join(data["stream"], "STOP"), "w").close()
    cfg = _cfg(_legs(wd, "port", data)[0]["cfg"])
    table0 = np.random.default_rng(5).uniform(
        -cfg.init_value_range, cfg.init_value_range,
        (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    table0[-1] = 0.0
    np.save(os.path.join(wd, "table0.npy"), table0)
    with open(os.path.join(wd, "legs.json"), "w") as fh:
        json.dump(_legs(wd, "jax", data), fh)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_LEGS, os.path.join(wd, "legs.json"),
         os.path.join(wd, "table0.npy")], cwd=wd, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for leg in _legs(wd, "port", data):
        cfg = _cfg(leg["cfg"])
        t0 = table0 if cfg.num_rows == table0.shape[0] else \
            table0[:cfg.num_rows]
        train(cfg, device="cpu", init_state=convert.state_from_numpy(
            t0.copy(), np.full_like(t0, cfg.adagrad_init), cfg, CPU))
        if leg.get("predict"):
            predict(cfg, device="cpu")
        if leg.get("serve"):
            step = max(int(d) for d in os.listdir(cfg.model_file + ".ckpt")
                       if d.isdigit())
            assert fmckpt.main(["publish", cfg.model_file, str(step)]) == 0
            server = ScorerServer(dataclasses.replace(
                cfg, metrics_file=leg["serve"]), device="cpu", watch=False)
            try:
                for req in leg["requests"]:
                    server.score_lines(req, timeout=60)
            finally:
                server.close()
    return wd, data


def _segments(path):
    """One event list per run (the sink appends: train, then predict)."""
    out = []
    for e in read_events(path):
        if e["event"] == "run_start":
            out.append([])
        out[-1].append(e)
    return out


def _names(events):
    metrics = [e for e in events if e["event"] == "metrics"]
    names = {k: set() for k in ("counters", "gauges", "hists")}
    bounds = {}
    for m in metrics:
        for k in names:
            names[k] |= set(m[k])
        for h, s in m["hists"].items():
            bounds[h] = s["bounds"]
    health = sorted({e.get("status") for e in events
                     if e["event"] == "health"})
    spans = {e["name"] for e in events if e["event"] == "span"}
    scalars = [(e["name"], e["step"]) for e in events
               if e["event"] == "scalar"]
    return {"kinds": sorted({e["event"] for e in events}), "names": names,
            "bounds": bounds, "spans": spans, "health": health,
            "scalars": scalars, "last": metrics[-1]}


# Names one package writes and the other does not, with the reason
# (ROADMAP.md §C lists them).
ONLY_JAX = set()
ONLY_PORT = set()


def _streams(runs, leg, which):
    wd, data = runs
    out = []
    for side in ("jax", "port"):
        leg_def = [x for x in _legs(wd, side, data) if x["name"] == leg][0]
        if which == "serve":
            path = leg_def["serve"]
        else:
            path = leg_def["cfg"]["model_file"] + ".metrics.jsonl"
        seg = _segments(path)
        out.append(seg[0 if which in ("train", "serve") else 1])
    return out


@pytest.mark.parametrize("leg,which", [
    ("epochs", "train"), ("epochs", "predict"), ("epochs", "serve"),
    ("stream", "train"), ("admit", "train")])
def test_streams_hold_the_same_names_and_counts(runs, leg, which):
    jev, pev = _streams(runs, leg, which)
    j, p = _names(jev), _names(pev)
    assert p["kinds"] == j["kinds"]
    for k in ("counters", "gauges", "hists"):
        assert p["names"][k] - ONLY_PORT == j["names"][k] - ONLY_JAX, k
    assert p["bounds"] == j["bounds"]
    assert p["spans"] == j["spans"]
    assert p["health"] == j["health"]
    assert p["scalars"] == j["scalars"]
    jc, pc = j["last"]["counters"], p["last"]["counters"]
    for name in COUNTS:
        assert pc.get(name) == jc.get(name), name
    assert p["last"]["run"]["kind"] == j["last"]["run"]["kind"]
    assert set(p["last"]["run"]) == set(j["last"]["run"])
    assert pev[-1]["event"] == jev[-1]["event"] == "run_end"


def test_epochs_counts_are_the_runs_own(runs):
    jev, pev = _streams(runs, "epochs", "train")
    c = _names(pev)["last"]["counters"]
    # 240 lines, batch 32: 8 steps an epoch; validation 60 lines a pass.
    assert c["train/steps"] == 16 and c["train/examples"] == 480
    assert c["pipeline/examples"] == 2 * 240 + 2 * 60
    assert c["checkpoint/saves"] == 6  # steps 3 .. 15 and the final 16
    serve = _names(_streams(runs, "epochs", "serve")[1])["last"]
    assert serve["counters"]["serve/requests"] == REQUESTS
    assert serve["gauges"]["slo/p99_ms"] == 50.0


@pytest.mark.parametrize("leg,which", [
    ("epochs", "train"), ("epochs", "serve"), ("stream", "train")])
def test_the_reference_reads_the_ports_stream(runs, leg, which, tmp_path,
                                              capsys):
    paths = []
    for side, events in zip(("jax", "port"), _streams(runs, leg, which)):
        path = str(tmp_path / f"{side}.jsonl")
        with open(path, "w") as fh:
            fh.write("".join(json.dumps(e) + "\n" for e in events))
        paths.append(path)
    jpath, ppath = paths
    assert [e["event"] for e in jax_read_events(ppath)] == \
        [e["event"] for e in read_events(ppath)]
    js, ps = attribution.summarize([jpath]), attribution.summarize([ppath])
    assert attribution.health_verdict(ps) == attribution.health_verdict(js)
    assert attribution.health_verdict(ps)["verdict"] == "OK"
    assert fmstat_main([ppath]) == 0
    assert fmstat_main([ppath, "--json"]) == 0
    out = capsys.readouterr().out
    assert "health" in out.lower()
    if (leg, which) == ("epochs", "train"):
        # The JAX package's own reader gives the port's stream the same
        # table and verdict.
        for argv in ([ppath], [ppath, "--json"]):
            assert fmstat_main(argv) == 0
            port = capsys.readouterr().out
            assert jax_fmstat_main(argv) == 0
            assert capsys.readouterr().out == port


def _small_cfg(tmp_path, **kw):
    rng = np.random.default_rng(2)
    _write(str(tmp_path / "t.txt"), _corpus(rng, 128))
    base = dict(vocabulary_size=1 << 10, factor_num=4, batch_size=32,
                epoch_num=1, train_files=(str(tmp_path / "t.txt"),),
                model_file=str(tmp_path / "m" / "fm"), metrics_file="auto",
                metrics_flush_steps=1, log_steps=0, dedup="device")
    base.update(kw)
    return FmConfig(**base)


def _verdict(path):
    return attribution.health_verdict(attribution.summarize([path]))


def test_a_nan_loss_gives_one_nonfinite_event(tmp_path):
    cfg = _small_cfg(tmp_path)
    t = np.full((cfg.num_rows, cfg.row_dim), np.nan, np.float32)
    train(cfg, device="cpu", init_state=convert.state_from_numpy(
        t, np.full_like(t, cfg.adagrad_init), cfg, CPU))
    path = cfg.model_file + ".metrics.jsonl"
    bad = [e for e in read_events(path)
           if e.get("status") == "nonfinite_loss"]
    assert len(bad) == 1
    assert (bad[0]["name"], bad[0]["step_first"], bad[0]["count"]) == \
        ("train/loss", 1, 4)
    assert _verdict(path)["verdict"] == "NONFINITE"


def test_a_crash_mid_epoch_ends_the_stream_with_crash(tmp_path,
                                                     monkeypatch):
    import fast_tffm_tpu_torch.train as ptrain
    cfg = _small_cfg(tmp_path, trace_spans=True)
    real = ptrain.train_step_body
    calls = [0]

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected step failure")
        return real(*a, **k)

    monkeypatch.setattr(ptrain, "train_step_body", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        train(cfg, device="cpu")
    path = cfg.model_file + ".metrics.jsonl"
    events = list(read_events(path))
    (crash,) = [e for e in events if e["event"] == "crash"]
    assert crash["step"] == 2 and "injected step failure" in crash["error"]
    assert crash["recent_events"]
    spans = [e for e in events if e["event"] == "span"
             and e["name"] == "train/step"]
    assert spans[-1].get("error") == "RuntimeError"
    assert events[-1]["event"] == "run_end"
    assert _verdict(path)["verdict"] == "CRASHED"


def test_a_walk_back_gives_ckpt_fallback(tmp_path):
    cfg = _small_cfg(tmp_path, save_steps=2, metrics_file="")
    train(cfg, device="cpu")  # steps 2 and 4 committed
    ckpt = cfg.model_file + ".ckpt"
    newest = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    with open(os.path.join(ckpt, str(newest), "table.pt"), "r+b") as fh:
        fh.seek(64)
        fh.write(b"\x00garbage\x00")
    cfg = dataclasses.replace(cfg, metrics_file="auto", epoch_num=1)
    train(cfg, device="cpu")
    path = cfg.model_file + ".metrics.jsonl"
    events = list(read_events(path))
    (fb,) = [e for e in events if e.get("status") == "ckpt_fallback"]
    assert fb["step"] == newest and "corrupt-" in fb["quarantined"]
    c = [e for e in events if e["event"] == "metrics"][-1]["counters"]
    assert c["checkpoint/quarantined_steps"] == 1.0
    assert c["checkpoint/fallbacks"] == 1.0
    assert _verdict(path)["verdict"].startswith("OK")
