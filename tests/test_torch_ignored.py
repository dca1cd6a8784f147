"""Config keys and the port's entry points (utils/ignored.py): every key
takes effect, so no entry point — ``train``, ``predict``, ``serve``, a
``dist_train`` rank, the fleet supervisor — logs one as ignored; the
``kernel`` key is logged as having no effect, and the keys the port
refuses still raise. The 15 keys the port ignored until its
multi-process and fleet telemetry landed (the 14 run-telemetry keys and
``protocol_trace``) each have a case: no rank of a 2-rank ``dist_train``
and no fleet supervisor logs it, and it reaches the rank's or the
supervisor's ``RunTelemetry``."""

import dataclasses
import glob
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.obs.sink import read_events
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.serve.fleet import FleetSupervisor
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.train import train
from fast_tffm_tpu_torch.utils.ignored import IGNORED_KEYS, ignored_keys_set

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Set away from the default: two telemetry keys, an SLO key and
# protocol_trace.
SET = dict(anatomy=False, metrics_file="auto", slo_min_auc=0.6,
           protocol_trace=True)

# The keys the multi-process arms and the fleet supervisor ignored until
# their telemetry was ported, each with a value away from its default.
TAKE_EFFECT = {
    "metrics_file": "{wd}/obs.jsonl",
    "metrics_flush_steps": 3,
    "trace_spans": True,
    "save_summaries_steps": 4,
    "profile_dir": "{wd}/prof",
    "profile_start_step": 2,
    "profile_num_steps": 2,
    "watchdog_stall_seconds": 120.0,
    "mem_pressure_fraction": 0.5,
    "anatomy": False,
    "slo_publish_staleness_seconds": 30.0,
    "slo_p99_ms": 40.0,
    "slo_max_bad_fraction": 0.02,
    "slo_min_auc": 0.6,
    "protocol_trace": True,
}

DIST_CFG = """[General]
vocabulary_size = 200
factor_num = 4
model_file = {wd}/model/fm
[Train]
train_files = {repo}/data/sample_train.txt
epoch_num = 1
batch_size = 64
log_steps = 4
host_threads = 1
{keys}
[SLO]
{slo_keys}
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = 0.5
cluster_connect_timeout_seconds = 90
"""


@pytest.fixture
def port_log(caplog):
    """The port's logger does not propagate: hand caplog's handler to
    it for the test."""
    lg = logging.getLogger("fast_tffm_tpu_torch")
    lg.addHandler(caplog.handler)
    caplog.set_level(logging.INFO, logger="fast_tffm_tpu_torch")
    try:
        yield caplog
    finally:
        lg.removeHandler(caplog.handler)
        for h in [h for h in lg.handlers
                  if isinstance(h, logging.FileHandler)]:
            lg.removeHandler(h)
            h.close()


def _assert_logged(caplog):
    """No key is logged as ignored, A11b's least of all."""
    assert "is accepted and ignored" not in caplog.text
    assert "item A11b" not in caplog.text


def _assert_stream(path):
    """A run's stream: run_start first, run_end last, the slo_min_auc
    gauge stamped."""
    events = list(read_events(path))
    assert events[0]["event"] == "run_start"
    assert events[-1]["event"] == "run_end"
    gauges = [e["gauges"] for e in events if e["event"] == "metrics"]
    assert gauges and gauges[-1]["slo/min_auc"] == 0.6


def _cfg(wd, **kw):
    return FmConfig(
        vocabulary_size=200, factor_num=4, batch_size=32, epoch_num=1,
        train_files=(os.path.join(REPO, "data", "sample_train.txt"),),
        predict_files=(os.path.join(REPO, "data", "sample_test.txt"),),
        model_file=os.path.join(wd, "model", "fm"),
        score_path=os.path.join(wd, "score"), serve_max_batch=8, **kw)


def _published(wd, **kw):
    cfg = _cfg(wd, **kw)
    table = np.random.default_rng(0).uniform(
        -0.1, 0.1, (cfg.vocabulary_size, cfg.row_dim)).astype(np.float32)
    save_checkpoint_from_numpy(cfg, table, None, 2)
    assert fmckpt.main(["publish", cfg.model_file, "2"]) == 0
    return cfg


def _values(wd):
    return {k: v.format(wd=wd) if isinstance(v, str) else v
            for k, v in TAKE_EFFECT.items()}


@pytest.fixture(scope="module")
def dist_rank(tmp_path_factory):
    """A 2-rank dist_train (one epoch) with every key of TAKE_EFFECT set,
    its workers processes on the CPU: (work dir, the two ranks' logs,
    the chief's and worker 1's events)."""
    wd = str(tmp_path_factory.mktemp("keys"))
    lines = {k: f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
             for k, v in _values(wd).items()}
    path = os.path.join(wd, "dist.cfg")
    with open(path, "w") as fh:
        fh.write(DIST_CFG.format(
            wd=wd, repo=REPO,
            keys="\n".join(v for k, v in lines.items()
                           if not k.startswith("slo_")),
            slo_keys="\n".join(v for k, v in lines.items()
                               if k.startswith("slo_")),
            hosts=ranks.worker_hosts(ranks.free_port(), 2)))
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fast_tffm_tpu_torch", "train", path,
         "--device", "cpu", "dist_train", "worker", str(i)],
        cwd=wd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], ranks.log_tails(
        {f"worker{i}": text for i, text in enumerate(logs)})
    events = [list(read_events(os.path.join(wd, name)))
              for name in ("obs.jsonl", "obs.jsonl.p1")]
    return wd, logs, events


@pytest.fixture(scope="module")
def supervisor_tel(tmp_path_factory):
    """The fleet supervisor of a config with every key of TAKE_EFFECT set
    (never started): (its log, its RunTelemetry)."""
    wd = str(tmp_path_factory.mktemp("sup"))
    lg = logging.getLogger("fast_tffm_tpu_torch")
    cap = _Capture()
    lg.addHandler(cap)
    try:
        cfg = dataclasses.replace(_cfg(wd, serve_port=7170),
                                  **_values(wd))
        sup = FleetSupervisor(cfg, os.path.join(wd, "unused.cfg"),
                              replicas=2, device="cpu")
        tel = sup._tel
        sup.stop()
    finally:
        lg.removeHandler(cap)
    return "\n".join(cap.lines), tel


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _chief_metrics(events):
    return [e for e in events if e["event"] == "metrics"]


def _effect(key, wd, events, tel):
    """The key's effect on the rank's stream and outputs, or on the
    supervisor's RunTelemetry."""
    chief, worker = events
    gauges = _chief_metrics(chief)[-1]["gauges"]
    spans = [e for e in chief + worker if e["event"] == "span"]
    if key == "metrics_file":
        assert os.path.exists(os.path.join(wd, "obs.jsonl.p1"))
        assert tel.sink.path.endswith("obs.jsonl")
    elif key == "metrics_flush_steps":
        steps = [e["step"] for e in _chief_metrics(chief)]
        assert {3, 6, 9, 12, 15} <= set(steps)
        assert tel.flush_steps == 3
    elif key == "trace_spans":
        assert {"train/step", "train/step_flags"} <= {e["name"]
                                                     for e in spans}
        assert tel.trace_spans
    elif key == "save_summaries_steps":
        # The chief alone writes TensorBoard, as in the JAX package.
        assert glob.glob(os.path.join(wd, "model", "fm.tb", "*"))
    elif key in ("profile_dir", "profile_start_step", "profile_num_steps"):
        # The chief's window: steps 3-4 of the run.
        assert os.listdir(os.path.join(wd, "prof")) == [
            "train_steps_3-4.trace.json"]
    elif key == "watchdog_stall_seconds":
        assert tel.watchdog is not None
        assert tel.watchdog.stall_seconds == 120.0
    elif key == "mem_pressure_fraction":
        assert tel.mem_pressure_fraction == 0.5
    elif key == "anatomy":
        assert not tel.anatomy
        assert not any(k.startswith("anatomy/") for k in gauges)
        assert not any("step" in e for e in spans
                       if e["name"] == "train/step_flags")
    elif key.startswith("slo_"):
        name = "slo/" + key[len("slo_"):]
        assert gauges[name] == TAKE_EFFECT[key]
    elif key == "protocol_trace":
        assert tel.protocol_trace
        seqs = [[e["label"] for e in ev if e["event"] == "collective"]
                for ev in events]
        assert seqs[0] and seqs[0] == seqs[1]
    else:
        raise AssertionError(f"no effect check for {key}")


@pytest.mark.parametrize("key", sorted(TAKE_EFFECT))
def test_every_telemetry_key_takes_effect(key, dist_rank, supervisor_tel):
    wd, logs, events = dist_rank
    sup_log, tel = supervisor_tel
    for text in logs + [sup_log]:
        assert "is accepted and ignored" not in text
    assert tel is not None
    _effect(key, wd, events, tel)


def test_ignored_keys_set_lists_keys_away_from_default():
    # Nothing is ignored any more: not the keys set away from their
    # defaults, not the keys TAKE_EFFECT sets.
    assert IGNORED_KEYS == ()
    assert ignored_keys_set(FmConfig()) == []
    assert ignored_keys_set(FmConfig(**SET)) == []
    assert ignored_keys_set(dataclasses.replace(
        FmConfig(), **_values("/x"))) == []


def test_train_logs_ignored_keys(tmp_path, port_log):
    cfg = _cfg(str(tmp_path), **SET)
    train(cfg, device="cpu")
    _assert_logged(port_log)
    _assert_stream(cfg.model_file + ".metrics.jsonl")
    # A refusal that stays: admit mode across processes.
    with pytest.raises(ValueError, match="vocab_mode = admit is "
                                         "single-process"):
        train(dataclasses.replace(
            _cfg(str(tmp_path), **SET), vocab_mode="admit",
            worker_hosts=("localhost:1", "localhost:2")),
            device="cpu", job_name="worker", task_index=0)


def test_predict_logs_ignored_keys(tmp_path, port_log):
    cfg = _published(str(tmp_path), **SET)
    (path,) = predict(cfg, device="cpu")
    assert os.path.getsize(path) > 0
    _assert_logged(port_log)
    assert list(read_events(cfg.model_file + ".metrics.jsonl"))[-1][
        "event"] == "run_end"
    # lookup = host predicts too, and logs no key as ignored either.
    port_log.clear()
    (path,) = predict(dataclasses.replace(cfg, lookup="host"),
                      device="cpu")
    assert os.path.getsize(path) > 0
    _assert_logged(port_log)


def test_serve_logs_ignored_keys(tmp_path, port_log):
    cfg = _published(str(tmp_path), **SET)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        assert len(server.score_lines(["1 3:1 5:0.5"], timeout=30).scores) \
            == 1
    finally:
        server.close()
    _assert_logged(port_log)
    _assert_stream(cfg.model_file + ".metrics.jsonl")
    # A fleet replica's server (external reloads) writes the stream its
    # supervisor names for it, <metrics_file>.r<i>, and logs no key as
    # ignored either.
    port_log.clear()
    shard = cfg.model_file + ".metrics.jsonl.r1"
    replica_cfg = dataclasses.replace(cfg, serve_reload_mode="external",
                                      serve_port=7170, serve_replicas=3,
                                      metrics_file=shard)
    server = ScorerServer(replica_cfg, device="cpu", watch=False)
    try:
        assert server.score_lines(["1 3:1"], timeout=30).step == 2
    finally:
        server.close()
    _assert_logged(port_log)
    _assert_stream(shard)


def test_fleet_supervisor_logs_ignored_keys(tmp_path, port_log):
    cfg = _cfg(str(tmp_path), serve_port=7170, **SET)
    sup = FleetSupervisor(cfg, str(tmp_path / "unused.cfg"), replicas=2,
                          device="cpu")
    assert [r.port for r in sup.replicas] == [7170, 7171]
    assert sup.replicas[0].command()[-2:] == ["--device", "cpu"]
    sup.stop()  # never started: nothing to drain
    _assert_logged(port_log)
    # The supervisor's own stream, opened and closed.
    events = list(read_events(cfg.model_file + ".metrics.jsonl"))
    assert events[0]["meta"]["kind"] == "fleet"
    assert events[-1]["event"] == "run_end"


KERNEL_LINE = ("has no effect in fast_tffm_tpu_torch and no ROADMAP.md item "
               "will give it one: a 2nd-order FM runs the hand-written CUDA "
               "kernels on the card and their plain PyTorch versions on the "
               "CPU; FFM and order > 2 run torch ops")


@pytest.mark.parametrize("kernel", ["xla", "pallas", "auto"])
def test_every_entry_point_logs_the_kernel_key(tmp_path, port_log, kernel):
    """``kernel = xla | pallas`` picks a route in the JAX package; the
    port has one route a model, so train, predict, serve and the fleet
    each log the key as having no effect (``auto``, what the port does
    anyway, is not logged), and the run goes on: the order-2 scores are
    those of ``kernel = auto``."""
    want = f"kernel = {kernel!r} {KERNEL_LINE}"
    train(_cfg(str(tmp_path / "t"), kernel=kernel), device="cpu")
    cfg = _published(str(tmp_path / "p"), kernel=kernel)
    (path,) = predict(cfg, device="cpu")
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        scores = server.score_lines(["1 3:1 5:0.5"], timeout=30).scores
    finally:
        server.close()
    sup = FleetSupervisor(dataclasses.replace(cfg, serve_port=7170),
                          str(tmp_path / "unused.cfg"), replicas=2,
                          device="cpu")
    sup.stop()
    logged = port_log.text.count(want)
    assert logged == (0 if kernel == "auto" else 4)
    auto = _published(str(tmp_path / "a"))
    (auto_path,) = predict(auto, device="cpu")
    assert open(path).read() == open(auto_path).read()
    assert len(scores) == 1
