"""Config keys the port accepts and ignores (utils/ignored.py): each entry
point — ``train``, ``predict``, ``serve`` — logs every such key set away
from its default, naming the ROADMAP.md item that brings it, and the
keys it refuses still raise."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.serve.fleet import FleetSupervisor
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.train import train
from fast_tffm_tpu_torch.utils.ignored import (IGNORED_KEYS,
                                               ignored_keys_set)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Set away from the default: two observability keys and the SLO key,
# whose verdict waits for A11 (outside a publishing stream run with
# validation files, slo_min_auc has no effect at all).
SET = dict(anatomy=False, metrics_file="auto", slo_min_auc=0.6)


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
    text = caplog.text
    assert ("anatomy = False is accepted and ignored: observability is "
            "not ported") in text
    assert "metrics_file = 'auto' is accepted and ignored" in text
    assert ("slo_min_auc = 0.6 is accepted and ignored: the SLO verdict "
            "(slo_min_auc only switches the publish quality sweep on, "
            "under publish_quality_eval = auto, in a stream run with "
            "validation files that publishes) is not ported") in text
    assert text.count("(ROADMAP.md, queue A, item A11)") == 3
    assert "item A13" not in text


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


@pytest.mark.parametrize("key,item,what", IGNORED_KEYS)
def test_every_ignored_key_is_a_config_key(key, item, what):
    defaults = FmConfig()
    assert hasattr(defaults, key) and item == "A11" and what
    assert ignored_keys_set(defaults) == []


def test_ignored_keys_set_lists_keys_away_from_default():
    got = ignored_keys_set(FmConfig(**SET))
    assert [(k, v, item) for k, v, item, _ in got] == [
        ("metrics_file", "auto", "A11"), ("anatomy", False, "A11"),
        ("slo_min_auc", 0.6, "A11")]


def test_train_logs_ignored_keys(tmp_path, port_log):
    train(_cfg(str(tmp_path), **SET), device="cpu")
    _assert_logged(port_log)
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
    # lookup = host predicts too, and logs the same ignored keys.
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
    # A fleet replica's server (external reloads) logs them the same.
    port_log.clear()
    replica_cfg = dataclasses.replace(cfg, serve_reload_mode="external",
                                      serve_port=7170, serve_replicas=3)
    server = ScorerServer(replica_cfg, device="cpu", watch=False)
    try:
        assert server.score_lines(["1 3:1"], timeout=30).step == 2
    finally:
        server.close()
    _assert_logged(port_log)


def test_fleet_supervisor_logs_ignored_keys(tmp_path, port_log):
    cfg = _cfg(str(tmp_path), serve_port=7170, **SET)
    sup = FleetSupervisor(cfg, str(tmp_path / "unused.cfg"), replicas=2,
                          device="cpu")
    assert [r.port for r in sup.replicas] == [7170, 7171]
    assert sup.replicas[0].command()[-2:] == ["--device", "cpu"]
    sup.stop()  # never started: nothing to drain
    _assert_logged(port_log)


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
