"""Whole ``dist_train`` commands of the port on the CPU: two processes of
``python -m fast_tffm_tpu_torch train|predict <cfg> --device cpu
dist_train worker <i>`` over gloo on a free port (the processes import
no jax).

- Train: both workers step in lockstep (the same losses in both logs,
  ``fixed unique-row bucket`` logged), the chief alone logs validation
  and writes the checkpoint and the ``.npz`` export; the final
  validation AUC is within 0.03 of a single-process run on the same
  lines (the JAX package's multi-process contract,
  tests/test_multiprocess.py) and of the JAX package's exact AUC of the
  2-worker model's own scores.
- Predict: one merged score file per input, one line per input line,
  blank lines included, no ``*.part*`` left; the scores equal a
  single-process predict of the same step within atol 2e-6.
- A step saved by 2 ranks restores on 1: a single-process train resumes
  at its step, and its table equals the 2-rank export.
- Liveness: a worker SIGKILLed mid-epoch makes the survivor exit
  non-zero naming it (``WorkerLostError``), within
  ``collective_timeout_seconds`` plus the lease's staleness — no hang.

The predict reuses the train's rendezvous port right after the train:
the train's store connections may hold it in TIME_WAIT then, which the
port's bring-up must not read as a listener
(test_torch_dist_liveness.py holds that alone).
"""

import dataclasses
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fast_tffm_tpu.metrics import exact_auc
from fast_tffm_tpu_torch.checkpoint import list_step_dirs
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.predict import load_table, predict
from fast_tffm_tpu_torch.train import evaluate, train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

REPO = ranks.REPO
CFG = """[General]
vocabulary_size = 200
factor_num = 8
model_file = {wd}/model/fm
[Train]
train_files = {repo}/data/sample_train.txt
validation_files = {repo}/data/sample_test.txt
epoch_num = {epochs}
batch_size = 64
learning_rate = 0.1
factor_lambda = 1e-6
bias_lambda = 1e-6
init_value_range = 0.01
log_steps = 4
save_steps = 7
max_features_per_example = 64
bucket_ladder = 8,16,32,64
host_threads = 1
metrics_file = auto
[Predict]
predict_files = {wd}/predict.txt
score_path = {wd}/score
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = 0.25
collective_timeout_seconds = {timeout}
cluster_connect_timeout_seconds = 60
"""


def _write_cfg(wd, epochs=2, timeout=30.0, name="dist.cfg"):
    port = ranks.free_port()
    path = os.path.join(wd, name)
    with open(path, "w") as fh:
        fh.write(CFG.format(wd=wd, repo=REPO, epochs=epochs,
                            hosts=ranks.worker_hosts(port, 2),
                            timeout=timeout))
    return path


def _spawn(mode, cfg_path, i, wd, tag):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    log = open(os.path.join(wd, f"{tag}{i}.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "fast_tffm_tpu_torch", mode, cfg_path,
         "--device", "cpu", "dist_train", "worker", str(i)],
        cwd=wd, env=env, stdout=log, stderr=subprocess.STDOUT)


def _run_both(mode, cfg_path, wd, tag, timeout=180):
    """Both workers of one command; a failure reports each worker's exit
    code and its log's tail (a fixture's failure reaches every test that
    uses it: the tails name the cause)."""
    procs = [_spawn(mode, cfg_path, i, wd, tag) for i in range(2)]
    rcs = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append(None)  # still running at the deadline
        finally:
            p.kill()
    logs = [open(os.path.join(wd, f"{tag}{i}.log")).read()
            for i in range(2)]
    assert rcs == [0, 0], (f"{mode} workers exited {rcs}" + ranks.log_tails(
        {f"{tag}{i}": text for i, text in enumerate(logs)}, 4000))
    return logs


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("dist_cli"))
    lines = open(os.path.join(REPO, "data", "sample_test.txt")).read(
        ).splitlines()
    # Blank lines score as the bias: the merged file keeps one line per
    # input line.
    with open(os.path.join(wd, "predict.txt"), "w") as fh:
        fh.write("\n".join(lines[:150] + ["", ""] + lines[150:]) + "\n")
    cfg_path = _write_cfg(wd)
    train_logs = _run_both("train", cfg_path, wd, "train")
    predict_logs = _run_both("predict", cfg_path, wd, "predict")
    return wd, cfg_path, train_logs, predict_logs, len(lines) + 2


def _losses(log):
    return re.findall(r"step (\d+) epoch \d+ loss ([0-9.]+)", log)


def _final_auc(log):
    return float(re.search(r"final validation AUC ([0-9.]+)", log).group(1))


def test_two_workers_train_in_lockstep(dist_run):
    wd, _, (log0, log1), _, _ = dist_run
    assert _losses(log0) == _losses(log1) != []
    for log in (log0, log1):
        assert "fixed unique-row bucket:" in log
        assert re.search(r"rank [01] of 2 on cpu", log)
    # The chief alone validates aloud and writes.
    assert "validation AUC" in log0 and "validation AUC" not in log1
    assert "checkpoint step" in log0 and "checkpoint step" not in log1
    assert os.path.exists(os.path.join(wd, "model", "fm.npz"))
    for i, log in enumerate((log0, log1)):
        m = re.search(r"worker (\d) of 2: (\d+) steps, (\d+) local examples",
                      log)
        assert m and int(m.group(1)) == i
    # Every training line once across the two byte ranges, per epoch.
    n = [int(re.search(r"(\d+) local examples", lg).group(1))
         for lg in (log0, log1)]
    assert sum(n) == 2 * 2000


def test_dist_arms_log_the_telemetry_keys_as_ignored(dist_run):
    # The multi-process arms write their streams: no rank logs a key as
    # ignored, each writes its own shard (the chief the file itself,
    # worker 1 its .p1), a train segment then a predict segment, and the
    # shards' train/examples sum to every line of both epochs.
    from fast_tffm_tpu_torch.obs.sink import read_events
    wd, _, train_logs, predict_logs, _ = dist_run
    for log in train_logs + predict_logs:
        assert "is accepted and ignored" not in log
    base = os.path.join(wd, "model", "fm.metrics.jsonl")
    examples = 0
    for i, path in enumerate((base, base + ".p1")):
        events = list(read_events(path))
        starts = [e for e in events if e["event"] == "run_start"]
        assert [e["meta"]["kind"] for e in starts] == ["train", "predict"]
        assert {(e["meta"]["process_index"], e["meta"]["process_count"])
                for e in starts} == {(i, 2)}
        assert [e["event"] for e in events].count("run_end") == 2
        train_seg = events[:events.index(starts[1])]
        last = [e for e in train_seg if e["event"] == "metrics"][-1]
        examples += last["counters"]["train/examples"]
    assert examples == 2 * 2000


def test_auc_matches_a_single_process_run(dist_run, tmp_path):
    wd, cfg_path, (log0, _), _, n_lines = dist_run
    multi = _final_auc(log0)
    cfg = load_config(cfg_path)
    single_cfg = dataclasses.replace(
        cfg, worker_hosts=(), model_file=str(tmp_path / "m" / "fm"),
        log_file="")
    train(single_cfg, device="cpu")
    single = load_table(single_cfg, torch.device("cpu"))
    single_auc, _ = evaluate(single_cfg, single, single_cfg.validation_files)
    assert abs(multi - single_auc) <= 0.03
    assert multi > 0.9
    # The JAX package's exact AUC of the 2-worker model's merged scores.
    labels = [float(ln.split()[0]) for ln in open(
        os.path.join(REPO, "data", "sample_test.txt"))]
    scores = np.loadtxt(os.path.join(wd, "score", "predict.txt.score"))
    keep = np.r_[np.arange(150), np.arange(152, n_lines)]
    assert abs(exact_auc(scores[keep], np.asarray(labels)) - multi) <= 0.03


def test_merged_predict_equals_single_process(dist_run, tmp_path):
    wd, cfg_path, _, (plog0, plog1), n_lines = dist_run
    out = os.path.join(wd, "score", "predict.txt.score")
    merged = np.loadtxt(out)
    assert len(open(out).read().splitlines()) == n_lines
    assert not [f for f in os.listdir(os.path.join(wd, "score"))
                if ".part" in f]
    assert "merged 2 parts" in plog0 and "merged" not in plog1
    cfg = dataclasses.replace(load_config(cfg_path), worker_hosts=(),
                              score_path=str(tmp_path / "single"))
    (single_out,) = predict(cfg, device="cpu")
    single = np.loadtxt(single_out)
    np.testing.assert_allclose(merged, single, rtol=0, atol=2e-6)
    # The blank lines score as the model's bias alone, on both routes.
    assert merged[150] == merged[151]


def test_two_rank_step_restores_on_one(dist_run, tmp_path):
    wd, cfg_path, (log0, _), _, _ = dist_run
    cfg = dataclasses.replace(load_config(cfg_path), worker_hosts=())
    step = int(re.search(r"training done: (\d+) steps", log0).group(1))
    table = load_table(cfg, torch.device("cpu"))
    export = np.load(os.path.join(wd, "model", "fm.npz"))["table"]
    np.testing.assert_array_equal(table.numpy()[:cfg.vocabulary_size],
                                  export)
    # A single-process train resumes the 2-rank step (in a copy, so the
    # other tests keep their model).
    mf = str(tmp_path / "resume" / "fm")
    shutil.copytree(cfg.model_file + ".ckpt", mf + ".ckpt")
    resumed = dataclasses.replace(cfg, model_file=mf, epoch_num=1,
                                  validation_files=())
    train(resumed, device="cpu")
    assert max(list_step_dirs(mf + ".ckpt")) > step


def test_killed_worker_surfaces_as_worker_lost(tmp_path):
    wd = str(tmp_path)
    timeout = 20.0
    cfg_path = _write_cfg(wd, epochs=500, timeout=timeout)
    procs = [_spawn("train", cfg_path, i, wd, "kill") for i in range(2)]
    try:
        log1 = os.path.join(wd, "kill1.log")
        deadline = time.monotonic() + 60
        while "step 8 epoch" not in open(log1).read():
            assert time.monotonic() < deadline, open(log1).read()[-2000:]
            assert procs[0].poll() is None
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        rc = procs[0].wait(timeout=timeout + 4 * 0.25 + 30)
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            p.kill()
    log0 = open(os.path.join(wd, "kill0.log")).read()
    assert rc != 0
    assert waited <= timeout + 4 * 0.25 + 5
    assert re.search(r"WorkerLostError.*process 1", log0), log0[-2000:]
