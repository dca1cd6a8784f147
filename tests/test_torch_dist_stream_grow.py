"""Elastic membership of the port's multi-process stream on the CPU: the
JAX package's ``kill-then-grow`` scenario (tools/fmchaos) over two
``python -m fast_tffm_tpu_torch train <cfg> --device cpu dist_train
worker <i>`` processes with ``run_mode = stream``, and ``elastic =
shrink`` without a joiner.

The corpus is phase-gated: four shards of exact batches, staged one at a
time, each waited on until the published pointer names its last step.
Ledger owners alternate 0, 1, 0, 1.

- kill-then-grow (``elastic = grow``): after shards 0 and 1, worker 1 is
  SIGKILLed while both idle in the flags window; the survivor reforms
  alone (generation 1), restores the published step with its merged
  watermark and runs the single-process arm; a ``train <cfg> --join``
  replacement is admitted at the next publish settle (generation 2) and
  takes ledger index 3; shards 2 and 3 train at full membership. The
  final table and accumulator are bit-identical to an uninterrupted
  2-worker control over the same corpus, the final step and watermark
  say every line trained exactly once, the joiner stepped shard 3, the
  reform and grow log their generations, and the lease directory holds
  only the final generation's files.
- ``elastic = shrink``: the survivor of the same kill finishes shards 2
  and 3 alone, every line exactly once.

The killed runs write their telemetry (``metrics_file``, a flush every
step): ``train/examples`` summed over the chief's stream, the dead
worker's shard and the joiner's (appended to the same ``.p1``) equals
every line written, as the JAX scenario checks, and the port's fmstat
and the JAX package's both read the healed run as ``RECOVERED (gen 2, 2
workers)``, the shrunken one as ``DEGRADED (1 worker lost)``.
"""

import os
import re
import signal
import sys

import torch

from fast_tffm_tpu.obs import attribution as jax_attribution
from fast_tffm_tpu_torch.checkpoint import (CheckpointState, read_watermark)
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.obs import attribution
from fast_tffm_tpu_torch.tools import fmstat
from fast_tffm_tpu_torch.train import checkpoint_template
from tools import fmstat as jax_fmstat

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

STEPS = ranks.STREAM_STEPS


def _final(cfg):
    ckpt = CheckpointState(cfg.model_file)
    try:
        return ckpt.restore(template=checkpoint_template(cfg))
    finally:
        ckpt.close()


def _stage(wd, cfg, procs, i):
    ranks.stage_shard(wd, i, ranks.stream_shard_lines(i))
    ranks.wait_for(lambda: ranks.published_step(cfg.model_file)
                   >= STEPS * (i + 1), procs, wd,
                   f"shard {i}'s steps published")


def _run(wd, elastic, kill, join):
    """Shards 0-1, then (``kill``) SIGKILL worker 1 and wait for the
    survivor's recovery and (``join``) a joiner's admission, then shards
    2-3 and STOP. Returns the config, the exit codes and the logs. A
    killed run writes its telemetry."""
    cfg_path = ranks.write_stream_run(wd, elastic=elastic, metrics=kill)
    cfg = load_config(cfg_path)
    argv = ["train", cfg_path, "--device", "cpu"]
    procs = {f"w{i}": ranks.spawn_cli(wd, f"w{i}", "none",
                                      argv + ["dist_train", "worker", str(i)])
             for i in (0, 1)}
    live = dict(procs)
    for i in (0, 1):
        _stage(wd, cfg, live, i)
    if kill:
        procs["w1"].send_signal(signal.SIGKILL)
        procs["w1"].wait()
        live = {"w0": procs["w0"]}
        ranks.wait_for(lambda: ranks.log_has(wd, "w0",
                                             "elastic recovery complete"),
                       live, wd, "the survivor's shrink")
        if join:
            procs["join"] = live["join"] = ranks.spawn_cli(
                wd, "join", "none", argv + ["--join"])
            ranks.wait_for(lambda: ranks.log_has(
                wd, "w0", "input shards re-balanced"), live, wd,
                "the joiner's admission at a publish settle")
    for i in (2, 3):
        _stage(wd, cfg, live, i)
    ranks.stop_stream(wd)
    rcs, logs = ranks.wait_all(procs, wd)
    return cfg, dict(zip(procs, rcs)), logs


def _assert_exactly_once(cfg):
    final = _final(cfg)
    step = int(final["step"])
    assert step == 4 * STEPS
    wm = read_watermark(cfg.model_file + ".ckpt", step)
    assert [os.path.basename(f["path"]) for f in wm["files"]] == [
        f"part-{i:05d}" for i in range(4)]
    for f in wm["files"]:
        with open(f["path"], "rb") as fh:
            blob = fh.read()
        assert (f["bytes"], f["lines"]) == (len(blob),
                                            blob.count(b"\n")), f
        assert os.path.exists(f["path"] + ".done"), f
    assert sum(f["lines"] for f in wm["files"]) == \
        4 * ranks.STREAM_SHARD_LINES
    return final


def _assert_streams(cfg, verdict, capsys):
    """Every line trained once by the shards' ``train/examples``, the
    survivor's ``worker_lost`` naming process 1, and ``verdict`` from
    both packages' readers, the port's fmstat printing as the JAX one."""
    shards = [cfg.metrics_file, cfg.metrics_file + ".p1"]
    summary = attribution.summarize(shards)
    assert summary["counters"]["train/examples"] == \
        4 * ranks.STREAM_SHARD_LINES
    lost = [h for h in summary["health_events"]
            if h.get("status") == "worker_lost"]
    assert lost and all([p["process_index"] for p in h["lost"]] == [1]
                        for h in lost), lost
    assert attribution.health_verdict(summary)["verdict"] == verdict
    assert jax_attribution.health_verdict(jax_attribution.summarize(
        shards))["verdict"] == verdict
    capsys.readouterr()
    assert fmstat.main(shards) == 0
    port = capsys.readouterr().out
    assert jax_fmstat.main(shards) == 0
    assert capsys.readouterr().out == port
    assert f"health: {verdict}" in port


def test_kill_then_grow_equals_the_uninterrupted_control(tmp_path, capsys):
    cfg, rcs, logs = _run(str(tmp_path / "healed"), "grow", kill=True,
                          join=True)
    tails = ranks.log_tails(logs)
    assert rcs == {"w0": 0, "w1": -9, "join": 0}, (rcs, tails)
    out0, outj = logs["w0"], logs["join"]
    for want in ("worker lost", "process 1",
                 "elastic shrink recovery, cluster generation 1",
                 "elastic reform generation 1: survivors [0]",
                 "elastic recovery complete: 1 survivor(s)",
                 f"restored checkpoint at step {2 * STEPS}",
                 "elastic grow: admitting joiner(s) [1] into cluster "
                 "generation 2",
                 "elastic grow generation 2: members [0, 1] (admitted [1])",
                 "elastic recovery complete: 2 member(s) (admitted [1]), "
                 "input shards re-balanced", "training done"):
        assert want in out0, (want, tails)
    for want in ("join: admitted into generation 2 as rank 1 of 2 (worker "
                 "slot 1)", f"restored checkpoint at step {2 * STEPS}",
                 "multi-process training: rank 1 of 2", "training done"):
        assert want in outj, (want, tails)
    # The joiner owns ledger index 3 (3 % 2): it stepped shard 3, alone
    # of the shards it read.
    assert re.search(r"stream input: %d batches, %d examples" % (
        STEPS, ranks.STREAM_SHARD_LINES), outj), tails
    done = [re.search(r"training done: (\d+) steps", t).group(1)
            for t in (out0, outj)]
    assert done == [str(4 * STEPS)] * 2
    healed = _assert_exactly_once(cfg)
    _assert_streams(cfg, "RECOVERED (gen 2, 2 workers)", capsys)
    assert sorted(os.listdir(cfg.model_file + ".hb")) == [
        "commit-2.json", "grow-2.json", "reform-2-0", "reform-2-1"]
    ccfg, crcs, clogs = _run(str(tmp_path / "control"), "grow", kill=False,
                             join=False)
    assert crcs == {"w0": 0, "w1": 0}, ranks.log_tails(clogs)
    control = _assert_exactly_once(ccfg)
    for k in ("table", "acc"):
        assert torch.equal(healed[k], control[k]), (
            k, float((healed[k] - control[k]).abs().max()))


def test_shrink_survivor_finishes_every_shard_alone(tmp_path, capsys):
    cfg, rcs, logs = _run(str(tmp_path), "shrink", kill=True, join=False)
    tails = ranks.log_tails(logs)
    assert rcs == {"w0": 0, "w1": -9}, (rcs, tails)
    out0 = logs["w0"]
    for want in ("elastic reform generation 1: survivors [0], this "
                 "process re-ranks 0 -> 0 of 1",
                 f"restored checkpoint at step {2 * STEPS}",
                 "training done"):
        assert want in out0, (want, tails)
    # Alone, the survivor read shards 2 and 3 (and owns every index).
    assert re.search(r"stream input: %d batches, %d examples" % (
        2 * STEPS, 2 * ranks.STREAM_SHARD_LINES), out0), tails
    _assert_exactly_once(cfg)
    _assert_streams(cfg, "DEGRADED (1 worker lost)", capsys)
