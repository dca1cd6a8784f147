"""A rank lost inside a multi-process stream's publish save, on the CPU:
two ``python -m fast_tffm_tpu_torch train <cfg> --device cpu dist_train
worker <i>`` processes with ``run_mode = stream`` and ``elastic =
grow``, no periodic saves (every save is a publish's, which gathers the
table to the chief).

Worker 1 is lost as it enters the chief's table gather of its first
save past step 8, while shard 2 trains:

- ``kill``: SIGKILL. Its connections close, the chief's gather raises
  and the lease names the peer.
- ``stop``: SIGSTOP, then SIGKILL once the survivor has recovered. Until
  the kill its connections stay open, as those of a killed process that
  is slow to die do (a peer whose heartbeat stopped while its sockets
  live): gloo never raises, and the chief's gather is still pending at
  ``collective_timeout_seconds``. The deadline guard abandons it and
  hands ``WorkerLostError`` to the elastic loop instead of exiting.

Either way the survivor shrinks alone (generation 1), restores the last
published step (8) and retrains shard 2; a ``train <cfg> --join``
replacement is admitted at a publish settle (generation 2) and steps
shard 3. The run ends at step 16 with every line trained exactly once.
"""

import os
import signal
import sys

import pytest
import torch

from fast_tffm_tpu_torch.checkpoint import CheckpointState, read_watermark
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.train import checkpoint_template

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

STEPS = ranks.STREAM_STEPS
# Past the lease's staleness (4 heartbeats of 1 s), short enough for a
# test: the stopped peer's gather is abandoned this long after it began.
COLLECTIVE_TIMEOUT = 8


@pytest.mark.parametrize("death", ["kill", "stop"])
def test_rank_lost_in_a_publish_save_shrinks_then_grows(tmp_path, death):
    wd = str(tmp_path)
    cfg_path = ranks.write_stream_run(wd, elastic="grow", save_steps=0,
                                      collective_timeout=COLLECTIVE_TIMEOUT)
    cfg = load_config(cfg_path)
    argv = ["train", cfg_path, "--device", "cpu"]
    procs = {"w0": ranks.spawn_cli(wd, "w0", "none",
                                   argv + ["dist_train", "worker", "0"]),
             "w1": ranks.spawn_cli(wd, "w1",
                                   f"{death}-in-save-after-step-{2 * STEPS}",
                                   argv + ["dist_train", "worker", "1"])}
    for i in (0, 1):
        ranks.stage_shard(wd, i, ranks.stream_shard_lines(i))
        ranks.wait_for(lambda: ranks.published_step(cfg.model_file)
                       >= STEPS * (i + 1), procs, wd,
                       f"shard {i}'s steps published")
    live = {"w0": procs["w0"]}
    # Shard 2 is rank 0's: its steps run with rank 1's filler, whose
    # first publish save loses rank 1.
    ranks.stage_shard(wd, 2, ranks.stream_shard_lines(2))
    ranks.wait_for(lambda: ranks.log_has(
        wd, "w0", "elastic recovery complete: 1 survivor"), live, wd,
        "the survivor's shrink")
    if death == "stop":
        assert procs["w1"].poll() is None, "the stopped rank exited"
        procs["w1"].send_signal(signal.SIGKILL)
    assert procs["w1"].wait(timeout=60) == -9
    procs["join"] = live["join"] = ranks.spawn_cli(wd, "join", "none",
                                                   argv + ["--join"])
    ranks.wait_for(lambda: ranks.log_has(wd, "w0",
                                         "input shards re-balanced"),
                   live, wd, "the joiner's admission at a publish settle")
    ranks.stage_shard(wd, 3, ranks.stream_shard_lines(3))
    ranks.wait_for(lambda: ranks.published_step(cfg.model_file)
                   >= 4 * STEPS, live, wd, "shard 3's steps published")
    ranks.stop_stream(wd)
    rcs, logs = ranks.wait_all(procs, wd)
    tails = ranks.log_tails(logs)
    assert dict(zip(procs, rcs)) == {"w0": 0, "w1": -9, "join": 0}, (
        rcs, tails)
    out0 = logs["w0"]
    lost = ("failed and the liveness table names dead peers"
            if death == "kill" else
            f"still pending past collective_timeout_seconds="
            f"{COLLECTIVE_TIMEOUT}s")
    for want in ("worker lost (collective 'checkpoint/table'", lost,
                 "process 1 (",
                 "elastic reform generation 1: survivors [0]",
                 f"restored checkpoint at step {2 * STEPS}",
                 "elastic grow generation 2: members [0, 1] (admitted [1])",
                 "training done: 16 steps"):
        assert want in out0, (want, tails)
    assert "exiting 86" not in out0, tails
    assert "training done: 16 steps" in logs["join"], tails
    ckpt = CheckpointState(cfg.model_file)
    try:
        final = ckpt.restore(template=checkpoint_template(cfg))
    finally:
        ckpt.close()
    assert int(final["step"]) == 4 * STEPS
    wm = read_watermark(cfg.model_file + ".ckpt", 4 * STEPS)
    assert [os.path.basename(f["path"]) for f in wm["files"]] == [
        f"part-{i:05d}" for i in range(4)]
    for f in wm["files"]:
        with open(f["path"], "rb") as fh:
            blob = fh.read()
        assert (f["bytes"], f["lines"]) == (len(blob),
                                            blob.count(b"\n")), f
        assert os.path.exists(f["path"] + ".done"), f
