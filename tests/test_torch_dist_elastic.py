"""Elastic shrink of the port's ``dist_train`` (``elastic = shrink``)
against the JAX package's, on the CPU:

- the reform rendezvous (``announce_reform``, ``reform_members``,
  ``fresh``, the lease's replaceable membership) and the settle of
  ``reform_shrunken_cluster`` on the lease directories both packages
  read, with the same fake clocks: equal answers;
- the input of a changed membership: each rank's stream, as the session
  asks for it (fixed-shape batches over more than one rank, the
  single-process stream for a lone survivor), equals the JAX package's
  for the same shard index and count, array for array, and the ranks
  together read every line once;
- ``kill-worker-midwindow``'s contract on two CPU workers of ``python -m
  fast_tffm_tpu_torch train <cfg> --device cpu dist_train worker <i>``:
  worker 1 is SIGKILLed as it begins the step after the first periodic
  save's, and the survivor exits 0 having logged ``worker lost``,
  ``process 1``, ``elastic reform generation 1``, ``elastic recovery
  complete`` and ``training done``; its final step and epoch follow the
  exactly-once arithmetic, and its table equals the JAX package's
  single-process resume from the same verified step over the same
  lines at rtol 1e-4 / atol 1e-6;
- the refusals: ``train --join`` wants ``elastic = grow`` and no role
  argv. (``elastic = off`` failing fast is
  ``test_torch_dist_cli.py::test_killed_worker_surfaces_as_worker_lost``.)
"""

import dataclasses
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.parallel import liveness as jax_lv
from fast_tffm_tpu_torch.__main__ import main as cli
from fast_tffm_tpu_torch.checkpoint import CheckpointState
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.data import pipeline
from fast_tffm_tpu_torch.parallel import liveness as port_lv
from fast_tffm_tpu_torch.train import checkpoint_template, train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

REPO = ranks.REPO
KEYS = ("labels", "weights", "uniq_ids", "local_idx", "vals", "fields")
# The step tolerance of the port against the JAX package.
RTOL, ATOL = 1e-4, 1e-6


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _leases(lv, directory, clock, index, members, hb=5.0):
    return lv.HeartbeatLease(directory, process_index=index,
                             members=members, heartbeat_seconds=hb,
                             host=f"host{index}", pid=100 + index,
                             clock=clock)


def _both(tmp_path, clock, index, members):
    d = str(tmp_path / "hb")
    return (_leases(jax_lv, d, clock, index, members),
            _leases(port_lv, d, clock, index, members))


def test_reform_announcements_equal_the_jax_ones(tmp_path):
    """tests/test_liveness.py's reform case, on one directory both
    packages read: per-generation announce files, read back alike."""
    clock = FakeClock()
    jme, pme = _both(tmp_path, clock, 0, (0, 1, 2))
    jp2, pp2 = _both(tmp_path, clock, 2, (0, 1, 2))
    pme.announce_reform(1)
    jp2.announce_reform(1)
    for lease in (jme, pme):
        assert lease.reform_members(1) == [0, 2]
        assert lease.reform_members(2) == []
    pp2.announce_reform(2)
    assert pme.reform_members(2) == jme.reform_members(2) == [2]
    assert sorted(os.listdir(tmp_path / "hb")) == [
        "reform-1-0", "reform-1-2", "reform-2-2"]


def test_lease_freshness_and_shrunken_membership_equal_the_jax_ones(
        tmp_path):
    """``fresh`` (membership-agnostic) and ``live_members`` over a
    membership the reform replaced: a departed member stops counting,
    a non-member's lease is still judged by its age."""
    clock = FakeClock()
    jme, pme = _both(tmp_path, clock, 0, (0, 1, 2))
    _, peer1 = _both(tmp_path, clock, 1, (0, 1, 2))
    _, peer2 = _both(tmp_path, clock, 2, (0, 1, 2))
    pme.renew()
    peer1.renew()
    peer2.renew()
    clock.t += 30.0  # past 4 x 5 s: peers 1 and 2 stale
    pme.renew()
    peer2.renew()
    for lease in (jme, pme):
        assert lease.live_members() == [0, 2]
        assert [lease.fresh(i) for i in (0, 1, 2, 3)] == [
            True, False, True, False]
        lease.members = (0, 2)  # what the reform assigns
        assert lease.live_members() == [0, 2]
        assert [p.process_index for p in lease.stale_peers()] == []


def test_reform_shrunken_cluster_equals_the_jax_settle(tmp_path,
                                                        monkeypatch):
    """Three workers lose worker 0 (the store's host): survivors 1 and 2
    settle generation 1, re-rank 1 -> 0 and 2 -> 1 and form their group
    at the first survivor's host, port + 1000 + 1; rank 0 sweeps the
    dead member's lease. Each package settles survivor 1 on its own
    directory, with survivor 2 live and announced there (the process
    group stubbed out: the settle and the sweep are compared)."""
    hosts = ("localhost:20000", "localhost:20001", "localhost:20002")
    results = {}
    for name, lv, Cfg in (("jax", jax_lv, JaxConfig),
                          ("port", port_lv, FmConfig)):
        dm = importlib.import_module(
            "fast_tffm_tpu.parallel.distributed" if name == "jax"
            else "fast_tffm_tpu_torch.parallel.distributed")
        joined = []
        monkeypatch.setattr(dm, "_join_cluster",
                            lambda *a, **kw: joined.append(kw))
        monkeypatch.setattr(dm, "retire_distributed_client", lambda: None)
        d = tmp_path / name
        d.mkdir()
        # The dead worker's lease, long stale.
        (d / "worker-0.hb").write_text(
            '{"process_index": 0, "host": "h", "pid": 1, "time": 1.0}')
        cfg = Cfg(worker_hosts=hosts, heartbeat_seconds=0.5,
                  elastic="shrink", cluster_connect_timeout_seconds=60.0)
        leases = [lv.HeartbeatLease(str(d), process_index=i,
                                    members=(0, 1, 2),
                                    heartbeat_seconds=0.5).start()
                  for i in (2, 1)]
        leases[0].announce_reform(1)
        try:
            rank, n, members = dm.reform_shrunken_cluster(cfg, leases[1], 1)
        finally:
            for lease in leases:
                lease.stop(remove=False)
        results[name] = (rank, n, members, leases[1].members, joined,
                         sorted(os.listdir(d)))
    assert results["port"] == results["jax"]
    rank, n, members, lease_members, joined, left = results["port"]
    assert (rank, n, members, lease_members) == (0, 2, [1, 2], (1, 2))
    assert joined == [dict(address="localhost:21002", num_processes=2,
                           process_id=0)]
    assert left == ["reform-1-1", "reform-1-2", "worker-1.hb",
                    "worker-2.hb"]


MEMBERSHIPS = {
    # a 4-worker job that lost two and healed; a 2-worker job's lone
    # survivor reads the whole input as a single process (a stream
    # depends on the rank and the count alone)
    "shrunk4to2": (0, 3),
    "regrown2to4": (0, 1, 2, 3),
    "lone": (1,),
}


def _write_lines(path, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 31 == 17:
            out.append("")
            continue
        ids = rng.integers(0, 200, size=int(rng.integers(1, 12)))
        out.append(" ".join([str(int(rng.random() < 0.4))]
                            + [f"{i}:{rng.random():.3f}" for i in ids]))
    path.write_text("\n".join(out) + "\n")
    return str(path)


@pytest.mark.parametrize("membership", sorted(MEMBERSHIPS))
def test_resharded_input_equals_the_jax_streams(tmp_path, membership):
    members = MEMBERSHIPS[membership]
    files = [_write_lines(tmp_path / "a.txt", 230, 1),
             _write_lines(tmp_path / "b.txt", 75, 2)]
    base = dict(vocabulary_size=200, factor_num=4, batch_size=16,
                bucket_ladder=(8, 16), max_features_per_example=16,
                shuffle=True, seed=5, uniq_bucket=128)
    jcfg, cfg = JaxConfig(**base), FmConfig(**base)
    n = len(members)
    total = 0
    for rank in range(n):
        for epoch in (1, 2):
            kw = dict(training=True, epochs=1, seed=cfg.seed + epoch,
                      shard_index=rank, num_shards=n, fixed_shape=n > 1,
                      uniq_bucket=128 if n > 1 else 0, raw_ids=n == 1)
            want = list(jax_pipeline.batch_iterator(jcfg, files, **kw))
            got = list(pipeline.batch_iterator(cfg, files, **kw))
            assert len(got) == len(want) > 0
            for w, g in zip(want, got):
                assert g.num_real == w.num_real
                for k in KEYS:
                    a, b = getattr(w, k), getattr(g, k)
                    if a is None or b is None:
                        assert a is None and b is None, k
                        continue
                    assert a.dtype == b.dtype and a.shape == b.shape, k
                    assert np.array_equal(a, b), k
            if epoch == 1:
                total += sum(b.num_real for b in got)
    lines = sum(1 for f in files for ln in open(f) if ln.strip())
    assert total == lines


_JAX_RESUME = r'''
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from fast_tffm_tpu.checkpoint import CheckpointState
from fast_tffm_tpu.config import load_config
from fast_tffm_tpu.train import ckpt_state, train
cfg_path, state_path = sys.argv[1], sys.argv[2]
assert jax.device_count() == 1, jax.devices()
cfg = load_config(cfg_path)
st = np.load(state_path)
ckpt = CheckpointState(cfg.model_file)
ckpt.save(int(st["step"]), *ckpt_state(cfg, jnp.asarray(st["table"]),
                                       jnp.asarray(st["acc"])),
          vocabulary_size=cfg.vocabulary_size, wait=True,
          epoch=int(st["epoch"]))
ckpt.close()
train(cfg)
'''


def _single_process_cfg(cfg_path, wd, name):
    """The config without its [Cluster] section, on its own model."""
    with open(cfg_path) as fh:
        text = fh.read()
    text = re.sub(r"\[Cluster\].*", "", text, flags=re.S).replace(
        f"{wd}/model/fm", f"{wd}/{name}/fm")
    path = os.path.join(wd, f"{name}.cfg")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def test_survivor_of_a_killed_worker_finishes_the_schedule(tmp_path):
    wd = str(tmp_path)
    epochs = 2
    cfg_path = ranks.write_elastic_run(wd, epochs, "shrink")
    cfg = load_config(cfg_path)
    kill_at = cfg.save_steps + 2
    argv = ["train", cfg_path, "--device", "cpu", "dist_train", "worker"]
    procs = {"w0": ranks.spawn_cli(wd, "w0", "keep-steps", argv + ["0"]),
             "w1": ranks.spawn_cli(wd, "w1", f"kill-at-step-{kill_at}",
                                   argv + ["1"])}
    rcs, logs = ranks.wait_all(procs, wd)
    tails = ranks.log_tails(logs)
    assert rcs[0] == 0 and rcs[1] == -9, (rcs, tails)
    out0 = logs["w0"]
    for want in ("worker lost", "process 1", "elastic reform generation 1",
                 "elastic recovery complete", "training done"):
        assert want in out0, (want, tails)
    assert re.search(r"elastic reform generation 1: survivors \[0\], this "
                     r"process re-ranks 0 -> 0 of 1", out0), tails
    # Exactly once: the survivor restored the last verified step (s0,
    # epoch e0) and ran epochs e0.. alone, a whole pass each.
    s0 = int(re.findall(r"restored checkpoint at step (\d+)", out0)[-1])
    resumes = re.findall(r"resuming interrupted epoch schedule at epoch "
                         r"(\d+)/", out0)
    e0 = int(resumes[-1]) if resumes else 0
    assert (s0, e0) == (cfg.save_steps, 0), tails
    per_pass = -(-ranks.ELASTIC_LINES // ranks.ELASTIC_BATCH)
    ckpt = CheckpointState(cfg.model_file)
    final = ckpt.restore(template=checkpoint_template(cfg))
    start = ckpt.restore(step=s0, template=checkpoint_template(cfg))
    ckpt.close()
    assert int(final["step"]) == s0 + (epochs - e0) * per_pass
    assert int(final["epoch"]) == epochs
    # The JAX package's single-process resume from the same step.
    state_path = os.path.join(wd, "s0.npz")
    np.savez(state_path, table=start["table"].numpy(),
             acc=start["acc"].numpy(), step=s0, epoch=int(start["epoch"]))
    jax_cfg = _single_process_cfg(cfg_path, wd, "jax")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _JAX_RESUME, jax_cfg,
                           state_path], cwd=wd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"restored checkpoint at step {s0}" in proc.stderr
    with np.load(os.path.join(wd, "jax", "fm.npz")) as j, \
            np.load(cfg.model_file + ".npz") as p:
        assert p["table"].shape == j["table"].shape == (200, 5)
        np.testing.assert_allclose(p["table"], j["table"], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(final["table"][:200].numpy(),
                               np.load(cfg.model_file + ".npz")["table"],
                               rtol=0, atol=0)


def test_join_wants_grow_and_no_role(tmp_path):
    cfg = FmConfig(worker_hosts=("localhost:21000", "localhost:21001"),
                   elastic="shrink", model_file=str(tmp_path / "m" / "fm"))
    with pytest.raises(ValueError, match="elastic = grow"):
        train(cfg, device="cpu", join=True)
    with pytest.raises(ValueError, match="dist_train role"):
        train(dataclasses.replace(cfg, elastic="grow"), device="cpu",
              join=True, job_name="worker", task_index=0)
    assert not os.path.exists(str(tmp_path / "m" / "fm.hb"))
    # The CLI: --join is a train mode; a bad pairing is a usage error.
    assert cli(["predict", "x.cfg", "--device", "cpu", "--join"]) == 2
    assert cli(["train", "x.cfg", "--device", "cpu", "--join",
                "dist_train", "worker", "0"]) == 2
