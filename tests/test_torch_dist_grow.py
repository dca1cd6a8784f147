"""Elastic grow of the port's ``dist_train`` (``elastic = grow``, ``train
<cfg> --join``) against the JAX package's, on the CPU:

- the grow protocol over files in the lease directory, the port's
  functions beside the JAX package's on the same directories and clocks
  (the cases of tests/test_liveness.py): fresh join tickets in name
  order, two joiners racing one slot, the plan and commit files' round
  trip and the refused joiner's generation floor, a joiner appearing
  mid-settle, a joiner dying mid-rendezvous, a stale-generation announce
  refused (the port logs the refusal; the JAX package's event waits for
  ROADMAP.md A11), the litter sweep, and the barrier's admission check;
- ``kill-then-grow`` on the epoch boundary: two CPU workers with
  ``elastic = grow`` lose worker 1, the survivor shrinks to a lone
  process, and a ``train <cfg> --join`` replacement is admitted at the
  next epoch boundary into slot 1; the job ends at two members with the
  exactly-once step arithmetic, and the lease directory holds only the
  final generation's files;
- ``grow-joiner-dies``: a joiner SIGKILLed as soon as it announced never
  wedges the incumbent, which commits without it and finishes.
"""

import os
import re
import sys
import time

import pytest

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.parallel import liveness as jax_lv
from fast_tffm_tpu.train import _GrowContext as JaxGrowContext
from fast_tffm_tpu_torch.checkpoint import CheckpointState
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.parallel import liveness as port_lv
from fast_tffm_tpu_torch.train import _GrowContext, checkpoint_template

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

BOTH = pytest.mark.parametrize("lv", [jax_lv, port_lv], ids=["jax", "port"])


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _lease(lv, tmp_path, clock, index=0, members=(0, 1), hb=5.0):
    return lv.HeartbeatLease(str(tmp_path / "hb"), process_index=index,
                             members=members, heartbeat_seconds=hb,
                             host=f"host{index}", pid=100 + index,
                             clock=clock)


def _ticket(lv, tmp_path, clock, name, t=None):
    """A join ticket written by hand (no renew thread)."""
    tk = lv.JoinTicket(str(tmp_path / "hb"), heartbeat_seconds=1.0,
                       clock=clock, name=name, pid=500)
    old = clock.t
    clock.t = old if t is None else t
    tk.renew()
    clock.t = old
    return tk


@BOTH
def test_pending_join_tickets_freshness_and_order(tmp_path, lv):
    clock = FakeClock()
    hb = str(tmp_path / "hb")
    _ticket(lv, tmp_path, clock, "join-0002-b")
    _ticket(lv, tmp_path, clock, "join-0001-a")
    _ticket(lv, tmp_path, clock, "join-0000-dead", t=clock.t - 60)
    (tmp_path / "hb" / "join-0003-torn").write_text("{garb")
    want = ["join-0001-a", "join-0002-b"]
    for mod in (jax_lv, port_lv):
        assert mod.pending_join_tickets(hb, stale_after=20.0,
                                        now=clock.t) == want
        assert mod.pending_join_tickets(str(tmp_path / "nodir"), 20.0) == []


def test_plan_grow_two_joiners_race_one_slot():
    cases = [(2, [0], 2, ["join-0009-late", "join-0001-first"]),
             (3, [2], 3, ["join-b", "join-a"]),
             (1, [0, 1], 2, ["join-x"]),
             (1, [0], 2, []),
             (5, [1, 3], 4, ["join-c", "join-a", "join-b"])]
    for case in cases:
        assert port_lv.plan_grow(*case) == jax_lv.plan_grow(*case), case
    assert port_lv.plan_grow(*cases[0]) == {
        "generation": 2, "incumbents": [0],
        "joiners": {"join-0001-first": 1}}
    assert port_lv.plan_grow(*cases[4])["joiners"] == {"join-a": 0,
                                                       "join-b": 2}


@BOTH
def test_grow_plan_commit_round_trip_and_stale_floor(tmp_path, lv):
    """Written by one package, read by both: plans, commits, the newest
    plan naming a ticket and the refused joiner's floor."""
    hb = str(tmp_path / "hb")
    (tmp_path / "hb").mkdir()
    plan = {"generation": 2, "incumbents": [0], "joiners": {"join-t": 1}}
    lv.write_grow_plan(hb, plan)
    lv.write_grow_plan(hb, {"generation": 4, "incumbents": [0, 2],
                            "joiners": {"join-u": 1}})
    lv.write_commit(hb, 2, [1, 0])
    (tmp_path / "hb" / "commit-3.json").write_text("{torn")
    (tmp_path / "hb" / "grow-5.json").write_text('{"generation": 5}')
    for mod in (jax_lv, port_lv):
        assert mod.read_grow_plan(hb, 2) == plan
        assert mod.read_grow_plan(hb, 9) is None
        assert mod.read_grow_plan(hb, 5) is None
        assert mod.grow_plan_for(hb, "join-t") == plan
        assert mod.grow_plan_for(hb, "join-u")["generation"] == 4
        assert mod.grow_plan_for(hb, "join-other") is None
        assert mod.grow_plan_for(hb, "join-t", min_generation=3) is None
        assert mod.read_commit(hb, 2) == [0, 1]
        assert mod.read_commit(hb, 3) is None
        assert mod.read_commit(hb, 7) is None


def _rendezvous(lv, tmp_path, clock, plan, events):
    """Drive ``grow_rendezvous_step`` through ``events``: (now, deadline,
    action) triples; returns its answer at each."""
    me = _lease(lv, tmp_path, clock, index=0, members=(0,))
    me.renew()
    me.announce_reform(plan["generation"])
    out = []
    for now, deadline, action in events:
        if action is not None:
            action()
        out.append(lv.grow_rendezvous_step(me, plan, now_monotonic=now,
                                           join_deadline=deadline))
    return out


@pytest.mark.parametrize("case", ["appears_mid_settle", "dies_mid_rendezvous",
                                  "never_announces"])
def test_grow_rendezvous_equals_the_jax_one(tmp_path, case):
    answers = {}
    for name, lv in (("jax", jax_lv), ("port", port_lv)):
        clock = FakeClock()
        d = tmp_path / name
        plan = {"generation": 2, "incumbents": [0],
                "joiners": {"join-t": 1}}
        joiner = _lease(lv, d, clock, index=1, members=(0, 1))

        def arrive():
            joiner.renew()
            joiner.announce_reform(2)

        def go_stale():
            clock.t += 30.0
            _lease(lv, d, clock, index=0, members=(0,)).renew()

        events = {
            "appears_mid_settle": [(0.0, 10.0, None), (5.0, 10.0, arrive),
                                   (10.0, 10.0, None)],
            "dies_mid_rendezvous": [(0.0, 10.0, arrive),
                                    (1.0, 10.0, go_stale),
                                    (10.0, 10.0, None)],
            "never_announces": [(0.0, 10.0, None), (9.9, 10.0, None),
                                (11.0, 10.0, None)],
        }[case]
        answers[name] = _rendezvous(lv, d, clock, plan, events)
    assert answers["port"] == answers["jax"]
    assert answers["port"][-1] == ([0, 1] if case == "appears_mid_settle"
                                   else [0])
    assert answers["port"][:-1] == [None] * (len(answers["port"]) - 1)


def test_stale_generation_announce_refused(tmp_path, caplog):
    """An announce from a slot the plan never assigned is left out of
    the membership in both packages; the port logs the refusal."""
    records = []
    for name, lv in (("jax", jax_lv), ("port", port_lv)):
        clock = FakeClock()
        d = tmp_path / name
        me = _lease(lv, d, clock, index=0, members=(0,))
        me.renew()
        me.announce_reform(4)
        stranger = _lease(lv, d, clock, index=3, members=(0, 3))
        stranger.renew()
        stranger.announce_reform(4)
        plan = {"generation": 4, "incumbents": [0], "joiners": {}}
        records.append((lv.unexpected_announcers(me, plan),
                        lv.grow_rendezvous_step(me, plan, now_monotonic=20.0,
                                                join_deadline=10.0)))
    assert records[0] == records[1] == ([3], [0])
    import logging
    logger = logging.getLogger("fast_tffm_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        port_lv.emit_join_refused(4, 3, "announced a generation it was "
                                  "never planned into")
    finally:
        logger.removeHandler(caplog.handler)
    assert any("join refused: generation 4, worker slot 3" in m
               for m in caplog.messages)


def test_sweep_lease_dir_equals_the_jax_sweep(tmp_path):
    """After N reforms only the current generation's files, the
    membership's leases and fresh tickets stay, in both packages."""
    left = {}
    for name, lv in (("jax", jax_lv), ("port", port_lv)):
        clock = FakeClock()
        d = tmp_path / name
        hb = d / "hb"
        for i, members in ((0, (0, 1)), (1, (0, 1)), (2, (0, 1, 2))):
            _lease(lv, d, clock, index=i, members=members).renew()
        me = _lease(lv, d, clock, index=0, members=(0, 1))
        for g in (1, 2, 3):
            me.announce_reform(g)
            lv.write_grow_plan(str(hb), {"generation": g,
                                         "incumbents": [0], "joiners": {}})
            lv.write_commit(str(hb), g, [0])
        _ticket(lv, d, clock, "join-0009-fresh")
        _ticket(lv, d, clock, "join-0001-dead", t=clock.t - 999)
        (hb / "worker-0.hb.tmp.77").write_text("torn")
        removed = lv.sweep_lease_dir(str(hb), generation=3, members=[0, 1],
                                     join_stale_after=20.0, now=clock.t)
        left[name] = (removed, sorted(p.name for p in hb.iterdir()))
    assert left["port"] == left["jax"]
    assert left["port"][1] == ["commit-3.json", "grow-3.json",
                               "join-0009-fresh", "reform-3-0",
                               "worker-0.hb", "worker-1.hb"]


def test_grow_context_barrier_check_equals_the_jax_one(tmp_path):
    """The barrier's admission check on one process: no ticket, a fresh
    ticket against the free slot, and capacity reached."""
    clock = FakeClock()
    hosts = ("h0:7000", "h1:7001")
    jlease = _lease(jax_lv, tmp_path, clock, index=0, members=(0,))
    please = _lease(port_lv, tmp_path, clock, index=0, members=(0,))
    please.renew()
    jctx = JaxGrowContext(JaxConfig(elastic="grow", worker_hosts=hosts),
                          jlease, members=[0], generation=1)
    pctx = _GrowContext(FmConfig(elastic="grow", worker_hosts=hosts),
                        please, members=[0], generation=1)
    assert pctx.capacity == jctx.capacity == 2
    assert pctx.check_barrier(None) is None and jctx.check_barrier() is None
    # A real-clock ticket: the check reads wall time.
    port_lv.JoinTicket(str(tmp_path / "hb"), heartbeat_seconds=5.0,
                       name="join-0001-t", pid=7).renew()
    want = {"generation": 2, "incumbents": [0],
            "joiners": {"join-0001-t": 1}}
    assert pctx.check_barrier(None) == jctx.check_barrier() == want
    pctx.adopt([0, 1], 2)
    jctx.adopt([0, 1], 2)
    assert pctx.check_barrier(None) is None and jctx.check_barrier() is None


def _grow_run(wd, joiner_faults):
    """Two ``elastic = grow`` workers over three epochs, worker 1
    SIGKILLed as it begins the step after step 12's save, and a ``--join``
    process whose ticket is published before the workers start (it waits
    while the cluster is full, so the first epoch boundary after the
    shrink admits it, however slowly the processes start)."""
    cfg_path = ranks.write_elastic_run(wd, 3, "grow")
    cfg = load_config(cfg_path)
    argv = ["train", cfg_path, "--device", "cpu"]
    procs = {"join": ranks.spawn_cli(wd, "join", joiner_faults,
                                     argv + ["--join"])}
    deadline = time.monotonic() + 120
    while "join: ticket" not in open(os.path.join(wd, "join.log")).read():
        assert procs["join"].poll() is None and time.monotonic() < deadline, \
            open(os.path.join(wd, "join.log")).read()[-3000:]
        time.sleep(0.05)
    procs["w0"] = ranks.spawn_cli(wd, "w0", "none",
                                  argv + ["dist_train", "worker", "0"])
    procs["w1"] = ranks.spawn_cli(wd, "w1",
                                  f"kill-at-step-{cfg.save_steps + 2}",
                                  argv + ["dist_train", "worker", "1"])
    rcs, logs = ranks.wait_all(procs, wd)
    return cfg, dict(zip(procs, rcs)), logs, ranks.log_tails(logs)


def _final(cfg):
    ckpt = CheckpointState(cfg.model_file)
    final = ckpt.restore(template=checkpoint_template(cfg))
    ckpt.close()
    return int(final["step"]), int(final["epoch"])


def test_joiner_heals_the_cluster_at_the_epoch_boundary(tmp_path):
    wd = str(tmp_path)
    cfg, rcs, logs, tails = _grow_run(wd, "none")
    assert rcs == {"join": 0, "w0": 0, "w1": -9}, (rcs, tails)
    out0, outj = logs["w0"], logs["join"]
    for want in ("worker lost", "process 1", "elastic reform generation 1",
                 "elastic grow: admitting joiner(s) [1] into cluster "
                 "generation 2",
                 "elastic grow generation 2: members [0, 1] (admitted [1])",
                 "elastic recovery complete: 2 member(s) (admitted [1])",
                 "multi-process training: rank 0 of 2", "training done"):
        assert want in out0, (want, tails)
    for want in ("join: announced for cluster generation 2 as worker slot 1",
                 "join: admitted into generation 2 as rank 1 of 2 (worker "
                 "slot 1)", "multi-process training: rank 1 of 2",
                 "training done"):
        assert want in outj, (want, tails)
    # The survivor restored step 12 (epoch 0) and ran epoch 0 alone; the
    # boundary's save is what both restore; epochs 1-2 ran at two
    # members, a rank's half of the lines each.
    restores = re.findall(r"restored checkpoint at step (\d+)", out0)
    s0, barrier = int(restores[0]), int(restores[1])
    single = -(-ranks.ELASTIC_LINES // ranks.ELASTIC_BATCH)
    assert s0 == cfg.save_steps and barrier == s0 + single, tails
    assert re.findall(r"restored checkpoint at step (\d+)", outj) == [
        str(barrier)]
    per_rank = [int(n) for n in re.findall(
        r"epoch [12] input: (\d+) batches", out0 + outj)]
    assert len(per_rank) == 4
    two = max(per_rank)
    assert _final(cfg) == (barrier + 2 * two, 3)
    # Both members closed the run at the same step.
    done = [re.search(r"training done: (\d+) steps", t).group(1)
            for t in (out0, outj)]
    assert done == [str(barrier + 2 * two)] * 2
    assert sorted(os.listdir(cfg.model_file + ".hb")) == [
        "commit-2.json", "grow-2.json", "reform-2-0", "reform-2-1"]


def test_dying_joiner_never_wedges_the_incumbent(tmp_path):
    wd = str(tmp_path)
    cfg, rcs, logs, tails = _grow_run(wd, "kill-at-announce")
    assert rcs == {"join": -9, "w0": 0, "w1": -9}, (rcs, tails)
    out0 = logs["w0"]
    assert re.search(r"grow generation 2: planned joiner slot\(s\) \[1\] "
                     r"never rendezvoused inside the settle window", out0), \
        tails
    assert "elastic grow generation 2: members [0] (admitted nobody)" in \
        out0, tails
    assert "training done" in out0
    single = -(-ranks.ELASTIC_LINES // ranks.ELASTIC_BATCH)
    # Epoch 0 from step 12, then epochs 1 and 2, all alone.
    assert _final(cfg) == (cfg.save_steps + 3 * single, 3)
