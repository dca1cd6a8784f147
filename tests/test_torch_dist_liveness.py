"""The port's heartbeat lease, collective deadline guard and bring-up
(fast_tffm_tpu_torch/parallel/liveness.py, distributed.py) against the
JAX package's, case for case, on fake clocks (the lease and guard
cases of tests/test_liveness.py and the retry-budget cases of
tests/test_cluster_bringup.py). Where the JAX package emits a telemetry
event the port logs a line (its telemetry waits for ROADMAP.md A11):
those cases check the port's log. Also: a rank with no coordinator to
join gives up within ``cluster_connect_timeout_seconds``, naming the
address and itself, and the coordinator address is worker_hosts[0]'s
port + 1000 in both packages.
"""

import logging
import threading
import time

import pytest

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.parallel import distributed as jax_dist
from fast_tffm_tpu.parallel import liveness as jax_lv
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.parallel import distributed as port_dist
from fast_tffm_tpu_torch.parallel import liveness as port_lv

BOTH = pytest.mark.parametrize("lv", [jax_lv, port_lv],
                               ids=["jax", "port"])


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


@pytest.fixture
def guard_teardown():
    yield
    jax_lv.restore_guard(None)
    port_lv.restore_guard(None)


@pytest.fixture
def port_log():
    """The port logger's records (its handler does not propagate)."""
    records = []

    class H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("fast_tffm_tpu_torch")
    h = H()
    logger.addHandler(h)
    yield records
    logger.removeHandler(h)


def _lease(lv, tmp_path, clock, index=0, members=(0, 1), hb=5.0):
    return lv.HeartbeatLease(str(tmp_path / "hb"), process_index=index,
                             members=members, heartbeat_seconds=hb,
                             host=f"host{index}", pid=100 + index,
                             clock=clock)


def _ids(peers):
    return [p.process_index for p in peers]


@BOTH
def test_missing_lease_reads_as_lost(tmp_path, lv):
    lease = _lease(lv, tmp_path, FakeClock())
    lease.renew()
    stale = lease.stale_peers()
    assert _ids(stale) == [1] and stale[0].age_seconds is None
    assert "no lease on disk" in stale[0].describe()


@BOTH
def test_staleness_threshold_math(tmp_path, lv):
    clock = FakeClock()
    me, peer = _lease(lv, tmp_path, clock), _lease(lv, tmp_path, clock, 1)
    me.renew()
    peer.renew()
    clock.t += 19.0
    assert me.stale_peers() == []
    clock.t += 2.0
    stale = me.stale_peers()
    assert _ids(stale) == [1]
    assert stale[0].age_seconds == pytest.approx(21.0)
    assert stale[0].host == "host1"
    assert stale[0].describe() == "process 1 (host1, last heartbeat " \
        "21.0s ago)"


@BOTH
def test_lease_renewal_races_staleness_check(tmp_path, lv):
    clock = FakeClock()
    me, peer = _lease(lv, tmp_path, clock), _lease(lv, tmp_path, clock, 1)
    me.renew()
    peer.renew()
    clock.t += 30.0
    assert _ids(me.stale_peers()) == [1]
    peer.renew()
    assert me.stale_peers() == [] and me.live_members() == [0, 1]


@BOTH
def test_live_members_and_shrunken_membership(tmp_path, lv):
    clock = FakeClock()
    me = _lease(lv, tmp_path, clock, 0, members=(0, 1, 2))
    p2 = _lease(lv, tmp_path, clock, 2, members=(0, 1, 2))
    me.renew()
    p2.renew()
    assert me.live_members() == [0, 2]
    me.members = (0, 2)
    assert me.stale_peers() == []


@BOTH
def test_torn_lease_file_reads_as_never_heard(tmp_path, lv):
    me = _lease(lv, tmp_path, FakeClock())
    me.renew()
    (tmp_path / "hb" / "worker-1.hb").write_text("{torn")
    stale = me.stale_peers()
    assert _ids(stale) == [1] and stale[0].age_seconds is None


@BOTH
def test_stop_removes_own_lease_and_sweeps_stale_peers(tmp_path, lv):
    clock = FakeClock()
    me = _lease(lv, tmp_path, clock, 0, members=(0, 1, 2))
    p1 = _lease(lv, tmp_path, clock, 1, members=(0, 1, 2))
    p2 = _lease(lv, tmp_path, clock, 2, members=(0, 1, 2))
    for lease in (me, p1, p2):
        lease.renew()
    clock.t += 30.0
    p2.renew()  # 1 stale, 2 fresh
    me.stop()
    assert me.read(0) is None and me.read(1) is None
    assert me.read(2) is not None


def test_check_peers_one_warning_per_episode(tmp_path, port_log):
    clock = FakeClock()
    me = _lease(port_lv, tmp_path, clock)
    peer = _lease(port_lv, tmp_path, clock, 1)
    me.renew()
    peer.renew()
    clock.t += 30.0
    assert _ids(me.check_peers()) == [1]
    assert me.check_peers() == []
    peer.renew()
    assert me.check_peers() == []
    clock.t += 30.0
    assert _ids(me.check_peers()) == [1]
    lost = [m for m in port_log if m.startswith("worker lost")]
    assert len(lost) == 2 and "process 1 (host1" in lost[0]


@BOTH
def test_no_guard_is_plain_call(lv, guard_teardown):
    assert lv.guarded_collective(lambda a, b: a + b, 1, 2) == 3


@BOTH
def test_exception_converts_when_peer_dead(tmp_path, lv, guard_teardown):
    lease = _lease(lv, tmp_path, FakeClock(), hb=0.01)
    lease.renew()
    lv.install_guard(lease, 30.0)

    def boom():
        raise RuntimeError("Gloo AllGather failed: connection closed")

    with pytest.raises(lv.WorkerLostError) as ei:
        lv.guarded_collective(boom, label="lockstep/window_fill")
    assert "process 1" in str(ei.value)
    assert "lockstep/window_fill" in str(ei.value)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert _ids(ei.value.lost) == [1]


@BOTH
def test_exception_reraised_when_everyone_alive(tmp_path, lv,
                                                guard_teardown):
    me = lv.HeartbeatLease(str(tmp_path / "hb"), process_index=0,
                           members=(0, 1), heartbeat_seconds=0.2)
    peer = lv.HeartbeatLease(str(tmp_path / "hb"), process_index=1,
                             members=(0, 1), heartbeat_seconds=0.2)
    me.renew()
    peer.start()
    lv.install_guard(me, 30.0)

    def boom():
        raise ValueError("not a peer problem")

    try:
        with pytest.raises(ValueError, match="not a peer problem"):
            lv.guarded_collective(boom, label="x")
    finally:
        peer.stop()


@BOTH
def test_worker_lost_error_passes_through_unwrapped(tmp_path, lv,
                                                    guard_teardown):
    lv.install_guard(_lease(lv, tmp_path, FakeClock()), 30.0)
    original = lv.WorkerLostError("already diagnosed",
                                  lost=[lv.PeerInfo(3, host="h3")])

    def reraise():
        raise original

    with pytest.raises(lv.WorkerLostError) as ei:
        lv.guarded_collective(reraise, label="x")
    assert ei.value is original


@BOTH
def test_deadline_fires_before_collective_returns(tmp_path, lv,
                                                  guard_teardown):
    lease = _lease(lv, tmp_path, FakeClock())
    lease.renew()  # peer 1 never writes: stale
    hits = []
    lv.install_guard(lease, 0.2, escalate=hits.append)
    release = threading.Event()
    t = threading.Thread(target=lambda: lv.guarded_collective(
        lambda: release.wait(10), label="train/step_flags"))
    t.start()
    deadline = time.monotonic() + 5
    while lv.current_guard().in_flight is None:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    time.sleep(0.25)
    assert lv.check_deadline() == "escalated"
    assert len(hits) == 1
    assert "WorkerLostError" in hits[0] and "process 1" in hits[0]
    assert "train/step_flags" in hits[0]
    assert str(lv.EXIT_WORKER_LOST) in hits[0]
    assert lv.current_guard().in_flight is not None
    release.set()
    t.join()
    if lv is port_lv:  # the stack dump beside the leases
        text = (tmp_path / "hb" / "worker-0.stacks").read_text()
        assert "train/step_flags" in text and "Thread" in text


@BOTH
def test_deadline_quiet_within_budget(tmp_path, lv, guard_teardown):
    lease = _lease(lv, tmp_path, FakeClock())
    lease.renew()
    hits = []
    lv.install_guard(lease, 100.0, escalate=hits.append)
    lv.current_guard().in_flight = ("x", time.monotonic())
    assert lv.check_deadline() is None and hits == []


@BOTH
def test_deadline_slow_warning_when_everyone_alive(tmp_path, lv,
                                                   guard_teardown,
                                                   port_log):
    clock = FakeClock()
    me, peer = _lease(lv, tmp_path, clock), _lease(lv, tmp_path, clock, 1)
    me.renew()
    peer.renew()
    hits = []
    lv.install_guard(me, 0.1, escalate=hits.append)
    lv.current_guard().in_flight = ("checkpoint/final_save",
                                    time.monotonic() - 1.0)
    assert lv.check_deadline() == "slow"
    assert lv.check_deadline() == "slow"
    assert hits == []
    if lv is port_lv:
        slow = [m for m in port_log if m.startswith("collective slow")]
        assert len(slow) == 1 and "checkpoint/final_save" in slow[0]


@BOTH
def test_deadline_covers_unguarded_sync_points(tmp_path, lv,
                                               guard_teardown):
    lease = _lease(lv, tmp_path, FakeClock())
    lease.renew()
    hits = []
    lv.install_guard(lease, 0.1, escalate=hits.append)
    lv.current_guard().last_progress = time.monotonic() - 1.0
    assert lv.check_deadline() == "escalated"
    assert "no guarded collective completing" in hits[0]
    hits.clear()
    lv.guarded_collective(lambda: None, label="x")
    assert lv.check_deadline() is None


@BOTH
def test_guard_progress_beat_on_completion(tmp_path, lv, guard_teardown):
    lv.install_guard(_lease(lv, tmp_path, FakeClock()), 5.0)
    st = lv.current_guard()
    before = st.last_progress
    time.sleep(0.01)
    assert lv.guarded_collective(lambda: 7, label="x") == 7
    assert st.in_flight is None and st.last_progress > before


class _Work:
    """A torch Work stand-in: pending until ``done`` is set; ``error``
    makes it complete with that error."""

    def __init__(self, error=None):
        self.done = threading.Event()
        self.error = error
        if error is not None:
            self.done.set()

    def is_completed(self):
        return self.done.is_set()

    def wait(self, timeout=None):
        if not self.done.wait(None if timeout is None
                              else timeout.total_seconds()):
            raise RuntimeError("Operation timed out!")
        if self.error is not None:
            raise self.error
        return True


def _abandoned_count():
    return len(port_lv.abandoned_work())


def test_guarded_work_without_guard_is_a_plain_wait(guard_teardown):
    w = _Work()
    w.done.set()
    port_lv.guarded_work(lambda: w, label="x")
    with pytest.raises(ValueError, match="semantic"):
        port_lv.guarded_work(lambda: _Work(ValueError("semantic")),
                             label="x")


def test_guarded_work_completing_as_a_wait_times_out(tmp_path,
                                                    guard_teardown):
    lease = _lease(port_lv, tmp_path, FakeClock())
    lease.renew()  # peer 1 never writes: stale
    port_lv.install_guard(lease, 30.0, recover=True)

    class Late(_Work):
        # Completes just after its first wait has timed out.
        def wait(self, timeout=None):
            if timeout is not None and not self.done.is_set():
                self.done.set()
                raise RuntimeError("Operation timed out!")
            return super().wait(timeout)

    port_lv.guarded_work(lambda: Late(), label="checkpoint/table")


def test_guarded_work_waits_out_a_slow_collective(tmp_path, guard_teardown):
    lease = _lease(port_lv, tmp_path, FakeClock())
    lease.renew()  # peer 1 never writes: stale
    port_lv.install_guard(lease, 30.0, recover=True)
    w = _Work()
    threading.Timer(0.6, w.done.set).start()
    port_lv.guarded_work(lambda: w, label="checkpoint/table")
    st = port_lv.current_guard()
    assert st.in_flight is None and not st.polling


def test_guarded_work_converts_a_raise_when_peer_dead(tmp_path,
                                                      guard_teardown):
    lease = _lease(port_lv, tmp_path, FakeClock(), hb=0.01)
    lease.renew()
    port_lv.install_guard(lease, 30.0, recover=True)
    err = RuntimeError("Connection closed by peer")
    with pytest.raises(port_lv.WorkerLostError) as ei:
        port_lv.guarded_work(lambda: _Work(err), label="checkpoint/table")
    assert "checkpoint/table" in str(ei.value) and "failed" in str(ei.value)
    assert ei.value.__cause__ is err


def test_elastic_guard_abandons_a_blocked_collective(tmp_path,
                                                     guard_teardown,
                                                     port_log):
    lease = _lease(port_lv, tmp_path, FakeClock())
    lease.renew()  # peer 1 never writes: stale
    hits = []
    port_lv.install_guard(lease, 0.3, escalate=hits.append, recover=True)
    before = _abandoned_count()
    w = _Work()
    seen = []

    def monitor():
        # The lease thread's tick while the wait is past the deadline.
        while port_lv.current_guard().in_flight is None:
            time.sleep(0.005)
        time.sleep(0.35)
        seen.append(port_lv.check_deadline())
    t = threading.Thread(target=monitor)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(port_lv.WorkerLostError) as ei:
        port_lv.guarded_work(lambda: w, label="checkpoint/table")
    t.join()
    assert time.monotonic() - t0 < 5
    assert "collective 'checkpoint/table' still pending past " \
        "collective_timeout_seconds=0.3s" in str(ei.value)
    assert [i.process_index for i in ei.value.lost] == [1]
    # The monitor left the verdict to the waiting thread: no exit.
    assert seen == ["abandoning"] and hits == []
    assert _abandoned_count() == before + 1
    assert port_lv.abandoned_work()[-1] == ("checkpoint/table", w)
    assert any("abandoned for the elastic reform" in m for m in port_log)
    st = port_lv.current_guard()
    assert st.in_flight is None and not st.polling
    w.done.set()


def test_guard_without_recovery_escalates_a_blocked_work(tmp_path,
                                                         guard_teardown):
    lease = _lease(port_lv, tmp_path, FakeClock())
    lease.renew()
    hits = []
    port_lv.install_guard(lease, 0.2, escalate=hits.append)
    w = _Work()
    t = threading.Thread(target=lambda: port_lv.guarded_work(
        lambda: w, label="checkpoint/table"))
    t.start()
    deadline = time.monotonic() + 5
    while port_lv.current_guard().in_flight is None:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    time.sleep(0.5)
    # elastic = off: the blocked thread waits on, the monitor exits.
    assert t.is_alive()
    assert port_lv.check_deadline() == "escalated"
    assert "checkpoint/table" in hits[0]
    assert str(port_lv.EXIT_WORKER_LOST) in hits[0]
    w.done.set()
    t.join()


def test_lease_dir_is_beside_the_checkpoints(tmp_path):
    mf = str(tmp_path / "m" / "fm")
    assert port_lv.lease_dir(FmConfig(model_file=mf)) == \
        jax_lv.lease_dir(JaxConfig(model_file=mf)) == mf + ".hb"


# --- bring-up ---------------------------------------------------------


DIST = pytest.mark.parametrize("dm", [jax_dist, port_dist],
                               ids=["jax", "port"])


@DIST
def test_succeeds_after_transient_failures(dm):
    clock = FakeClock(0.0)
    calls = []

    def init(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: failed to connect")

    assert dm.initialize_with_retry(
        init, address="head:9476", num_processes=4, process_id=2,
        timeout_seconds=600.0, sleep=clock.sleep, clock=clock) == 3
    for kw in calls:
        assert (kw["coordinator_address"], kw["num_processes"],
                kw["process_id"]) == ("head:9476", 4, 2)
    assert calls[0]["initialization_timeout"] == int(
        dm.CONNECT_ATTEMPT_CAP_SECONDS)
    assert clock.sleeps == [dm.CONNECT_RETRY_SLEEP_SECONDS] * 2


@DIST
def test_exhaustion_names_coordinator_and_process(dm):
    clock = FakeClock(0.0)

    def init(**kw):
        raise RuntimeError("DEADLINE_EXCEEDED: deadline exceeded")

    with pytest.raises(RuntimeError) as ei:
        dm.initialize_with_retry(init, address="head:9476",
                                 num_processes=4, process_id=3,
                                 timeout_seconds=30.0, sleep=clock.sleep,
                                 clock=clock)
    msg = str(ei.value)
    assert "process 3" in msg and "head:9476" in msg
    assert "cluster_connect_timeout_seconds=30" in msg
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert clock.t <= 30.0 + 1e-9


@DIST
def test_attempt_timeout_shrinks_to_remaining_budget(dm):
    clock = FakeClock(0.0)
    calls = []

    def init(**kw):
        calls.append(kw["initialization_timeout"])
        clock.t += kw["initialization_timeout"]
        raise RuntimeError("UNAVAILABLE")

    with pytest.raises(RuntimeError):
        dm.initialize_with_retry(init, address="h:1", num_processes=2,
                                 process_id=1, timeout_seconds=100.0,
                                 sleep=clock.sleep, clock=clock)
    assert calls[0] == 60 and all(c >= 1 for c in calls)
    assert calls[1] <= 100 - 60 - dm.CONNECT_RETRY_SLEEP_SECONDS


@DIST
def test_zero_budget_never_calls_initialize(dm):
    clock = FakeClock(0.0)
    with pytest.raises(RuntimeError, match="0 attempt"):
        dm.initialize_with_retry(
            lambda **kw: pytest.fail("called"), address="h:1",
            num_processes=2, process_id=0, timeout_seconds=0.0,
            sleep=clock.sleep, clock=clock)


def test_coordinator_address_and_task_index_check():
    hosts = ("10.0.0.1:2222", "10.0.0.2:2222")
    for hs in (hosts, ("head",)):
        assert port_dist.coordinator_address(FmConfig(worker_hosts=hs)) == \
            jax_dist.coordinator_address(JaxConfig(worker_hosts=hs))
        # A reform's address: the generation bumps the port, and the
        # members' hosts replace the config's (the first hosts the store).
        for g in (1, 2, 7):
            for members in (hs[-1:], hs[::-1]):
                assert port_dist.coordinator_address(
                    FmConfig(worker_hosts=hs), g, hosts=members) == \
                    jax_dist.coordinator_address(JaxConfig(worker_hosts=hs),
                                                 g, hosts=members)
    assert port_dist.coordinator_address(FmConfig(worker_hosts=hosts), 3,
                                         hosts=hosts[1:]) == "10.0.0.2:3225"
    with pytest.raises(ValueError, match="out of range"):
        port_dist.init_from_cluster(FmConfig(worker_hosts=hosts), "worker",
                                    2)
    with pytest.raises(ValueError, match="job_name"):
        port_dist.init_from_cluster(FmConfig(worker_hosts=hosts), "ps", 0)
    assert port_dist.init_from_cluster(FmConfig(), "worker", 0) == (0, 1)


def test_rank_without_coordinator_gives_up_naming_it(port_log):
    """Worker 1 of a cluster whose worker 0 never starts: the rendezvous
    fails within the connect budget, naming the address and the rank,
    after a "cluster bring-up failed" log line."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dist_ranks import free_port
    port = free_port()
    cfg = FmConfig(worker_hosts=(f"localhost:{port - 1000}", "localhost:1"),
                   cluster_connect_timeout_seconds=3.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        port_dist.init_from_cluster(cfg, "worker", 1)
    assert time.monotonic() - t0 < 20.0
    assert f"localhost:{port}" in str(ei.value)
    assert "process 1" in str(ei.value)
    assert any(m.startswith("cluster bring-up failed") for m in port_log)


def test_rank_zero_refuses_a_rendezvous_port_in_use(port_log):
    """Rank 0 of a job whose rendezvous port another job's store holds
    (a predict started while its train runs, on one config) gives up
    naming the address in use, instead of meeting the other job's ranks
    in a shared store."""
    import os
    import socket
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dist_ranks import free_port
    port = free_port()
    with socket.socket() as held:
        held.bind(("127.0.0.1", port))
        held.listen(1)
        cfg = FmConfig(worker_hosts=(f"localhost:{port - 1000}",
                                     "localhost:1"),
                       cluster_connect_timeout_seconds=2.0)
        with pytest.raises(RuntimeError, match="Address already in use"):
            port_dist.init_from_cluster(cfg, "worker", 0)


def test_rendezvous_port_after_a_finished_job_is_free(port_log):
    """A train followed by a predict on one config: the train's rank 0
    closed its store's connections first, so they sit in TIME_WAIT on
    the rendezvous port for a minute. The port is free for the next
    store (a live listener still is not: the test above), and the next
    2-rank job forms on it at once. (A plain bind refused it, and the
    predict's bring-up failed after cluster_connect_timeout_seconds.)"""
    import datetime
    import os
    import socket
    import subprocess
    import sys
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dist_ranks import free_port
    port = free_port()
    host = "127.0.0.1"
    client = ("import datetime, time, torch.distributed as d; "
              f"s = d.TCPStore({host!r}, {port}, 2, is_master=False, "
              "timeout=datetime.timedelta(seconds=60)); s.get('go'); "
              "time.sleep(1.5)")
    peer = subprocess.Popen([sys.executable, "-c", client])
    try:
        master = dist.TCPStore(host, port, 2, is_master=True,
                               timeout=datetime.timedelta(seconds=60),
                               wait_for_workers=True)
        master.set("go", "1")
        time.sleep(0.3)
        del master  # rank 0 closes first: TIME_WAIT on the port
    finally:
        assert peer.wait(timeout=60) == 0
    with socket.socket() as plain:
        with pytest.raises(OSError, match="Address already in use"):
            plain.bind((host, port))
    port_dist._check_port_free(host, port)
    store = dist.TCPStore(host, port, 1, is_master=True,
                          timeout=datetime.timedelta(seconds=10),
                          wait_for_workers=True)
    del store


def test_rendezvous_port_in_the_ephemeral_range_warns(port_log,
                                                      monkeypatch):
    """Every generation's rendezvous port is checked against the host's
    ephemeral range (the reforms bind generation-bumped ports), once
    per port."""
    monkeypatch.setattr(port_dist, "ephemeral_port_range",
                        lambda: (32768, 60999))
    monkeypatch.setattr(port_dist, "_WARNED_PORTS", set())
    assert not port_dist.warn_ephemeral_port(25000)
    assert port_dist.warn_ephemeral_port(32768)
    assert port_dist.warn_ephemeral_port(32768)
    assert port_dist.warn_ephemeral_port(32769)
    warned = [m for m in port_log if "ephemeral port range" in m]
    assert len(warned) == 2
    assert warned[0].startswith("rendezvous port 32768 lies in the host's "
                                "ephemeral port range 32768-60999")
    # _join_cluster checks the port it is given, whatever the generation.
    seen = []
    monkeypatch.setattr(port_dist, "warn_ephemeral_port", seen.append)
    monkeypatch.setattr(port_dist, "initialize_with_retry",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            RuntimeError("stop")))
    cfg = FmConfig(worker_hosts=("localhost:31767", "localhost:31768"))
    for g in (0, 1, 2):
        with pytest.raises(RuntimeError, match="stop"):
            port_dist._join_cluster(
                cfg, port_dist.coordinator_address(cfg, g, cfg.worker_hosts),
                2, 0)
    assert seen == [32767, 32768, 32769]
