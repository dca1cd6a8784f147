"""Multi-process bring-up — the port's counterpart of
``fast_tffm_tpu/parallel/distributed.py``.

The reference builds a TF1 cluster from ``[Cluster]`` ``ps_hosts`` and
``worker_hosts`` and trains asynchronously against parameter servers.
The JAX package maps it onto one synchronous jax.distributed job; the
port maps it onto one ``torch.distributed`` process group: ``train|
predict <cfg> dist_train worker <i>`` is rank i of ``len(worker_hosts)``,
the table is row-sharded over the ranks (parallel/sharded.py), and
there are no ps roles (``__main__.py`` explains them away).

The rendezvous is a ``torch.distributed.TCPStore`` at worker_hosts[0]'s
port + 1000 (``coordinator_address``), hosted by rank 0; the group's
backend is gloo, which also serves ranks that share one card (NCCL
refuses two ranks on one device). ``initialize_with_retry`` bounds the
bring-up by ``cluster_connect_timeout_seconds`` in slices of at most
``CONNECT_ATTEMPT_CAP_SECONDS``; a job that never forms raises naming
the coordinator and the process, after a "cluster bring-up failed" log
line.

Elastic membership (``elastic = shrink | grow``; train.py drives it):
after a ``WorkerLostError`` the survivors abandon the broken group
without a handshake (``retire_distributed_client``: gloo's teardown does
not wait on a reset peer), settle the next generation's membership in
the lease directory and form a new group at a generation-bumped port
hosted by the first survivor (``reform_shrunken_cluster``); a lone
survivor goes on as a single process. At an epoch boundary a planned
admission reforms the grown cluster the same way
(``reform_grown_cluster``), and the replacement process comes up
through the same rendezvous (``join_rendezvous``, ``train --join``).
Every generation's rendezvous port is checked against the host's
ephemeral range, with a warning when it lies inside.
"""

from __future__ import annotations

import datetime
import functools
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.utils.logging import get_logger

# Per-attempt cap on the rendezvous: the total budget
# (cluster_connect_timeout_seconds) is spent in bounded slices with a
# short breather between them, so one wedged connect cannot eat the
# whole budget and the log shows the worker still trying.
CONNECT_ATTEMPT_CAP_SECONDS = 60.0
CONNECT_RETRY_SLEEP_SECONDS = 2.0

# The gloo group's own timeout while the heartbeat lease owns death
# detection, or when collective_timeout_seconds is 0 (no deadline):
# torch's default for a process group.
_DEFAULT_GROUP_TIMEOUT_SECONDS = 1800.0


def coordinator_address(cfg: FmConfig, generation: int = 0,
                        hosts: Optional[Sequence[str]] = None) -> str:
    """worker_hosts[0] with its port shifted up by 1000 (the reference's
    worker port served TF's gRPC; the rendezvous needs its own), so
    every process derives the same address from the shared config.
    ``generation`` (an elastic reform) bumps the port once per reform:
    the last generation's store port may still be held, or belong to the
    dead worker, and every member derives the same bumped address.
    ``hosts`` replaces the config's list (a reform passes its members'
    hosts; the first of them hosts the store)."""
    host = (hosts if hosts is not None else cfg.worker_hosts)[0]
    if ":" in host:
        name, port = host.rsplit(":", 1)
        return f"{name}:{int(port) + 1000 + int(generation)}"
    return f"{host}:{8476 + int(generation)}"


def initialize_with_retry(initialize: Callable[..., None], address: str,
                          num_processes: int, process_id: int,
                          timeout_seconds: float,
                          sleep: Callable[[float], None] = time.sleep,
                          clock: Callable[[], float] = time.monotonic
                          ) -> int:
    """Drive ``initialize(coordinator_address=, num_processes=,
    process_id=, initialization_timeout=)`` until it succeeds or
    ``timeout_seconds`` of total budget is spent, then raise naming the
    coordinator and the process that failed to join. Each attempt gets
    at most CONNECT_ATTEMPT_CAP_SECONDS and the remaining budget.
    ``sleep`` and ``clock`` are injectable, so tests pin the budget math
    without waiting. Returns the number of attempts made."""
    deadline = clock() + timeout_seconds
    attempts = 0
    last_error: Optional[Exception] = None
    while True:
        remaining = deadline - clock()
        if remaining <= 0:
            get_logger().error(
                "cluster bring-up failed: process %d could not join the "
                "rendezvous at %s in %d attempt(s) within %gs: %s",
                process_id, address, attempts, timeout_seconds,
                f"{type(last_error).__name__}: {last_error}")
            raise RuntimeError(
                f"process {process_id} failed to join the "
                f"torch.distributed cluster: the rendezvous at {address} "
                f"did not form within cluster_connect_timeout_seconds="
                f"{timeout_seconds:g}s ({attempts} attempt(s)). Is the "
                "coordinator process (worker 0) up, and its port "
                "(worker_hosts[0] port + 1000) reachable from this host? "
                f"Last error: {last_error}") from last_error
        attempts += 1
        try:
            initialize(coordinator_address=address,
                       num_processes=num_processes,
                       process_id=process_id,
                       initialization_timeout=max(1, int(min(
                           remaining, CONNECT_ATTEMPT_CAP_SECONDS))))
            return attempts
        except Exception as e:  # an unreachable or still-booting
            # coordinator surfaces as a timeout or a refused connect:
            # retry on any failure while budget remains
            last_error = e
            if clock() + CONNECT_RETRY_SLEEP_SECONDS >= deadline:
                sleep(max(0.0, deadline - clock()))
            else:
                sleep(CONNECT_RETRY_SLEEP_SECONDS)


def init_from_cluster(cfg: FmConfig, job_name: str,
                      task_index: int) -> Tuple[int, int]:
    """Join the job as rank ``task_index`` of the config's cluster.
    Returns (data shard index, number of shards) for the input pipeline:
    each worker reads its own byte range of every file."""
    if job_name != "worker":
        raise ValueError(f"unsupported job_name {job_name!r}; only "
                         "'worker' exists in the port (ps roles are "
                         "handled at the CLI)")
    hosts = cfg.worker_hosts
    # Validated before the single-host return: an out-of-range index
    # against a one-host config would otherwise race the real worker's
    # checkpoint writes as shard 0 of 1.
    if not 0 <= task_index < max(len(hosts), 1):
        raise ValueError(f"task_index {task_index} out of range for "
                         f"{len(hosts)} worker_hosts")
    if len(hosts) <= 1:
        return 0, 1
    _join_cluster(cfg, address=coordinator_address(cfg),
                  num_processes=len(hosts), process_id=task_index)
    return task_index, len(hosts)


def _group_timeout(cfg: FmConfig) -> datetime.timedelta:
    """The gloo group's timeout, past which a blocked collective raises.
    With the heartbeat lease on (``heartbeat_seconds`` > 0) the lease
    and the deadline guard own death detection: a killed peer resets the
    connections at once, a stopped one goes stale, and a collective
    that is only slow (every rank waiting on the chief's export) must
    not fail, so the group waits torch's default. Without a lease the
    group's own timeout is the only bound: ``collective_timeout_
    seconds`` (0: the default), as the JAX package keeps the runtime's
    own death detection when the lease is off."""
    seconds = (_DEFAULT_GROUP_TIMEOUT_SECONDS if cfg.heartbeat_seconds > 0
               else cfg.collective_timeout_seconds
               or _DEFAULT_GROUP_TIMEOUT_SECONDS)
    return datetime.timedelta(seconds=float(seconds))


def _initialize_resilient(coordinator_address: str, num_processes: int,
                          process_id: int, initialization_timeout: int,
                          group_timeout: datetime.timedelta) -> None:
    """One bring-up attempt (the ``initialize`` of
    ``initialize_with_retry``): rank 0 checks the port is free and hosts
    the TCP store, every rank connects to it, and the gloo group forms
    over it with ``group_timeout``, which leaves death detection to the
    lease (``_group_timeout``). A half-formed attempt is torn down so
    the next one starts clean."""
    import torch.distributed as dist
    host, port = coordinator_address.rsplit(":", 1)
    if process_id == 0:
        _check_port_free(host, int(port))
    store = None
    try:
        store = dist.TCPStore(
            host, int(port), num_processes, is_master=process_id == 0,
            timeout=datetime.timedelta(seconds=initialization_timeout),
            wait_for_workers=True)
        dist.init_process_group("gloo", store=store, rank=process_id,
                                world_size=num_processes,
                                timeout=group_timeout)
    except Exception:
        if dist.is_initialized():
            dist.destroy_process_group()
        del store
        raise


def _join_cluster(cfg: FmConfig, address: str, num_processes: int,
                  process_id: int) -> None:
    """Form the process group at ``address`` as rank ``process_id`` of
    ``num_processes`` (``_initialize_resilient``, retried within
    ``cluster_connect_timeout_seconds``)."""
    import torch.distributed as dist

    host, port = address.rsplit(":", 1)
    if host in ("localhost", "127.0.0.1") and \
            "GLOO_SOCKET_IFNAME" not in os.environ:
        # A one-host cluster talks over loopback: gloo would otherwise
        # look its peers up by the machine's host name.
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    warn_ephemeral_port(int(port))
    initialize_with_retry(
        functools.partial(_initialize_resilient,
                          group_timeout=_group_timeout(cfg)),
        address=address, num_processes=num_processes,
        process_id=process_id,
        timeout_seconds=cfg.cluster_connect_timeout_seconds)
    if dist.get_world_size() != num_processes:
        raise RuntimeError(
            "torch.distributed did not federate the cluster: expected "
            f"{num_processes} processes, got {dist.get_world_size()}")


def ephemeral_port_range() -> Tuple[int, int]:
    """The host's range of local ports for outgoing connections (Linux:
    ``ip_local_port_range``; the kernel's default where unreadable)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            lo, hi = (int(x) for x in fh.read().split())
        return lo, hi
    except (OSError, ValueError):
        return 32768, 60999


_WARNED_PORTS: set = set()


def warn_ephemeral_port(port: int) -> bool:
    """Warn (once per port) when a rendezvous port lies in the host's
    ephemeral range: a rank that keeps connecting to it before the store
    listens can be handed that port as its own source port and connect
    to itself, which holds the port and fails the bring-up. Every
    generation's port passes here. Returns whether it lies inside."""
    lo, hi = ephemeral_port_range()
    if not lo <= port <= hi:
        return False
    if port not in _WARNED_PORTS:
        _WARNED_PORTS.add(port)
        get_logger().warning(
            "rendezvous port %d lies in the host's ephemeral port range "
            "%d-%d: a rank connecting before the store listens can take "
            "it as its own source port and fail the bring-up; pick "
            "worker_hosts ports so that every generation's rendezvous "
            "(worker port + 1000 + generation) stays below %d", port, lo,
            hi, lo)
    return True


def retire_distributed_client() -> None:
    """Leave the process group without a handshake: a barrier or a
    store round trip cannot complete with a dead peer. gloo's teardown
    drops the pairs without waiting on a reset peer, and rank 0's store
    goes with the group (the next generation's store is hosted at a
    bumped port), so torch's ``destroy_process_group`` is enough. A
    group with a collective the deadline guard abandoned
    (liveness.abandoned_work: a peer that stopped heartbeating but kept
    its sockets open) is unregistered the same way but never freed:
    freeing it joins its worker thread, which stays blocked until that
    peer's sockets close, and a stopped peer's never do."""
    import torch.distributed as dist
    from fast_tffm_tpu_torch.parallel.liveness import abandoned_work
    if dist.is_available() and dist.is_initialized():
        if abandoned_work():
            _keep_forever(dist.group.WORLD)
        dist.destroy_process_group()


def _keep_forever(obj) -> None:
    """One reference to ``obj`` that is never dropped, not even when
    the interpreter shuts down."""
    import ctypes
    ctypes.pythonapi.Py_IncRef(ctypes.py_object(obj))


def _await_reform(cfg: FmConfig, lease, generation: int) -> List[int]:
    """The shrink's settle: announce ``generation``, then wait until
    every live lease holder has announced it and that set has held
    still for REFORM_SETTLE_SECONDS. Returns the members (original
    indices, sorted)."""
    from fast_tffm_tpu_torch.parallel.liveness import REFORM_SETTLE_SECONDS
    lease.announce_reform(generation)
    budget = cfg.cluster_connect_timeout_seconds
    deadline = time.monotonic() + budget
    members: List[int] = []
    stable_since: Optional[float] = None
    while True:
        live = set(lease.live_members())
        announced = set(lease.reform_members(generation))
        agreed = sorted(live & announced)
        now = time.monotonic()
        if agreed and live <= announced:
            if agreed != members:
                members, stable_since = agreed, now
            elif (stable_since is not None
                  and now - stable_since >= REFORM_SETTLE_SECONDS):
                return members
        else:
            members, stable_since = agreed, None
        if now >= deadline:
            raise RuntimeError(
                f"elastic reform generation {generation} did not converge "
                f"within cluster_connect_timeout_seconds={budget:g}s: "
                f"live={sorted(live)} announced={sorted(announced)}")
        time.sleep(min(0.1, max(lease.heartbeat_seconds / 4, 0.02)))


def _form_generation(cfg: FmConfig, generation: int, members: Sequence[int],
                     rank: int) -> None:
    """The group of ``members`` (original indices, rank order) at
    ``generation``'s port, hosted by the first member; nothing for a
    membership of one."""
    if len(members) > 1:
        hosts = [cfg.worker_hosts[m] for m in members]
        _join_cluster(cfg, address=coordinator_address(cfg, generation,
                                                       hosts=hosts),
                      num_processes=len(members), process_id=rank)


def reform_shrunken_cluster(cfg: FmConfig, lease, generation: int,
                            logger=None) -> Tuple[int, int, List[int]]:
    """Rebuild the job from the surviving membership after a
    ``WorkerLostError`` (``elastic = shrink | grow``): leave the broken
    group without a handshake, announce ``generation`` in the lease
    directory and wait for the live announcers to settle, then re-rank
    by original index and form the new group at the generation-bumped
    port of the first survivor's host (a lone survivor goes on as a
    single process). The lease's membership shrinks in place. Returns
    ``(rank, num_shards, members)``: the members' order is the input's
    new shard order, so the lost worker's byte ranges spread over the
    survivors at the next pass."""
    from fast_tffm_tpu_torch.parallel.liveness import sweep_lease_dir
    log = logger or get_logger()
    retire_distributed_client()
    members = _await_reform(cfg, lease, generation)
    if lease.process_index not in members:
        raise RuntimeError(
            f"elastic reform generation {generation}: this process "
            f"({lease.process_index}) lost its own lease; members={members}")
    lease.members = tuple(members)
    rank = members.index(lease.process_index)
    log.info("elastic reform generation %d: survivors %s, this process "
             "re-ranks %d -> %d of %d", generation, members,
             lease.process_index, rank, len(members))
    _form_generation(cfg, generation, members, rank)
    if rank == 0:
        sweep_lease_dir(lease.directory, generation, members,
                        join_stale_after=lease.stale_after)
    return rank, len(members), members


def reform_grown_cluster(cfg: FmConfig, lease, generation: int, plan: dict,
                         logger=None) -> Tuple[int, int, List[int], int]:
    """Rebuild the job with the planned joiners admitted (``elastic =
    grow``), through the shrink's per-generation rendezvous: leave the
    healthy group, announce ``generation`` and let the chief (the lowest
    incumbent) settle it with ``grow_rendezvous_step`` — incumbents
    required, joiners optional, a joiner whose lease is not fresh when
    the ``join_settle_seconds`` window closes (floored at the staleness
    window) left out; announcers the plan never assigned are refused
    aloud. The chief commits the membership (``commit-<g>.json``), which
    every party adopts, and the group forms at the bumped port. A
    committed joiner that dies before its connect lands exhausts the
    bring-up; the incumbents then fall back to a shrink reform at the
    next generation. Returns ``(rank, num_shards, members,
    generation)``: the caller adopts the returned (final) generation."""
    from fast_tffm_tpu_torch.parallel import liveness as lv
    log = logger or get_logger()
    retire_distributed_client()
    lease.announce_reform(generation)
    budget = cfg.cluster_connect_timeout_seconds
    deadline = time.monotonic() + budget
    join_deadline = time.monotonic() + max(
        cfg.join_settle_seconds, lease.stale_after + lease.heartbeat_seconds)
    incumbents = [int(i) for i in plan["incumbents"]]
    chief = lease.process_index == min(incumbents)
    refused: set = set()
    while True:
        now = time.monotonic()
        members = lv.read_commit(lease.directory, generation)
        if members is not None:
            break
        for slot in lv.unexpected_announcers(lease, plan):
            if slot not in refused:
                refused.add(slot)
                log.warning(
                    "grow generation %d: refusing announce from slot %d — "
                    "not in the admission plan (stale generation or slot "
                    "collision)", generation, slot)
                if chief:
                    lv.emit_join_refused(generation, slot,
                                         "announced a generation it was "
                                         "never planned into")
        if chief:
            members = lv.grow_rendezvous_step(lease, plan, now,
                                              join_deadline)
            if members is not None:
                dropped = sorted(set(int(s) for s in
                                     plan["joiners"].values())
                                 - set(members))
                if dropped:
                    log.warning(
                        "grow generation %d: planned joiner slot(s) %s never "
                        "rendezvoused inside the settle window (died "
                        "mid-rendezvous?); reforming without them",
                        generation, dropped)
                lv.write_commit(lease.directory, generation, members)
                break
        if now >= deadline:
            raise RuntimeError(
                f"elastic grow generation {generation} did not converge "
                f"within cluster_connect_timeout_seconds={budget:g}s: "
                f"announced={lease.reform_members(generation)} plan={plan}")
        time.sleep(min(0.1, max(lease.heartbeat_seconds / 4, 0.02)))
    if lease.process_index not in members:
        raise RuntimeError(
            f"elastic grow generation {generation}: this incumbent "
            f"({lease.process_index}) is missing from the committed "
            f"membership {members}")
    lease.members = tuple(members)
    rank = members.index(lease.process_index)
    joined = sorted(set(members) - set(incumbents))
    log.info("elastic grow generation %d: members %s (admitted %s), this "
             "process re-ranks %d -> %d of %d", generation, members,
             joined or "nobody", lease.process_index, rank, len(members))
    try:
        _form_generation(cfg, generation, members, rank)
    except RuntimeError:
        stale_joiners = [s for s in joined if not lease.fresh(s)]
        if not stale_joiners:
            raise
        log.warning(
            "grow generation %d bring-up failed with committed joiner(s) %s "
            "now stale; falling back to a shrink reform at generation %d",
            generation, stale_joiners, generation + 1)
        rank, n, members = reform_shrunken_cluster(cfg, lease,
                                                   generation + 1, logger)
        return rank, n, members, generation + 1
    if rank == 0:
        lv.sweep_lease_dir(lease.directory, generation, members,
                           join_stale_after=lease.stale_after)
    return rank, len(members), members, generation


def join_rendezvous(cfg: FmConfig, logger=None):
    """The replacement process's half of elastic grow (``train <cfg>
    --join``): publish a join ticket, wait for a running cluster's
    admission plan, then come up through the incumbents' rendezvous.
    Returns ``(lease, rank, num_shards, members, generation, slot)``;
    from there ``train`` treats this process as any member (the
    verified restore and the re-sharded input happen in its session).
    Bounded by ``join_timeout_seconds`` (0: the connect budget); a
    commit that leaves this joiner out (a lost slot race, a late
    announce) is refused aloud and the wait resumes for the next
    opening."""
    from fast_tffm_tpu_torch.parallel import liveness as lv
    log = logger or get_logger()
    directory = lv.lease_dir(cfg)
    os.makedirs(directory, exist_ok=True)
    hb = cfg.heartbeat_seconds
    ticket = lv.JoinTicket(directory, heartbeat_seconds=hb).start()
    budget = cfg.join_timeout_seconds or cfg.cluster_connect_timeout_seconds
    deadline = time.monotonic() + budget
    poll = min(1.0, max(hb / 4, 0.05))
    min_generation = 0
    lease = None
    log.info("join: ticket %s published in %s; waiting for a running "
             "cluster's admission plan (budget %gs)", ticket.name,
             directory, budget)
    try:
        while True:
            plan = lv.grow_plan_for(directory, ticket.name,
                                    min_generation=min_generation)
            if plan is not None:
                g = int(plan["generation"])
                slot = int(plan["joiners"][ticket.name])
                committed = lv.read_commit(directory, g)
                if committed is not None and slot not in committed:
                    log.warning("join: generation %d committed without this "
                                "joiner (stale plan); waiting for a fresh "
                                "offer", g)
                    min_generation = g + 1
                    plan = None
            if plan is not None:
                hint = sorted({int(i) for i in plan["incumbents"]}
                              | {int(s) for s in plan["joiners"].values()})
                lease = lv.HeartbeatLease(directory, process_index=slot,
                                          members=hint,
                                          heartbeat_seconds=hb).start()
                lease.announce_reform(g)
                log.info("join: announced for cluster generation %d as "
                         "worker slot %d", g, slot)
                while True:
                    committed = lv.read_commit(directory, g)
                    if committed is not None:
                        break
                    if time.monotonic() >= deadline:
                        raise RuntimeError(
                            f"join: generation {g} never committed within "
                            f"the join budget {budget:g}s (did the "
                            "incumbents die mid-rendezvous?)")
                    time.sleep(poll)
                if slot not in committed:
                    log.warning("join: commit for generation %d excludes "
                                "this joiner (slot race lost or announce "
                                "too late); waiting for the next opening", g)
                    lv.emit_join_refused(g, slot,
                                         "commit excluded this joiner")
                    lease.stop()
                    lease = None
                    min_generation = g + 1
                    continue
                members = committed
                lease.members = tuple(members)
                rank = members.index(slot)
                _form_generation(cfg, g, members, rank)
                log.info("join: admitted into generation %d as rank %d of %d "
                         "(worker slot %d)", g, rank, len(members), slot)
                return lease, rank, len(members), members, g, slot
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"join: no running cluster admitted this process within "
                    f"{budget:g}s: is a trainer with elastic = grow running "
                    f"against {cfg.model_file}, with a free worker slot, and "
                    "reaching its next epoch boundary?")
            time.sleep(poll)
    except BaseException:
        if lease is not None:
            lease.stop()
        raise
    finally:
        ticket.stop(remove=True)


def share_host_threads(cfg: FmConfig, device, members: Sequence[int],
                       slot: int) -> None:
    """Ranks on the CPU that share one host split its cores between
    their torch thread pools: each rank's pool spinning on every core
    while the others compute (and wait in gloo) makes a CPU step far
    slower. The host's ranks are the ``members`` (original worker
    indices) whose ``worker_hosts`` entry names the host of ``slot``
    (this process's), so an elastic reform recomputes the split for
    its membership (a lone survivor takes every core)."""
    import torch
    if torch.device(device).type != "cpu" or len(cfg.worker_hosts) <= slot:
        return
    names = [h.rsplit(":", 1)[0] for h in cfg.worker_hosts]
    local = max(1, sum(1 for m in members if names[m] == names[slot]))
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:
        cpus = os.cpu_count() or 1
    torch.set_num_threads(max(1, cpus // local))


def _check_port_free(host: str, port: int) -> None:
    """Raise ``OSError`` when another process listens on the rendezvous
    port: torch's store may share a port with a live listener, and the
    ranks of two jobs started on one config (a predict while its train
    still runs) would then meet in each other's store. The probe sets
    ``SO_REUSEADDR``, as the store's own listener does: without it the
    connections of the job that last used the port, left in TIME_WAIT
    for a minute when its rank 0 closed them first, would read as a
    listener and refuse a port the store can bind (a train followed by
    a predict on one config), while a live listener still refuses it."""
    import socket
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
