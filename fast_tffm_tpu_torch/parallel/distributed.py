"""Multi-process bring-up — the port's counterpart of
``fast_tffm_tpu/parallel/distributed.py`` (bring-up only).

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
line. Elastic reform and ``train --join`` are refused in train.py
(ROADMAP.md A10, its second slice).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Sequence, Tuple

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


def coordinator_address(cfg: FmConfig) -> str:
    """worker_hosts[0] with its port shifted up by 1000 (the reference's
    worker port served TF's gRPC; the rendezvous needs its own), so
    every process derives the same address from the shared config."""
    host = cfg.worker_hosts[0]
    if ":" in host:
        name, port = host.rsplit(":", 1)
        return f"{name}:{int(port) + 1000}"
    return f"{host}:8476"


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


def _join_cluster(cfg: FmConfig, address: str, num_processes: int,
                  process_id: int) -> None:
    """Form the process group at ``address`` as rank ``process_id`` of
    ``num_processes``: rank 0 hosts the TCP store, every rank connects
    to it, and the gloo group forms over it."""
    import torch.distributed as dist

    host, port = address.rsplit(":", 1)
    if host in ("localhost", "127.0.0.1") and \
            "GLOO_SOCKET_IFNAME" not in os.environ:
        # A one-host cluster talks over loopback: gloo would otherwise
        # look its peers up by the machine's host name.
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"

    def _initialize(coordinator_address: str, num_processes: int,
                    process_id: int, initialization_timeout: int) -> None:
        if process_id == 0:
            _check_port_free(host, int(port))
        store = None
        try:
            store = dist.TCPStore(
                host, int(port), num_processes,
                is_master=process_id == 0,
                timeout=datetime.timedelta(seconds=initialization_timeout),
                wait_for_workers=True)
            dist.init_process_group("gloo", store=store, rank=process_id,
                                    world_size=num_processes,
                                    timeout=_group_timeout(cfg))
        except Exception:
            # A half-formed attempt must not block the next one.
            if dist.is_initialized():
                dist.destroy_process_group()
            del store
            raise

    initialize_with_retry(
        _initialize, address=address, num_processes=num_processes,
        process_id=process_id,
        timeout_seconds=cfg.cluster_connect_timeout_seconds)
    if dist.get_world_size() != num_processes:
        raise RuntimeError(
            "torch.distributed did not federate the cluster: expected "
            f"{num_processes} processes, got {dist.get_world_size()}")


def share_host_threads(cfg: FmConfig, device, num_processes: int) -> None:
    """Ranks on the CPU that share one host split its cores between
    their torch thread pools: each rank's pool spinning on every core
    while the others compute (and wait in gloo) makes a CPU step far
    slower. The host's ranks are the ``worker_hosts`` entries naming
    this rank's host."""
    import torch
    if torch.device(device).type != "cpu" or num_processes <= 1:
        return
    names = [h.rsplit(":", 1)[0] for h in cfg.worker_hosts]
    mine = names[process_index()] if len(names) > process_index() else ""
    local = max(1, sum(1 for n in names if n == mine))
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:
        cpus = os.cpu_count() or 1
    torch.set_num_threads(max(1, cpus // local))


def _check_port_free(host: str, port: int) -> None:
    """Raise ``OSError`` when another process listens on the rendezvous
    port: torch's store may share a port with a live listener, and the
    ranks of two jobs started on one config (a predict while its train
    still runs) would then meet in each other's store."""
    import socket
    with socket.socket() as s:
        s.bind((host, port))


def process_index() -> int:
    """This process's rank (0 outside a multi-process job)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count() -> int:
    """The job's process count (1 outside a multi-process job)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
