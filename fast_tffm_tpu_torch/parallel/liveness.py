"""Compute-plane liveness: heartbeat leases and the collective deadline
guard — the port's counterpart of ``fast_tffm_tpu/parallel/liveness.py``
(the lease, the guard and the elastic membership's rendezvous).

Every lockstep step is a collective, so one dead or wedged rank would
park every peer inside it. Two layers close that gap:

- ``HeartbeatLease``: each process rewrites a small lease file in a
  shared rendezvous directory (``<model_file>.hb/``, the shared
  filesystem checkpoints already assume) every ``heartbeat_seconds``
  from a daemon thread (``fmt-heartbeat``), so a rank blocked in a
  collective still renews and only a killed, stopped or crashed one
  goes stale (``STALE_FACTOR`` intervals). Between renewals the thread
  logs a ``worker lost`` warning once per stale peer and runs the
  deadline check.
- ``guarded_collective(fn, *args)``: every blocking collective runs
  under it. A collective that raises (a killed peer resets gloo's
  connections within seconds) becomes a ``WorkerLostError`` naming the
  peers the lease table shows dead, once a transport-shaped error has
  had a staleness window to show them. A collective that blocks (a
  stopped peer keeps its sockets open) is caught by the lease thread:
  past ``collective_timeout_seconds`` with stale peers it logs the
  diagnosis as a ``WorkerLostError`` line, writes every thread's stack
  beside the leases (``<model_file>.hb/worker-<i>.stacks``) and exits
  the process with ``EXIT_WORKER_LOST`` — a bounded, named failure
  instead of a hang.
- ``guarded_work(start)``: the same for a collective issued
  asynchronously (the process group's collectives, parallel/sharded.py),
  waited on in slices by the calling thread. Under an elastic guard
  (``install_guard(recover=True)``) that thread abandons a collective
  still pending past the deadline with stale peers and raises the
  ``WorkerLostError`` itself, for the elastic loop to reform on: a
  killed peer whose process is slow to die keeps its sockets open as a
  stopped one does, and gloo does not raise. The abandoned work's group
  is never destroyed (``abandoned_work``): its worker thread may stay
  blocked on that peer, and destroying the group would join it.

The elastic membership's rendezvous lives here too, all host-only logic
over files in the same directory (train.py and distributed.py drive
it): a survivor of a lost peer announces the next cluster generation
(``announce_reform``) and reforms with the live announcers
(``reform_members``); a replacement process publishes a join ticket
(``JoinTicket``, renewed on ``fmt-join-ticket``), the chief plans its
admission into a free original slot at a safe barrier (``plan_grow``,
``grow-<g>.json``), the rendezvous settles (``grow_rendezvous_step``)
and the chief commits the final membership (``commit-<g>.json``); a
reform's chief sweeps superseded generations (``sweep_lease_dir``).

The staleness, deadline and rendezvous math is clock-injectable, so
tests run it on fake clocks. The protocol trace waits for ROADMAP.md
A11.
"""

from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import json
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fast_tffm_tpu_torch.utils.logging import get_logger

# A lease is stale once it is this many heartbeat intervals old: one of
# scheduling jitter, one of shared-filesystem lag and margin — a live
# but slow worker must not read as dead, and a dead one must go stale
# well inside any sane collective_timeout_seconds.
STALE_FACTOR = 4.0

# The exit code of a process whose blocked collective passed its
# deadline with stale peers (the JAX package's).
EXIT_WORKER_LOST = 86

# Elastic reform: once the live set and the announced set agree, the
# membership must hold still this long before survivors commit to it
# (the skew between survivors' detections).
REFORM_SETTLE_SECONDS = 1.0

# The grow rendezvous files, beside the worker leases:
#   join-<stamp>-<pid>  a replacement process's join ticket, renewed like
#                       a lease (file name order is the admission order
#                       when joiners race for slots)
#   grow-<g>.json       the chief's admission plan for generation g
#                       (which ticket takes which worker slot)
#   commit-<g>.json     the chief's final membership for generation g,
#                       which every party adopts verbatim
JOIN_PREFIX = "join-"
GROW_PLAN_PREFIX = "grow-"
COMMIT_PREFIX = "commit-"


class WorkerLostError(RuntimeError):
    """A collective failed or expired and the liveness table names dead
    peers. ``lost`` carries their lease info; empty when the deadline
    fired with every peer still heartbeating."""

    def __init__(self, message: str, lost: Sequence["PeerInfo"] = ()):
        super().__init__(message)
        self.lost: Tuple["PeerInfo", ...] = tuple(lost)


@dataclasses.dataclass(frozen=True)
class PeerInfo:
    """One row of the liveness table."""
    process_index: int
    host: str = "?"
    pid: int = -1
    age_seconds: Optional[float] = None  # None = lease never written

    def describe(self) -> str:
        age = ("no lease on disk" if self.age_seconds is None
               else f"last heartbeat {self.age_seconds:.1f}s ago")
        return f"process {self.process_index} ({self.host}, {age})"


class HeartbeatLease:
    """One process's lease in the shared rendezvous directory, and the
    read side of every peer's.

    ``renew()`` atomically rewrites ``worker-<i>.hb`` with a wall-clock
    stamp (``clock``; wall time, since staleness compares one process's
    stamp with another's clock). ``start()`` renews on a daemon thread
    every ``heartbeat_seconds`` and checks the peers and the collective
    deadline between renewals. ``members``: the expected membership
    (original process indices), which each elastic reform replaces so
    departed workers stop being reported."""

    def __init__(self, directory: str, process_index: int,
                 members: Sequence[int], heartbeat_seconds: float = 5.0,
                 host: Optional[str] = None, pid: Optional[int] = None,
                 stale_after: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self.directory = directory
        self.process_index = int(process_index)
        self.members: Tuple[int, ...] = tuple(sorted(members))
        self.heartbeat_seconds = float(heartbeat_seconds)
        self.stale_after = (float(stale_after) if stale_after is not None
                            else STALE_FACTOR * self.heartbeat_seconds)
        self.host = host if host is not None else socket.gethostname()
        self.pid = int(pid if pid is not None else os.getpid())
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reported_lost: set = set()  # one warning per episode
        os.makedirs(self.directory, exist_ok=True)

    # -- write side ------------------------------------------------------
    def lease_path(self, process_index: int) -> str:
        return os.path.join(self.directory, f"worker-{process_index}.hb")

    def renew(self) -> None:
        """Atomic lease rewrite; never raises into the renew loop (a
        transient filesystem error costs one beat, which the stale
        margin absorbs)."""
        path = self.lease_path(self.process_index)
        tmp = f"{path}.tmp.{self.pid}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"process_index": self.process_index,
                           "host": self.host, "pid": self.pid,
                           "time": self._clock()}, fh)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    # -- read side -------------------------------------------------------
    def read(self, process_index: int) -> Optional[Dict]:
        """A peer's lease record, or None (missing, torn or garbled all
        read as "never heard from", the safe direction)."""
        try:
            with open(self.lease_path(process_index),
                      encoding="utf-8") as fh:
                rec = json.load(fh)
            float(rec["time"])
            return rec
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def peer_info(self, process_index: int,
                  now: Optional[float] = None) -> PeerInfo:
        rec = self.read(process_index)
        if rec is None:
            return PeerInfo(process_index)
        now = self._clock() if now is None else now
        return PeerInfo(process_index, host=str(rec.get("host", "?")),
                        pid=int(rec.get("pid", -1)),
                        age_seconds=max(0.0, now - float(rec["time"])))

    def stale_peers(self, now: Optional[float] = None) -> List[PeerInfo]:
        """Members other than us whose lease is older than
        ``stale_after``, or missing: the diagnosis the guard names."""
        now = self._clock() if now is None else now
        out = []
        for p in self.members:
            if p == self.process_index:
                continue
            info = self.peer_info(p, now=now)
            if info.age_seconds is None or \
                    info.age_seconds > self.stale_after:
                out.append(info)
        return out

    def live_members(self, now: Optional[float] = None) -> List[int]:
        """Members with a fresh lease, us included: the shrink reform's
        source of membership."""
        stale = {i.process_index for i in self.stale_peers(now=now)}
        return [p for p in self.members if p not in stale]

    def fresh(self, process_index: int,
              now: Optional[float] = None) -> bool:
        """Whether ``worker-<i>.hb`` is on disk and within the staleness
        threshold, member or not (the grow rendezvous asks about joiner
        slots before they are members)."""
        if process_index == self.process_index:
            return True
        info = self.peer_info(process_index, now=now)
        return (info.age_seconds is not None
                and info.age_seconds <= self.stale_after)

    # -- elastic reform rendezvous ----------------------------------------
    def announce_reform(self, generation: int) -> None:
        """Announce that this process is ready to reform into cluster
        generation ``generation`` (idempotent; a file per generation, so
        a later reform never reads an earlier round's announcements)."""
        path = os.path.join(self.directory,
                            f"reform-{int(generation)}-{self.process_index}")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(f"{self.host} {self.pid} {self._clock():.3f}\n")

    def reform_members(self, generation: int) -> List[int]:
        """The original process indices that announced ``generation``."""
        prefix = f"reform-{int(generation)}-"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith(prefix):
                try:
                    out.append(int(n[len(prefix):]))
                except ValueError:
                    pass
        return sorted(out)

    # -- renew / monitor thread -----------------------------------------
    def check_peers(self) -> List[PeerInfo]:
        """One monitor tick: a ``worker lost`` warning for every member
        newly gone stale (one per staleness episode; a peer whose lease
        resumes re-arms). Returns the newly lost peers."""
        if self.read(self.process_index) is None:
            # Our own lease, renewed this tick, is unreadable: the
            # directory is broken, not the peers; skip the tick.
            return []
        stale = self.stale_peers()
        stale_ids = {i.process_index for i in stale}
        fresh = [i for i in stale
                 if i.process_index not in self._reported_lost]
        self._reported_lost &= stale_ids  # recovered peers re-arm
        for info in fresh:
            self._reported_lost.add(info.process_index)
            get_logger().warning("worker lost (heartbeat monitor): %s",
                                 info.describe())
        return fresh

    def start(self) -> "HeartbeatLease":
        if self._thread is None and self.heartbeat_seconds > 0:
            self.renew()  # the lease exists before anyone looks for it

            def loop():
                while not self._stop.wait(self.heartbeat_seconds):
                    self.renew()
                    try:
                        self.check_peers()
                        check_deadline()
                    except Exception:  # noqa: BLE001 - the monitor
                        # outlives a bad tick; staleness is evaluated
                        # again next interval
                        pass
            self._thread = threading.Thread(target=loop,
                                            name="fmt-heartbeat",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, remove: bool = True) -> None:
        """Stop renewing; ``remove`` drops our lease file and sweeps
        stale leases of dead members, so a clean exit leaves no ghosts
        for the next run. A fresh peer lease is never touched."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        if not remove:
            return
        try:
            os.remove(self.lease_path(self.process_index))
        except OSError:
            pass
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        now = self._clock()
        for n in names:
            if not (n.startswith("worker-") and n.endswith(".hb")):
                continue
            try:
                idx = int(n[len("worker-"):-len(".hb")])
            except ValueError:
                continue
            if idx == self.process_index:
                continue
            info = self.peer_info(idx, now=now)
            if info.age_seconds is None or \
                    info.age_seconds > self.stale_after:
                try:
                    os.remove(os.path.join(self.directory, n))
                except OSError:
                    pass


def lease_dir(cfg) -> str:
    """The rendezvous directory of a run: ``<model_file>.hb/``, beside
    the checkpoint directory on the same shared filesystem."""
    return os.path.abspath(cfg.model_file) + ".hb"


# -- elastic grow: join tickets, admission plans, commits ---------------
#
# The shrink's mechanisms run the other way: a replacement process
# publishes a join ticket, the cluster notices it at a safe barrier (the
# epoch boundary; train.py), the chief writes a plan giving the ticket a
# free original worker slot, and both sides rendezvous through the same
# per-generation announce files into a cluster that includes the joiner.
# A joiner that dies mid-rendezvous goes stale inside the settle window
# and the reform commits without it; an announce into a generation the
# plan never assigned is refused; joiners racing for fewer slots resolve
# by ticket order.


class JoinTicket:
    """A replacement process's join request: ``join-<stamp>-<pid>`` in
    the rendezvous directory, renewed on a daemon thread
    (``fmt-join-ticket``) as a worker lease is, so a joiner that dies
    stops renewing and is never planned for. The zero-padded
    millisecond stamp makes file name order the admission order."""

    def __init__(self, directory: str, heartbeat_seconds: float = 5.0,
                 host: Optional[str] = None, pid: Optional[int] = None,
                 clock: Callable[[], float] = time.time,
                 name: Optional[str] = None):
        self.directory = directory
        self.heartbeat_seconds = float(heartbeat_seconds)
        self.host = host if host is not None else socket.gethostname()
        self.pid = int(pid if pid is not None else os.getpid())
        self._clock = clock
        self.name = name or (f"{JOIN_PREFIX}{int(self._clock() * 1e3):016d}"
                             f"-{self.pid}")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, self.name)

    def renew(self) -> None:
        """Atomic rewrite, never raising (as ``HeartbeatLease.renew``)."""
        tmp = f"{self.path}.tmp.{self.pid}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"host": self.host, "pid": self.pid,
                           "time": self._clock()}, fh)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def start(self) -> "JoinTicket":
        if self._thread is None and self.heartbeat_seconds > 0:
            self.renew()

            def loop():
                while not self._stop.wait(self.heartbeat_seconds):
                    self.renew()
            self._thread = threading.Thread(target=loop,
                                            name="fmt-join-ticket",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, remove: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        if remove:
            try:
                os.remove(self.path)
            except OSError:
                pass


def pending_join_tickets(directory: str, stale_after: float,
                         now: Optional[float] = None) -> List[str]:
    """Fresh join ticket names in file name order: the cluster's
    admission scan. A stale or garbled ticket is a dead joiner, never
    planned for; an unreadable directory reads as nobody waiting."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    now = time.time() if now is None else now
    out = []
    for n in names:
        if not n.startswith(JOIN_PREFIX) or ".tmp." in n:
            continue
        try:
            with open(os.path.join(directory, n), encoding="utf-8") as fh:
                rec = json.load(fh)
            age = now - float(rec["time"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if age <= stale_after:  # clock skew (age < 0) reads fresh
            out.append(n)
    return out


def plan_grow(generation: int, members: Sequence[int], capacity: int,
              tickets: Sequence[str]) -> Optional[Dict]:
    """The chief's admission decision at a safe barrier: fresh tickets
    to free ORIGINAL worker slots (the departed workers' indices, so
    ``worker_hosts`` keeps its meaning), in ticket name order; None when
    there is nothing to do. Pure: two joiners racing one slot resolve by
    ticket order, the loser staying pending."""
    free = sorted(set(range(int(capacity))) - {int(m) for m in members})
    tickets = sorted(tickets)
    if not free or not tickets:
        return None
    return {"generation": int(generation),
            "incumbents": sorted(int(m) for m in members),
            "joiners": {t: s for t, s in zip(tickets, free)}}


def _atomic_write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def grow_plan_path(directory: str, generation: int) -> str:
    return os.path.join(directory, f"{GROW_PLAN_PREFIX}{int(generation)}.json")


def commit_path(directory: str, generation: int) -> str:
    return os.path.join(directory, f"{COMMIT_PREFIX}{int(generation)}.json")


def write_grow_plan(directory: str, plan: Dict) -> str:
    path = grow_plan_path(directory, plan["generation"])
    _atomic_write_json(path, plan)
    return path


def write_commit(directory: str, generation: int,
                 members: Sequence[int]) -> str:
    path = commit_path(directory, generation)
    _atomic_write_json(path, {"generation": int(generation),
                              "members": [int(m) for m in members]})
    return path


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def read_grow_plan(directory: str, generation: int) -> Optional[Dict]:
    plan = _read_json(grow_plan_path(directory, generation))
    if (not isinstance(plan, dict) or "incumbents" not in plan
            or not isinstance(plan.get("joiners"), dict)):
        return None
    return plan


def read_commit(directory: str, generation: int) -> Optional[List[int]]:
    rec = _read_json(commit_path(directory, generation))
    if not isinstance(rec, dict) or "members" not in rec:
        return None
    try:
        return sorted(int(m) for m in rec["members"])
    except (TypeError, ValueError):
        return None


def grow_plan_for(directory: str, ticket_name: str,
                  min_generation: int = 0) -> Optional[Dict]:
    """The newest admission plan naming ``ticket_name``, ignoring
    generations below ``min_generation`` (a refused joiner raises the
    floor, so a superseded plan is never acted on twice): what a
    joiner's wait polls."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    gens = []
    for n in names:
        if n.startswith(GROW_PLAN_PREFIX) and n.endswith(".json"):
            try:
                gens.append(int(n[len(GROW_PLAN_PREFIX):-len(".json")]))
            except ValueError:
                pass
    for g in sorted(gens, reverse=True):
        if g < min_generation:
            break
        plan = read_grow_plan(directory, g)
        if plan is not None and ticket_name in plan["joiners"]:
            return plan
    return None


def grow_rendezvous_step(lease: HeartbeatLease, plan: Dict,
                         now_monotonic: float,
                         join_deadline: float) -> Optional[List[int]]:
    """One tick of the chief's grow settle loop: the final membership
    once it is decidable, else None. Decidable once every incumbent has
    announced the plan's generation and the settle window
    (``join_deadline``) has fully passed: staleness is the only death
    signal and it lags a death by the threshold, so the window is never
    cut short. Then each planned slot is in (announced, with a fresh
    worker lease) or out (it died mid-rendezvous, and must not wedge the
    incumbents)."""
    g = int(plan["generation"])
    announced = set(lease.reform_members(g))
    incumbents = [int(i) for i in plan["incumbents"]]
    if not set(incumbents) <= announced:
        return None
    optional = sorted(int(s) for s in plan["joiners"].values())
    if optional and now_monotonic < join_deadline:
        return None
    joined = [s for s in optional if s in announced and lease.fresh(s)]
    return sorted(set(incumbents) | set(joined))


def unexpected_announcers(lease: HeartbeatLease, plan: Dict) -> List[int]:
    """Announce files for the plan's generation from slots the plan
    never assigned (a joiner acting on a stale plan, a slot collision):
    left out of the membership and refused aloud."""
    g = int(plan["generation"])
    expected = ({int(i) for i in plan["incumbents"]}
                | {int(s) for s in plan["joiners"].values()})
    return sorted(set(lease.reform_members(g)) - expected)


def sweep_lease_dir(directory: str, generation: int, members: Sequence[int],
                    join_stale_after: float = 0.0,
                    now: Optional[float] = None) -> int:
    """The reform's litter sweep: announce, plan and commit files of
    superseded generations, leases of processes outside the membership,
    dead (stale or garbled) join tickets and temporary files. The
    current generation's files and fresh tickets (joiners waiting for a
    later opening) stay. Returns the files removed; never raises."""
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    keep = {int(m) for m in members}
    fresh_tickets = (set(pending_join_tickets(directory, join_stale_after,
                                              now=now))
                     if join_stale_after > 0 else set())
    removed = 0
    for n in names:
        drop = False
        if ".tmp." in n:
            drop = True
        elif n.startswith("reform-"):
            try:
                drop = int(n.split("-")[1]) < int(generation)
            except (IndexError, ValueError):
                drop = True
        elif (n.startswith(GROW_PLAN_PREFIX)
              or n.startswith(COMMIT_PREFIX)) and n.endswith(".json"):
            prefix = (GROW_PLAN_PREFIX if n.startswith(GROW_PLAN_PREFIX)
                      else COMMIT_PREFIX)
            try:
                drop = int(n[len(prefix):-len(".json")]) < int(generation)
            except ValueError:
                drop = True
        elif n.startswith("worker-") and n.endswith(".hb"):
            try:
                drop = int(n[len("worker-"):-len(".hb")]) not in keep
            except ValueError:
                drop = True
        elif n.startswith(JOIN_PREFIX):
            drop = n not in fresh_tickets
        if drop:
            try:
                os.remove(os.path.join(directory, n))
                removed += 1
            except OSError:
                pass
    return removed


def emit_join_refused(generation: int, slot, reason: str) -> None:
    """The refusal of a joiner the rendezvous turned away (an announce
    into a generation it was never planned into, a commit that left it
    out), logged at once: the refused process idles outside the
    cluster. The JAX package's ``health: join_refused`` event waits for
    ROADMAP.md A11."""
    get_logger().warning(
        "join refused: generation %d, worker slot %d: %s", int(generation),
        int(slot) if slot is not None else -1, str(reason)[:200])


@dataclasses.dataclass
class _GuardState:
    lease: Optional[HeartbeatLease]
    timeout_seconds: float
    # (label, started monotonic) of the collective blocking the calling
    # thread; None between collectives. A tuple assignment, atomic under
    # the GIL, read by the monitor thread.
    in_flight: Optional[Tuple[str, float]] = None
    # When a guarded collective last completed (or the guard was armed):
    # the lockstep runs one every step, so none completing within the
    # deadline also catches a hang in an unguarded sync point.
    last_progress: float = 0.0
    # The escalation of the monitor's hang verdict; tests inject a
    # recorder instead of exiting.
    escalate: Callable[[str], None] = None  # type: ignore[assignment]
    warned_slow: bool = False
    # Elastic recovery is on: the thread waiting in ``guarded_work``
    # abandons a collective the deadline finds blocked on stale peers,
    # and the monitor leaves that verdict to it.
    recover: bool = False
    # The collective in flight is waited on by ``guarded_work``.
    polling: bool = False


_GUARD: Optional[_GuardState] = None
# Works abandoned by ``guarded_work`` (label, work): their process
# group must outlive the process (distributed.retire_distributed_client).
_ABANDONED: List[Tuple[str, object]] = []
# How long ``guarded_work`` blocks in one wait before it looks at the
# deadline again.
WORK_WAIT_SLICE_SECONDS = 0.25


def install_guard(lease: Optional[HeartbeatLease], timeout_seconds: float,
                  escalate: Optional[Callable[[str], None]] = None,
                  recover: bool = False) -> Optional[_GuardState]:
    """Arm ``guarded_collective`` for this process (train and predict
    call it once the cluster is up). ``recover``: the caller reforms on
    ``WorkerLostError`` (``elastic = shrink | grow``), so a blocked
    ``guarded_work`` raises it instead of the process exiting. Returns
    the previous state for ``restore_guard``."""
    global _GUARD
    prev = _GUARD
    _GUARD = _GuardState(lease=lease, timeout_seconds=float(timeout_seconds),
                         last_progress=time.monotonic(),
                         escalate=escalate or _default_escalate,
                         recover=bool(recover))
    return prev


def restore_guard(prev: Optional[_GuardState]) -> None:
    global _GUARD
    _GUARD = prev


def current_guard() -> Optional[_GuardState]:
    return _GUARD


def guarded_collective(fn: Callable, *args, label: str = "collective",
                       **kwargs):
    """Run a blocking collective under the process's deadline guard.
    Without a guard (one process) this is a plain call. Armed: the call
    runs inline, marked in flight for the monitor's deadline check; a
    raise is re-raised, except when the lease table shows dead peers —
    then a ``WorkerLostError`` naming them, with the original error as
    its cause; a call still blocked past ``collective_timeout_seconds``
    with stale peers is escalated by the monitor thread."""
    state = _GUARD
    if state is None:
        return fn(*args, **kwargs)
    state.in_flight = (label, time.monotonic())
    try:
        return fn(*args, **kwargs)
    except WorkerLostError:
        raise
    except Exception as e:
        _convert_if_peers_lost(state.lease, label, e)
        raise
    finally:
        state.in_flight = None
        state.last_progress = time.monotonic()
        state.warned_slow = False


def guarded_work(start: Callable[[], object], label: str = "collective"
                 ) -> None:
    """Run an asynchronous collective under the process's deadline
    guard: ``start()`` issues it (``async_op=True``) and returns its
    work, which this thread waits on in slices of
    ``WORK_WAIT_SLICE_SECONDS`` inside ``guarded_collective``. Under an
    elastic guard (``recover``), a collective still pending past
    ``collective_timeout_seconds`` while the lease names stale peers is
    abandoned: logged, kept in ``abandoned_work``, and a
    ``WorkerLostError`` raised for the elastic loop."""
    state = _GUARD
    if state is None:
        start().wait()
        return

    def wait() -> None:
        work = start()
        state.polling = True
        try:
            while True:
                try:
                    work.wait(datetime.timedelta(
                        seconds=WORK_WAIT_SLICE_SECONDS))
                    return
                except RuntimeError:
                    # A wait that timed out leaves the work pending. A
                    # completed one (it failed, or it finished as the
                    # wait timed out) gives its outcome to a plain wait.
                    if work.is_completed():
                        work.wait()
                        return
                if state.recover:
                    _abandon_if_lost(state, label, work)
        finally:
            state.polling = False
    guarded_collective(wait, label=label)


def _abandon_if_lost(state: _GuardState, label: str, work) -> None:
    """Past the deadline with stale peers: give ``work`` up and raise
    ``WorkerLostError`` naming them; return otherwise."""
    snap = state.in_flight
    if snap is None or state.timeout_seconds <= 0:
        return
    waited = time.monotonic() - snap[1]
    if waited <= state.timeout_seconds:
        return
    lost = state.lease.stale_peers() if state.lease is not None else []
    if not lost:
        return
    _dump_stacks(state.lease, label)
    _ABANDONED.append((label, work))
    who = "; ".join(i.describe() for i in lost)
    get_logger().error(
        "worker lost during '%s': %s (still pending after %.1fs, past "
        "collective_timeout_seconds=%gs: abandoned for the elastic "
        "reform)", label, who, waited, state.timeout_seconds)
    raise WorkerLostError(
        f"collective '{label}' still pending past "
        f"collective_timeout_seconds={state.timeout_seconds:g}s and the "
        f"liveness table names dead peers: {who}", lost=lost)


def abandoned_work() -> List[Tuple[str, object]]:
    """(label, work) of every collective ``guarded_work`` abandoned in
    this process."""
    return list(_ABANDONED)


def check_deadline(state: Optional[_GuardState] = None,
                   now: Optional[float] = None) -> Optional[str]:
    """One monitor tick of the collective deadline. Past
    ``collective_timeout_seconds`` (the collective in flight, or since
    the last one completed): with stale peers, log the diagnosis, dump
    the stacks and escalate (by default log the ``WorkerLostError``
    line and exit ``EXIT_WORKER_LOST``: the blocked thread can never
    raise); with none, one ``collective slow`` warning (a slow save or
    storage stall must not kill a healthy cluster). An elastic guard's
    ``guarded_work`` in flight raises that verdict itself instead
    ("abandoning"). Returns "escalated", "abandoning", "slow" or
    None."""
    state = state if state is not None else _GUARD
    if state is None or state.timeout_seconds <= 0:
        return None
    now = time.monotonic() if now is None else now
    snap = state.in_flight
    if snap is not None:
        label, started = snap
        waited = now - started
    else:
        label = "no guarded collective completing"
        waited = now - state.last_progress
    if waited <= state.timeout_seconds:
        return None
    lease = state.lease
    lost = lease.stale_peers() if lease is not None else []
    if not lost:
        if not state.warned_slow:
            state.warned_slow = True
            get_logger().warning(
                "collective slow: '%s' waited %.1fs, past "
                "collective_timeout_seconds=%gs, with every peer still "
                "heartbeating", label, waited, state.timeout_seconds)
        return "slow"
    if snap is not None and state.recover and state.polling:
        return "abandoning"
    _dump_stacks(lease, label)
    who = "; ".join(i.describe() for i in lost)
    message = (f"WorkerLostError: '{label}' exceeded "
               f"collective_timeout_seconds={state.timeout_seconds:g}s; "
               f"peers that stopped heartbeating: {who}. The blocked "
               "thread cannot be unblocked from Python; exiting "
               f"{EXIT_WORKER_LOST}.")
    state.escalate(message)
    return "escalated"


def _default_escalate(message: str) -> None:
    get_logger().critical(message)
    for h in get_logger().handlers:
        try:
            h.flush()
        except Exception:  # noqa: BLE001 - nothing left to do with a
            pass           # broken handler on the way out
    os._exit(EXIT_WORKER_LOST)


def _await_staleness(lease: Optional[HeartbeatLease]) -> List[PeerInfo]:
    """Stale peers per the lease table, polled for up to one staleness
    window: a peer killed a moment ago needs that long to go visibly
    stale."""
    if lease is None:
        return []
    deadline = time.monotonic() + lease.stale_after + lease.heartbeat_seconds
    while True:
        stale = lease.stale_peers()
        if stale or time.monotonic() >= deadline:
            return stale
        time.sleep(min(0.05, max(lease.heartbeat_seconds / 4, 0.01)))


# Error text that smells of the transport failing (a dead peer's reset
# through gloo), as against a semantic error of the collective itself:
# only those are worth a staleness window's wait.
_TRANSPORT_ERROR_MARKERS = (
    "connection", "unavailable", "socket", "gloo", "transport",
    "deadline", "aborted", "cancelled", "coordination", "heartbeat",
    "peer", "barrier", "timed out", "timeout", "closed", "reset",
    "broken pipe",
)


def _looks_like_transport_error(cause: BaseException) -> bool:
    text = f"{type(cause).__name__}: {cause}".lower()
    return any(m in text for m in _TRANSPORT_ERROR_MARKERS)


def _convert_if_peers_lost(lease: Optional[HeartbeatLease], label: str,
                           cause: BaseException) -> None:
    """Raise WorkerLostError from ``cause`` when the lease table blames
    a dead peer; return otherwise (the caller re-raises the original).
    A transport-shaped error gets the staleness grace; any other error
    one immediate check."""
    if lease is not None and not _looks_like_transport_error(cause):
        lost = lease.stale_peers()
    else:
        lost = _await_staleness(lease)
    if not lost:
        return
    who = "; ".join(i.describe() for i in lost)
    get_logger().error("worker lost during '%s': %s (%s: %s)", label, who,
                       type(cause).__name__, str(cause)[:200])
    raise WorkerLostError(
        f"collective '{label}' failed and the liveness table names "
        f"dead peers: {who}", lost=lost) from cause


def _dump_stacks(lease: Optional[HeartbeatLease], label: str) -> None:
    """Every thread's stack, appended to ``worker-<i>.stacks`` beside
    the leases: where each thread was parked when the deadline passed.
    Best effort."""
    if lease is None:
        return
    try:
        path = os.path.join(lease.directory,
                            f"worker-{lease.process_index}.stacks")
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(f"\n==== collective '{label}' deadline expired at "
                     f"{time.time():.3f} ====\n")
            fh.flush()
            faulthandler.dump_traceback(file=fh, all_threads=True)
    except Exception:  # noqa: BLE001 - forensics must never mask the
        pass           # diagnosis about to be logged
