"""Replica supervisor for the serving fleet — the port's counterpart of
``fast_tffm_tpu/serve/fleet.py``.

``python -m fast_tffm_tpu_torch serve <cfg> --replicas N`` (or
``serve_replicas = N`` in the config) runs this process: it spawns N
ScorerServer children (``python -m fast_tffm_tpu_torch.serve.replica
<cfg> [--device cuda|cpu]``) on ports ``serve_port + i``, binds the
failover proxy (serve/proxy.py) on ``serve_proxy_port`` as the clients'
front door, and supervises:

- **Health**: every ``serve_health_poll_seconds`` each replica's
  ``/healthz`` is read. ``alive`` (the process answers) drives
  restarts; ``ready`` (warm, not mid-reload, queue under the shed
  depth) drives routing: a warming or reloading replica is routed
  around, never restarted.
- **Restarts**: a replica whose process exited, or that stopped
  answering for ``_WEDGED_SILENCE_SECONDS`` (then killed), respawns
  under capped exponential backoff (``serve_restart_backoff_seconds``,
  doubling, capped at 16x, reset once it reports ready). Each spawned
  process's death is counted once (``fleet/deaths``), on the first
  poll that sees it exited, whatever probes failed before.
- **Staggered reloads**: children run ``serve_reload_mode = external``;
  when the ``published`` pointer moves, the supervisor hands each
  replica the reload token in turn: wait until at least one other
  replica is ready, ``POST /reload`` (synchronous; the replica reports
  not ready meanwhile), wait for it to come back ready, go on. The
  fleet never has a moment with no replica ready.
- **Canary**: with ``serve_canary_fraction`` > 0 or
  ``serve_canary_shadow``, the last replica follows the
  ``published-canary`` pointer (``fmckpt publish --canary``) and the
  proxy sends it the configured fraction of traffic, or copies.
- **Drain**: ``stop`` (SIGTERM or SIGINT under ``run_fleet``) stops the
  watch threads and the proxy, SIGTERMs every child (each drains its
  own admission queue) and reaps them.

Each child binds the card itself unless ``device`` is ``"cpu"``: one
CUDA context and one copy of the table each. A child without a card and
without ``--device cpu`` exits non-zero, and the supervisor logs the
exit and restarts it under the backoff. The fleet's gauges and counters
(``fleet/*``, ``proxy/*``) live on the registry that ``stats`` reads.
With ``metrics_file`` set it is the supervisor's own stream's
(``make_telemetry(cfg, "fleet")``): the per-replica gauges
``fleet/replica<i>_alive``, ``_ready``, ``_step`` and ``_queue_depth``,
flushed at once on every change of the ready count (so a snapshot taken
mid-incident shows the gap: fmstat's ``FLEET DEGRADED (k/N ready)``)
and after each staggered reload, a heartbeat every health poll, and
``run_end`` at ``stop``. Each replica writes its own stream,
``<metrics_file>.r<i>``, named for it in ``FM_METRICS_FILE``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from fast_tffm_tpu_torch.checkpoint import read_pointer, read_published
from fast_tffm_tpu_torch.obs.registry import MetricsRegistry
from fast_tffm_tpu_torch.obs.telemetry import make_telemetry
from fast_tffm_tpu_torch.parallel.distributed import ephemeral_port_range
from fast_tffm_tpu_torch.serve.proxy import FleetView, Replica, ScoreProxy
from fast_tffm_tpu_torch.utils.ignored import log_ignored_keys
from fast_tffm_tpu_torch.utils.logging import get_logger

# Backoff cap, as a multiple of the base: 1, 2, 4, 8, 16, 16, ...
_BACKOFF_CAP_FACTOR = 16.0
# Seconds of /healthz silence from a live process before the supervisor
# calls it wedged and kills it. Time, not a probe count: a new replica
# is silent for seconds (interpreter, torch import, the step's restore)
# before its front end binds, and the window must not shrink with a
# fast health poll. The clock restarts at every spawn.
_WEDGED_SILENCE_SECONDS = 60.0
# How long a child gets to drain after SIGTERM before SIGKILL.
_DRAIN_SECONDS = 15.0
# Budget for one replica's turn of a staggered reload (the reload and
# its return to ready).
_RELOAD_STEP_TIMEOUT = 120.0


class RestartPolicy:
    """Capped exponential backoff over an injected clock.
    ``record_death`` schedules the next allowed restart, ``can_restart``
    gates the respawn, ``record_healthy`` resets the streak."""

    def __init__(self, base_seconds: float,
                 cap_factor: float = _BACKOFF_CAP_FACTOR,
                 clock: Callable[[], float] = time.monotonic):
        self._base = float(base_seconds)
        self._cap = self._base * float(cap_factor)
        self._clock = clock
        self._failures = 0
        self._not_before = 0.0

    def record_death(self) -> float:
        """Note one death; returns the delay applied."""
        delay = min(self._base * (2.0 ** self._failures), self._cap)
        self._failures += 1
        self._not_before = self._clock() + delay
        return delay

    def can_restart(self) -> bool:
        return self._clock() >= self._not_before

    def record_healthy(self) -> None:
        self._failures = 0
        self._not_before = 0.0

    @property
    def failures(self) -> int:
        return self._failures


class ReplicaProc:
    """One supervised child: its process, its routing row in the proxy's
    FleetView, and its restart policy."""

    def __init__(self, index: int, cfg, cfg_path: str,
                 canary: bool = False, device: Optional[str] = None,
                 logger=None,
                 clock: Callable[[], float] = time.monotonic):
        self.index = int(index)
        self.cfg = cfg
        self.cfg_path = os.path.abspath(cfg_path)
        self.port = cfg.serve_port + self.index
        self.canary = bool(canary)
        self.device = device
        self.row = Replica(self.index, cfg.serve_host, self.port,
                           canary=self.canary)
        self.policy = RestartPolicy(cfg.serve_restart_backoff_seconds,
                                    clock=clock)
        self.proc: Optional[subprocess.Popen] = None
        # Whether the current process's exit has been counted.
        self.death_counted = False
        self.probe_failures = 0
        self._clock = clock
        # Last moment this replica answered /healthz, or was spawned.
        self.last_answer = clock()
        self._logger = logger or get_logger()
        self._log_fh = None

    # -- process lifecycle ----------------------------------------------

    def command(self) -> List[str]:
        cmd = [sys.executable, "-m", "fast_tffm_tpu_torch.serve.replica",
               self.cfg_path]
        if self.device is not None:
            cmd += ["--device", self.device]
        return cmd

    def spawn(self) -> None:
        env = dict(os.environ)
        # Per-replica knobs ride the FM_<KNOB> overrides the replica
        # applies (config.apply_env_overrides): its port, external
        # reloads (the supervisor owns them), the canary pointer.
        env["FM_SERVE_PORT"] = str(self.port)
        env["FM_SERVE_RELOAD_MODE"] = "external"
        if self.canary:
            env["FM_SERVE_POINTER"] = "canary"
        if self.cfg.metrics_file:
            # The replica's own stream, beside the supervisor's.
            base = self.cfg.metrics_file
            if base == "auto":
                base = self.cfg.model_file + ".metrics.jsonl"
            env["FM_METRICS_FILE"] = f"{base}.r{self.index}"
        # The package must import wherever the child starts.
        import fast_tffm_tpu_torch
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(fast_tffm_tpu_torch.__file__)))
        env["PYTHONPATH"] = root + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        if self._log_fh is None:
            self._log_fh = open(
                f"{self.cfg.model_file}.replica{self.index}.log", "ab")
        self.proc = subprocess.Popen(self.command(), env=env,
                                     stdout=self._log_fh,
                                     stderr=subprocess.STDOUT)
        self.death_counted = False
        self.probe_failures = 0
        self.last_answer = self._clock()
        self._logger.info(
            "fleet: replica %d%s spawned (pid %d, port %d)",
            self.index, " (canary)" if self.canary else "",
            self.proc.pid, self.port)

    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def exited(self) -> bool:
        return self.proc is None or self.proc.poll() is not None

    def terminate(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.terminate()
            except OSError:
                pass

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass

    def reap(self, timeout: float = _DRAIN_SECONDS) -> None:
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.kill()
                self.proc.wait()
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    # -- health ----------------------------------------------------------

    def probe(self, timeout: float = 1.0) -> Optional[dict]:
        """One /healthz read; None when the replica does not answer."""
        conn = http.client.HTTPConnection(self.cfg.serve_host, self.port,
                                          timeout=timeout)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            return json.loads(body)
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    def reload(self, step: int,
               timeout: float = _RELOAD_STEP_TIMEOUT) -> bool:
        """Hand this replica the reload token: a synchronous POST
        /reload that returns after the swap or its failure."""
        conn = http.client.HTTPConnection(self.cfg.serve_host, self.port,
                                          timeout=timeout)
        try:
            conn.request("POST", "/reload", body=str(int(step)),
                         headers={"Content-Type": "text/plain"})
            resp = conn.getresponse()
            resp.read()
            return resp.status == 200
        except (OSError, http.client.HTTPException):
            return False
        finally:
            conn.close()

    def is_ready(self) -> bool:
        """A fresh readiness probe (the stagger protocol's view: never
        a cached row). An answer also refreshes the proxy's row, so a
        replica the stagger just saw come back ready is routed to
        before the stagger takes the next one out."""
        h = self.probe()
        if h is None:
            return False
        ready = bool(h.get("ready"))
        self.row.set_health(True, ready,
                            served_step=int(h.get("served_step", -1)),
                            queue_depth=int(h.get("queue_depth", 0)))
        return ready


def staggered_reload(handles, step: int, reloaded=None,
                     min_other_ready: int = 1,
                     wait_seconds: float = _RELOAD_STEP_TIMEOUT,
                     poll: float = 0.1,
                     sleep: Callable[[float], None] = time.sleep,
                     clock: Callable[[], float] = time.monotonic,
                     logger=None) -> int:
    """The stagger protocol over anything with ``is_ready()`` and
    ``reload(step)``: for each handle in turn, wait until at least
    ``min_other_ready`` other handles are ready (past ``wait_seconds``,
    reload anyway rather than serve a stale step for ever), hand it the
    reload token, then wait for it to come back ready before the next.
    Returns the number of successful reloads; ``reloaded(handle, ok)``
    runs after each turn."""
    log = logger or get_logger()
    done = 0
    for h in handles:
        others = [o for o in handles if o is not h]
        if others:
            deadline = clock() + wait_seconds
            while sum(1 for o in others if o.is_ready()) < min_other_ready:
                if clock() >= deadline:
                    log.warning(
                        "fleet: stagger stalled — fewer than %d other "
                        "replicas ready; reloading anyway rather than "
                        "serve a stale step", min_other_ready)
                    break
                sleep(poll)
        ok = h.reload(step)
        if ok:
            deadline = clock() + wait_seconds
            while not h.is_ready() and clock() < deadline:
                sleep(poll)
            done += 1
        else:
            log.warning("fleet: reload of step %d failed on a replica; "
                        "it keeps serving its previous step", step)
        if reloaded is not None:
            reloaded(h, ok)
    return done


class FleetSupervisor:
    """Owns the children, the proxy and the watch threads
    (``fmt-fleet-health``, ``fmt-fleet-reload``). Drive with ``start()``
    and ``stop()``; ``run_fleet`` adds the signal handling of the CLI.
    ``device`` is passed to every child as ``--device``; None leaves
    them on the card."""

    def __init__(self, cfg, cfg_path: str,
                 replicas: Optional[int] = None,
                 device: Optional[str] = None, logger=None):
        if replicas is not None:
            cfg = dataclasses.replace(cfg, serve_replicas=int(replicas))
        if cfg.serve_replicas < 2:
            raise ValueError(
                "FleetSupervisor needs serve_replicas >= 2 (one replica "
                "is `python -m fast_tffm_tpu_torch serve`)")
        if device not in (None, "cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.cfg = cfg
        self._logger = logger or get_logger(log_file=cfg.log_file or None)
        log_ignored_keys(cfg, self._logger)
        # The supervisor's stream (None: metrics off, a bare registry).
        self._tel = make_telemetry(cfg, "fleet", device=device)
        self._reg = (self._tel.registry if self._tel is not None
                     else MetricsRegistry())
        canary_on = cfg.serve_canary_fraction > 0 or cfg.serve_canary_shadow
        n = cfg.serve_replicas
        self.replicas: List[ReplicaProc] = [
            ReplicaProc(i, cfg, cfg_path,
                        canary=(canary_on and i == n - 1), device=device,
                        logger=self._logger)
            for i in range(n)]
        self.view = FleetView([r.row for r in self.replicas])
        self.proxy = ScoreProxy(
            self.view, retry_budget=cfg.serve_retry_budget,
            affinity_header=cfg.serve_affinity_header,
            canary_fraction=cfg.serve_canary_fraction,
            canary_shadow=cfg.serve_canary_shadow,
            max_inflight=cfg.serve_proxy_max_inflight,
            registry=self._reg, logger=self._logger)
        self.proxy_port: Optional[int] = None
        self.directory = os.path.abspath(cfg.model_file) + ".ckpt"
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._polls = 0
        self._last_ready = -1
        # An outgoing connection (the proxy's, a probe's) can take a port
        # of this range as its own; its TIME_WAIT then holds the port
        # for a minute, and a dead replica's restart cannot bind it.
        lo, hi = ephemeral_port_range()
        inside = [p for p in [r.port for r in self.replicas]
                  + [cfg.serve_proxy_port] if lo <= p <= hi]
        if inside:
            self._logger.warning(
                "fleet: ports %s lie in the host's ephemeral port range "
                "%d-%d: a replica restarted there can fail to bind its "
                "port for up to a minute (TIME_WAIT of an outgoing "
                "connection); pick serve_port and serve_proxy_port below "
                "%d", inside, lo, hi, lo)
        self._reg.set("fleet/replicas", float(n))
        self._reg.set("fleet/ready", 0.0)
        self._reg.set("fleet/alive", 0.0)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        try:
            for r in self.replicas:
                r.spawn()
            self.proxy_port = self.proxy.start(self.cfg.serve_proxy_port,
                                               host=self.cfg.serve_host)
        except BaseException:
            self._drain_children()
            raise
        self._logger.info(
            "fleet: %d replicas on ports %d..%d, proxy on http://%s:%d",
            len(self.replicas), self.replicas[0].port,
            self.replicas[-1].port, self.cfg.serve_host, self.proxy_port)
        for name, fn in (("fmt-fleet-health", self._health_loop),
                         ("fmt-fleet-reload", self._reload_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def wait_ready(self, k: int = 1, timeout: float = 120.0) -> bool:
        """Block until at least k replicas are ready."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if sum(1 for r in self.replicas if r.row.is_ready()) >= k:
                return True
            if self._stop.is_set():
                return False
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        """Drain the whole fleet: watch threads and proxy down, every
        child SIGTERMed (each drains its own queue) and reaped.
        Idempotent."""
        if self._stop.is_set():
            return
        self._stop.set()
        for t in self._threads:
            t.join()
        self.proxy.shutdown()
        self._drain_children()
        if self._tel is not None:
            try:
                self._tel.close(step=self._polls)
            except Exception:  # noqa: BLE001 - the drain is done
                self._logger.exception("metrics sink close failed")
        self._logger.info("fleet: drained %d replicas; supervisor down",
                          len(self.replicas))

    def _drain_children(self) -> None:
        for r in self.replicas:
            r.terminate()
        for r in self.replicas:
            r.reap()

    def pids(self) -> List[Optional[int]]:
        return [r.pid() for r in self.replicas]

    def flush_metrics(self) -> None:
        """A metrics event now (no-op without a stream)."""
        if self._tel is not None:
            self._tel.barrier_flush(self._polls)

    def stats(self) -> dict:
        """The fleet's counters and gauges (``fleet/*``, ``proxy/*``)
        by name."""
        snap = self._reg.snapshot()
        return {**snap["gauges"], **snap["counters"]}

    # -- health loop -----------------------------------------------------

    def _poll_replica(self, r: ReplicaProc) -> None:
        i = r.index
        if not r.exited():
            h = r.probe(timeout=max(0.5,
                                    self.cfg.serve_health_poll_seconds))
            if h is not None:
                r.probe_failures = 0
                r.last_answer = r._clock()
                ready = bool(h.get("ready"))
                if ready:
                    r.policy.record_healthy()
                step = int(h.get("served_step", -1))
                depth = int(h.get("queue_depth", 0))
                r.row.set_health(True, ready, served_step=step,
                                 queue_depth=depth)
                self._reg.set(f"fleet/replica{i}_step", float(step))
                self._reg.set(f"fleet/replica{i}_queue_depth",
                              float(depth))
                return
            r.probe_failures += 1
            r.row.set_health(False, False)
            silence = r._clock() - r.last_answer
            if silence < _WEDGED_SILENCE_SECONDS:
                return
            self._logger.warning(
                "fleet: replica %d silent for %.0fs (%d failed probes); "
                "killing it", i, silence, r.probe_failures)
            r.kill()
            r.reap(timeout=5.0)
            self._reg.count("fleet/wedged_kills")
        # The process has exited: count its death once, then respawn
        # when the backoff allows.
        r.row.set_health(False, False)
        if r.proc is not None and not r.death_counted:
            r.death_counted = True
            delay = r.policy.record_death()
            self._reg.count("fleet/deaths")
            self._logger.warning(
                "fleet: replica %d (pid %s) exited rc=%s; restart in "
                "%.1fs (failure #%d)", i, r.proc.pid, r.proc.returncode,
                delay, r.policy.failures)
        if r.policy.can_restart():
            r.spawn()
            self._reg.count("fleet/restarts")

    def _health_loop(self) -> None:
        poll = self.cfg.serve_health_poll_seconds
        while not self._stop.wait(poll):
            for r in self.replicas:
                try:
                    self._poll_replica(r)
                except Exception:  # noqa: BLE001 - one replica's bad
                    # poll must not starve the others of supervision
                    self._logger.exception(
                        "fleet: health poll of replica %d failed", r.index)
            alive, ready, total, rows = self.view.counts()
            for row in rows:
                i = row["index"]
                self._reg.set(f"fleet/replica{i}_alive",
                              1.0 if row["alive"] else 0.0)
                self._reg.set(f"fleet/replica{i}_ready",
                              1.0 if row["ready"] else 0.0)
            self._reg.set("fleet/alive", float(alive))
            self._reg.set("fleet/ready", float(ready))
            self._polls += 1
            if self._tel is not None:
                self._tel.heartbeat()
            if ready != self._last_ready:
                if self._last_ready >= 0:
                    self._logger.info("fleet: ready count %d -> %d (of %d)",
                                      self._last_ready, ready, total)
                self._last_ready = ready
                # On every edge of the ready count, so a snapshot taken
                # mid-incident sees the gap.
                self.flush_metrics()

    # -- reload loop (staggered) ----------------------------------------

    def _reload_loop(self) -> None:
        poll = self.cfg.serve_poll_seconds
        while not self._stop.wait(poll):
            try:
                # Staleness is judged against what the replicas serve
                # (their last health rows), not a remembered pointer: a
                # restarted replica loads the pointer itself, and a
                # publish racing startup is never lost. A token handed
                # to a current replica is a no-op there.
                step = read_published(self.directory)
                if step is not None:
                    stale = [r for r in self.replicas
                             if not r.canary and r.row.row()["alive"]
                             and r.row.row()["served_step"] != step]
                    if stale:
                        self._stagger(step)
                canary = next((r for r in self.replicas if r.canary),
                              None)
                if canary is not None:
                    cstep = read_pointer(self.directory, "canary")
                    row = canary.row.row()
                    if (cstep is not None and row["alive"]
                            and row["served_step"] != cstep):
                        self._logger.info(
                            "fleet: canary pointer -> step %d; reloading "
                            "the canary replica", cstep)
                        ok = canary.reload(cstep)
                        self._reg.count("fleet/canary_reloads" if ok else
                                        "fleet/canary_reload_failures")
            except Exception:  # noqa: BLE001 - a torn tick heals on
                # the next poll, as in the replica's own watcher
                self._logger.exception(
                    "fleet: reload poll failed; retrying next tick")

    def _stagger(self, step: int) -> None:
        primaries = [r for r in self.replicas if not r.canary]
        self._logger.info(
            "fleet: published pointer -> step %d; staggered reload across "
            "%d replicas", step, len(primaries))

        def _after(_h, ok):
            self._reg.count("fleet/reloads" if ok
                            else "fleet/reload_failures")
            self.flush_metrics()

        staggered_reload(primaries, step, reloaded=_after,
                         logger=self._logger)


def run_fleet(cfg, cfg_path: str, replicas: Optional[int] = None,
              device: Optional[str] = None) -> int:
    """The ``serve --replicas N`` entry point: supervise until SIGTERM or
    SIGINT, then drain the fleet; returns 0."""
    logger = get_logger(log_file=cfg.log_file or None)
    stop = threading.Event()

    def _on_signal(signum, _frame):
        logger.info("fleet: received signal %d; draining", signum)
        stop.set()

    prev = {s: signal.signal(s, _on_signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    sup = None
    try:
        sup = FleetSupervisor(cfg, cfg_path, replicas=replicas,
                              device=device, logger=logger).start()
        stop.wait()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        if sup is not None:
            sup.stop()
    return 0
