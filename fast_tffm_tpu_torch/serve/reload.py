"""Hot-reload watcher — the port's counterpart of
``fast_tffm_tpu/serve/reload.py``: poll the ``published`` pointer, swap
the table (under ``vocab_mode = admit``, the table with its slot map).

The pointer file in ``<model_file>.ckpt/`` is the train-to-serve
contract: ``fmckpt publish`` only repoints it at a manifest-verified
step, atomically. This thread re-reads it every ``serve_poll_seconds``
(times a seeded jitter of ``serve_poll_jitter``, so a fleet never polls
in lockstep), and when it names a step other than the one being served,
hands the step to ``ScorerServer.reload_step``: a verified restore of
that explicit step, then an atomic swap. Under ``vocab_mode = admit``
the swap is the (table, slot map, step) triple: the step's vocab
sidecar loads, crc-checked, before the table, so a reload never pairs a
new table with an old map. Requests in flight keep the triple their
flush captured.

Under ``serve_reload_mode = external`` (a fleet replica) the watcher
still polls, so ``/healthz``'s published step stays fresh, but never
reloads: the fleet supervisor's stagger protocol owns reloads and hands
each replica its turn through ``POST /reload``
(``ScorerServer.external_reload``), so the fleet never cold-stops
together.

Failure posture: a garbled or unreadable pointer reads as "nothing new"
and heals on the next poll; a step that fails verification or restore
(or, in admit mode, carries no readable vocab sidecar) counts a
``serve/reload_failures`` and the previous triple keeps serving. Every
tick beats the server's watchdog (an idle server is not stalled) and,
where the card reports a capacity, sets ``serve/reload_headroom_bytes``
(capacity less the ledger's live bytes).
"""

from __future__ import annotations

import random
import threading

from fast_tffm_tpu_torch.checkpoint import read_pointer
from fast_tffm_tpu_torch.obs.memory import LEDGER, device_capacity_bytes


class ReloadWatcher:
    """Daemon poll thread (``fmt-serve-reload``). ``poll_once`` is the
    whole per-tick protocol and ``next_wait`` the jittered cadence,
    both public so tests drive them without the thread.
    ``auto_reload=False`` is the external-coordinator mode: ticks only
    observe the pointer."""

    def __init__(self, server, poll_seconds: float,
                 jitter: float = 0.0, seed: int = 0,
                 auto_reload: bool = True):
        self._server = server
        self._poll = float(poll_seconds)
        self._jitter = max(0.0, min(float(jitter), 0.999))
        # Deterministic per-replica stream: the same replica jitters
        # the same way run to run, different ports decorrelate.
        self._rng = random.Random(int(seed) * 2654435761 + 1)
        self._auto = bool(auto_reload)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="fmt-serve-reload",
                                        daemon=True)

    def start(self) -> "ReloadWatcher":
        self._thread.start()
        return self

    def next_wait(self) -> float:
        """One tick's wait: poll * (1 ± U(0, jitter)); the mean cadence
        stays serve_poll_seconds."""
        if not self._jitter:
            return self._poll
        return self._poll * (1.0 + self._rng.uniform(-self._jitter,
                                                     self._jitter))

    def _run(self) -> None:
        while not self._stop.wait(self.next_wait()):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the poll loop must
                # survive anything: a transient filesystem error on one
                # tick is the next tick's clean read. Reload failures
                # are counted inside reload_step.
                self._server._logger.exception(
                    "published-pointer poll failed; retrying next tick")

    def poll_once(self) -> bool:
        """One tick: read the pointer, record what it says, reload when
        it moved, unless an external coordinator owns reloads. Returns
        True when a reload was attempted."""
        self._server.idle_beat()
        cap = device_capacity_bytes()
        if cap:
            self._server._reg.set("serve/reload_headroom_bytes",
                                  float(cap - LEDGER.live_bytes()))
        step = read_pointer(self._server.directory,
                            self._server.cfg.serve_pointer)
        if step is None:
            return False
        self._server.note_published(step)
        if not self._auto or step == self._server.served_step:
            return False
        self._server.reload_step(step)
        return True

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
