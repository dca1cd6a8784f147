"""Online serving for the port.

- ``server.py``   ScorerServer: the published step, the warmed shape
                  ladder, the micro-batching admission queue, hot reload
                  (by poll, or ``external_reload`` for a fleet replica).
- ``reload.py``   ReloadWatcher: polls the pointer, reloads or observes.
- ``frontend.py`` the HTTP front end (POST /score, POST /reload, GET
                  /healthz) and the single-process ``serve`` entry point.
- ``proxy.py``    the fleet's failover proxy (ScoreProxy, FleetView,
                  rendezvous affinity, the canary splitter).
- ``fleet.py``    FleetSupervisor: N replica processes, their restarts
                  and the staggered reload (``serve --replicas N``).
- ``replica.py``  a fleet replica's process entry point.
"""

from fast_tffm_tpu_torch.serve.fleet import (FleetSupervisor, RestartPolicy,
                                             run_fleet, staggered_reload)
from fast_tffm_tpu_torch.serve.proxy import (FleetView, FractionSplitter,
                                             Replica, ScoreProxy,
                                             rendezvous_choose)
from fast_tffm_tpu_torch.serve.server import ScoreResult, ScorerServer

__all__ = ["FleetSupervisor", "FleetView", "FractionSplitter", "Replica",
           "RestartPolicy", "ScoreProxy", "ScoreResult", "ScorerServer",
           "rendezvous_choose", "run_fleet", "staggered_reload"]
