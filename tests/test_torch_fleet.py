"""The port's serving fleet (fast_tffm_tpu_torch/serve/fleet.py,
proxy.py, replica.py) against the JAX package's, on the CPU.

- Units, case for case against ``fast_tffm_tpu/serve``:
  ``rendezvous_choose`` over 1,000 seeded keys and every subset of 4
  replicas; ``FractionSplitter.take()`` sequences; ``RestartPolicy``
  under an injected clock; ``staggered_reload`` over fake handles (the
  calls, their order and the return); both ``ScoreProxy``s against the
  same HTTP stubs (failover on a refused connection and on a 5xx, the
  503 with ``Retry-After``, a 4xx passed through, shedding, the
  aggregated ``/healthz``, affinity, canary fraction and fallback):
  the same status codes, bodies, headers and counters.
- The deaths count: a probe that fails just before the process exits.
  The port counts the death once; the JAX ``_poll_replica`` counts
  none (ROADMAP.md §C, deliberate differences).
- End to end: a 2-replica ``FleetSupervisor`` on the CPU over two
  checkpoint steps of a small model (2^10 rows, k = 4): a replica
  SIGKILLed mid-burst (zero client failures, a respawn, 2 ready again)
  and a staggered reload under load (every proxy ``/healthz`` sample
  ready >= 1); every body equal to the port's batch predict of its
  ``X-FM-Step`` byte for byte, and those lines equal to the JAX
  package's scores of the same tables (kernel = pallas in interpret
  mode) at rtol 1e-5 / atol 1e-6. ``python -m fast_tffm_tpu_torch serve
  <cfg> --device cpu --replicas 2`` drains on SIGTERM and exits 0.
- A config naming a fleet (``serve_replicas = 3``) trains and predicts
  as the JAX package's does.
"""

import dataclasses
import http.client
import http.server
import itertools
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.metrics import sigmoid as jax_sigmoid
from fast_tffm_tpu.predict import predict_scores as jax_predict_scores
from fast_tffm_tpu.serve import fleet as jax_fleet
from fast_tffm_tpu.serve import proxy as jax_proxy
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.checkpoint import read_published
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.predict import load_table, predict
from fast_tffm_tpu_torch.serve import fleet as port_fleet
from fast_tffm_tpu_torch.serve import proxy as port_proxy
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.train import train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_proxy, jax_fleet), "port": (port_proxy, port_fleet)}
VOCAB = 1 << 10
FACTORS = 4
MAX_BATCH = 16
STEPS = (10, 20)
# Every wait in this file has a deadline; a fleet start on a loaded host
# (two replica processes importing torch) takes seconds.
DEADLINE = 120.0


def _wait(cond, what, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# --- rendezvous, splitter, restart policy, stagger ----------------------


SUBSETS = [s for n in range(1, 5) for s in itertools.combinations(range(4), n)]


@pytest.mark.parametrize("subset", SUBSETS,
                         ids=["-".join(map(str, s)) for s in SUBSETS])
def test_rendezvous_choose_matches_jax(subset):
    rng = np.random.default_rng(17)
    keys = [f"user-{int(k)}" for k in rng.integers(0, 1 << 40, 1000)]
    picks = {}
    for name, (proxy, _) in PACKAGES.items():
        replicas = [proxy.Replica(i, "127.0.0.1", 9000 + i) for i in subset]
        picks[name] = [proxy.rendezvous_choose(k, replicas).index
                       for k in keys]
    assert picks["port"] == picks["jax"]
    assert set(picks["port"]) <= set(subset)


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 1 / 3, 1.0])
def test_fraction_splitter_matches_jax(fraction):
    seqs = {name: [s.take() for _ in range(1000)]
            for name, s in ((n, p.FractionSplitter(fraction))
                            for n, (p, _) in PACKAGES.items())}
    assert seqs["port"] == seqs["jax"]
    assert sum(seqs["port"]) == int(1000 * fraction)


def _policy_trace(fleet, base, cap):
    clock = [0.0]
    p = fleet.RestartPolicy(base, cap_factor=cap, clock=lambda: clock[0])
    out = [p.can_restart()]
    for t in range(8):
        out.append(p.record_death())
        out.append(p.failures)
        for dt in (0.0, base * 0.99, base * 3, base * 40):
            clock[0] += dt
            out.append(p.can_restart())
        if t == 4:
            p.record_healthy()
            out.append((p.failures, p.can_restart()))
    return out


@pytest.mark.parametrize("base,cap", [(1.0, 16.0), (0.25, 4.0), (2.0, 1.0)])
def test_restart_policy_matches_jax(base, cap):
    port = _policy_trace(port_fleet, base, cap)
    assert port == _policy_trace(jax_fleet, base, cap)
    if (base, cap) == (1.0, 16.0):
        assert port[1:29:6] == [1.0, 2.0, 4.0, 8.0, 16.0]


class _FakeHandle:
    """A replica's reload surface (ReplicaProc's ``is_ready`` and
    ``reload``); every call lands in the fleet's shared log."""

    def __init__(self, name, fleet, fail=False, ready_after_polls=2):
        self.name, self.fleet, self.fail = name, fleet, fail
        self.ready = True
        self.step = 0
        self._polls_left = 0
        self._ready_after = ready_after_polls

    def is_ready(self):
        if not self.ready and self._polls_left > 0:
            self._polls_left -= 1
            if self._polls_left == 0:
                self.ready = True
        self.fleet.log.append(("is_ready", self.name, self.ready))
        return self.ready

    def reload(self, step):
        others = sum(1 for h in self.fleet if h is not self and h.ready)
        self.fleet.log.append(("reload", self.name, step, others))
        if self.fail:
            return False
        self.ready = False
        self._polls_left = self._ready_after
        self.step = step
        return True


class _Fleet(list):
    def __init__(self):
        super().__init__()
        self.log = []


def _stagger_case(fleet_mod, case):
    fleet = _Fleet()
    clock = [0.0]

    def tick(s):
        fleet.log.append(("sleep", s))
        clock[0] += 1.0

    kw = dict(sleep=tick, clock=lambda: clock[0])
    if case == "one-other-ready":
        fleet.extend(_FakeHandle(f"r{i}", fleet) for i in range(4))
        done = fleet_mod.staggered_reload(fleet, step=11, **kw)
    elif case == "failure-continues":
        fleet.extend([_FakeHandle("r0", fleet),
                      _FakeHandle("r1", fleet, fail=True),
                      _FakeHandle("r2", fleet)])
        done = fleet_mod.staggered_reload(
            fleet, step=5, reloaded=lambda h, ok: fleet.log.append(
                ("reloaded", h.name, ok)), **kw)
    elif case == "stalled-reloads-anyway":
        fleet.extend([_FakeHandle("r0", fleet), _FakeHandle("r1", fleet)])
        fleet[1].ready = False
        done = fleet_mod.staggered_reload(fleet, step=3, wait_seconds=5.0,
                                          **kw)
    else:  # slow-comeback: a handle that takes many polls to be ready
        fleet.extend(_FakeHandle(f"r{i}", fleet, ready_after_polls=7)
                     for i in range(3))
        done = fleet_mod.staggered_reload(fleet, step=9, wait_seconds=4.0,
                                          **kw)
    return done, fleet.log, [(h.step, h.ready) for h in fleet]


@pytest.mark.parametrize("case", ["one-other-ready", "failure-continues",
                                  "stalled-reloads-anyway", "slow-comeback"])
def test_staggered_reload_matches_jax(case):
    port = _stagger_case(port_fleet, case)
    assert port == _stagger_case(jax_fleet, case)
    done, log, states = port
    if case == "one-other-ready":
        assert done == 4 and states == [(11, True)] * 4
        # The invariant: at every reload >= 1 other handle ready.
        assert min(e[3] for e in log if e[0] == "reload") >= 1
    if case == "failure-continues":
        assert done == 2 and states[1] == (0, True)
        assert [e for e in log if e[0] == "reloaded"] == [
            ("reloaded", "r0", True), ("reloaded", "r1", False),
            ("reloaded", "r2", True)]
    if case == "stalled-reloads-anyway":
        assert states[0][0] == 3 and states[1][0] == 3


# --- both proxies against the same stubs ---------------------------------


class _StubHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):  # noqa: N802 - http.server contract
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        srv = self.server
        srv.hits += 1
        self.send_response(srv.status)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(srv.body)))
        if srv.step is not None:
            self.send_header("X-FM-Step", str(srv.step))
        self.end_headers()
        self.wfile.write(srv.body)

    def log_message(self, fmt, *args):  # noqa: A003 - silence
        pass


class _Stub(http.server.ThreadingHTTPServer):
    """One fake replica: a scripted status, body and step."""

    daemon_threads = True

    def __init__(self, status=200, body=b"0.500000\n", step=7):
        self.status, self.body, self.step = status, body, step
        self.hits = 0
        super().__init__(("127.0.0.1", 0), _StubHandler)
        self.thread = threading.Thread(target=self.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def port(self):
        return self.server_address[1]

    def close(self):
        self.shutdown()
        self.thread.join(timeout=30)
        self.server_close()


def _dead_port():
    """A loopback port nothing listens on (bound, then released)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ready(proxy, index, port, canary=False):
    r = proxy.Replica(index, "127.0.0.1", port, canary=canary)
    r.set_health(alive=True, ready=True, served_step=7)
    return r


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "text/plain"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


def _counters(proxy):
    return proxy.registry.snapshot()["counters"]


def _key_on(proxy_mod, target, replicas):
    return next(k for k in (f"k{i}" for i in range(256))
                if proxy_mod.rendezvous_choose(k, replicas) is target)


class _StubPool:
    """The stubs of one case, shared by both packages' runs (affinity
    hashes the replica's address), their hits counted per run."""

    def __init__(self):
        self._stubs = {}

    def get(self, name, **kw):
        if name not in self._stubs:
            self._stubs[name] = _Stub(**kw)
        return self._stubs[name]

    def reset_hits(self):
        for s in self._stubs.values():
            s.hits = 0

    def close(self):
        for s in self._stubs.values():
            s.close()


def _proxy_case(pm, case, pool):
    """One scripted proxy case; returns what a client and the counters
    see."""
    pool.reset_hits()
    stub = pool.get
    if case == "failover-refused":
        good = stub("good")
        bad, ok = _ready(pm, 0, _dead_port()), _ready(pm, 1, good.port)
        proxy = pm.ScoreProxy(pm.FleetView([bad, ok]), retry_budget=2,
                              backoff_seconds=0.0)
        out = proxy.forward_score(b"1 0:1.0\n",
                                  _key_on(pm, bad, [bad, ok]))
        return out, _counters(proxy), bad.is_ready(), good.hits
    if case == "failover-5xx":
        sick = stub("sick", status=500, body=b"boom\n", step=None)
        good = stub("good")
        r0, r1 = _ready(pm, 0, sick.port), _ready(pm, 1, good.port)
        proxy = pm.ScoreProxy(pm.FleetView([r0, r1]), retry_budget=2,
                              backoff_seconds=0.0)
        out = proxy.forward_score(b"1 0:1.0\n", _key_on(pm, r0, [r0, r1]))
        return out, _counters(proxy), r0.is_ready(), sick.hits, good.hits
    if case == "budget-spent-503":
        reps = [_ready(pm, i, _dead_port()) for i in range(3)]
        proxy = pm.ScoreProxy(pm.FleetView(reps), retry_budget=2,
                              backoff_seconds=0.0)
        (code, body, extra) = proxy.forward_score(b"1 0:1.0\n", None)
        # The body names the last replica tried; its port is random.
        return (code, body.startswith(b"no replica could score"),
                extra, _counters(proxy))
    if case == "4xx-passes":
        bad_req = stub("bad", status=400, body=b"parse error\n",
                       step=None)
        proxy = pm.ScoreProxy(pm.FleetView([_ready(pm, 0, bad_req.port)]),
                              retry_budget=3, backoff_seconds=0.0)
        out = proxy.forward_score(b"garbage\n", None)
        return out, _counters(proxy), bad_req.hits
    if case == "shed":
        good = stub("good")
        proxy = pm.ScoreProxy(pm.FleetView([_ready(pm, 0, good.port)]),
                              max_inflight=1)
        port = proxy.start(0)
        try:
            assert proxy.inflight.acquire(blocking=False)
            shed = _http(port, "POST", "/score", b"1 0:1.0\n")
            proxy.inflight.release()
            served = _http(port, "POST", "/score", b"1 0:1.0\n")
        finally:
            proxy.shutdown()
        return shed, served, _counters(proxy), good.hits
    if case == "healthz":
        r0 = _ready(pm, 0, 1)
        r1 = pm.Replica(1, "127.0.0.1", 2)
        r1.set_health(alive=True, ready=False)
        proxy = pm.ScoreProxy(pm.FleetView([r0, r1]))
        port = proxy.start(0)
        try:
            seen = [_http(port, "GET", "/healthz")]
            r0.mark_failed()
            seen.append(_http(port, "GET", "/healthz"))
        finally:
            proxy.shutdown()
        return [(code, json.loads(body)) for code, body, _ in seen]
    if case == "affinity":
        a, b = stub("a", step=3), stub("b", step=4)
        reps = [_ready(pm, 0, a.port), _ready(pm, 1, b.port)]
        proxy = pm.ScoreProxy(pm.FleetView(reps), retry_budget=0)
        outs = [proxy.forward_score(b"1 0:1.0\n", key)
                for key in ("user-42", "user-7", "user-42", "user-9")
                for _ in range(3)]
        return outs, _counters(proxy), a.hits, b.hits
    if case == "canary-fraction":
        prim = [_ready(pm, i, 9100 + i) for i in range(2)]
        canary = _ready(pm, 2, 9200, canary=True)
        proxy = pm.ScoreProxy(pm.FleetView(prim + [canary]),
                              canary_fraction=0.25)
        picks = [proxy.pick(None).index for _ in range(200)]
        return picks, _counters(proxy)
    # canary-fallback: fraction 0 never routes to the canary until
    # every primary is down.
    prim = [_ready(pm, i, 9100 + i) for i in range(2)]
    canary = _ready(pm, 2, 9200, canary=True)
    proxy = pm.ScoreProxy(pm.FleetView(prim + [canary]))
    picks = [proxy.pick(None).index for _ in range(50)]
    for r in prim:
        r.mark_failed()
    return picks, proxy.pick(None).index, _counters(proxy)


PROXY_CASES = ["failover-refused", "failover-5xx", "budget-spent-503",
               "4xx-passes", "shed", "healthz", "affinity",
               "canary-fraction", "canary-fallback"]


@pytest.mark.parametrize("case", PROXY_CASES)
def test_proxy_matches_jax(case):
    pool = _StubPool()
    try:
        port = _proxy_case(port_proxy, case, pool)
        assert port == _proxy_case(jax_proxy, case, pool)
    finally:
        pool.close()
    if case == "failover-refused":
        (code, body, extra), counters, bad_ready, _ = port
        assert (code, body, extra) == (200, b"0.500000\n",
                                       {"X-FM-Replica": "1",
                                        "X-FM-Step": "7"})
        assert counters["proxy/transport_errors"] == 1
        assert counters["proxy/retries"] == 1 and not bad_ready
    if case == "failover-5xx":
        (code, _, _), counters, sick_ready, sick_hits, good_hits = port
        assert code == 200 and counters["proxy/upstream_5xx"] == 1
        assert not sick_ready and sick_hits == good_hits == 1
    if case == "budget-spent-503":
        code, named, extra, counters = port
        assert code == 503 and named and extra == {"Retry-After": "1"}
        assert counters["proxy/transport_errors"] == 3
        assert counters["proxy/unrouted_503"] == 1
    if case == "4xx-passes":
        (code, body, _), counters, hits = port
        assert (code, body, hits) == (400, b"parse error\n", 1)
        assert "proxy/retries" not in counters
    if case == "shed":
        shed, served, counters, _ = port
        assert shed[0] == 503 and shed[2] == "1"
        assert b"max in-flight" in shed[1]
        assert served[:2] == (200, b"0.500000\n")
        assert counters["proxy/shed_503"] == 1
    if case == "healthz":
        (c0, p0), (c1, p1) = port
        assert c0 == 200 and (p0["replicas"], p0["alive"], p0["ready"]) \
            == (2, 2, 1)
        assert c1 == 503 and p1["status"] == "degraded"
    if case == "affinity":
        outs = port[0]
        for key_outs in (outs[0:3] + outs[6:9], outs[3:6], outs[9:12]):
            assert len({o[2]["X-FM-Replica"] for o in key_outs}) == 1
    if case == "canary-fraction":
        picks, counters = port
        assert picks.count(2) == 50 and counters["proxy/canary_requests"] == 50
    if case == "canary-fallback":
        picks, last, _ = port
        assert 2 not in picks and last == 2


# --- the deaths count ----------------------------------------------------


def _fleet_cfg_text(wd, base_port, proxy_port, replicas=2, backoff=0.2):
    return f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = False
factor_num = {FACTORS}
model_file = {os.path.join(wd, "fm_model")}
log_file = {os.path.join(wd, "fm.log")}

[Train]
train_files = {os.path.join(REPO, "data", "sample_train.txt")}
batch_size = 64

[Predict]
predict_files = {os.path.join(wd, "lines.txt")}
score_path = {os.path.join(wd, "score")}

[Serve]
serve_port = {base_port}
serve_proxy_port = {proxy_port}
serve_replicas = {replicas}
serve_max_batch = {MAX_BATCH}
serve_max_wait_ms = 2
serve_poll_seconds = 0.2
serve_health_poll_seconds = 0.1
serve_restart_backoff_seconds = {backoff}
"""


def _deaths_case(name, tmp_path):
    _, fleet_mod = PACKAGES[name]
    path = tmp_path / f"{name}.cfg"
    path.write_text(_fleet_cfg_text(str(tmp_path), 19000, 19010,
                                    backoff=0.01))
    cfg = (jax_load_config if name == "jax" else load_config)(str(path))
    sup = fleet_mod.FleetSupervisor(cfg, str(path))
    r = sup.replicas[0]
    spawns = []
    r.spawn = lambda: spawns.append(time.monotonic())
    r.probe = lambda timeout=1.0: None
    r.proc = subprocess.Popen([sys.executable, "-c",
                               "import sys; sys.stdin.read()"],
                              stdin=subprocess.PIPE)
    try:
        sup._poll_replica(r)        # alive; the probe fails
        r.proc.stdin.close()        # ... and then the process exits
        r.proc.wait(timeout=60)
        sup._poll_replica(r)        # its exit is observed
        time.sleep(0.05)            # past the 0.01 s backoff
        sup._poll_replica(r)
        sup._poll_replica(r)
    finally:
        if r.proc.poll() is None:
            r.proc.kill()
        r.proc.wait(timeout=60)
    c = sup._reg.snapshot()["counters"]
    return int(c.get("fleet/deaths", 0)), len(spawns) >= 1


def test_a_death_after_a_failed_probe_counts_once(tmp_path):
    # The port counts the death exactly once and respawns.
    assert _deaths_case("port", tmp_path) == (1, True)
    # The JAX package respawns too but loses the death: its
    # _poll_replica counts one only when no probe failed before it.
    assert _deaths_case("jax", tmp_path) == (0, True)


@pytest.mark.parametrize("base,proxy,warned", [
    (19000, 19010, []), (40000, 19010, [40000, 40001]),
    (19000, 45000, [45000])])
def test_supervisor_warns_on_ephemeral_ports(tmp_path, base, proxy, warned):
    """A replica port inside the host's ephemeral range can be held by an
    outgoing connection's TIME_WAIT while a killed replica restarts (the
    respawn then fails to bind for up to a minute): the supervisor says
    so. (Linux's default range, 32768-60999, holds these ports.)"""
    import logging
    path = tmp_path / "w.cfg"
    path.write_text(_fleet_cfg_text(str(tmp_path), base, proxy))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("fast_tffm_tpu_torch")
    logger.addHandler(handler)
    try:
        port_fleet.FleetSupervisor(load_config(str(path)), str(path))
    finally:
        logger.removeHandler(handler)
    msgs = [r.getMessage() for r in records if "ephemeral" in r.getMessage()]
    lo, hi = port_fleet.ephemeral_port_range()
    want = [p for p in (base, base + 1, proxy) if lo <= p <= hi]
    assert len(msgs) == (1 if want else 0)
    if (lo, hi) == (32768, 60999):
        assert want == warned
    if want:
        assert str(want) in msgs[0]


# --- end to end: a fleet on the CPU -------------------------------------


def _free_port_block(n):
    """A base port with ``n`` free ports from it (bound, then released),
    below the ephemeral range (``FleetSupervisor`` warns inside it)."""
    rng = np.random.default_rng(os.getpid())
    top = min(port_fleet.ephemeral_port_range()[0], 32768)
    for _ in range(200):
        base = int(rng.integers(10000, top - n))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no block of free ports")


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 13))
        ids = np.sort(rng.choice(VOCAB, size=k, replace=False))
        vals = rng.uniform(0.1, 2.0, size=k)
        out.append(f"{int(rng.integers(0, 2))} " + " ".join(
            f"{i}:{v:.3f}" for i, v in zip(ids, vals)))
    return out


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """Two published-able steps of a small model, each step's predict
    lines from the port, and the JAX package's scores of the tables."""
    wd = str(tmp_path_factory.mktemp("torch_fleet"))
    lines = _lines(300, 41)
    with open(os.path.join(wd, "lines.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    base = _free_port_block(3)
    cfg_path = os.path.join(wd, "fleet.cfg")
    with open(cfg_path, "w") as fh:
        fh.write(_fleet_cfg_text(wd, base, base + 2))
    cfg = load_config(cfg_path)
    jcfg = dataclasses.replace(jax_load_config(cfg_path), kernel="pallas",
                               dedup="device")
    expected, jax_scores = {}, {}
    for k, step in enumerate(STEPS):
        rng = np.random.default_rng(100 + k)
        table = (rng.normal(size=(cfg.num_rows, cfg.row_dim)) * 0.3
                 ).astype(np.float32)
        table[-1] = 0.0
        save_checkpoint_from_numpy(cfg, table, None, step)
        step_cfg = dataclasses.replace(
            cfg, score_path=os.path.join(wd, f"score{step}"))
        predict(step_cfg, table=load_table(cfg, "cpu", step=step),
                device="cpu")
        with open(os.path.join(step_cfg.score_path, "lines.txt.score")) as fh:
            expected[step] = fh.read().splitlines(keepends=True)
        jax_scores[step] = jax_sigmoid(jax_predict_scores(
            jcfg, jnp.asarray(table), [os.path.join(wd, "lines.txt")]))
    assert fmckpt.main(["publish", cfg.model_file, str(STEPS[0])]) == 0
    return dict(wd=wd, cfg=cfg, cfg_path=cfg_path, lines=lines,
                expected=expected, jax_scores=jax_scores)


def test_step_lines_match_jax_scores(model):
    for step in STEPS:
        got = np.array([float(s) for s in model["expected"][step]])
        assert got.shape == model["jax_scores"][step].shape == (300,)
        np.testing.assert_allclose(got, model["jax_scores"][step],
                                   rtol=1e-5, atol=1e-6)
    assert model["expected"][STEPS[0]] != model["expected"][STEPS[1]]


@pytest.fixture(scope="module")
def fleet(model):
    sup = port_fleet.FleetSupervisor(model["cfg"], model["cfg_path"],
                                     device="cpu")
    try:
        sup.start()
        assert sup.wait_ready(2, timeout=DEADLINE), _tails(model)
        yield sup
    finally:
        sup.stop()


def _tails(model):
    out = []
    for i in range(2):
        path = f"{model['cfg'].model_file}.replica{i}.log"
        if os.path.exists(path):
            with open(path, errors="replace") as fh:
                out.append(f"--- replica {i}\n" + fh.read()[-3000:])
    return "\n".join(out)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return (resp.status, resp.read(), resp.headers["X-FM-Step"],
                    resp.headers["X-FM-Replica"])
    except urllib.error.HTTPError as e:
        return e.code, e.read(), None, None


class _Burst:
    """Client threads posting blocks of 1-16 lines through the proxy
    until stopped; every response is kept."""

    def __init__(self, port, lines, n_clients, seed):
        self.results, self.failures = [], []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(
            target=self._run, args=(port, lines, seed + i),
            name=f"burst-{i}") for i in range(n_clients)]
        for t in self._threads:
            t.start()

    def _run(self, port, lines, seed):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            n = int(rng.integers(1, MAX_BATCH + 1))
            lo = int(rng.integers(0, len(lines) - n + 1))
            try:
                out = _post(port, "\n".join(lines[lo:lo + n]) + "\n")
            except OSError as e:
                with self._lock:
                    self.failures.append(repr(e))
                continue
            with self._lock:
                self.results.append((lo, n) + out)

    def count(self):
        with self._lock:
            return len(self.results)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive(), "a client thread hung"


def _check_bodies(model, results):
    by_step = {}
    for lo, n, status, body, step, replica in results:
        assert status == 200, (status, body[:200])
        assert replica in ("0", "1")
        want = "".join(model["expected"][int(step)][lo:lo + n]).encode()
        assert body == want, f"body for lines [{lo}, {lo + n}) at step {step}"
        by_step[int(step)] = by_step.get(int(step), 0) + 1
    return by_step


def test_fleet_absorbs_a_sigkill_mid_burst(model, fleet):
    names = {t.name for t in threading.enumerate()}
    assert {"fmt-fleet-health", "fmt-fleet-reload", "fmt-proxy-http"} <= names
    assert not [n for n in names if n.startswith("fm-")]
    burst = _Burst(fleet.proxy_port, model["lines"], 3, seed=7)
    try:
        _wait(lambda: burst.count() >= 20, "the burst to start")
        victim = fleet.replicas[1]
        old_pid = victim.pid()
        os.kill(old_pid, signal.SIGKILL)
        _wait(lambda: victim.pid() != old_pid, "the respawn")
        _wait(lambda: victim.row.is_ready() and fleet.wait_ready(2, 0.1),
              "2 ready replicas again")
        mark = burst.count()
        _wait(lambda: burst.count() >= mark + 20, "requests after recovery")
    finally:
        burst.stop()
    assert not burst.failures, burst.failures[:3]
    assert _check_bodies(model, burst.results) == {
        STEPS[0]: len(burst.results)}
    stats = fleet.stats()
    assert stats["fleet/deaths"] >= 1 and stats["fleet/restarts"] >= 1
    assert stats["proxy/requests"] >= len(burst.results)
    assert stats["fleet/replicas"] == 2


def test_fleet_staggered_reload_keeps_one_ready(model, fleet):
    samples = []
    stop_sampling = threading.Event()

    def sample():
        while not stop_sampling.is_set():
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", fleet.proxy_port, timeout=10)
                try:
                    conn.request("GET", "/healthz")
                    resp = conn.getresponse()
                    samples.append((resp.status,
                                    json.loads(resp.read())["ready"]))
                finally:
                    conn.close()
            except OSError as e:
                samples.append((repr(e), 0))
            time.sleep(0.005)

    sampler = threading.Thread(target=sample, name="healthz-sampler")
    sampler.start()
    burst = _Burst(fleet.proxy_port, model["lines"], 3, seed=70)
    new = STEPS[1]
    try:
        _wait(lambda: burst.count() >= 10, "requests before the publish")
        assert fmckpt.main(["publish", model["cfg"].model_file,
                            str(new)]) == 0

        def reloaded():
            rows = [r.probe() for r in fleet.replicas]
            return all(h and h["served_step"] == new and h["ready"]
                       for h in rows)

        _wait(reloaded, f"every replica serving step {new}")
        _wait(lambda: any(r[4] == str(new) for r in list(burst.results)),
              "a response on the new step")
    finally:
        burst.stop()
        stop_sampling.set()
        sampler.join(timeout=DEADLINE)
    assert samples and all(s == 200 and ready >= 1 for s, ready in samples), \
        [s for s in samples if s[0] != 200 or s[1] < 1][:5]
    assert not burst.failures, burst.failures[:3]
    assert set(_check_bodies(model, burst.results)) == set(STEPS)
    stats = fleet.stats()
    assert stats["fleet/reloads"] >= 2
    assert stats.get("fleet/reload_failures", 0) == 0
    for r in fleet.replicas:
        h = r.probe()
        assert h["device"] == "cpu" and h["kernel"] == "plain"
        assert h["flushes"] > 0 and h["reload_failures"] == 0


def test_fleet_stop_reaps_children_and_threads(fleet):
    pids = fleet.pids()
    fleet.stop()
    for r in fleet.replicas:
        assert r.exited()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    leaked = [t.name for t in threading.enumerate() if t.is_alive()
              and t.name.startswith(("fmt-fleet", "fmt-proxy"))]
    assert not leaked, leaked


def test_cli_fleet_drains_on_sigterm(model, tmp_path):
    base = _free_port_block(3)
    cfg_path = str(tmp_path / "cli.cfg")
    with open(cfg_path, "w") as fh:
        # The model's directory and lines, ports of its own, and one
        # replica in the file: --replicas 2 asks for the fleet.
        fh.write(_fleet_cfg_text(model["wd"], base, base + 2, replicas=1)
                 .replace("fm.log", "cli.log"))
    log_path = str(tmp_path / "cli.stderr")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fast_tffm_tpu_torch", "serve", cfg_path,
             "--device", "cpu", "--replicas", "2"], cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT)
    try:
        def fleet_ready():
            try:
                code, body, _ = _http(base + 2, "GET", "/healthz")
            except OSError:
                return False
            return code == 200 and json.loads(body)["ready"] == 2

        _wait(fleet_ready, "the CLI fleet to be ready")
        status, body, step, replica = _post(base + 2, model["lines"][0] + "\n")
        published = read_published(model["cfg"].model_file + ".ckpt")
        assert status == 200 and step == str(published)
        assert body == model["expected"][published][0].encode()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=DEADLINE) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    with open(log_path) as fh:
        text = fh.read()
    pids = [int(p) for p in re.findall(r"spawned \(pid (\d+),", text)]
    assert len(pids) == 2, text[-3000:]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert "fleet: drained 2 replicas" in text


# --- a fleet config trains and predicts ---------------------------------


_JAX_RUN = r'''
import runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.train as jax_train
cfg_path, table = sys.argv[1], np.load(sys.argv[2])
jax_train.init_table = lambda cfg, seed=0: jnp.asarray(table)
for mode in ("train", "predict"):
    sys.argv = ["run_tffm.py", mode, cfg_path]
    try:
        runpy.run_path(RUN_TFFM, run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
'''


def _sample_cfg(wd):
    with open(os.path.join(REPO, "sample.cfg")) as fh:
        text = fh.read()
    text = (text.replace("./model/fm_model", os.path.join(wd, "fm_model"))
            .replace("./log/fm.log", os.path.join(wd, "fm.log"))
            .replace("./score", os.path.join(wd, "score"))
            .replace("data/", os.path.join(REPO, "data") + "/")
            .replace("epoch_num = 5", "epoch_num = 2"))
    path = os.path.join(wd, "sample.cfg")
    with open(path, "w") as fh:
        fh.write(text + "\n[Serve]\nserve_replicas = 3\nserve_port = 7170\n")
    return path


def test_fleet_config_trains_and_predicts_as_jax(tmp_path):
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jwd)
    os.makedirs(pwd)
    jcfg_path, pcfg_path = _sample_cfg(jwd), _sample_cfg(pwd)
    cfg = load_config(pcfg_path)
    assert cfg.serve_replicas == 3
    rng = np.random.default_rng(29)
    table0 = rng.uniform(-cfg.init_value_range, cfg.init_value_range,
                         (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    table0[-1] = 0.0
    np.save(os.path.join(jwd, "table0.npy"), table0)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_RUN.replace("RUN_TFFM",
                              repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run(
        [sys.executable, "-c", script, jcfg_path,
         os.path.join(jwd, "table0.npy")], cwd=jwd, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    acc0 = np.full_like(table0, cfg.adagrad_init)
    train(cfg, device="cpu",
          init_state=convert.state_from_numpy(table0, acc0, cfg,
                                              torch.device("cpu")))
    assert main(["predict", pcfg_path, "--device", "cpu"]) == 0
    with np.load(os.path.join(jwd, "fm_model.npz")) as j, \
            np.load(os.path.join(pwd, "fm_model.npz")) as p:
        np.testing.assert_allclose(p["table"], j["table"], rtol=1e-4,
                                   atol=1e-6)
    scores = []
    for wd in (jwd, pwd):
        with open(os.path.join(wd, "score", "sample_test.txt.score")) as fh:
            scores.append(np.array([float(s) for s in fh.read().split()]))
    assert scores[0].shape == scores[1].shape == (500,)
    np.testing.assert_allclose(scores[1], scores[0], atol=1e-5)
