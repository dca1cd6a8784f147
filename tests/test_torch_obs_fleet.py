"""The serving fleet's telemetry on the CPU: a 2-replica fleet of the port
(``FleetSupervisor`` with ``metrics_file``) writes the supervisor's
stream and one ``<metrics_file>.r<i>`` stream a replica; the proxy
answers ``GET /metrics`` in Prometheus text; across a replica's SIGKILL
the supervisor's flush on the ready count's edge leaves a snapshot that
the port's fmstat and the JAX package's read as ``FLEET DEGRADED (1/2
ready)`` with the same FLEET section, and once the replica is back and
the fleet drained, both read ``OK`` with the death counted once."""

import os
import shutil
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

from fast_tffm_tpu.obs import attribution as jax_attribution
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.obs import attribution
from fast_tffm_tpu_torch.obs.sink import read_events
from fast_tffm_tpu_torch.serve import fleet as port_fleet
from fast_tffm_tpu_torch.tools import fmckpt, fmstat
from tools import fmstat as jax_fmstat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 120.0


def _free_port_block(n):
    """A base port with ``n`` free ports from it, below the ephemeral
    range (the supervisor warns inside it)."""
    import socket
    rng = np.random.default_rng(os.getpid() + 17)
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


def _wait(cond, what, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _verdicts(paths):
    return (attribution.health_verdict(attribution.summarize(paths)),
            jax_attribution.health_verdict(jax_attribution.summarize(paths)))


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """The fleet's life: start, a GET /metrics, a SIGKILL of replica 1
    (the supervisor's stream copied at its degraded snapshot), the
    respawn, the drain. Returns the paths and what was seen."""
    wd = str(tmp_path_factory.mktemp("obs_fleet"))
    base = _free_port_block(3)
    metrics = os.path.join(wd, "fleet.jsonl")
    cfg = FmConfig(
        vocabulary_size=200, factor_num=4, batch_size=32,
        train_files=(os.path.join(REPO, "data", "sample_train.txt"),),
        model_file=os.path.join(wd, "fm_model"),
        log_file=os.path.join(wd, "fm.log"), metrics_file=metrics,
        serve_port=base, serve_proxy_port=base + 2, serve_replicas=2,
        serve_max_batch=8, serve_poll_seconds=0.2,
        serve_health_poll_seconds=0.1, serve_restart_backoff_seconds=0.2)
    table = np.random.default_rng(3).normal(
        size=(cfg.num_rows, cfg.row_dim)).astype(np.float32) * 0.1
    save_checkpoint_from_numpy(cfg, table, None, 5)
    assert fmckpt.main(["publish", cfg.model_file, "5"]) == 0
    cfg_path = os.path.join(wd, "fleet.cfg")
    with open(cfg_path, "w") as fh:  # the replicas' config file
        fh.write(f"""[General]
vocabulary_size = 200
factor_num = 4
model_file = {cfg.model_file}
log_file = {cfg.log_file}
[Train]
train_files = {cfg.train_files[0]}
batch_size = 32
metrics_file = {metrics}
[Serve]
serve_port = {base}
serve_proxy_port = {base + 2}
serve_replicas = 2
serve_max_batch = 8
serve_poll_seconds = 0.2
""")
    sup = port_fleet.FleetSupervisor(cfg, cfg_path, device="cpu")
    seen = {}
    try:
        sup.start()
        assert sup.wait_ready(2, timeout=DEADLINE)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{sup.proxy_port}/metrics",
                timeout=30) as resp:
            seen["metrics"] = (resp.status, resp.headers["Content-Type"],
                               resp.read().decode())
        victim = sup.replicas[1]
        old = victim.pid()
        os.kill(old, signal.SIGKILL)

        def degraded():
            v, _ = _verdicts([metrics])
            return v["verdict"].startswith("FLEET DEGRADED")
        _wait(degraded, "a degraded snapshot in the supervisor's stream")
        seen["degraded"] = os.path.join(wd, "degraded.jsonl")
        shutil.copy(metrics, seen["degraded"])
        _wait(lambda: victim.pid() != old and sup.wait_ready(2, 0.1),
              "the respawned replica ready")
        # The stream's last gauges are the health loop's last tick, which
        # may lag the rows wait_ready reads: drain once that tick has
        # counted both replicas ready.
        _wait(lambda: sup.stats().get("fleet/ready") == 2,
              "the supervisor's count of 2 ready replicas")
    finally:
        sup.stop()
    return wd, metrics, seen


def test_the_supervisor_and_every_replica_write_a_stream(fleet_run):
    wd, metrics, _ = fleet_run
    assert sorted(f for f in os.listdir(wd) if f.startswith("fleet.jsonl")
                  ) == ["fleet.jsonl", "fleet.jsonl.r0", "fleet.jsonl.r1"]
    sup = list(read_events(metrics))
    assert sup[0]["meta"]["kind"] == "fleet"
    assert sup[-1]["event"] == "run_end"
    for i in (0, 1):
        events = list(read_events(f"{metrics}.r{i}"))
        starts = [e for e in events if e["event"] == "run_start"]
        assert starts and all(e["meta"]["kind"] == "serve" for e in starts)
    # Replica 1's shard ends with its respawn's run, which drained and
    # ended (the killed process's buffered events, if it flushed none,
    # died with it).
    r1 = list(read_events(metrics + ".r1"))
    assert r1[-1]["event"] == "run_end"
    assert [e["event"] for e in r1].count("run_start") in (1, 2)


def test_the_proxy_answers_get_metrics(fleet_run):
    status, ctype, body = fleet_run[2]["metrics"]
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert "fm_fleet_replicas 2" in body
    assert "# TYPE fm_fleet_ready gauge" in body


@pytest.mark.parametrize("moment,verdict", [
    ("degraded", "FLEET DEGRADED (1/2 ready)"), ("final", "OK")])
def test_both_readers_read_the_fleet_alike(fleet_run, capsys, moment,
                                           verdict):
    _, metrics, seen = fleet_run
    path = seen["degraded"] if moment == "degraded" else metrics
    port, jax = _verdicts([path])
    assert port == jax
    assert port["verdict"] == verdict
    capsys.readouterr()
    assert fmstat.main([path]) == 0
    out = capsys.readouterr().out
    assert jax_fmstat.main([path]) == 0
    assert capsys.readouterr().out == out
    assert "FLEET (serve --replicas)" in out
    if moment == "final":
        counters = attribution.summarize([path])["counters"]
        assert counters["fleet/deaths"] == 1
        assert counters["fleet/restarts"] >= 1
