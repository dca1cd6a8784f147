"""The multi-process arms' telemetry against the JAX package's: one
config (two workers, one epoch, ``metrics_file``, ``trace_spans``,
``protocol_trace``) runs a 2-rank ``dist_train`` train and then a
2-rank predict through the JAX package (``run_tffm.py``) and through the
port (``python -m fast_tffm_tpu_torch ... --device cpu``), each worker a
process; a second config runs the same two workers in ``run_mode =
stream`` over two sealed shards and STOP, with the exit publish (the
publish interval outlasts the run, so both packages publish once).

- Each package's workers write the same shard files (the chief
  ``<metrics_file>``, worker 1 ``<metrics_file>.p1``), each holding a
  train then a predict run, stamped with the worker's index and the
  process count.
- A shard holds the JAX shard's event kinds and counter, gauge,
  histogram and span names (``ONLY_JAX`` / ``ONLY_PORT``: the deliberate
  differences, ROADMAP.md §C), and the same ``train/examples``: the
  shards sum to every example of the epoch.
- The protocol trace is one sequence on both ranks (``fmtrace
  --collectives`` exits 0); with one collective removed from a shard it
  exits 1 naming the first mismatch, as the JAX tool does.
- The port's fmstat and fmtrace print and exit as the JAX tools on both
  packages' shards, and the step anatomy aligns the port's ranks on its
  barrier spans.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

from fast_tffm_tpu.obs import attribution as j_attr
from fast_tffm_tpu_torch.obs import anatomy as p_anatomy
from fast_tffm_tpu_torch.obs import attribution as p_attr
from fast_tffm_tpu_torch.obs.sink import read_events
from fast_tffm_tpu_torch.tools import fmstat as p_fmstat
from fast_tffm_tpu_torch.tools import fmtrace as p_fmtrace
from tools import fmstat as j_fmstat
from tools import fmtrace as j_fmtrace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

REPO = ranks.REPO
LINES = 2000  # data/sample_train.txt
CFG = """[General]
vocabulary_size = 200
factor_num = 4
model_file = {wd}/model/fm
[Train]
train_files = {repo}/data/sample_train.txt
validation_files = {repo}/data/sample_test.txt
epoch_num = 1
batch_size = 64
log_steps = 4
save_steps = 7
metrics_file = {wd}/m.jsonl
metrics_flush_steps = 4
trace_spans = true
protocol_trace = true
[Predict]
predict_files = {repo}/data/sample_test.txt
score_path = {wd}/score
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = 0.5
cluster_connect_timeout_seconds = 90
"""
STREAM_CFG = """[General]
vocabulary_size = 200
factor_num = 4
model_file = {wd}/model/fm
[Train]
run_mode = stream
stream_dir = {wd}/stream
stream_poll_seconds = 0.05
seal_policy = done
publish_interval_seconds = 3600
validation_files = {repo}/data/sample_test.txt
validation_max_batches = 4
batch_size = 64
log_steps = 4
max_features_per_example = 32
bucket_ladder = 8,16,32
uniq_bucket = 256
metrics_file = {wd}/m.jsonl
metrics_flush_steps = 4
trace_spans = true
protocol_trace = true
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = 0.5
cluster_connect_timeout_seconds = 90
"""

# Names one package's shards hold and the other's do not (ROADMAP.md §C):
# the JAX package fans fixed-shape input over its parallel build plane
# (the port builds it serially) and, on a link its probe calls slow,
# fetches the buffered loss lines through its bulk fetcher (the port
# fetches them with one copy at the barrier, no span); the port stages
# each rank's batch through the wire encoder's buffers.
ONLY_JAX = {"pipeline/build_worker", "pipeline/worker_build_seconds",
            "pipeline/host_threads", "pipeline/ring_occupancy",
            "fetch/bulk", "fetch/d2h_seconds"}
ONLY_PORT = {"mem/wire_buffers_bytes"}
_SIGNALS = (-signal.SIGSEGV, -signal.SIGABRT, -signal.SIGBUS)


def _launch(argv_of, wd, env):
    procs = [subprocess.Popen(argv_of(i), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        finally:
            p.kill()
    return [p.returncode for p in procs], outs


def _stage_stream(wd):
    """data/sample_train.txt as two sealed shards of 1,000 lines, then
    STOP: a stream the workers drain and end."""
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    with open(os.path.join(REPO, "data", "sample_train.txt")) as fh:
        lines = fh.read().splitlines()
    for k in range(2):
        path = os.path.join(sd, f"part-{k:05d}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines[k * 1000:(k + 1) * 1000]) + "\n")
        open(path + ".done", "w").close()
    open(os.path.join(sd, "STOP"), "w").close()


def _run(side, wd, mode):
    """The train (``mode`` epochs: then the predict) of ``side`` in
    ``wd``; returns the rcs and outputs of the first command that failed,
    or None."""
    os.makedirs(wd)
    cfg = os.path.join(wd, "dist.cfg")
    with open(cfg, "w") as fh:
        fh.write((CFG if mode == "epochs" else STREAM_CFG).format(
            wd=wd, repo=REPO,
            hosts=ranks.worker_hosts(ranks.free_port(), 2)))
    if mode == "stream":
        _stage_stream(wd)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    if side == "jax":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["PYTHONPATH"] = REPO
        env.pop("JAX_PLATFORMS", None)
    for command in (("train", "predict") if mode == "epochs"
                    else ("train",)):
        if side == "jax":
            def argv_of(i):
                return [sys.executable, "run_tffm.py", command, cfg,
                        "dist_train", "worker", str(i)]
        else:
            def argv_of(i):
                return [sys.executable, "-m", "fast_tffm_tpu_torch",
                        command, cfg, "--device", "cpu", "dist_train",
                        "worker", str(i)]
        rcs, outs = _launch(argv_of, wd, env)
        if rcs != [0, 0]:
            return rcs, outs
    return None


def _both_runs(tmp_path_factory, mode):
    """{side: directory of its shards}. A JAX worker that dies on a
    signal (the reference's known jaxlib flake on CPU,
    tests/test_multiprocess.py) is rerun in a fresh directory, twice at
    most; any other failure fails at once."""
    base = str(tmp_path_factory.mktemp(f"obs_dist_{mode}"))
    out = {}
    for side in ("port", "jax"):
        for attempt in range(3):
            wd = os.path.join(base, f"{side}{attempt}")
            failed = _run(side, wd, mode)
            if failed is None:
                out[side] = wd
                break
            rcs, outs = failed
            assert side == "jax" and any(rc in _SIGNALS for rc in rcs) \
                and attempt < 2, (side, rcs, outs[0][-3000:],
                                  outs[1][-3000:])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _both_runs(tmp_path_factory, "epochs")


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    return _both_runs(tmp_path_factory, "stream")


def _shards(wd):
    return [os.path.join(wd, "m.jsonl"), os.path.join(wd, "m.jsonl.p1")]


def _segments(path):
    out = []
    for e in read_events(path):
        if e["event"] == "run_start":
            out.append([])
        out[-1].append(e)
    return out


def _clean_exit_race(e):
    """The JAX monitor's ``worker_lost`` for peers whose leases are gone
    (``age_seconds`` None): a peer that finished a moment first and
    removed its lease on a clean exit. The port's monitor passes over a
    removed lease (ROADMAP.md §C), so this event is the reference's
    alone, and only in some runs."""
    return (e["event"] == "health" and e.get("status") == "worker_lost"
            and e.get("label") == "heartbeat_monitor"
            and all(p.get("age_seconds") is None for p in e.get("lost", ())))


def _jax_names(events):
    return _names([e for e in events if not _clean_exit_race(e)])


def _names(events):
    metrics = [e for e in events if e["event"] == "metrics"]
    names = set()
    for m in metrics:
        for k in ("counters", "gauges", "hists"):
            names |= set(m[k])
    return {"kinds": {e["event"] for e in events},
            "names": names,
            "spans": {e["name"] for e in events if e["event"] == "span"},
            "health": {e.get("status") for e in events
                       if e["event"] == "health"},
            "run": set(metrics[-1]["run"]),
            "last": metrics[-1]}


def test_shard_files_are_the_jax_packages(runs):
    for side in ("jax", "port"):
        files = sorted(f for f in os.listdir(runs[side])
                       if f.startswith("m.jsonl"))
        assert files == ["m.jsonl", "m.jsonl.p1"], (side, files)
    for i, path in enumerate(_shards(runs["port"])):
        segs = _segments(path)
        assert [s[0]["meta"]["kind"] for s in segs] == ["train", "predict"]
        for seg in segs:
            assert seg[0]["meta"]["process_index"] == i
            assert seg[0]["meta"]["process_count"] == 2
            assert seg[-1]["event"] == "run_end"


@pytest.mark.parametrize("shard,seg", [(0, 0), (0, 1), (1, 0), (1, 1)],
                         ids=["chief-train", "chief-predict",
                              "worker1-train", "worker1-predict"])
def test_shards_hold_the_jax_names(runs, shard, seg):
    j = _jax_names(_segments(_shards(runs["jax"])[shard])[seg])
    p = _names(_segments(_shards(runs["port"])[shard])[seg])
    assert p["kinds"] == j["kinds"]
    assert p["names"] - ONLY_PORT == j["names"] - ONLY_JAX
    assert p["spans"] - ONLY_PORT == j["spans"] - ONLY_JAX
    assert p["health"] == j["health"]
    assert p["run"] == j["run"]
    for name in ("train/examples", "train/steps", "predict/examples",
                 "lockstep/windows", "lockstep/programs",
                 "lockstep/real_batches", "lockstep/filler_batches",
                 "lockstep/examples", "checkpoint/saves"):
        assert p["last"]["counters"].get(name) == \
            j["last"]["counters"].get(name), name


def test_train_examples_sum_to_the_epoch(runs):
    for side in ("jax", "port"):
        total = sum(_names(_segments(path)[0])["last"]["counters"]
                    ["train/examples"] for path in _shards(runs[side]))
        assert total == LINES, side


def test_protocol_trace_is_one_sequence_on_both_ranks(runs, capsys):
    shards = _shards(runs["port"])
    seqs = p_fmtrace.collective_sequences(shards)
    assert sorted(seqs) == [0, 1]
    assert len(seqs[0]) > 10 and seqs[0] == seqs[1]
    # The step's flags and row exchange, the lockstep windows, the
    # checkpoint's broadcasts and gathers, predict's barriers.
    assert {"train/step_flags", "rows/gather", "lockstep/window_fill",
            "predict/parts_barrier"} <= set(seqs[0])
    argv = ["--collectives"] + shards
    assert p_fmtrace.main(argv) == 0
    port = capsys.readouterr()
    assert j_fmtrace.main(argv) == 0
    assert capsys.readouterr() == port
    assert "sequences identical" in port.err


def test_a_doctored_trace_names_the_first_mismatch(runs, tmp_path, capsys):
    # The train runs' segments, worker 1's without its sixth collective.
    paths = []
    for i, path in enumerate(_shards(runs["port"])):
        events = _segments(path)[0]
        if i == 1:
            at = [k for k, e in enumerate(events)
                  if e["event"] == "collective"][5]
            events = events[:at] + events[at + 1:]
        paths.append(str(tmp_path / os.path.basename(path)))
        with open(paths[-1], "w") as fh:
            fh.writelines(json.dumps(e) + "\n" for e in events)
    argv = ["--collectives"] + paths
    assert p_fmtrace.main(argv) == 1
    port = capsys.readouterr()
    assert j_fmtrace.main(argv) == 1
    assert capsys.readouterr() == port
    assert "DIVERGE at position 5" in port.err


@pytest.mark.parametrize("side", ["jax", "port"])
def test_the_readers_agree_on_each_packages_shards(runs, side, capsys):
    shards = _shards(runs[side])
    for argv, j_main, p_main in (
            (shards, j_fmstat.main, p_fmstat.main),
            (["--json"] + shards, j_fmstat.main, p_fmstat.main),
            (["slo", "--allow-skip"] + shards, j_fmstat.main,
             p_fmstat.main),
            (["--anatomy"] + shards, j_fmtrace.main, p_fmtrace.main),
            (["--anatomy", "--json"] + shards, j_fmtrace.main,
             p_fmtrace.main)):
        jrc = j_main(list(argv))
        jout = capsys.readouterr()
        assert p_main(list(argv)) == jrc, argv
        assert capsys.readouterr() == jout, argv
    js, ps = j_attr.summarize(shards), p_attr.summarize(shards)
    assert p_attr.health_verdict(ps) == j_attr.health_verdict(js)
    assert p_attr.health_verdict(ps)["verdict"] == "OK"


def test_anatomy_aligns_the_ports_ranks_on_its_barriers(runs):
    rep = p_anatomy.report(_shards(runs["port"]))
    assert "error" not in rep
    assert sorted(rep["ranks"]) == [0, 1]
    for r in rep["ranks"].values():
        assert 0.0 < r["efficiency"] <= 1.0
    assert rep["top_barrier"] in p_anatomy.BARRIER_SPANS
    barriers = {e["name"] for e in read_events(_shards(runs["port"])[1])
                if e["event"] == "span"} & set(p_anatomy.BARRIER_SPANS)
    assert barriers == {"train/step_flags", "lockstep/allgather"}


@pytest.mark.parametrize("shard", [0, 1], ids=["chief", "worker1"])
def test_stream_shards_hold_the_jax_names(stream_runs, shard):
    j = _jax_names(_segments(_shards(stream_runs["jax"])[shard])[0])
    p = _names(_segments(_shards(stream_runs["port"])[shard])[0])
    assert p["kinds"] == j["kinds"]
    assert p["names"] - ONLY_PORT == j["names"] - ONLY_JAX
    assert p["spans"] - ONLY_PORT == j["spans"] - ONLY_JAX
    assert p["health"] == j["health"]
    assert p["run"] == j["run"]
    for name in ("train/examples", "train/steps",
                 "stream/files_discovered", "stream/files_sealed"):
        assert p["last"]["counters"].get(name) == \
            j["last"]["counters"].get(name), name


def test_stream_shards_sum_to_every_line_once(stream_runs, capsys):
    for side in ("jax", "port"):
        shards = _shards(stream_runs[side])
        assert sum(_names(_segments(path)[0])["last"]["counters"]
                   ["train/examples"] for path in shards) == LINES, side
    shards = _shards(stream_runs["port"])
    assert p_fmtrace.main(["--collectives"] + shards) == 0
    assert "sequences identical" in capsys.readouterr().err
    assert p_attr.health_verdict(p_attr.summarize(shards))["verdict"] == \
        j_attr.health_verdict(j_attr.summarize(shards))["verdict"] == "OK"


# -- the protocol trace's switch and events, in process ----------------------

@pytest.fixture
def trace_state(monkeypatch):
    """The trace's module-global switch, env cache and sequence, unset
    (as tests/test_protocol_trace.py resets the JAX package's)."""
    from fast_tffm_tpu_torch.parallel import liveness
    monkeypatch.delenv("FM_PROTOCOL_TRACE", raising=False)
    monkeypatch.setattr(liveness, "_PROTOCOL_TRACE", None)
    monkeypatch.setattr(liveness, "_PROTOCOL_ENV", None)
    monkeypatch.setattr(liveness, "_PROTOCOL_SEQ", 0)
    return liveness


def test_trace_switch_precedence(trace_state, tmp_path, monkeypatch):
    from fast_tffm_tpu_torch.obs.telemetry import RunTelemetry, activate
    lv = trace_state
    assert not lv.protocol_trace_enabled()
    monkeypatch.setenv("FM_PROTOCOL_TRACE", "1")
    monkeypatch.setattr(lv, "_PROTOCOL_ENV", None)
    assert lv.protocol_trace_enabled()
    lv.enable_protocol_trace(False)
    assert not lv.protocol_trace_enabled()
    lv.enable_protocol_trace(True)
    assert lv.protocol_trace_enabled()
    monkeypatch.setattr(lv, "_PROTOCOL_TRACE", None)
    monkeypatch.setattr(lv, "_PROTOCOL_ENV", None)
    monkeypatch.delenv("FM_PROTOCOL_TRACE")
    tel = RunTelemetry(str(tmp_path / "m.jsonl"), meta={},
                       protocol_trace=True)
    with activate(tel):
        assert lv.protocol_trace_enabled()
    assert not lv.protocol_trace_enabled()
    tel.close(0)


@pytest.mark.parametrize("raw", ["", "0", "false", "no", " False "])
def test_env_off_values_do_not_enable(trace_state, monkeypatch, raw):
    import fast_tffm_tpu.parallel.liveness as jax_liveness
    monkeypatch.setenv("FM_PROTOCOL_TRACE", raw)
    monkeypatch.setattr(jax_liveness, "_PROTOCOL_TRACE", None)
    monkeypatch.setattr(jax_liveness, "_PROTOCOL_ENV", None)
    assert not trace_state.protocol_trace_enabled()
    assert not jax_liveness.protocol_trace_enabled()


@pytest.mark.parametrize("guard", [False, True], ids=["unguarded",
                                                      "guarded"])
def test_collectives_are_numbered_at_issue(trace_state, tmp_path, guard):
    """One ``collective`` event a collective, written before it is
    issued (``guarded_work``: before ``start()``), numbered in issue
    order, with its label and op; a guarded wait that is not a
    collective (``collective=False``) is not traced; with the trace off
    nothing is written."""
    from fast_tffm_tpu_torch.obs.telemetry import RunTelemetry, activate
    lv = trace_state
    issued = []

    class Done:
        def wait(self, timeout=None):
            return True

        def is_completed(self):
            return True

    def start(label):
        def go():
            seen = [e["label"] for e in read_events(path)
                    if e["event"] == "collective"] if os.path.exists(
                        path) else []
            issued.append((label, seen))
            return Done()
        return go

    path = str(tmp_path / "m.jsonl")
    tel = RunTelemetry(path, meta={"process_index": 0}, protocol_trace=True)
    prev = lv.install_guard(None, 30.0) if guard else lv.current_guard()
    try:
        with activate(tel):
            lv.guarded_work(start("a/flags"), "a/flags", "all_gather")
            tel.sink.flush()
            lv.guarded_work(start("b/rows"), "b/rows", "all_reduce")
            assert lv.guarded_collective(lambda x: x, 5, label="c/fetch",
                                         collective=False) == 5
        tel.close(0)
    finally:
        lv.restore_guard(prev)
    evs = [e for e in read_events(path) if e["event"] == "collective"]
    assert [(e["seq"], e["label"], e["op"]) for e in evs] == [
        (1, "a/flags", "all_gather"), (2, "b/rows", "all_reduce")]
    # The first collective's event, flushed, was on disk when the second
    # was issued, and none was written after an issue.
    assert issued == [("a/flags", []), ("b/rows", ["a/flags"])]
    off = str(tmp_path / "off.jsonl")
    tel = RunTelemetry(off, meta={"process_index": 0})
    with activate(tel):
        lv.guarded_work(start("a/flags"), "a/flags", "all_gather")
    tel.close(0)
    assert not [e for e in read_events(off) if e["event"] == "collective"]
