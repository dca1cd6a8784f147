"""The stream source (``fast_tffm_tpu_torch/data/stream.py``) against the
JAX package's (``fast_tffm_tpu/data/stream.py``), on the CPU: both follow
one stream directory while a scenario writes, seals, truncates and
deletes shards in it, and the emitted batches must be equal array for
array, with every ``stream_pos`` equal as JSON. The scenarios (torn tail,
``.done`` and quiet seals, truncation, deletion, strict ledger order,
``STOP`` sealing an open file, the poll budget, resume from a mid-file
watermark) run on every route — the serial C++ builder, the ring at
``host_threads`` 2 and 4, the generic tolerant path with bad lines, and
unlimited features — for FM and for FFM. Then the watermark sidecar
through ``CheckpointState``: the round trip, its bytes against the JAX
writer's, and a walk-back past a quarantined step to the older
watermark."""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data import stream as jsl
from fast_tffm_tpu.data.badlines import BadLineTracker as JaxBadLines
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import stream as psl
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.testing.faults import truncate_checkpoint
from fast_tffm_tpu_torch.train import checkpoint_template

torch.set_num_threads(1)

B = 8
ROUTES = {
    "serial": dict(host_threads=1),
    "ring2": dict(host_threads=2),
    "ring4": dict(host_threads=4),
    "tolerant": dict(host_threads=1, bad_line_policy="skip",
                     max_bad_fraction=0.5),
    "unlimited": dict(host_threads=1, max_features_per_example=0),
}


def _lines(seed, n, ffm, bad=False):
    """``n`` distinct example lines (FFM: ``field:id:val`` tokens); with
    ``bad``, every 11th line is malformed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 12))
        ids = rng.integers(0, 4000, k)
        vals = np.round(rng.uniform(0.1, 2.0, k), 3)
        if ffm:
            toks = [f"{int(rng.integers(0, 4))}:{j}:{v}"
                    for j, v in zip(ids, vals)]
        else:
            toks = [f"{j}:{v}" for j, v in zip(ids, vals)]
        out.append(f"{int(rng.integers(0, 2))} " + " ".join(toks))
        if bad and i % 11 == 5:
            out[-1] = "1 7:zz"
    return out


def _cfg_kw(sd, route, ffm):
    kw = dict(vocabulary_size=4096, factor_num=2, batch_size=B,
              run_mode="stream", stream_dir=str(sd), stream_poll_seconds=1.0,
              seal_policy="auto", shuffle=False, seed=3, **ROUTES[route])
    if ffm:
        kw.update(model_type="ffm", field_num=4)
    return kw


class _Clock:
    """Each reading a poll interval past the last: discovery runs at
    every poll, and the quiet seal still reads the files' real mtimes."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 10.0
        return self.t


class Pair:
    """The JAX source and the port's over one directory."""

    def __init__(self, sd, route, ffm, watermark=None):
        kw = _cfg_kw(sd, route, ffm)
        self.jcfg, self.pcfg = JaxFmConfig(**kw), FmConfig(**kw)
        self.jbad = JaxBadLines.from_config(self.jcfg)
        self.pbad = BadLineTracker.from_config(self.pcfg)
        jtr = jsl.StreamTracker(str(sd), 1.0, "auto", bad_lines=self.jbad,
                                watermark=watermark, clock=_Clock())
        ptr = psl.StreamTracker(str(sd), 1.0, "auto", bad_lines=self.pbad,
                                watermark=watermark, clock=_Clock())
        self.j = jsl.StreamSource(self.jcfg, jtr, raw_ids=True,
                                  workers=jsl.stream_workers(self.jcfg),
                                  bad_lines=self.jbad)
        self.p = psl.StreamSource(self.pcfg, ptr, raw_ids=True,
                                  workers=psl.stream_workers(self.pcfg),
                                  bad_lines=self.pbad)
        assert psl.stream_workers(self.pcfg) == \
            jsl.stream_workers(self.jcfg)
        self.out = {"jax": [], "port": []}
        self.done = {"jax": False, "port": False}

    def pump(self):
        """Drain both sources to IDLE or DONE. A ring's groups in flight
        are harvested before the next poll, so the tracker state each
        batch's watermark records does not depend on thread timing."""
        for side, src, mod in (("jax", self.j, jsl), ("port", self.p, psl)):
            while True:
                if getattr(src, "_ring", None) is not None and \
                        src._inflight:
                    src._harvest(block=True)
                b = src.next_batch(block=False)
                if b is mod.DONE:
                    self.done[side] = True
                    break
                if b is mod.IDLE:
                    break
                self.out[side].append(b)

    def close(self):
        self.j.close()
        self.p.close()
        for t in (self.jbad, self.pbad):
            if t is not None:
                t.close()


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for i, (p, j) in enumerate(zip(got, want)):
        assert p.num_real == j.num_real, i
        for name in ("labels", "weights", "local_idx", "vals", "uniq_ids",
                     "fields"):
            a, b = getattr(p, name), getattr(j, name)
            assert (a is None) == (b is None), (i, name)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{i} {name}")
        assert json.dumps(p.stream_pos, sort_keys=True) == \
            json.dumps(j.stream_pos, sort_keys=True), i


def _write(path, text, mode="w"):
    with open(path, mode) as fh:
        fh.write(text)


def _age(path):
    """Make ``path`` look quiet for longer than the seal window."""
    t = os.path.getmtime(path) - 1000
    os.utime(path, (t, t))


# Each scenario writes into ``sd`` and pumps ``pair`` between writes;
# ``lines(seed, n)`` gives the route's lines.

def _torn_tail(sd, pair, lines):
    a = lines(1, 30)
    text = "\n".join(a) + "\n"
    cut = len("\n".join(a[:13])) + 5  # in the middle of line 14
    _write(sd / "part-0", text[:cut])
    pair.pump()
    _write(sd / "part-0", text[cut:], "a")
    pair.pump()
    _write(sd / "part-0", "\n".join(lines(2, 9)), "a")  # no final newline
    pair.pump()
    _write(sd / "part-0.done", "")
    (sd / "STOP").touch()
    pair.pump()


def _seals(sd, pair, lines):
    _write(sd / "part-0", "\n".join(lines(1, 21)) + "\n")
    pair.pump()
    _write(sd / "part-1", "\n".join(lines(2, 17)) + "\n")
    pair.pump()  # part-0 still open: blocks part-1
    _write(sd / "part-0.done", "")
    pair.pump()
    _age(sd / "part-1")  # quiet seal
    pair.pump()
    _write(sd / "part-2", "\n".join(lines(3, 5)) + "\n")
    (sd / "STOP").touch()
    pair.pump()


def _truncated(sd, pair, lines):
    _write(sd / "part-0", "\n".join(lines(1, 30)) + "\n")
    pair.pump()
    with open(sd / "part-0", "r+") as fh:  # same inode, fewer bytes
        fh.truncate(100)
    _write(sd / "part-1", "\n".join(lines(2, 19)) + "\n")
    _write(sd / "part-1.done", "")
    pair.pump()
    (sd / "STOP").touch()
    pair.pump()


def _deleted(sd, pair, lines):
    _write(sd / "part-0", "\n".join(lines(1, 20)) + "\n")
    pair.pump()
    os.remove(sd / "part-0")
    _write(sd / "part-1", "\n".join(lines(2, 26)) + "\n")
    _write(sd / "part-1.done", "")
    pair.pump()
    (sd / "STOP").touch()
    pair.pump()


def _ledger_order(sd, pair, lines):
    # "b" is found first: the ledger follows discovery, not names, and
    # an open head blocks every file behind it.
    _write(sd / "b", "\n".join(lines(1, 13)) + "\n")
    pair.pump()
    _write(sd / "a", "\n".join(lines(2, 22)) + "\n")
    _write(sd / "a.done", "")
    pair.pump()
    _write(sd / "b", "\n".join(lines(3, 6)) + "\n", "a")
    _write(sd / "b.done", "")
    pair.pump()
    (sd / "STOP").touch()
    pair.pump()


def _stop_seals_open(sd, pair, lines):
    _write(sd / "part-0", "\n".join(lines(1, 27)) + "\n")
    pair.pump()
    _write(sd / "part-1", "\n".join(lines(2, 11)))  # open, torn tail
    pair.pump()
    (sd / "STOP").touch()  # STOP seals every open file
    pair.pump()


def _budget(sd, pair, lines):
    for k in range(3):
        _write(sd / f"part-{k}", "\n".join(lines(k, 25)) + "\n")
        _write(sd / f"part-{k}.done", "")
    (sd / "STOP").touch()
    for _ in range(60):
        pair.pump()
        if all(pair.done.values()):
            break


SCENARIOS = {"torn_tail": _torn_tail, "seals": _seals,
             "truncated": _truncated, "deleted": _deleted,
             "ledger_order": _ledger_order,
             "stop_seals_open": _stop_seals_open, "budget": _budget}

# What each scenario's last watermark must show: (file name, dead) in
# ledger order, every file sealed.
LEDGERS = {"torn_tail": [("part-0", False)],
           "seals": [("part-0", False), ("part-1", False),
                     ("part-2", False)],
           "truncated": [("part-0", True), ("part-1", False)],
           "deleted": [("part-0", True), ("part-1", False)],
           "ledger_order": [("b", False), ("a", False)],
           "stop_seals_open": [("part-0", False), ("part-1", False)],
           "budget": [("part-0", False), ("part-1", False),
                      ("part-2", False)]}


def _run(tmp_path, monkeypatch, scenario, route, ffm):
    sd = tmp_path / "s"
    sd.mkdir()
    if scenario == "budget":
        monkeypatch.setattr(jsl, "MAX_POLL_BYTES", 300)
        monkeypatch.setattr(psl, "MAX_POLL_BYTES", 300)
    bad = route == "tolerant"

    def lines(seed, n):
        return _lines(seed, n, ffm, bad)

    pair = Pair(sd, route, ffm)
    try:
        SCENARIOS[scenario](sd, pair, lines)
        pair.pump()
        assert pair.done == {"jax": True, "port": True}
        _assert_same_batches(pair.out["port"], pair.out["jax"])
        if bad:
            assert pair.pbad.bad == pair.jbad.bad > 0
            assert pair.pbad.total == pair.jbad.total
        assert pair.p.stats.batches == len(pair.out["port"])
        files = pair.out["port"][-1].stream_pos["files"]
        assert [(os.path.basename(f["path"]), f["dead"]) for f in files] \
            == LEDGERS[scenario]
        assert all(f["sealed"] or f["dead"] for f in files)
    finally:
        pair.close()
    return sd, pair


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fm_stream_matches_jax(tmp_path, monkeypatch, scenario, route):
    _run(tmp_path, monkeypatch, scenario, route, ffm=False)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("scenario", ["torn_tail", "seals", "deleted"])
def test_ffm_stream_matches_jax(tmp_path, monkeypatch, scenario, route):
    sd, pair = _run(tmp_path, monkeypatch, scenario, route, ffm=True)
    assert pair.out["port"][0].fields is not None


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_resume_from_mid_file_watermark_matches_jax(tmp_path, monkeypatch,
                                                    route):
    sd, first = _run(tmp_path, monkeypatch, "seals", route, ffm=False)
    k = 1  # after the second batch: mid-way through part-0
    wm = first.out["port"][k].stream_pos
    assert 0 < wm["files"][0]["lines"] < 21
    resumed = Pair(sd, route, ffm=False, watermark=wm)
    try:
        resumed.pump()
        assert resumed.done == {"jax": True, "port": True}
        _assert_same_batches(resumed.out["port"], resumed.out["jax"])
        # ... and the resumed stream is the rest of the first one.
        want = first.out["port"][k + 1:]
        got = resumed.out["port"]
        if route in ("tolerant", "unlimited"):
            # Line groups re-align only where the generic path's batches
            # do: compare the examples, in order.
            def rows(bs):
                return [(float(b.labels[i]),
                         tuple(b.local_idx[i][b.vals[i] != 0]))
                        for b in bs for i in range(b.num_real)]
            assert rows(got) == rows(want)
        else:
            assert [b.num_real for b in got] == [b.num_real for b in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.local_idx, w.local_idx)
        assert got[-1].stream_pos == want[-1].stream_pos
    finally:
        resumed.close()


def test_prefetcher_thread_ends_with_the_source(tmp_path):
    sd = tmp_path / "s"
    sd.mkdir()
    cfg = FmConfig(**_cfg_kw(sd, "serial", False))
    src = psl.StreamSource(cfg, psl.StreamTracker(str(sd), 0.01, "auto"))
    pf = psl.StreamPrefetcher(src)
    assert pf.get(timeout=0.05) is psl.IDLE
    assert any(t.name == "fmt-stream-prefetch" for t in
               threading.enumerate())
    _write(sd / "part-0", "\n".join(_lines(1, 12, False)) + "\n")
    (sd / "STOP").touch()
    got = []
    for _ in range(200):
        b = pf.get(timeout=0.05)
        if b is psl.DONE:
            break
        if b is not psl.IDLE:
            got.append(b)
    assert [b.num_real for b in got] == [8, 4]
    pf.close()
    assert not any(t.name == "fmt-stream-prefetch" for t in
                   threading.enumerate())


# --- the watermark through CheckpointState ----------------------------------


def _ckpt_state(tmp_path):
    cfg = FmConfig(vocabulary_size=300, factor_num=2,
                   model_file=str(tmp_path / "m" / "fm"))
    table = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.num_rows, cfg.row_dim)).astype(np.float32))
    acc = torch.full((cfg.num_rows, cfg.row_dim), cfg.adagrad_init)
    return cfg, table, acc


def _watermarks(tmp_path):
    sd = tmp_path / "s"
    sd.mkdir()
    _write(sd / "a.txt", "\n".join(_lines(5, 40, False)) + "\n")
    _write(sd / "a.txt.done", "")
    (sd / "STOP").touch()
    cfg = FmConfig(**_cfg_kw(sd, "serial", False))
    src = psl.StreamSource(cfg, psl.StreamTracker(str(sd), 0.01, "auto"))
    batches = []
    while True:
        b = src.next_batch(block=True)
        if b is psl.DONE:
            break
        batches.append(b)
    src.close()
    return sd, cfg, batches


def test_watermark_round_trip_matches_the_jax_writer(tmp_path):
    from fast_tffm_tpu import checkpoint as jck
    _, _, batches = _watermarks(tmp_path)
    wm5, wm10 = batches[0].stream_pos, batches[2].stream_pos
    cfg, table, acc = _ckpt_state(tmp_path)
    ckpt = ck.CheckpointState(cfg.model_file)
    ckpt.save(5, table, acc, vocabulary_size=cfg.vocabulary_size,
              stream_state=wm5)
    ckpt.save(10, table, acc, vocabulary_size=cfg.vocabulary_size,
              wait=True, stream_state=wm10)
    # A same-step save (the final save landing on a periodic one)
    # writes the watermark again without touching the arrays.
    ckpt.save(10, table, acc, vocabulary_size=cfg.vocabulary_size,
              force=True, wait=True, stream_state=wm10)
    ckpt.close()
    d = ckpt.directory
    assert ck.read_watermark(d, 5) == wm5
    assert ck.read_watermark(d, 10) == wm10
    twin = tmp_path / "twin"
    twin.mkdir()
    jck.write_watermark(str(twin), 10, wm10)
    with open(ck.watermark_path(d, 10), "rb") as a, \
            open(jck.watermark_path(str(twin), 10), "rb") as b:
        assert a.read() == b.read()
    restored = ck.CheckpointState(cfg.model_file).restore(
        template=checkpoint_template(cfg))
    assert restored["step"] == 10 and restored["stream"] == wm10
    # A garbled sidecar reads as no watermark.
    _write(ck.watermark_path(d, 10), "{not json")
    assert ck.read_watermark(d, 10) is None
    # An epoch-mode save on a fresh step drops a stale same-step sidecar.
    ck.write_watermark(d, 20, wm5)
    ckpt = ck.CheckpointState(cfg.model_file)
    ckpt.save(20, table, acc, vocabulary_size=cfg.vocabulary_size,
              wait=True)
    ckpt.close()
    assert ck.read_watermark(d, 20) is None


def test_walk_back_restores_the_older_watermark(tmp_path):
    sd, scfg, batches = _watermarks(tmp_path)
    wm5, wm10 = batches[0].stream_pos, batches[2].stream_pos
    cfg, table, acc = _ckpt_state(tmp_path)
    ckpt = ck.CheckpointState(cfg.model_file)
    for step, wm in ((5, wm5), (10, wm10)):
        ckpt.save(step, table, acc, vocabulary_size=cfg.vocabulary_size,
                  wait=True, stream_state=wm)
    ckpt.close()
    truncate_checkpoint(cfg.model_file, step=10)
    ckpt = ck.CheckpointState(cfg.model_file)
    restored = ckpt.restore(template=checkpoint_template(cfg))
    ckpt.close()
    d = ckpt.directory
    assert restored["step"] == 5 and restored["stream"] == wm5
    assert ck.read_watermark(d, 10) is None
    assert os.path.exists(os.path.join(d, "corrupt-10", "watermark-10.json"))
    # The resumed source starts right after wm5: re-reads, never skips.
    src = psl.StreamSource(scfg, psl.StreamTracker(
        str(sd), 0.01, "auto", watermark=restored["stream"]))
    nxt = src.next_batch(block=True)
    src.close()
    np.testing.assert_array_equal(nxt.local_idx, batches[1].local_idx)


def test_retention_and_gc_drop_orphaned_watermarks(tmp_path):
    from fast_tffm_tpu_torch.tools import fmckpt
    _, _, batches = _watermarks(tmp_path)
    cfg, table, acc = _ckpt_state(tmp_path)
    ckpt = ck.CheckpointState(cfg.model_file, max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, table, acc, vocabulary_size=cfg.vocabulary_size,
                  wait=True, stream_state=batches[step - 1].stream_pos)
    ckpt.close()
    d = ckpt.directory
    assert not os.path.exists(ck.watermark_path(d, 1))  # retention
    state = fmckpt.scan(d)
    assert [(s["step"], s["watermark"]) for s in state["steps"]] == [
        (2, True), (3, True)]
    import io
    out = io.StringIO()
    fmckpt.cmd_ls(d, out=out)
    assert out.getvalue().count("+watermark") == 2
    ck.write_watermark(d, 1, batches[0].stream_pos)  # an orphan
    shutil.copy(ck.watermark_path(d, 1), ck.watermark_path(d, 1) + ".tmp")
    assert fmckpt.scan(d)["orphans"] == ["watermark-1.json",
                                         "watermark-1.json.tmp"]
    assert fmckpt.cmd_gc(d, False, out=io.StringIO()) == 0
    assert fmckpt.scan(d)["orphans"] == []
    assert ck.read_watermark(d, 2) == batches[1].stream_pos
