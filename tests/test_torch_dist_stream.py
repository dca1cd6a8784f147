"""The multi-process stream's pieces (``fast_tffm_tpu_torch/data/stream.py``
and ``obs/quality.py``) against the JAX package's, in process on the
CPU, with inputs drawn from numpy seeds:

- ``merge_watermark_payloads``: the two cases of tests/test_stream.py
  (an owner's entry wins over a stale chief's short payload; ownership
  re-agreed under a changed membership), and a property over random
  ledgers, memberships and short payloads; ``exchange_watermarks`` over
  a two-rank fake mesh equals the JAX merge of the same payloads;
- the tracker's whole-file ownership: the chunks each owner's
  ``StreamTracker`` releases per poll, equal to the JAX tracker's with
  the same ``shard_index`` and ``num_shards`` on one directory;
- fixed-shape ``StreamSource`` batches (the lockstep shape) equal to the
  JAX source's array for array, ``stream_pos`` and the spill counts
  included, for each owner, with the unique bucket spilling and not;
- ``probe_stream_uniq_bucket``'s decision on sealed, quiet, dead and
  empty directories;
- ``QualityStats.sums`` / ``load_sums``.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data import stream as jsl
from fast_tffm_tpu.data.badlines import BadLineTracker as JaxBadLines
from fast_tffm_tpu.obs.quality import QualityStats as JaxQualityStats
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import stream as psl
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.data.pipeline import uniq_bucket_top
from fast_tffm_tpu_torch.obs.quality import QualityStats

torch.set_num_threads(1)

B = 16


def _rec(path, b):
    return {"path": path, "bytes": b, "lines": b, "sealed": True,
            "dead": False, "end": 100}


MERGE_CASES = {
    # The chief stepped only fillers: its payload is empty, and the
    # owner's advanced entry must survive the merge.
    "stale_chief": ([{"format": 1, "files": []},
                     {"format": 1, "files": [_rec("f0", 0),
                                             _rec("f1", 60)]}], 2),
    "per_index_owner": ([{"format": 1, "files": [_rec("f0", 25),
                                                 _rec("f1", 0)]},
                         {"format": 1, "files": [_rec("f0", 0),
                                                 _rec("f1", 60)]}], 2),
    # Grown back to 2 after a 1-rank phase consumed f0 and f1: the
    # joiner's empty payload cannot drop the restored positions, and
    # once it adopts a tag for its f3 it wins entry 3.
    "grown_joiner_empty": ([{"format": 1, "files": [
        _rec("f0", 100), _rec("f1", 100), _rec("f2", 40)]},
        {"format": 1, "files": []}], 2),
    "grown_joiner_owns_f3": ([{"format": 1, "files": [
        _rec("f0", 100), _rec("f1", 100), _rec("f2", 40)]},
        {"format": 1, "files": [_rec("f0", 100), _rec("f1", 100),
                                _rec("f2", 0), _rec("f3", 60)]}], 2),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_cases_equal_the_jax_merge(case):
    payloads, n = MERGE_CASES[case]
    got = psl.merge_watermark_payloads(payloads, n)
    assert got == jsl.merge_watermark_payloads(payloads, n)
    want_bytes = {"stale_chief": [0, 60], "per_index_owner": [25, 60],
                  "grown_joiner_empty": [100, 100, 40],
                  "grown_joiner_owns_f3": [100, 100, 40, 60]}[case]
    assert [f["bytes"] for f in got["files"]] == want_bytes


@st.composite
def _ledgers(draw):
    """A ledger of up to 7 files, 1 to 4 ranks, and each rank's payload:
    a prefix of the ledger (short: a rank that has not adopted a tag
    covering the later files), its own entries advanced."""
    n_files = draw(st.integers(0, 7))
    ranks = draw(st.integers(1, 4))
    payloads = []
    for r in range(ranks):
        k = draw(st.integers(0, n_files))
        files = []
        for i in range(k):
            owned = i % ranks == r
            b = draw(st.integers(0, 500)) if owned else 0
            files.append({"path": f"part-{i}", "bytes": b, "lines": b // 7,
                          "sealed": draw(st.booleans()) if owned else False,
                          "dead": False, "end": None, "ino": 1000 + i})
        payloads.append({"format": 1, "files": files})
    return payloads, ranks


@settings(max_examples=200, deadline=None)
@given(_ledgers())
def test_merge_property_equals_the_jax_merge(case):
    payloads, ranks = case
    got = psl.merge_watermark_payloads(payloads, ranks)
    assert got == jsl.merge_watermark_payloads(payloads, ranks)
    longest = max(len(p["files"]) for p in payloads)
    assert [f["path"] for f in got["files"]] == [
        f"part-{i}" for i in range(longest)]


class _FakeMesh:
    """Rank ``rank`` of a two-rank mesh whose peer's payload is fixed:
    ``all_gather_host`` stacks the ranks' arrays, in rank order."""

    size = 2

    def __init__(self, rank, peer_payload):
        self.rank = rank
        self.peer = json.dumps(peer_payload).encode("utf-8")
        self.labels = []

    def all_gather_host(self, arr, label):
        self.labels.append(label)
        if label == "stream/watermark_len":
            mine, peer = arr, np.asarray([len(self.peer)], np.int64)
        else:
            peer = np.zeros_like(arr)
            peer[:len(self.peer)] = np.frombuffer(self.peer, np.uint8)
            mine = arr
        parts = [mine, peer] if self.rank == 0 else [peer, mine]
        return np.stack(parts)


@pytest.mark.parametrize("rank", [0, 1])
def test_exchange_over_two_ranks_equals_the_jax_merge(rank):
    w0, w1 = MERGE_CASES["grown_joiner_owns_f3"][0]
    mine, peer = (w0, w1) if rank == 0 else (w1, w0)
    mesh = _FakeMesh(rank, peer)
    got = psl.exchange_watermarks(mine, mesh)
    assert got == jsl.merge_watermark_payloads([w0, w1], 2)
    assert mesh.labels == ["stream/watermark_len", "stream/watermark_merge"]
    assert psl.exchange_watermarks(w0, None) is w0


def _lines(seed, n, dense=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(6, 14)) if dense else int(rng.integers(1, 6))
        ids = rng.integers(0, 3000 if dense else 40, k)
        vals = np.round(rng.uniform(0.1, 2.0, k), 3)
        out.append(f"{int(rng.integers(0, 2))} "
                   + " ".join(f"{j}:{v}" for j, v in zip(ids, vals)))
    return out


def _write(path, text, mode="w"):
    with open(path, mode) as fh:
        fh.write(text)


class _Clock:
    """A poll interval past the last reading each time: discovery runs
    at every poll."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 10.0
        return self.t


def _arrivals(sd, tick, dense=False):
    """Five shards arriving in torn appends, sealed by ``.done``
    markers, one open head blocking the ledger behind it; ``tick()``
    runs between writes."""
    texts = ["\n".join(_lines(10 + k, 21 + 7 * k, dense)) + "\n"
             for k in range(5)]
    _write(sd / "part-0", texts[0][:50])
    tick()
    _write(sd / "part-0", texts[0][50:], "a")
    _write(sd / "part-1", texts[1])
    _write(sd / "part-1.done", "")
    tick()
    _write(sd / "part-0.done", "")
    _write(sd / "part-2", texts[2][:130])
    tick()
    _write(sd / "part-2", texts[2][130:], "a")
    _write(sd / "part-2.done", "")
    _write(sd / "part-3", texts[3])
    _write(sd / "part-3.done", "")
    tick()
    _write(sd / "part-4", texts[4])
    _write(sd / "part-4.done", "")
    (sd / "STOP").touch()
    tick()
    tick()


@pytest.mark.parametrize("num_shards,shard_index",
                         [(2, 0), (2, 1), (3, 0), (3, 2)])
def test_owned_chunks_per_poll_equal_the_jax_tracker(tmp_path,
                                                     num_shards,
                                                     shard_index):
    sd = tmp_path / "s"
    sd.mkdir()
    kw = dict(shard_index=shard_index, num_shards=num_shards,
              clock=_Clock())
    jtr = jsl.StreamTracker(str(sd), 1.0, "done", **kw)
    kw["clock"] = _Clock()
    ptr = psl.StreamTracker(str(sd), 1.0, "done", **kw)
    polls = {"jax": [], "port": []}

    def tick():
        polls["jax"].append(jtr.poll())
        polls["port"].append(ptr.poll())
    _arrivals(sd, tick)
    assert polls["port"] == polls["jax"]
    got = [i for chunks in polls["port"] for i, _ in chunks]
    assert got and all(i % num_shards == shard_index for i in got)
    assert ptr.finished and jtr.finished
    assert [ptr.owned(i) for i in range(5)] == \
        [jtr.owned(i) for i in range(5)]


def _cfgs(sd, **extra):
    kw = dict(vocabulary_size=4096, factor_num=2, batch_size=B,
              run_mode="stream", stream_dir=str(sd), stream_poll_seconds=1.0,
              seal_policy="done", shuffle=False, seed=3, host_threads=4,
              max_features_per_example=16, bucket_ladder=(4, 8, 16))
    kw.update(extra)
    return JaxFmConfig(**kw), FmConfig(**kw)


def _drain(src, mod, out):
    while True:
        b = src.next_batch(block=False)
        if b is mod.IDLE or b is mod.DONE:
            return
        out.append(b)


# (owner, unique bucket, route): 64 spills, 256 does not. The tolerant
# (generic) route has no spill in either package (an overfull batch
# raises UniqOverflow), so it runs at the bucket that fits.
SOURCE_CASES = [(o, b, "serial") for o in (0, 1) for b in (64, 256)] + \
    [(o, 256, "tolerant") for o in (0, 1)]


@pytest.mark.parametrize("owner,bucket,route", SOURCE_CASES)
def test_fixed_shape_batches_equal_the_jax_source(tmp_path, owner, bucket,
                                                  route):
    sd = tmp_path / "s"
    sd.mkdir()
    extra = ({"bad_line_policy": "skip", "max_bad_fraction": 0.5}
             if route == "tolerant" else {})
    jcfg, pcfg = _cfgs(sd, **extra)
    assert psl.stream_workers(pcfg, fixed_shape=True) == \
        jsl.stream_workers(jcfg, fixed_shape=True) == 1
    jbad, pbad = (JaxBadLines.from_config(jcfg),
                  BadLineTracker.from_config(pcfg))
    sides = {}
    for name, mod, cfg, bad in (("jax", jsl, jcfg, jbad),
                                ("port", psl, pcfg, pbad)):
        tr = mod.StreamTracker(str(sd), 1.0, "done", shard_index=owner,
                               num_shards=2, clock=_Clock(), bad_lines=bad)
        src = mod.StreamSource(cfg, tr, fixed_shape=True,
                               uniq_bucket=bucket, raw_ids=False,
                               bad_lines=bad)
        sides[name] = (mod, src, [])

    def tick():
        for mod, src, out in sides.values():
            _drain(src, mod, out)
    _arrivals(sd, tick, dense=True)
    jax_out, port_out = sides["jax"][2], sides["port"][2]
    assert len(port_out) == len(jax_out) > 2
    for i, (p, j) in enumerate(zip(port_out, jax_out)):
        assert p.num_real == j.num_real, i
        for k in ("labels", "weights", "local_idx", "vals", "uniq_ids"):
            np.testing.assert_array_equal(getattr(p, k), getattr(j, k),
                                          err_msg=f"{i} {k}")
        assert p.uniq_ids.shape == (bucket,)
        assert json.dumps(p.stream_pos, sort_keys=True) == \
            json.dumps(j.stream_pos, sort_keys=True), i
    ps, js = sides["port"][1].stats, sides["jax"][1].stats
    assert (ps.batches, ps.spilled_batches, ps.real_examples) == \
        (js.batches, js.spilled_batches, js.real_examples)
    assert (ps.spilled_batches > 0) == (bucket == 64)
    for _, src, _ in sides.values():
        src.close()
    # The last batch's tag (a drained stream's final watermark, as in
    # the JAX package) covers every owned file whole, line for line;
    # each is sealed on disk by its .done marker.
    final = port_out[-1].stream_pos
    for i, f in enumerate(final["files"]):
        if i % 2 == owner:
            with open(f["path"], "rb") as fh:
                blob = fh.read()
            assert (f["bytes"], f["lines"]) == (len(blob),
                                                blob.count(b"\n")), f
            assert os.path.exists(f["path"] + ".done")


def _probe_dir(sd, case):
    """(watermark to restore, seal policy) of a probe case."""
    lines = "\n".join(_lines(7, 48)) + "\n"
    if case == "sealed":
        _write(sd / "part-0", lines)
        _write(sd / "part-0.done", "")
        _write(sd / "part-1", lines[:200])  # open: not probed
    elif case == "quiet":
        _write(sd / "part-0", lines)
        t = os.path.getmtime(sd / "part-0") - 1000
        os.utime(sd / "part-0", (t, t))
        return None, "quiet"
    elif case == "dead":
        _write(sd / "part-0", lines)
        _write(sd / "part-0.done", "")
        return {"format": 1, "files": [{
            "path": str(sd / "part-0"), "bytes": 10, "lines": 0,
            "sealed": True, "dead": True, "end": 10}]}, "auto"
    return None, "auto"


@pytest.mark.parametrize("case", ["sealed", "quiet", "dead", "empty"])
def test_probe_decision_equals_the_jax_probe(tmp_path, case):
    sd = tmp_path / "s"
    sd.mkdir()
    wm, policy = _probe_dir(sd, case)
    jcfg, pcfg = _cfgs(sd, seal_policy=policy, bucket_ladder=(16,))
    got = psl.probe_stream_uniq_bucket(
        pcfg, psl.StreamTracker(str(sd), 0.05, policy, watermark=wm))
    want = jsl.probe_stream_uniq_bucket(
        jcfg, jsl.StreamTracker(str(sd), 0.05, policy, watermark=wm))
    assert got == want
    fallback = min(1024, uniq_bucket_top(pcfg))
    assert (got == fallback) == (case in ("dead", "empty")), got


@pytest.mark.parametrize("loss_type", ["logistic", "mse"])
def test_quality_sums_round_trip_equals_the_jax_one(loss_type):
    rng = np.random.default_rng(5)
    stats = []
    for cls in (QualityStats, JaxQualityStats):
        parts = [cls(loss_type), cls(loss_type)]
        for k, q in enumerate(parts):
            r = np.random.default_rng(20 + k)
            q.update(r.normal(0, 3, 300), (r.random(300) < 0.3) * 1.0,
                     r.uniform(0.2, 2.0, 300))
        merged = cls(loss_type)
        merged.load_sums(parts[0].sums() + parts[1].sums())
        stats.append((parts, merged))
    (pp, pm), (jp, jm) = stats
    for a, b in zip(pp + [pm], jp + [jm]):
        np.testing.assert_allclose(a.sums(), b.sums(), rtol=1e-12)
        assert a.sums().dtype == np.float64
    assert pm.loss == pytest.approx(jm.loss, rel=1e-12)
    assert pm.calibration == pytest.approx(jm.calibration, rel=1e-12)
    bad = rng.random(3)
    for cls in (QualityStats, JaxQualityStats):
        with pytest.raises(ValueError, match="4 values"):
            cls(loss_type).load_sums(bad)
