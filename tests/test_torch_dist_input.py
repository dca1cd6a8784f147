"""The port's multi-process input (fast_tffm_tpu_torch/data/pipeline.py)
against the JAX package's, on the CPU:

- ``shard_byte_range`` and the sharded ``_iter_lines`` equal the JAX
  ones, lines, weights and file line numbers (a property test over
  random files, as tests/test_sharded_input.py);
- ``probe_uniq_bucket`` equals the JAX one;
- ``fixed_shape`` batches (and sharded ones) equal the JAX
  ``batch_iterator``'s, array for array, on the C++ fast path at
  ``host_threads`` 1 and 4 (fixed-shape input takes the serial builder
  whatever ``host_threads`` says) and on the generic path (weight
  files);
  ``empty_batch`` equals the JAX filler;
- the ``uniq_bucket`` spill contract of
  ``tests/test_sharded_input.py::test_uniq_bucket_spill``, held as a
  contract (every example once, every batch one static shape, more
  batches than without spills) on the C++ path at ``host_threads`` 1
  and 4 and on the generic path (a tolerant ``bad_line_policy`` routes there: the
  port has no fallback from a failing builder, which the JAX test's
  ``[True]`` case relies on); a bucket too small for one example raises.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis",
                    reason="hypothesis not installed in this container")
from hypothesis import given, settings, strategies as st  # noqa: E402

from fast_tffm_tpu.config import FmConfig as JaxConfig  # noqa: E402
from fast_tffm_tpu.data import pipeline as jax_pipeline  # noqa: E402
from fast_tffm_tpu_torch.config import FmConfig  # noqa: E402
from fast_tffm_tpu_torch.data import pipeline  # noqa: E402

KEYS = ("labels", "weights", "uniq_ids", "local_idx", "vals", "fields")


@settings(max_examples=40, deadline=None)
@given(lines=st.lists(st.text(alphabet=st.characters(
    blacklist_characters="\n\r", blacklist_categories=("Cs",)),
    max_size=24), max_size=40),
    num_shards=st.integers(1, 5), trailing_newline=st.booleans(),
    keep_empty=st.booleans())
def test_sharded_lines_equal_the_jax_ones(tmp_path_factory, lines,
                                          num_shards, trailing_newline,
                                          keep_empty):
    tmp = tmp_path_factory.mktemp("p")
    content = "\n".join(lines) + ("\n" if trailing_newline and lines else "")
    p = tmp / "f.txt"
    p.write_text(content, encoding="utf-8")
    path = str(p)
    merged = []
    for i in range(num_shards):
        assert pipeline.shard_byte_range(path, i, num_shards) == \
            jax_pipeline.shard_byte_range(path, i, num_shards)
        want = list(jax_pipeline._iter_lines([path], (), i, num_shards,
                                             keep_empty=keep_empty))
        got = list(pipeline._iter_lines([path], (), keep_empty=keep_empty,
                                        shard_index=i,
                                        num_shards=num_shards))
        assert [g[:2] for g in got] == [w[:2] for w in want]
        # The port carries the absolute line number the JAX package
        # resolves on its error path.
        assert [g[2] for g in got] == [
            jax_pipeline._source_lineno(w[2]) for w in want]
        merged.extend(g[0] for g in got)
    assert len(merged) == len(list(pipeline._iter_lines(
        [path], (), keep_empty=keep_empty)))


def test_weighted_shards_equal_the_jax_ones(tmp_path):
    data, wts = tmp_path / "d.txt", tmp_path / "w.txt"
    rng = np.random.default_rng(5)
    lines = ["" if i % 13 == 7 else f"1 {i}:1" for i in range(97)]
    data.write_text("\n".join(lines) + "\n")
    wts.write_text("\n".join(f"{rng.random() + 0.5:.3f}"
                             for _ in lines) + "\n")
    for n in (2, 3, 5):
        for i in range(n):
            want = list(jax_pipeline._iter_lines([str(data)], [str(wts)],
                                                 i, n))
            got = list(pipeline._iter_lines([str(data)], [str(wts)],
                                            shard_index=i, num_shards=n))
            assert [g[:2] for g in got] == [w[:2] for w in want]


def _write(tmp_path, n=300, vocab=4096, seed=0, name="t.txt", ffm=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 29 == 11:
            out.append("")
            continue
        k = int(rng.integers(1, 14))
        ids = rng.integers(0, vocab, size=k)
        toks = [str(int(rng.random() < 0.4))]
        for fid in ids:
            toks.append(f"{int(rng.integers(0, 3))}:{fid}:{rng.random():.3f}"
                        if ffm else f"{fid}:{rng.random():.3f}")
        out.append(" ".join(toks))
    p = tmp_path / name
    p.write_text("\n".join(out) + "\n")
    return str(p)


def _cfgs(**kw):
    base = dict(vocabulary_size=4096, factor_num=4, batch_size=32,
                bucket_ladder=(8, 16), max_features_per_example=16,
                shuffle=True, queue_size=96, seed=3)
    base.update(kw)
    return JaxConfig(**base), FmConfig(**base)


def _same(want, got):
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert g.num_real == w.num_real
        for k in KEYS:
            a, b = getattr(w, k), getattr(g, k)
            if a is None or b is None:
                assert a is None and b is None, k
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k


def test_probe_uniq_bucket_equals_the_jax_probe(tmp_path):
    files = [_write(tmp_path, 200, seed=s, name=f"f{s}.txt")
             for s in range(3)]
    for B in (16, 32, 64):
        jcfg, cfg = _cfgs(batch_size=B)
        want = jax_pipeline.probe_uniq_bucket(jcfg, files)
        assert pipeline.probe_uniq_bucket(cfg, files) == want
        assert pipeline.uniq_bucket_top(cfg) == \
            jax_pipeline.uniq_bucket_top(jcfg)


@pytest.mark.parametrize("route", ["serial", "threads4", "generic", "ffm"])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_fixed_shape_batches_equal_the_jax_ones(tmp_path, route, shard):
    files = [_write(tmp_path, 250, seed=1, name="a.txt",
                    ffm=route == "ffm"),
             _write(tmp_path, 90, seed=2, name="b.txt", ffm=route == "ffm")]
    kw = dict(host_threads=4 if route == "threads4" else 1)
    if route == "ffm":
        kw.update(model_type="ffm", field_num=3)
    jcfg, cfg = _cfgs(**kw)
    it_kw = dict(training=True, epochs=2, fixed_shape=True, uniq_bucket=128,
                 shard_index=shard[0], num_shards=shard[1])
    if route == "generic":
        wfiles = []
        for i, f in enumerate(files):
            n = sum(1 for _ in open(f))
            w = tmp_path / f"w{i}.txt"
            w.write_text("\n".join(f"{0.5 + (j % 7) / 10:.2f}"
                                   for j in range(n)) + "\n")
            wfiles.append(str(w))
        it_kw["weight_files"] = wfiles
    jstats, stats = jax_pipeline.SpillStats(), pipeline.SpillStats()
    want = list(jax_pipeline.batch_iterator(jcfg, files, stats=jstats,
                                            **it_kw))
    got = list(pipeline.batch_iterator(cfg, files, stats=stats,
                                       raw_ids=False, **it_kw))
    _same(want, got)
    assert all(b.local_idx.shape == (32, 16) and len(b.uniq_ids) == 128
               for b in got)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.spilled_batches > 0  # the bucket binds on this data


def test_empty_batch_equals_the_jax_filler():
    for kw in ({}, dict(model_type="ffm", field_num=3)):
        jcfg, cfg = _cfgs(**kw)
        _same([jax_pipeline.empty_batch(jcfg, uniq_bucket=128)],
              [pipeline.empty_batch(cfg, uniq_bucket=128)])


def _write_indexed(tmp_path, n, vocab, feats_per_line, seed=0):
    """Line i: label i, feats_per_line distinct ids, so batches map back
    to their source lines."""
    rng = np.random.default_rng(seed)
    lines, per_line = [], []
    for i in range(n):
        ids = rng.choice(vocab, size=feats_per_line, replace=False)
        per_line.append(set(int(x) for x in ids))
        lines.append(" ".join([str(i)] + [f"{j}:0.5" for j in ids]))
    p = tmp_path / "train.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p), per_line


def _examples(batches):
    out = {}
    for b in batches:
        for r in range(b.num_real):
            mask = b.vals[r] != 0
            key = int(b.labels[r])
            assert key not in out, "example emitted twice"
            out[key] = set(int(x) for x in b.uniq_ids[b.local_idx[r][mask]])
    return out


@pytest.mark.parametrize("route", ["serial", "threads4", "generic"])
def test_uniq_bucket_spill(tmp_path, route):
    """A deliberately small unique bucket: batches close early (spill),
    every example still trains exactly once, every batch keeps the same
    static shapes — on the C++ paths and the generic one."""
    path, per_line = _write_indexed(tmp_path, n=60, vocab=100_000,
                                    feats_per_line=8, seed=2)
    kw = dict(vocabulary_size=100_000, batch_size=16, shuffle=False,
              max_features_per_example=8, bucket_ladder=(8,),
              host_threads=4 if route == "threads4" else 1)
    if route == "generic":
        kw["bad_line_policy"] = "skip"
    cfg = FmConfig(**kw)
    assert pipeline.host_parallel_workers(cfg, fixed_shape=True) == 1
    stats = pipeline.SpillStats()
    # 16 examples x 8 fresh ids would need ~128 uniques; bucket 64
    # closes each batch after ~7 examples.
    batches = list(pipeline.batch_iterator(
        cfg, [path], training=True, epochs=1, fixed_shape=True,
        uniq_bucket=64, raw_ids=False, stats=stats))
    assert all(len(b.uniq_ids) == 64 for b in batches)
    assert all(b.local_idx.shape == (16, 8) for b in batches)
    assert all(b.num_real >= 1 for b in batches)
    assert len(batches) > 60 // 16  # the spill made extra batches
    assert stats.spilled_batches > 0
    assert _examples(batches) == {i: s for i, s in enumerate(per_line)}


def test_uniq_bucket_too_small_for_one_example(tmp_path):
    path, _ = _write_indexed(tmp_path, n=4, vocab=100_000,
                             feats_per_line=8, seed=3)
    for policy in ("error", "skip"):
        cfg = FmConfig(vocabulary_size=100_000, batch_size=4, shuffle=False,
                       max_features_per_example=8, bucket_ladder=(8,),
                       bad_line_policy=policy)
        with pytest.raises(Exception,
                           match="uniq_bucket|max_uniq|unique-row"):
            list(pipeline.batch_iterator(cfg, [path], training=True,
                                         epochs=1, fixed_shape=True,
                                         uniq_bucket=8, raw_ids=False))
