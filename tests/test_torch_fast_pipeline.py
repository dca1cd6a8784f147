"""The port's ``batch_iterator`` (fast_tffm_tpu_torch/data/pipeline.py)
against ``fast_tffm_tpu.data.pipeline.batch_iterator`` with the same
arguments, array for array and dtype for dtype, ``raw_ids`` true and
false, on several files (blank lines, one without its final newline):

- the C++ fast path, ``host_threads`` 1 and 4, shuffle on and off, two
  epochs; and the same stream from the port's plain (pure-Python) one;
- ``keep_empty`` with a ``FileMarks`` ledger;
- the generic path: weight files, ``bad_line_policy`` skip and
  quarantine (the quarantine files byte-equal at one worker, the same
  records at four; the breaker raising with the JAX package's serial
  message after the same batches, at one worker and at four),
  ``max_features_per_example = 0``;
- a parse error names the same file and line on every route;
- the port's leak contract: no ``fmt-build-*`` thread survives a
  completed stream or a closed generator at ``host_threads = 4``.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.data.badlines import BadInputError as JaxBadInputError
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import pipeline
from fast_tffm_tpu_torch.data.badlines import BadInputError

KEYS = ("labels", "weights", "uniq_ids", "local_idx", "vals")


def _lines(seed, n, hashed=False, bad_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 17 == 6:
            out.append(["", "   ", "\t"][i % 3])
            continue
        if bad_every and i % bad_every == bad_every - 1:
            out.append(["1 7:zz", "x 3:1", "1 999:1"][i % 3])
            continue
        toks = [str(int(rng.random() < 0.4))]
        for j in range(int(rng.integers(1, 22))):
            fid = (f"C{j}=v{int(rng.zipf(1.3)) % 70}" if hashed
                   else str(int(rng.integers(0, 300))))
            toks.append(f"{fid}:{rng.random():.4f}")
        out.append(" ".join(toks))
    return out


def _files(wd, hashed=False, bad_every=0, sizes=(130, 75, 160)):
    """One file of each size (0 = an empty file); the last ends without
    its newline."""
    paths = []
    for i, n in enumerate(sizes):
        path = os.path.join(wd, f"part{i}.txt")
        lines = _lines(10 + i, n, hashed, bad_every)
        with open(path, "w") as fh:
            if lines:
                fh.write("\n".join(lines)
                         + ("\n" if i < len(sizes) - 1 else ""))
        paths.append(path)
    return paths


def _weight_files(paths):
    out = []
    for k, path in enumerate(paths):
        with open(path, "rb") as fh:
            n = fh.read().count(b"\n") + 1
        wpath = path + ".w"
        with open(wpath, "w") as fh:
            fh.write("".join(f"{0.25 + ((i * 7 + k) % 9) / 4:.2f}\n"
                             for i in range(n)))
        out.append(wpath)
    return out


def _cfgs(wd, **kw):
    base = dict(vocabulary_size=300, factor_num=4, batch_size=32,
                bucket_ladder=(8, 16, 32), max_features_per_example=16,
                queue_size=200, seed=5, dedup="device",
                model_file=os.path.join(wd, "model", "fm"))
    base.update(kw)
    jbase = dict(base, model_file=os.path.join(wd, "jax", "fm"))
    return JaxConfig(**jbase), FmConfig(**base)


def _assert_same(want, got):
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert g.num_real == w.num_real
        assert getattr(w, "fields", None) is None
        for k in KEYS:
            a, b = getattr(w, k), getattr(g, k)
            if a is None or b is None:
                assert a is None and b is None, k
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k


def _both(jcfg, cfg, files, **kw):
    want = list(jax_pipeline.batch_iterator(jcfg, files, **kw))
    got = list(pipeline.batch_iterator(cfg, files, **kw))
    _assert_same(want, got)
    return got


@pytest.mark.parametrize("host_threads", [1, 4])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("raw_ids", [True, False])
def test_fast_path_matches_jax(tmp_path, host_threads, shuffle, raw_ids):
    files = _files(str(tmp_path), hashed=True)
    jcfg, cfg = _cfgs(str(tmp_path), vocabulary_size=1 << 20,
                      hash_feature_id=True, shuffle=shuffle,
                      host_threads=host_threads)
    got = _both(jcfg, cfg, files, training=True, epochs=2, seed=9,
                raw_ids=raw_ids)
    assert {b.local_idx.shape[1] for b in got} <= {8, 16, 32}
    if raw_ids:
        plain = list(pipeline.plain_batch_iterator(cfg, files, epochs=2,
                                                   seed=9))
        _assert_same(plain, got)


@pytest.mark.parametrize("host_threads", [1, 4])
@pytest.mark.parametrize("raw_ids", [True, False])
def test_keep_empty_with_file_marks_matches_jax(tmp_path, host_threads,
                                                raw_ids):
    files = _files(str(tmp_path), sizes=(40, 0, 75, 33))
    jcfg, cfg = _cfgs(str(tmp_path), host_threads=host_threads)
    jmarks, marks = jax_pipeline.FileMarks(), pipeline.FileMarks()
    kw = dict(training=False, epochs=1, keep_empty=True, raw_ids=raw_ids)
    want = list(jax_pipeline.batch_iterator(jcfg, files, file_marks=jmarks,
                                            **kw))
    got = list(pipeline.batch_iterator(cfg, files, file_marks=marks, **kw))
    _assert_same(want, got)
    assert marks.snapshot() == jmarks.snapshot()
    assert [s for _, s in marks.snapshot()] == [0, 40, 40, 115]
    if raw_ids:
        _assert_same(got, list(pipeline.plain_batch_iterator(
            cfg, files, training=False, keep_empty=True)))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("raw_ids", [True, False])
def test_weight_files_match_jax(tmp_path, shuffle, raw_ids):
    files = _files(str(tmp_path))
    weights = _weight_files(files)
    jcfg, cfg = _cfgs(str(tmp_path), shuffle=shuffle, host_threads=4)
    got = _both(jcfg, cfg, files, training=True, epochs=2,
                weight_files=weights, raw_ids=raw_ids)
    assert len({float(w) for b in got for w in b.weights}) > 3


@pytest.mark.parametrize("host_threads", [1, 4])
@pytest.mark.parametrize("policy", ["skip", "quarantine"])
@pytest.mark.parametrize("raw_ids", [True, False])
def test_tolerant_policies_match_jax(tmp_path, host_threads, policy,
                                     raw_ids):
    files = _files(str(tmp_path), bad_every=40)
    jcfg, cfg = _cfgs(str(tmp_path), bad_line_policy=policy,
                      max_bad_fraction=0.5, host_threads=host_threads,
                      shuffle=True)
    _both(jcfg, cfg, files, training=True, epochs=2, raw_ids=raw_ids)
    if policy == "quarantine":
        with open(jcfg.model_file + ".quarantine", "rb") as fh:
            want = fh.read()
        with open(cfg.model_file + ".quarantine", "rb") as fh:
            got = fh.read()
        assert want.count(b"\n") > 3
        if host_threads == 1:
            assert got == want
        else:  # records may interleave across workers in both packages
            assert sorted(got.splitlines()) == sorted(want.splitlines())


@pytest.mark.parametrize("host_threads", [1, 4])
def test_breaker_raises_at_the_same_line(tmp_path, host_threads):
    """The port accounts each chunk's bad lines in stream order, so at
    four workers it trips where the JAX package's serial stream trips,
    with its message; the JAX package's four workers record in no fixed
    order, so its message there is held only to naming a worst file."""
    files = _files(str(tmp_path), bad_every=9)
    jcfg, cfg = _cfgs(str(tmp_path), bad_line_policy="skip",
                      max_bad_fraction=0.05, host_threads=host_threads)
    jserial = dataclasses.replace(jcfg, host_threads=1)
    out = []
    for mod, c, err in ((jax_pipeline, jserial, JaxBadInputError),
                        (jax_pipeline, jcfg, JaxBadInputError),
                        (pipeline, cfg, BadInputError)):
        seen = []
        it = mod.batch_iterator(c, files, training=False, raw_ids=True)
        try:
            with pytest.raises(err) as e:
                for b in it:
                    seen.append(b)
        finally:
            it.close()
        out.append((seen, str(e.value)))
    (jseen, jmsg), (_, jmsg_now), (pseen, pmsg) = out
    assert "worst file: " + files[0] in pmsg and "worst file: " in jmsg_now
    assert pmsg == jmsg
    assert len(pseen) == len(jseen)
    if jseen:
        _assert_same(jseen, pseen)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("raw_ids", [True, False])
def test_unlimited_features_take_the_generic_path(tmp_path, shuffle,
                                                  raw_ids):
    files = _files(str(tmp_path))
    with open(files[1], "a") as fh:
        fh.write("1 " + " ".join(f"{j}:1" for j in range(100)) + "\n")
    jcfg, cfg = _cfgs(str(tmp_path), max_features_per_example=0,
                      shuffle=shuffle, host_threads=4)
    got = _both(jcfg, cfg, files, training=True, epochs=2, raw_ids=raw_ids)
    assert max(b.local_idx.shape[1] for b in got) == 128


@pytest.mark.parametrize("route", ["serial", "parallel", "generic"])
def test_parse_error_names_the_same_file_and_line(tmp_path, route):
    files = _files(str(tmp_path))
    with open(files[2]) as fh:
        lines = fh.read().split("\n")
    lines[40] = "1 5:x"
    with open(files[2], "w") as fh:
        fh.write("\n".join(lines))
    kw = dict(serial=dict(host_threads=1), parallel=dict(host_threads=4),
              generic=dict(max_features_per_example=0))[route]
    jcfg, cfg = _cfgs(str(tmp_path), **kw)
    msgs = []
    for mod, c in ((jax_pipeline, jcfg), (pipeline, cfg)):
        with pytest.raises(ValueError) as e:
            list(mod.batch_iterator(c, files, training=False,
                                    raw_ids=True))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert msgs[1].startswith(f"{files[2]} line 41: ")


def test_no_build_thread_survives(tmp_path):
    files = _files(str(tmp_path))

    def leaked():
        return [t for t in threading.enumerate()
                if t.name.startswith("fmt-build") and t.is_alive()]

    _, cfg = _cfgs(str(tmp_path), host_threads=4)
    assert pipeline.host_parallel_workers(cfg) == 4
    list(pipeline.batch_iterator(cfg, files, training=True, epochs=2))
    assert not leaked()
    it = pipeline.batch_iterator(cfg, files, training=True)
    next(it)
    assert leaked()
    it.close()
    assert not leaked()
    # Abandoned behind prefetch: the prefetch thread closes it.
    it = pipeline.prefetch(pipeline.batch_iterator(cfg, files), depth=2)
    next(it)
    it.close()
    for t in threading.enumerate():
        if t.name == "prefetch":
            t.join(timeout=30)
    assert not leaked()
    # The generic tolerant pool as well.
    tcfg = dataclasses.replace(cfg, bad_line_policy="skip")
    it = pipeline.batch_iterator(tcfg, files)
    next(it)
    it.close()
    assert not leaked()


def test_stream_options_still_refused(tmp_path):
    """The sharded and fixed-shape streams are ported (held to the JAX
    package in tests/test_torch_dist_input.py); what stays refused is
    what the JAX package refuses: a fixed shape over raw ids, and a
    FileMarks ledger outside a single in-order keep_empty pass.
    uniq_bucket on one unsharded stream is inert, as there."""
    jcfg, cfg = _cfgs(str(tmp_path))
    files = _files(str(tmp_path))
    _both(jcfg, cfg, files, num_shards=2, shard_index=1, raw_ids=True)
    with pytest.raises(ValueError, match="no fixed-U protocol"):
        next(pipeline.batch_iterator(cfg, files, fixed_shape=True,
                                     raw_ids=True))
    _assert_same(list(pipeline.batch_iterator(cfg, files)),
                 list(pipeline.batch_iterator(
                     dataclasses.replace(cfg, uniq_bucket=512), files)))
    with pytest.raises(ValueError, match="file_marks requires"):
        next(pipeline.batch_iterator(cfg, files,
                                     file_marks=pipeline.FileMarks()))
