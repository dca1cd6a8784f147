"""The port's input path (hashing, the line parser, raw-ids batch
assembly) against the JAX package's, array for array and dtype for
dtype: same lines in, same arrays out."""

import dataclasses

import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data import hashing as jax_hashing
from fast_tffm_tpu.data import parser as jax_parser
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.data.synth import generate, make_ground_truth
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import hashing, parser, pipeline

SAMPLE = "data/sample_test.txt"


def _sample_lines():
    with open(SAMPLE) as fh:
        return fh.read().splitlines()


def _criteo_lines(n=300, seed=4):
    lines, _, _ = generate(n, seed, make_ground_truth(seed))
    return lines


def _assert_blocks_equal(a, b):
    for name in ("labels", "poses", "ids", "vals"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name
    assert b.fields is None


@pytest.mark.parametrize("fid", ["", "a", "C3=v17", "12345678",
                                 "123456789", "héllo wörld", "x" * 40])
@pytest.mark.parametrize("vocab", [200, 1 << 20, 16777216])
def test_hash_feature_matches(fid, vocab):
    assert hashing.murmur64(fid.encode()) == jax_hashing.murmur64(
        fid.encode())
    assert hashing.hash_feature(fid, vocab) == jax_hashing.hash_feature(
        fid, vocab)


@pytest.mark.parametrize("source,kwargs", [
    ("sample", dict(vocabulary_size=200)),
    ("sample", dict(vocabulary_size=200, max_features_per_example=3)),
    ("criteo", dict(vocabulary_size=16777216, hash_feature_id=True)),
    ("blanks", dict(vocabulary_size=200, keep_empty=True)),
    ("blanks", dict(vocabulary_size=200, keep_empty=False)),
])
def test_parse_lines_matches(source, kwargs):
    if source == "criteo":
        lines = _criteo_lines()
    else:
        lines = _sample_lines()
    if source == "blanks":
        lines = ["", lines[0], "   ", lines[1], "\t", lines[2], ""]
    _assert_blocks_equal(jax_parser.parse_lines(lines, **kwargs),
                         parser.parse_lines(lines, **kwargs))


@pytest.mark.parametrize("bad", ["x 1:1", "1 abc:1", "1 5:zz",
                                 "1 999:1", "1 1:2:3"])
def test_parse_errors_match(bad):
    lines = ["1 3:1.0", bad]
    with pytest.raises(jax_parser.ParseError) as want:
        jax_parser.parse_lines(lines, 200)
    with pytest.raises(parser.ParseError) as got:
        parser.parse_lines(lines, 200)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    jbad, pbad = [], []
    _assert_blocks_equal(
        jax_parser.parse_lines(lines, 200, keep_empty=True, bad_lines=jbad),
        parser.parse_lines(lines, 200, keep_empty=True, bad_lines=pbad))
    assert jbad == pbad


@pytest.mark.parametrize("source,B", [("sample", 512), ("sample", 1024),
                                      ("criteo", 512), ("blanks", 16)])
def test_raw_ids_device_batch_matches(source, B):
    hashed = source == "criteo"
    vocab = 16777216 if hashed else 200
    lines = _criteo_lines() if hashed else _sample_lines()
    if source == "blanks":
        lines = ["", lines[0], "", lines[1]]
    kw = dict(vocabulary_size=vocab, hash_feature_id=hashed,
              bucket_ladder=(8, 16, 32, 64, 128))
    block = parser.parse_lines(lines, vocab, hash_feature_id=hashed,
                               keep_empty=True)
    want = jax_pipeline.make_device_batch(block, JaxConfig(**kw),
                                          batch_size=B, raw_ids=True)
    got = pipeline.make_device_batch(block, FmConfig(**kw), batch_size=B)
    assert want.uniq_ids is None and want.fields is None
    for name in ("labels", "weights", "local_idx", "vals"):
        x, y = getattr(want, name), getattr(got, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    assert got.num_real == want.num_real == len(lines)


def test_ladder_fit_and_bounded_examples_match():
    for n in (1, 7, 8, 9, 39, 64, 65, 256, 257, 1000):
        for ladder in ((8, 16, 32, 64, 128, 256), (4, 48), (64,)):
            assert (pipeline._ladder_fit(n, ladder)
                    == jax_pipeline._ladder_fit(n, ladder))
    for mf in (0, 16, 256, 300):
        kw = dict(max_features_per_example=mf)
        errs = []
        for mod, cfg in ((jax_pipeline, JaxConfig(**kw)),
                         (pipeline, FmConfig(**kw))):
            try:
                mod.require_bounded_examples(cfg, "serving")
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


def test_expand_files_matches(tmp_path):
    for name in ("b.txt", "a.txt", "c.dat"):
        (tmp_path / name).write_text("1 1:1\n")
    pats = [str(tmp_path / "*.txt"), str(tmp_path / "missing.txt"),
            str(tmp_path / "c.dat")]
    assert pipeline.expand_files(pats) == jax_pipeline.expand_files(pats)


def test_device_batch_fields_are_the_raw_ids_subset():
    jax_fields = {f.name for f in dataclasses.fields(
        jax_pipeline.DeviceBatch)}
    port_fields = {f.name for f in dataclasses.fields(pipeline.DeviceBatch)}
    assert port_fields <= jax_fields
