"""The port's C++ parser (fast_tffm_tpu_torch/data/cparser.py and its
copy of _parser.cc) against the JAX package's, on the same bytes:
``parse_lines_fast``, ``scan_examples``, ``parse_lines_salvage``,
``dedup_ids_fast`` and ``BatchBuilder`` outputs equal array for array,
and equal to what the port's pure-Python ``parse_lines`` and
``make_device_batch`` give. Inputs cover hashed ids, ``keep_empty``,
field-aware tokens, over-long examples and chunks cut mid-line. Also:
the two ``_parser.cc`` files are byte-identical; the library builds into
``fast_tffm_tpu_torch/_build/``; a stale ABI under the current name is
rebuilt; and without a compiler ``batch_iterator`` raises instead of
parsing in Python."""

import os
import subprocess

import numpy as np
import pytest

from fast_tffm_tpu.data import cparser as jax_cparser
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import cparser, parser, pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(seed, n=300, hashed=False, field_aware=False, blanks=True,
           nnz_hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if blanks and i % 13 == 5:
            out.append(["", "  \t", "\r"][i % 3])
            continue
        toks = [str(int(rng.random() < 0.4))]
        for j in range(int(rng.integers(0, nnz_hi))):
            fid = (f"C{j}=v{int(rng.zipf(1.3)) % 90}" if hashed
                   else str(int(rng.integers(0, 300))))
            tok = fid if rng.random() < 0.3 else f"{fid}:{rng.random():.4f}"
            if field_aware:
                tok = f"{int(rng.integers(0, 3))}:{tok}"
            toks.append(tok)
        out.append(" ".join(toks))
    return out


_PARSE_CASES = {
    "plain": (dict(), dict(vocabulary_size=300)),
    "hashed": (dict(hashed=True),
               dict(vocabulary_size=1 << 24, hash_feature_id=True)),
    "keep_empty": (dict(), dict(vocabulary_size=300, keep_empty=True)),
    "field_aware": (dict(field_aware=True),
                    dict(vocabulary_size=300, field_aware=True,
                         field_num=3)),
    "over_long": (dict(nnz_hi=40),
                  dict(vocabulary_size=300, max_features_per_example=7)),
}


def _assert_blocks_equal(a, b):
    for name in ("labels", "poses", "ids", "vals", "fields"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def test_parser_source_is_a_byte_copy():
    with open(os.path.join(REPO, "fast_tffm_tpu", "data", "_parser.cc"),
              "rb") as a, open(cparser._SRC, "rb") as b:
        assert a.read() == b.read()


def test_library_builds_into_the_port_build_dir():
    path = cparser.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "fast_tffm_tpu_torch", "_build")
    assert os.path.basename(path).startswith("lib_parser-")
    lib = cparser._load()
    assert os.path.isfile(path)
    assert lib.fm_abi_version() == 7
    assert cparser.auto_threads() >= 1 and cparser.available()


@pytest.mark.parametrize("case", sorted(_PARSE_CASES))
def test_parse_lines_fast_matches(case):
    gen_kw, kw = _PARSE_CASES[case]
    lines = _lines(3, **gen_kw)
    want = jax_cparser.parse_lines_fast(lines, **kw)
    got = cparser.parse_lines_fast(lines, **kw)
    _assert_blocks_equal(want, got)
    _assert_blocks_equal(got, parser.parse_lines(lines, **kw))


@pytest.mark.parametrize("bad", ["x 1:1", "1 abc:1", "1 5:zz", "1 999:1",
                                 "1 1:2:3"])
def test_parse_errors_and_salvage_match(bad):
    lines = _lines(4, n=40) + [bad] + _lines(5, n=20)
    with pytest.raises(ValueError) as want:
        jax_cparser.parse_lines_fast(lines, 300)
    with pytest.raises(parser.ParseError) as got:
        cparser.parse_lines_fast(lines, 300)
    assert str(got.value) == str(want.value)
    for keep_empty in (False, True):
        jbad, pbad = [], []
        _assert_blocks_equal(
            jax_cparser.parse_lines_salvage(lines, 300, keep_empty=keep_empty,
                                            bad_lines=jbad),
            cparser.parse_lines_salvage(lines, 300, keep_empty=keep_empty,
                                        bad_lines=pbad))
        assert pbad == jbad and len(pbad) == 1


def test_scan_examples_matches():
    blob = ("\n".join(_lines(6, n=120)) + "\n").encode()
    for keep_empty in (False, True):
        for n_target in (1, 7, 64, 500):
            for offset in (0, 1, 37, len(blob) // 2):
                for cut in (len(blob), len(blob) - 5, len(blob) // 3):
                    data = blob[:cut]
                    args = (data, n_target, keep_empty)
                    assert cparser.scan_examples(*args, offset=offset) == \
                        jax_cparser.scan_examples(*args, offset=offset)


@pytest.mark.parametrize("n", [0, 1, 5, 1000])
def test_dedup_ids_fast_matches(n):
    rng = np.random.default_rng(n)
    ids = (rng.zipf(1.3, size=n) % 5000).astype(np.int32)
    want_u, want_inv = jax_cparser.dedup_ids_fast(ids)
    got_u, got_inv = cparser.dedup_ids_fast(ids)
    plain_u, plain_inv = pipeline.first_occurrence_unique(ids)
    for a, b in ((want_u, got_u), (want_inv, got_inv), (got_u, plain_u),
                 (got_inv, plain_inv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got_u[got_inv], ids)


def _build_all(mod, blob, chunks, B, **kw):
    """Every finish() tuple of a builder fed ``chunks`` (whose join is
    ``blob``), re-feeding each unconsumed tail as the pipeline does."""
    bb = mod.BatchBuilder(B, 16, kw.pop("vocab"), **kw)
    out, tail = [], b""
    for c in chunks:
        data, off = tail + c, 0
        while True:
            full, consumed = bb.feed(data, off)
            off += consumed
            if not full:
                break
            out.append(bb.finish())
        tail = data[off:]
    if tail:
        bb.feed(tail + b"\n")
    final = bb.finish()
    if final[0]:
        out.append(final)
    return out


_BUILDER_CASES = {
    "raw": dict(raw_ids=True),
    "host": dict(),
    "raw_keep_empty": dict(raw_ids=True, keep_empty=True),
    "host_keep_empty_threads": dict(keep_empty=True, num_threads=3),
    "hashed_raw": dict(raw_ids=True, hash_feature_id=True),
    "over_long_host": dict(max_features_per_example=5),
}


@pytest.mark.parametrize("case", sorted(_BUILDER_CASES))
def test_batch_builder_matches_jax_and_plain(case):
    kw = dict(_BUILDER_CASES[case])
    hashed = kw.get("hash_feature_id", False)
    vocab = 1 << 24 if hashed else 300
    lines = _lines(7, n=150, hashed=hashed)
    blob = ("\n".join(lines)).encode()  # no final newline
    chunks = [blob[i:i + 97] for i in range(0, len(blob), 97)]  # mid-line
    B = 32
    want = _build_all(jax_cparser, blob, [blob], B, vocab=vocab, **kw)
    got = _build_all(cparser, blob, chunks, B, vocab=vocab, **kw)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        n = g[0]
        assert n == w[0] and g[6] == w[6]
        assert np.array_equal(g[1][:n], w[1][:n])
        for i in (3, 4):
            assert np.array_equal(g[i], w[i])
        if w[2] is None:
            assert g[2] is None
        else:
            assert np.array_equal(g[2], w[2]) and g[2][0] == vocab
    # The plain version: the same lines through the pure-Python parser
    # and make_device_batch hold the same rows and values.
    keep_empty = kw.get("keep_empty", False)
    kept = [ln for ln in lines if keep_empty or ln.strip(parser.WHITESPACE)]
    cfg = FmConfig(vocabulary_size=vocab, hash_feature_id=hashed,
                   bucket_ladder=(4, 8, 16),
                   max_features_per_example=kw.get(
                       "max_features_per_example", 16))
    for i, g in enumerate(got):
        block = parser.parse_lines(
            kept[i * B:(i + 1) * B], vocab, hash_feature_id=hashed,
            keep_empty=keep_empty,
            max_features_per_example=cfg.max_features_per_example)
        plain = pipeline.make_device_batch(block, cfg, B)
        n, L = g[0], plain.local_idx.shape[1]
        assert n == plain.num_real
        rows = g[3] if g[2] is None else g[2][g[3]]
        assert np.array_equal(rows[:, :L], plain.local_idx)
        assert (rows[:, L:] == vocab).all()
        assert np.array_equal(g[4][:, :L], plain.vals)
        assert np.array_equal(g[1][:n], plain.labels[:n])


def test_host_dedup_device_batch_matches_jax():
    from fast_tffm_tpu.config import FmConfig as JaxConfig
    from fast_tffm_tpu.data import pipeline as jax_pipeline
    lines = _lines(8, n=90, hashed=True)
    kw = dict(vocabulary_size=1 << 24, hash_feature_id=True,
              bucket_ladder=(4, 8, 16))
    block = parser.parse_lines(lines, 1 << 24, hash_feature_id=True)
    w = np.linspace(0.5, 2.0, block.batch_size).astype(np.float32)
    want = jax_pipeline.make_device_batch(block, JaxConfig(**kw), weights=w,
                                          batch_size=128)
    for dedup in (pipeline.first_occurrence_unique, cparser.dedup_ids_fast):
        got = pipeline.make_device_batch(block, FmConfig(**kw), 128,
                                         weights=w, raw_ids=False,
                                         dedup=dedup)
        for name in ("labels", "weights", "uniq_ids", "local_idx", "vals"):
            a, b = getattr(want, name), getattr(got, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def _stub_library(path):
    """A library with every symbol of the parser but ABI version 6."""
    src = str(path) + ".c"
    with open(src, "w") as fh:
        fh.write("long long fm_abi_version(void) { return 6; }\n")
        for name in cparser._SYMBOLS[1:]:
            fh.write(f"int {name}(void) {{ return 0; }}\n")
    subprocess.run(["g++", "-x", "c", "-shared", "-fPIC", "-o", str(path),
                    src], check=True, capture_output=True)


def test_stale_abi_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(cparser, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cparser, "_lib", None)
    path = cparser.library_path()
    assert path.startswith(str(tmp_path))
    _stub_library(path)
    lib = cparser._load()
    assert lib.fm_abi_version() == 7
    assert not [f for f in os.listdir(tmp_path) if ".reload." in f
                or f.endswith(".tmp")]
    block = cparser.parse_lines_fast(["1 3:2"], 300)
    assert block.ids.tolist() == [3] and block.vals.tolist() == [2.0]


def test_without_a_compiler_batch_iterator_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cparser, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cparser, "_lib", None)
    monkeypatch.setattr(cparser, "CXX", str(tmp_path / "missing" / "g++"))
    data = tmp_path / "d.txt"
    data.write_text("1 3:1\n0 4:1\n")
    cfg = FmConfig(vocabulary_size=300, batch_size=4, shuffle=False)
    for kw in (dict(), dict(keep_empty=True, training=False)):
        with pytest.raises(RuntimeError, match="cannot run"):
            next(pipeline.batch_iterator(cfg, [str(data)], **kw))
    # The generic path's block parse does not fall back either.
    with pytest.raises(RuntimeError, match="C.. parser unavailable"):
        next(pipeline.batch_iterator(
            FmConfig(vocabulary_size=300, batch_size=4,
                     max_features_per_example=0), [str(data)]))
    assert not os.listdir(tmp_path / "build")
