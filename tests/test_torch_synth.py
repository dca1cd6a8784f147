"""The port's synthetic CTR data and NumPy trainers
(fast_tffm_tpu_torch/data/synth.py) against ``fast_tffm_tpu.data.synth``
on the same seeds: files byte for byte and metadata equal
(``write_dataset``, ``write_ffm_dataset``), the generative pieces array
for array, the parsed blocks equal, and the trainers' scores equal to
the bit (the same numpy code on the same blocks). Plus the port's
counterpart of ``tests/test_criteo_like.py``'s order-3 oracle check,
and the port's parse refusing where the JAX package falls back."""

import numpy as np
import pytest

from fast_tffm_tpu.data import synth as jax_synth
from fast_tffm_tpu_torch.data import cparser, synth
from fast_tffm_tpu_torch.models.oracle import fm_score

N_TRAIN, N_TEST = 3000, 1000
VOCAB = 1 << 16


def _same(a, b):
    """Equal to the bit, recursively through tuples, lists, dicts and
    dataclasses."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for name in a.__dataclass_fields__:
            _same(getattr(a, name), getattr(b, name))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("name", [
    "CAT_VOCABS", "NUM_FIELDS", "ZIPF_A", "PAIR_RANK", "N_PAIRS",
    "FFM_FIELDS", "FFM_FIELD_OFFSETS", "FFM_PAIR_RANK", "FFM_N_PAIRS"])
def test_constants_equal(name):
    _same(getattr(jax_synth, name), getattr(synth, name))


def _draw(m, seed):
    return m._draw_ids(np.random.default_rng(seed), 500)


def _logits(m, seed):
    gt = m.make_ground_truth(seed)
    rng = np.random.default_rng(seed + 9)
    ids = m._draw_ids(rng, 400)
    num_z = np.round(np.log1p(rng.lognormal(1.0, 1.2, (400, 13))), 3)
    return m.logits_for(gt, ids, num_z)


GENERATORS = {
    "make_ground_truth": lambda m, s: m.make_ground_truth(s),
    "draw_ids": _draw,
    "logits_for": _logits,
    "generate": lambda m, s: m.generate(700, s + 1, m.make_ground_truth(s)),
    "make_ffm_truth": lambda m, s: m._make_ffm_truth(s),
    "ffm_generate": lambda m, s: m._ffm_generate(
        300, s + 1, m._make_ffm_truth(s)),
    "ffm_vocab_size": lambda m, s: m.ffm_vocab_size(),
}


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal(name, seed):
    _same(GENERATORS[name](jax_synth, seed), GENERATORS[name](synth, seed))


def _write(m, tmp, kind, seed):
    d = tmp / m.__name__.split(".")[0]
    d.mkdir()
    train, test = str(d / "train.txt"), str(d / "test.txt")
    write = m.write_ffm_dataset if kind == "ffm" else m.write_dataset
    meta = write(train, test, N_TRAIN, N_TEST, seed=seed)
    return train, test, meta


@pytest.mark.parametrize("seed", [3, 17])
@pytest.mark.parametrize("kind", ["fm", "ffm"])
def test_written_files_are_byte_equal(tmp_path, kind, seed):
    jtrain, jtest, jmeta = _write(jax_synth, tmp_path, kind, seed)
    train, test, meta = _write(synth, tmp_path, kind, seed)
    for a, b in ((jtrain, train), (jtest, test)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            want = fa.read()
            assert fb.read() == want
        assert want.count(b"\n") in (N_TRAIN, N_TEST)
    _same(jmeta, meta)
    assert 0.5 < meta["bayes_auc"] < 1.0


@pytest.fixture(scope="module")
def fm_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("synth_fm")
    train, test = str(tmp / "train.txt"), str(tmp / "test.txt")
    meta = synth.write_dataset(train, test, N_TRAIN, N_TEST, seed=17)
    return train, test, meta


@pytest.fixture(scope="module")
def ffm_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("synth_ffm")
    train, test = str(tmp / "train.txt"), str(tmp / "test.txt")
    synth.write_ffm_dataset(train, test, N_TRAIN, N_TEST, seed=5)
    return train, test


BLOCK_KEYS = ("labels", "poses", "ids", "vals", "fields")


@pytest.mark.parametrize("batch_size", [256, 1000])
def test_parse_file_blocks_equal(fm_files, batch_size):
    train, test, _ = fm_files
    for path in (train, test):
        want = jax_synth.parse_file_blocks(path, VOCAB, batch_size)
        got = synth.parse_file_blocks(path, VOCAB, batch_size)
        assert len(got) == len(want) == -(-(
            N_TRAIN if path == train else N_TEST) // batch_size)
        for w, g in zip(want, got):
            assert g.batch_size == w.batch_size
            for key in BLOCK_KEYS:
                _same(getattr(w, key), getattr(g, key))


@pytest.mark.parametrize("batch_size", [256, 1000])
def test_parse_ffm_file_equal(ffm_files, batch_size):
    for path in ffm_files:
        _same(jax_synth.parse_ffm_file(path, batch_size),
              synth.parse_ffm_file(path, batch_size))


def test_parse_ffm_file_refuses_a_torn_line(tmp_path):
    path = tmp_path / "torn.txt"
    F = len(synth.FFM_FIELDS)
    path.write_text("1 " + " ".join(f"{f}:{f}" for f in range(F)) + "\n"
                    + "0 0:1 0:2\n")
    with pytest.raises(ValueError, match="field 0 appears twice"):
        synth.parse_ffm_file(str(path), 4)


def test_parse_file_blocks_has_no_python_fallback(fm_files, monkeypatch):
    """Where the JAX package's block parse falls back to its Python
    parser, the port's raises (it has no parser fallback)."""
    def unusable(*args, **kwargs):
        raise OSError("C++ parser library unusable")
    monkeypatch.setattr(cparser, "parse_lines_fast", unusable)
    with pytest.raises(OSError, match="unusable"):
        synth.parse_file_blocks(fm_files[0], VOCAB, 256)


@pytest.mark.parametrize("order", [2, 3])
def test_numpy_fm_trainer_scores_equal(fm_files, order):
    train, test, _ = fm_files
    tr = synth.parse_file_blocks(train, VOCAB, 256)
    te = synth.parse_file_blocks(test, VOCAB, 256)
    kw = dict(vocab=VOCAB, k=4, lr=0.05, epochs=2, factor_lambda=1e-6,
              bias_lambda=1e-6, order=order)
    want = jax_synth.numpy_fm_train_predict(tr, te, **kw)
    got = synth.numpy_fm_train_predict(tr, te, **kw)
    assert got.shape == (N_TEST,) and np.isfinite(got).all()
    _same(want, got)


def test_numpy_ffm_trainer_scores_equal(ffm_files):
    tr = synth.parse_ffm_file(ffm_files[0], 256)
    te = synth.parse_ffm_file(ffm_files[1], 256)
    kw = dict(vocab=synth.ffm_vocab_size(), k=4, lr=0.05, epochs=2,
              factor_lambda=1e-6, bias_lambda=1e-6)
    want = jax_synth.numpy_ffm_train_predict(tr, te, **kw)
    got = synth.numpy_ffm_train_predict(tr, te, **kw)
    assert got.shape == (N_TEST,) and np.isfinite(got).all()
    _same(want, got)


@pytest.mark.parametrize("order", [2, 3])
def test_fm_forward_equal(rng, order):
    z = rng.normal(0.0, 0.7, size=(5, 7, 3))
    _same(jax_synth._fm_forward(z, order), synth._fm_forward(z, order))


def test_fm_forward_refuses_order_4(rng):
    with pytest.raises(ValueError, match="order 2 or 3"):
        synth._fm_forward(rng.normal(size=(2, 3, 2)), 4)


def test_pad_batches_equal(fm_files):
    blocks = synth.parse_file_blocks(fm_files[1], VOCAB, 300)
    _same(list(jax_synth._pad_batches(blocks, 48, VOCAB)),
          list(synth._pad_batches(blocks, 48, VOCAB)))


def test_numpy_oracle_order3_forward_and_grad(rng):
    """The port's trainer-oracle order-3 math against the independent
    per-example ANOVA-DP oracle (the port's ``models/oracle.fm_score``),
    and its dz gradient against central differences — the counterpart
    of ``tests/test_criteo_like.py::test_numpy_oracle_order3_forward_and_grad``."""
    B, L, k = 5, 7, 3
    z = rng.normal(0.0, 0.7, size=(B, L, k))
    inter, dz = synth._fm_forward(z, order=3)
    # forward: ANOVA degrees 2..3 summed over latent dims; fm_score
    # computes the same from (v, x) — use x=1 so z == v
    table = np.zeros((L, k + 1))
    for b in range(B):
        table[:, :k] = z[b]
        want = fm_score(table, np.arange(L), np.ones(L), order=3)
        assert inter[b].sum() == pytest.approx(want, rel=1e-9)
    # gradient: central differences on the summed interaction
    eps = 1e-6
    for (b, l, f) in ((0, 0, 0), (2, 3, 1), (4, 6, 2)):
        zp, zm = z.copy(), z.copy()
        zp[b, l, f] += eps
        zm[b, l, f] -= eps
        num = (synth._fm_forward(zp, 3)[0][b].sum()
               - synth._fm_forward(zm, 3)[0][b].sum()) / (2 * eps)
        assert dz[b, l, f] == pytest.approx(num, rel=1e-5)
