"""Weight carry-across (fast_tffm_tpu_torch/models/convert.py): a table
exported by the JAX package loads into the port and scores the same
batches; the port's export loads back unchanged.

Scores are held at the reference's Pallas-vs-XLA bound, rtol 1e-5 /
atol 1e-6 (tests/test_pallas_fm.py): both sides accumulate in f32, in
different orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import export_npz
from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.data.synth import generate, make_ground_truth
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import parse_lines
from fast_tffm_tpu_torch.data.pipeline import make_device_batch
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.models import fm as port_fm


def _kw(vocab, k, hashed):
    return dict(vocabulary_size=vocab, factor_num=k, hash_feature_id=hashed,
                bucket_ladder=(8, 16, 32, 64), batch_size=64)


def _numpy_table(vocab, k, seed):
    rng = np.random.default_rng(seed)
    t = (rng.normal(size=(vocab + 1, k + 1)) * 0.1).astype(np.float32)
    t[-1] = 0.0
    return t


def _jax_scores(kw, table, batch):
    jcfg = JaxConfig(kernel="pallas", dedup="device", **kw)
    fn = jax_fm.make_score_fn(jax_fm.ModelSpec.from_config(jcfg))
    return np.asarray(fn(jnp.asarray(table), None,
                         jnp.asarray(batch.local_idx),
                         jnp.asarray(batch.vals)))


@pytest.mark.parametrize("vocab,k,hashed", [(200, 8, False),
                                            (4096, 16, True)])
def test_jax_export_scores_the_same_in_the_port(tmp_path, vocab, k, hashed):
    kw = _kw(vocab, k, hashed)
    table = _numpy_table(vocab, k, seed=vocab)
    path = str(tmp_path / "fm_model.npz")
    export_npz(jnp.asarray(table), path, vocabulary_size=vocab)
    cfg = FmConfig(**kw)
    port_table = convert.load_npz(path, cfg, torch.device("cpu"))
    assert port_table.shape == (cfg.num_rows, cfg.row_dim)
    assert port_table.dtype == torch.float32
    assert np.array_equal(port_table.numpy(), table)
    if hashed:
        lines = generate(200, 3, make_ground_truth(3))[0]
    else:
        with open("data/sample_test.txt") as fh:
            lines = fh.read().splitlines()[:200]
    spec = port_fm.ModelSpec.from_config(cfg)
    for lo in range(0, len(lines), 64):
        block = parse_lines(lines[lo:lo + 64], vocab, hash_feature_id=hashed,
                            keep_empty=True)
        batch = make_device_batch(block, cfg)
        got = port_fm.score_body(spec, port_table,
                                 torch.from_numpy(batch.local_idx),
                                 torch.from_numpy(batch.vals)).numpy()
        jbatch = jax_pipeline.make_device_batch(
            block, JaxConfig(**kw), raw_ids=True)
        want = _jax_scores(kw, table, jbatch)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_port_export_loads_back_byte_equal(tmp_path):
    cfg = FmConfig(**_kw(300, 8, False))
    table = torch.from_numpy(_numpy_table(300, 8, seed=1))
    path = str(tmp_path / "model" / "fm_model")
    convert.save_npz(table, path, cfg)
    with np.load(path + ".npz") as npz:
        assert npz.files == ["table"]
        arr = npz["table"]
    assert arr.dtype == np.float32 and arr.shape == (300, 9)
    assert arr.tobytes() == table[:300].numpy().tobytes()
    assert np.array_equal(
        convert.load_npz(path + ".npz", cfg, torch.device("cpu")).numpy(),
        table.numpy())


def test_table_layouts_accepted(tmp_path):
    cfg = FmConfig(**_kw(100, 4, False))
    full = _numpy_table(100, 4, seed=2)
    full[-1] = 7.0  # a live value in the pad row is zeroed on load
    ckpt = np.zeros((cfg.ckpt_rows, 5), np.float32)
    ckpt[:101] = full
    for arr in (full[:100], full, ckpt):
        t = convert.table_from_numpy(arr, cfg, torch.device("cpu"))
        assert t.shape == (101, 5)
        assert np.array_equal(t[:100].numpy(), full[:100])
        assert not t[100].any()
    for bad in (full[:, :4], full[:50], full[None]):
        with pytest.raises(ValueError, match="does not fit"):
            convert.table_from_numpy(bad, cfg, torch.device("cpu"))


def test_init_table_distribution_and_pad_row():
    cfg = FmConfig(vocabulary_size=5000, factor_num=8, init_value_range=0.05)
    g = torch.Generator().manual_seed(3)
    t = port_fm.init_table(cfg, torch.device("cpu"), g)
    assert t.shape == (cfg.num_rows, cfg.row_dim)
    assert t.dtype == torch.float32
    assert not t[-1].any()
    body = t[:-1]
    assert body.abs().max() <= 0.05 and body.min() < -0.045
    assert abs(float(body.mean())) < 2e-3
    again = port_fm.init_table(cfg, torch.device("cpu"),
                               torch.Generator().manual_seed(3))
    assert torch.equal(t, again)


def test_spec_matches_the_jax_spec_fields():
    cfg = FmConfig(**_kw(200, 8, False))
    got = dataclasses.asdict(port_fm.ModelSpec.from_config(cfg))
    want = dataclasses.asdict(jax_fm.ModelSpec.from_config(
        JaxConfig(**_kw(200, 8, False))))
    assert got == {k: want[k] for k in got}
    assert port_fm.resolved_kernel(torch.device("cpu")) == "plain"
    assert port_fm.resolved_kernel(torch.device("cuda")) == "cuda"
