"""The port's cross-file predict sweep (scoring.score_sweep, predict.py)
and its chunked fetcher (utils/fetch.py), on the CPU:

- the score files of one sweep over several files (blank lines, an
  empty file, a file without its final newline, batches that cross file
  boundaries) are byte-identical to the per-file path the port had
  before the sweep (each file alone, ``batch_size`` lines a batch), for
  ``dedup`` device and host and ``host_threads`` 1 and 4;
- the sweep's per-file scores are within rtol 1e-5 / atol 1e-6 of the
  JAX package's ``score_sweep`` on the same table (one numpy array),
  also under ``bad_line_policy = skip``, where a bad line scores as the
  bias and keeps the files line-aligned;
- ``ChunkedFetcher`` keeps add order across chunks, re-raises a
  consumer error at ``flush`` and joins its thread on ``close``;
  ``ScoreWriter`` raises a failed write at ``close``.
"""

import dataclasses
import logging
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu import scoring as jax_scoring
from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu_torch import scoring
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.parser import parse_lines
from fast_tffm_tpu_torch.data.pipeline import make_device_batch
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.utils.fetch import ChunkedFetcher

torch.set_num_threads(1)

VOCAB = 1 << 12


def _write_files(wd, bad=False):
    """Four predict files of 70, 0, 45 and 101 lines: blank lines, an
    empty file, the last without its final newline."""
    rng = np.random.default_rng(31)
    paths = []
    for i, n in enumerate((70, 0, 45, 101)):
        lines = []
        for j in range(n):
            if j % 9 == 4:
                lines.append(["", "  "][j % 2])
            elif bad and j % 23 == 11:
                lines.append("1 C1=v3:zz")
            else:
                toks = [str(int(rng.random() < 0.3))]
                toks += [f"C{f}=v{int(rng.zipf(1.4)) % 40}:"
                         f"{rng.random():.3f}"
                         for f in range(int(rng.integers(1, 30)))]
                lines.append(" ".join(toks))
        path = os.path.join(wd, f"p{i}.txt")
        with open(path, "w") as fh:
            if lines:
                fh.write("\n".join(lines) + ("\n" if i < 3 else ""))
        paths.append(path)
    return paths


def _cfg(wd, files, **kw):
    base = dict(vocabulary_size=VOCAB, hash_feature_id=True, factor_num=4,
                batch_size=64, bucket_ladder=(8, 16, 32),
                max_features_per_example=32, predict_files=tuple(files),
                score_path=os.path.join(wd, "score"),
                model_file=os.path.join(wd, "fm"), dedup="device")
    base.update(kw)
    return base


def _table(cfg):
    rng = np.random.default_rng(5)
    t = rng.normal(0.0, 0.3, (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    t[-1] = 0.0
    return t


def _per_file_scores(cfg, table, path):
    """The port's predict before the sweep: each file alone, its lines
    read in ``batch_size`` chunks, parsed with keep_empty, scored and
    formatted batch by batch."""
    scorer = scoring.CompiledScorer(cfg, torch.device("cpu"))
    with open(path, "rb") as fh:
        lines = [raw[:-1] if raw.endswith(b"\n") else raw for raw in fh]
    out = []
    for lo in range(0, len(lines), cfg.batch_size):
        chunk = [x.decode("utf-8") for x in lines[lo:lo + cfg.batch_size]]
        block = parse_lines(
            chunk, cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
            max_features_per_example=cfg.max_features_per_example,
            keep_empty=True)
        batch = make_device_batch(block, cfg)
        raw = scorer.score_batch(table, batch)[:batch.num_real]
        out.append(scoring.format_scores(scorer.transform(raw.numpy())))
    return "".join(out)


@pytest.mark.parametrize("dedup", ["device", "host"])
@pytest.mark.parametrize("host_threads", [1, 4])
def test_sweep_files_equal_the_per_file_path(tmp_path, dedup, host_threads):
    files = _write_files(str(tmp_path))
    cfg = FmConfig(**_cfg(str(tmp_path), files, dedup=dedup,
                          host_threads=host_threads))
    table = torch.from_numpy(_table(cfg))
    written = predict(cfg, table=table, device="cpu")
    assert written == [os.path.join(cfg.score_path,
                                    os.path.basename(p) + ".score")
                       for p in files]
    for path, out in zip(files, written):
        with open(out) as fh:
            got = fh.read()
        assert got == _per_file_scores(cfg, table, path), path
    with open(written[3]) as fh:
        assert len(fh.read().splitlines()) == 101
    assert os.path.getsize(written[1]) == 0
    assert not [t for t in threading.enumerate()
                if t.name in ("fetcher", "fmt-score-writer")
                or t.name.startswith("fmt-build")]


@pytest.mark.parametrize("dedup", ["device", "host"])
@pytest.mark.parametrize("policy", ["error", "skip"])
def test_sweep_matches_jax_score_sweep(tmp_path, dedup, policy):
    files = _write_files(str(tmp_path), bad=policy == "skip")
    kw = _cfg(str(tmp_path), files, dedup=dedup, bad_line_policy=policy,
              max_bad_fraction=0.5)
    cfg, jcfg = FmConfig(**kw), JaxConfig(**kw)
    table = _table(cfg)
    want, got = {}, {}
    n_jax = jax_scoring.score_sweep(jcfg, jnp.asarray(table), files,
                                    lambda p, v: want.setdefault(p, v))
    n = scoring.score_sweep(cfg, torch.from_numpy(table.copy()), files,
                            lambda p, v: got.setdefault(p, v))
    assert n == n_jax == 70 + 45 + 101
    assert list(got) == list(want) == files
    for path in files:
        assert got[path].shape == want[path].shape
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   rtol=1e-5, atol=1e-6, err_msg=path)
    if policy == "skip":  # line 12 of p0.txt is bad: no features, 0.0
        assert got[files[0]][11] == 0.0 == want[files[0]][11]


def test_chunked_fetcher_order_errors_and_join():
    seen = []
    f = ChunkedFetcher(lambda a, m: seen.append((a.tolist(), m)), chunk=3)
    for i in range(8):
        f.add(torch.arange(i, i + 2, dtype=torch.float32), i)
    f.flush()
    assert [m for _, m in seen] == list(range(8))
    assert seen[5][0] == [5.0, 6.0]

    def boom(a, m):
        if m == 4:
            raise ValueError("consumer failed")
        seen.append(m)

    f = ChunkedFetcher(boom, chunk=2)
    for i in range(6):
        f.add(torch.zeros(3), i)
    with pytest.raises(ValueError, match="consumer failed"):
        f.flush()
    f.add(torch.zeros(1), 9)  # clean again after the raising flush
    f.close()  # drops the pending add and joins
    assert not [t for t in threading.enumerate() if t.name == "fetcher"]


def test_score_writer_raises_a_failed_write(tmp_path):
    w = scoring.ScoreWriter(logging.getLogger("test"))
    w.submit(str(tmp_path / "ok.score"), np.array([0.5, 0.25]))
    w.submit(str(tmp_path / "missing" / "x.score"), np.array([0.5]))
    with pytest.raises(FileNotFoundError):
        w.close()
    with open(tmp_path / "ok.score") as fh:
        assert fh.read() == "0.500000\n0.250000\n"
    w.close(raise_error=False)


def test_predict_reads_a_port_checkpoint(tmp_path):
    from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
    files = _write_files(str(tmp_path))[:1]
    cfg = FmConfig(**_cfg(str(tmp_path), files))
    table = _table(cfg)
    save_checkpoint_from_numpy(cfg, table, None, 3)
    out = predict(dataclasses.replace(cfg, host_threads=2), device="cpu")
    with open(out[0]) as fh:
        assert fh.read() == _per_file_scores(cfg, torch.from_numpy(table),
                                             files[0])
