"""The port's wire format (fast_tffm_tpu_torch/wire.py), held to the
contracts of the JAX package's ``tests/test_wire.py`` and to its
``wire.py`` on the same batches, on the CPU.

- Ladders: the flat ladder's floor and quarter octaves, the serve
  ladder's rect-fraction rungs, equal to the JAX package's rung for rung.
- Encode: the port's encoder ships the JAX encoder's arrays, byte for
  byte and dtype for dtype, with the same byte accounting; its
  ``unpack_rectangles`` (torch ops) equals the JAX one array for array,
  and rebuilds the padded rectangles bit for bit, for both dedup modes,
  empty and full batches and FFM fields.
- Packed-wide is a pure transfer change: across the pipeline's routes
  the padded and packed bodies give the same scores and the same
  trained table and accumulator, to the bit; packed-narrow stays within
  the JAX package's narrow tolerance.
- The slice: ``train`` with ``wire_format = packed`` equals the padded
  run to the bit and ships fewer bytes; predict's score files and a
  server's answers are equal byte for byte.
"""

import dataclasses
import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from fast_tffm_tpu import wire as jax_wire
from fast_tffm_tpu_torch import wire
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.badlines import BadLineTracker
from fast_tffm_tpu_torch.data.parser import parse_lines
from fast_tffm_tpu_torch.data.pipeline import (batch_iterator,
                                               make_device_batch)
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.scoring import CompiledScorer
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.train import train

torch.set_num_threads(1)

CPU = torch.device("cpu")
VOCAB = 400


def _write_corpus(path, n, seed=0, max_nnz=14, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        nnz = int(rng.integers(1, max_nnz))
        ids = rng.choice(vocab, size=nnz, replace=False)
        lines.append(" ".join([str(int(rng.integers(0, 2)))]
                              + [f"{i}:{rng.random():.4f}" for i in ids]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def _write_ffm_corpus(path, n, seed=9, fields=6):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        nnz = int(rng.integers(1, fields + 1))
        toks = [f"{f}:{int(rng.integers(0, VOCAB))}:{rng.random():.3f}"
                for f in rng.choice(fields, size=nnz, replace=False)]
        lines.append(" ".join([str(int(rng.integers(0, 2)))] + toks))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def _cfg(path, **kw):
    base = dict(vocabulary_size=VOCAB, factor_num=4, batch_size=16,
                learning_rate=0.1, factor_lambda=1e-6, bias_lambda=1e-6,
                max_features_per_example=16, bucket_ladder=(8, 16),
                train_files=(path,), shuffle=False)
    base.update(kw)
    return FmConfig(**base)


def _table(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-0.05, 0.05, (cfg.num_rows, cfg.row_dim)
                    ).astype(np.float32)
    t[-1] = 0.0
    return torch.from_numpy(t)


# --- ladder math -------------------------------------------------------------


def test_flat_bucket_floor_and_quarter_octave():
    assert wire.flat_bucket(0) == wire.FLAT_LADDER_FLOOR
    assert wire.flat_bucket(wire.FLAT_LADDER_FLOOR) == wire.FLAT_LADDER_FLOOR
    for nnz in (9, 17, 33, 100, 1000, 12345, 262145, 319488):
        b = wire.flat_bucket(nnz)
        assert nnz <= b <= nnz * 1.25, (nnz, b)
    rungs = [wire.flat_bucket(n) for n in range(1, 5000)]
    assert rungs == sorted(rungs)
    assert rungs == [jax_wire.flat_bucket(n) for n in range(1, 5000)]


@pytest.mark.parametrize("B,L", [(32, 32), (1, 8), (256, 64), (7, 3)])
def test_rect_fraction_rungs_bounded_and_cover(B, L):
    rungs = wire.rect_fraction_rungs(B, L)
    assert len(rungs) <= 5 and rungs[0] == wire.FLAT_LADDER_FLOOR
    assert rungs[-1] == max(B * L, wire.FLAT_LADDER_FLOOR)
    assert rungs == jax_wire.rect_fraction_rungs(B, L)
    assert wire.flat_rungs(B, L) == rungs
    assert wire.rect_fraction_rungs(1, 8) == (8,)


# --- encode / unpack ---------------------------------------------------------


def _encoders(dtypes="wide", rect_fraction=False, pad_id=VOCAB):
    return (wire.WireEncoder(wire.WireSpec("packed", dtypes), pad_id,
                             rect_fraction=rect_fraction),
            jax_wire.WireEncoder(jax_wire.WireSpec("packed", dtypes),
                                 pad_id, rect_fraction=rect_fraction))


def _unpack(wb, pad_id):
    pad = (pad_id if wb.args.get("uniq_ids") is None
           else len(wb.args["uniq_ids"]) - 1)
    return wire.unpack_rectangles(wb.L, pad, wb.args["lengths"],
                                  wb.args["flat_idx"], wb.args["flat_vals"],
                                  wb.args.get("flat_fields"))


def _jax_unpack(jwb, pad_id):
    a = jwb.args
    pad = pad_id if a.get("uniq_ids") is None else len(a["uniq_ids"]) - 1
    return jax_wire.unpack_rectangles(
        jwb.L, pad, jax.numpy.asarray(a["lengths"]),
        jax.numpy.asarray(a["flat_idx"]), jax.numpy.asarray(a["flat_vals"]),
        (jax.numpy.asarray(a["flat_fields"]) if "flat_fields" in a
         else None))


def _assert_same_encoding(wb, jwb, pad_id):
    assert (wb.L, wb.packed) == (jwb.L, jwb.packed)
    assert (wb.wire_bytes, wb.logical_bytes) == (jwb.wire_bytes,
                                                 jwb.logical_bytes)
    assert set(k for k, v in jwb.args.items() if v is not None) == set(
        k for k, v in wb.args.items() if v is not None)
    for k, v in jwb.args.items():
        if v is None:
            continue
        got = wb.args[k].numpy()
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    for got, want in zip(_unpack(wb, pad_id), _jax_unpack(jwb, pad_id)):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.int32 or got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dedup", ["host", "device"])
def test_encode_unpack_roundtrip_bitwise_and_equal_to_jax(tmp_path, dedup):
    path = _write_corpus(tmp_path / "t.txt", 100, seed=1)
    cfg = _cfg(path, dedup=dedup)
    raw = dedup == "device"
    enc, jenc = _encoders()
    n = 0
    for b in batch_iterator(cfg, cfg.train_files, training=True,
                            raw_ids=raw):
        for encode, jencode in ((enc.encode_train, jenc.encode_train),
                                (enc.encode_score, jenc.encode_score)):
            wb, jwb = encode(b), jencode(b)
            _assert_same_encoding(wb, jwb, cfg.pad_id)
            li, vv, ff = _unpack(wb, cfg.pad_id)
            assert ff is None and li.is_contiguous()
            assert np.array_equal(vv.numpy(), b.vals)
            if raw:
                assert np.array_equal(li.numpy(), b.local_idx)
            else:
                # Padding may sit at another pad_id slot: the rows each
                # cell addresses are the same.
                assert np.array_equal(b.uniq_ids[li.numpy()],
                                      b.uniq_ids[b.local_idx])
        n += 1
    assert n == 7


def test_encode_empty_and_full_batches():
    lines = ["1 " + " ".join(f"{i}:1.0" for i in range(8)), "0", "1 5:2.0"]
    cfg = _cfg(os.devnull)
    b = make_device_batch(parse_lines(lines, VOCAB, keep_empty=True), cfg)
    enc, jenc = _encoders()
    wb = enc.encode_score(b)
    _assert_same_encoding(wb, jenc.encode_score(b), cfg.pad_id)
    li, vv, _ = _unpack(wb, cfg.pad_id)
    assert np.array_equal(li.numpy(), b.local_idx)
    assert np.array_equal(vv.numpy(), b.vals)
    assert wb.args["lengths"][:3].tolist() == [8, 0, 1]
    # All padding (a filler batch), and a rectangle with no padding.
    empty = make_device_batch(parse_lines([], VOCAB), cfg, batch_size=4)
    full = make_device_batch(parse_lines(
        [" ".join(["1"] + [f"{i + j}:0.5" for i in range(8)])
         for j in range(4)], VOCAB), cfg, batch_size=4)
    for batch in (empty, full):
        wb = enc.encode_train(batch)
        _assert_same_encoding(wb, jenc.encode_train(batch), cfg.pad_id)
        li, vv, _ = _unpack(wb, cfg.pad_id)
        assert np.array_equal(li.numpy(), batch.local_idx)
        assert np.array_equal(vv.numpy(), batch.vals)
    assert int(enc.encode_train(empty).args["lengths"].sum()) == 0
    assert enc.encode_train(full).args["flat_idx"].shape == (32,)


def test_encoder_narrow_dtypes(tmp_path):
    path = _write_corpus(tmp_path / "t.txt", 40, seed=2)
    cfg = _cfg(path, dedup="device")
    enc, jenc = _encoders("narrow")
    b = next(batch_iterator(cfg, cfg.train_files, training=True))
    wb = enc.encode_train(b)
    _assert_same_encoding(wb, jenc.encode_train(b), cfg.pad_id)
    assert wb.args["flat_vals"].dtype == torch.float16
    assert wb.args["weights"].dtype == torch.float16
    assert wb.args["labels"].dtype == torch.float32
    assert wb.args["flat_idx"].dtype == torch.int32
    assert wb.wire_bytes < wb.logical_bytes
    _, vv, _ = _unpack(wb, cfg.pad_id)
    assert vv.dtype == torch.float32


def test_encode_ffm_fields_and_serve_ladder(tmp_path):
    path = _write_ffm_corpus(tmp_path / "f.txt", 80)
    cfg = _cfg(path, model_type="ffm", field_num=6, factor_num=2)
    for rect in (False, True):
        enc, jenc = _encoders(rect_fraction=rect)
        for raw in (True, False):
            for b in batch_iterator(cfg, cfg.train_files, training=True,
                                    raw_ids=raw):
                assert b.fields is not None
                wb = enc.encode_score(b)
                _assert_same_encoding(wb, jenc.encode_score(b), cfg.pad_id)
                _, _, ff = _unpack(wb, cfg.pad_id)
                assert np.array_equal(ff.numpy(), b.fields)
                B, L = b.local_idx.shape
                if rect:
                    assert wb.args["flat_idx"].shape[0] in \
                        wire.rect_fraction_rungs(B, L)


def test_padded_encoding_is_the_batch_args_layout(tmp_path):
    path = _write_corpus(tmp_path / "t.txt", 30, seed=3)
    cfg = _cfg(path, dedup="host")
    enc = wire.WireEncoder(wire.WireSpec(), cfg.pad_id)
    b = next(batch_iterator(cfg, cfg.train_files, raw_ids=False))
    wb = enc.encode_train(b)
    want = port_fm.batch_args(b, CPU)
    assert not wb.packed and wb.wire_bytes == wb.logical_bytes
    assert sorted(wb.args) == sorted(want)
    for k, v in want.items():
        assert torch.equal(wb.args[k], v)
    placed = enc.device_put(wb, CPU)
    assert all(placed[k] is wb.args[k] or torch.equal(placed[k], wb.args[k])
               for k in want)
    assert sorted(enc.encode_score(b).args) == ["local_idx", "uniq_ids",
                                                 "vals"]


# --- bit-parity of the bodies across the pipeline's routes ------------------


def _dispatch_parity(cfg, batches, dtypes="wide"):
    """The same batches through the padded and packed train and score
    bodies; wide: scores, table and accumulator equal to the bit."""
    spec = port_fm.ModelSpec.from_config(cfg)
    enc = wire.WireEncoder(wire.WireSpec("packed", dtypes), cfg.pad_id)
    t1, t2 = _table(cfg), _table(cfg)
    a1 = torch.full_like(t1, cfg.adagrad_init)
    a2 = torch.full_like(t2, cfg.adagrad_init)
    assert batches
    for b in batches:
        args = port_fm.batch_args(b, CPU)
        sargs = {k: v for k, v in args.items()
                 if k not in ("labels", "weights")}
        s1 = port_fm.score_body(spec, t1, **sargs)
        wbs = enc.encode_score(b)
        s2 = port_fm.packed_score_body(spec, wbs.L, t1,
                                       **enc.device_put(wbs, CPU))
        if dtypes == "wide":
            assert torch.equal(s1, s2), "scores diverged"
        else:
            np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=2e-3,
                                       atol=2e-3)
        port_fm.train_step_body(spec, t1, a1, **args)
        wb = enc.encode_train(b)
        assert wb.packed and wb.wire_bytes > 0
        port_fm.packed_train_step_body(spec, wb.L, t2, a2,
                                       **enc.device_put(wb, CPU))
    return t1, a1, t2, a2


def _assert_bitwise(cfg, batches):
    t1, a1, t2, a2 = _dispatch_parity(cfg, batches)
    assert torch.equal(t1, t2), "train table diverged"
    assert torch.equal(a1, a2), "accumulator diverged"
    assert not torch.equal(t1, _table(cfg))


@pytest.mark.parametrize("dedup", ["host", "device"])
def test_parity_fast_path(tmp_path, dedup):
    path = _write_corpus(tmp_path / "t.txt", 150, seed=3)
    cfg = _cfg(path, dedup=dedup)
    _assert_bitwise(cfg, list(batch_iterator(
        cfg, cfg.train_files, training=True, raw_ids=dedup == "device")))


def test_parity_generic_unbounded(tmp_path):
    path = _write_corpus(tmp_path / "t.txt", 120, seed=4)
    cfg = _cfg(path, max_features_per_example=0, dedup="host")
    _assert_bitwise(cfg, list(batch_iterator(cfg, cfg.train_files,
                                             training=True, raw_ids=False)))


def test_parity_tolerant_skip(tmp_path):
    path = _write_corpus(tmp_path / "t.txt", 100, seed=5)
    with open(path) as fh:
        lines = fh.read().splitlines()
    lines[10] = "1 broken:::"
    lines[55] = "not-a-label 3:1.0"
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    cfg = _cfg(path, bad_line_policy="skip", dedup="host")
    batches = list(batch_iterator(
        cfg, cfg.train_files, training=True, raw_ids=False,
        bad_lines=BadLineTracker("skip", cfg.max_bad_fraction)))
    _assert_bitwise(cfg, batches)


def test_parity_host_threads_ring(tmp_path):
    path = _write_corpus(tmp_path / "t.txt", 400, seed=6)
    cfg = _cfg(path, host_threads=4, shuffle=True)
    _assert_bitwise(cfg, list(batch_iterator(cfg, cfg.train_files,
                                             training=True)))


@pytest.mark.parametrize("model", ["ffm", "order3"])
def test_parity_ffm_and_order3(tmp_path, model):
    if model == "ffm":
        path = _write_ffm_corpus(tmp_path / "ffm.txt", 80)
        cfg = _cfg(path, model_type="ffm", field_num=6, factor_num=2)
    else:
        path = _write_corpus(tmp_path / "t.txt", 100, seed=8)
        cfg = _cfg(path, order=3)
    for dedup in ("device", "host"):
        c = dataclasses.replace(cfg, dedup=dedup)
        _assert_bitwise(c, list(batch_iterator(
            c, c.train_files, training=True, raw_ids=dedup == "device")))


def test_narrow_mode_tolerance(tmp_path):
    """packed-narrow: one f16 rounding of values and weights — scores
    and the trained table within the JAX package's narrow tolerance."""
    path = _write_corpus(tmp_path / "t.txt", 150, seed=10)
    cfg = _cfg(path, dedup="device")
    t1, _, t2, _ = _dispatch_parity(
        cfg, list(batch_iterator(cfg, cfg.train_files, training=True)),
        dtypes="narrow")
    assert torch.isfinite(t2).all()
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), rtol=0.05, atol=5e-3)


# --- resolve and config validation -------------------------------------------


def test_resolve_wire_downgrades_warn():
    cfg = _cfg(os.devnull, wire_format="packed")
    assert wire.resolve_wire(cfg).describe() == "packed-wide"
    with pytest.warns(UserWarning, match="lockstep"):
        assert not wire.resolve_wire(cfg, multi_process=True).packed
    with pytest.warns(UserWarning, match="mesh"):
        assert not wire.resolve_wire(cfg, mesh=object()).packed
    with pytest.warns(UserWarning, match="offload"):
        assert not wire.resolve_wire(cfg, backend=object(),
                                     train=True).packed
    assert wire.resolve_wire(cfg, backend=object()).packed
    assert not wire.resolve_wire(_cfg(os.devnull), multi_process=True).packed
    narrow = dataclasses.replace(cfg, wire_dtypes="narrow")
    assert wire.resolve_wire(narrow).describe() == "packed-narrow"


def test_config_rejects_narrow_without_packed():
    with pytest.raises(ValueError, match="narrow requires"):
        _cfg(os.devnull, wire_dtypes="narrow")
    with pytest.raises(ValueError, match="wire_format"):
        _cfg(os.devnull, wire_format="zstd")
    with pytest.raises(ValueError, match="wire_dtypes"):
        _cfg(os.devnull, wire_format="packed", wire_dtypes="bf16")


def test_batch_payload_bytes_counts_shipped_arrays():
    args = {"a": np.zeros(10, np.float16), "b": torch.zeros(3),
            "uniq_ids": None}
    assert wire.batch_payload_bytes(args) == 20 + 12


# --- the slice: train, predict, serve ----------------------------------------


def _detach_file_logs():
    lg = logging.getLogger("fast_tffm_tpu_torch")
    for h in [h for h in lg.handlers
              if isinstance(h, logging.FileHandler)]:
        lg.removeHandler(h)
        h.close()


def _train_run(wd, **kw):
    cfg = FmConfig(vocabulary_size=VOCAB, factor_num=4, batch_size=16,
                   learning_rate=0.1, shuffle=True, seed=0, log_steps=0,
                   epoch_num=2, train_files=(os.path.join(wd,
                                                          "corpus.txt"),),
                   model_file=os.path.join(wd, kw.pop("name"), "fm"),
                   log_file=os.path.join(wd, "fm.log"), **kw)
    try:
        return cfg, train(cfg, device="cpu")
    finally:
        _detach_file_logs()


def test_train_packed_bitwise_and_fewer_bytes(tmp_path):
    """``train`` at the default ladder: packed-wide gives the padded
    run's table to the bit and ships fewer bytes, packed-narrow fewer
    still, within the narrow tolerance."""
    wd = str(tmp_path)
    # nnz 1..9 against the default ladder's L = 16: the padding the
    # packed wire leaves behind.
    _write_corpus(os.path.join(wd, "corpus.txt"), 300, seed=11, max_nnz=10)
    tables = {}
    for name, kw in (("padded", {}), ("packed", {"wire_format": "packed"}),
                     ("narrow", {"wire_format": "packed",
                                 "wire_dtypes": "narrow"})):
        _, tables[name] = _train_run(wd, name=name, **kw)
    assert torch.equal(tables["padded"], tables["packed"])
    assert torch.isfinite(tables["narrow"]).all()
    np.testing.assert_allclose(tables["padded"].numpy(),
                               tables["narrow"].numpy(), rtol=0.05,
                               atol=5e-3)
    with open(os.path.join(wd, "fm.log")) as fh:
        log = fh.read()
    for mode in ("padded-wide", "packed-wide", "packed-narrow"):
        assert f"wire format: {mode}" in log
    sent = {m: (int(a), int(b)) for m, a, b in re.findall(
        r"wire (\S+): h2d_bytes = (\d+) over \d+ steps, against (\d+)", log)}
    assert sent["padded-wide"][0] == sent["padded-wide"][1]
    assert sent["packed-wide"][1] == sent["padded-wide"][0]
    assert sent["packed-wide"][0] <= sent["packed-wide"][1] / 2
    assert sent["packed-narrow"][0] < sent["packed-wide"][0]


def test_predict_and_serve_packed_equal_padded(tmp_path):
    """Predict's score files and a server's answers: padded and
    packed-wide byte for byte; the packed server warms every flat rung
    and names the wire in its stats."""
    from fast_tffm_tpu_torch.predict import predict
    from fast_tffm_tpu_torch.tools import fmckpt
    wd = str(tmp_path)
    lines = []
    with open(_write_corpus(os.path.join(wd, "p.txt"), 90, seed=12)) as fh:
        lines = fh.read().splitlines()
    lines.insert(5, "")
    with open(os.path.join(wd, "p.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    base = FmConfig(vocabulary_size=VOCAB, factor_num=4, batch_size=32,
                    bucket_ladder=(8, 16), max_features_per_example=16,
                    serve_max_batch=8, serve_max_wait_ms=1.0,
                    predict_files=(os.path.join(wd, "p.txt"),),
                    model_file=os.path.join(wd, "model", "fm"),
                    log_file=os.path.join(wd, "fm.log"))
    save_checkpoint_from_numpy(base, _table(base).numpy(), None, 3)
    assert fmckpt.main(["publish", base.model_file, "3"]) == 0
    texts, answers = {}, {}
    try:
        for name, kw in (("padded", {}),
                         ("packed", {"wire_format": "packed"})):
            cfg = dataclasses.replace(
                base, score_path=os.path.join(wd, name), **kw)
            (path,) = predict(cfg, device="cpu")
            with open(path) as fh:
                texts[name] = fh.read()
            server = ScorerServer(cfg, device="cpu", watch=False)
            try:
                assert server.stats()["wire"] == (
                    "packed-wide" if kw else "padded-wide")
                answers[name] = [server.score_lines(lines[i:i + 7],
                                                    timeout=30).scores
                                 for i in range(0, len(lines), 7)]
                assert server.stats()["flush_errors"] == 0
            finally:
                server.close()
    finally:
        _detach_file_logs()
    assert texts["padded"] == texts["packed"]
    assert len(texts["packed"].splitlines()) == len(lines)
    for a, b in zip(answers["padded"], answers["packed"]):
        assert np.array_equal(a, b)
    scorer = CompiledScorer(dataclasses.replace(base, wire_format="packed"),
                            CPU, dedup="device")
    out = scorer.score_packed_shape(_table(base), 4, 8, 16)
    assert out.shape == (4,) and torch.equal(
        out, torch.full((4,), 0.0))
    with pytest.raises(ValueError, match="packed raw-ids"):
        CompiledScorer(base, CPU).score_packed_shape(_table(base), 4, 8, 8)
