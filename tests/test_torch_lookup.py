"""The port's lookup backends (fast_tffm_tpu_torch/lookup.py) and the
offload kernels' plain versions (ops/offload_kernel.py) against the JAX
package's lookup.py and numpy, on the CPU.

- Seam methods: the port's ``HostOffloadLookup`` and ``PinnedHostLookup``
  (plain mode) against the JAX package's backends of the same names,
  loaded with one state: ``gather`` equal to the bit (a copy),
  ``apply_grad`` and ``state`` at rtol 1e-6 (the JAX numpy backend and
  the port's host backend divide by sqrt; the pinned backends multiply
  by rsqrt), ``load`` and ``for_table`` with their shape errors.
- ``make_offload_train_step``: 10 steps from one state against the JAX
  package's, for FM (JAX ``kernel = pallas`` in interpret mode) and
  FFM, on both port backends: table, accumulator, loss and scores at
  rtol 1e-4 / atol 1e-6, the bound the CPU tests hold the train step to.
- The kernels' plain versions against numpy: the gather exactly, the
  write-back at rtol 1e-6 (rsqrt against 1/sqrt), with pad slots that
  repeat the pad row.
- Backends built without a device ask for the card, as the entry
  points do.
- The chunked host init: equal to ``models/fm.init_table`` from the same
  seed, the pad row and the alignment tail 0, the accumulator
  ``adagrad_init`` throughout.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu import lookup as jax_lookup
from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu_torch import lookup
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.ops import offload_kernel as ok

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BACKENDS = [(lookup.HostOffloadLookup, jax_lookup.HostOffloadLookup),
            (lookup.PinnedHostLookup, jax_lookup.PinnedHostLookup)]
IDS = ["host_offload", "pinned_plain"]


def _kw(**kw):
    base = dict(vocabulary_size=300, factor_num=4, batch_size=32,
                learning_rate=0.1, factor_lambda=1e-6, bias_lambda=1e-6)
    base.update(kw)
    return base


def _state(cfg, seed=3):
    """A [ckpt_rows, D] state laid out as a checkpoint stores it."""
    rng = np.random.default_rng(seed)
    table = np.zeros((cfg.ckpt_rows, cfg.row_dim), np.float32)
    table[:cfg.vocabulary_size] = rng.uniform(
        -0.1, 0.1, (cfg.vocabulary_size, cfg.row_dim))
    acc = np.full((cfg.ckpt_rows, cfg.row_dim), cfg.adagrad_init,
                  np.float32)
    acc[:cfg.vocabulary_size] += rng.uniform(
        0, 0.5, (cfg.vocabulary_size, cfg.row_dim)).astype(np.float32)
    return table, acc


def _pair(port_cls, jax_cls, cfg, jcfg, table, acc):
    lk = port_cls(cfg, _init=False, device=CPU)
    lk.load(torch.from_numpy(table.copy()), torch.from_numpy(acc.copy()))
    jlk = jax_cls(jcfg, _init=False)
    jlk.load(table.copy(), acc.copy())
    return lk, jlk


def _ids(cfg, rng, n=40, pads=9):
    return np.concatenate([rng.choice(cfg.vocabulary_size, n,
                                      replace=False),
                           np.full(pads, cfg.pad_id)]).astype(np.int32)


@pytest.mark.parametrize("port_cls,jax_cls", BACKENDS, ids=IDS)
def test_seam_methods_match_jax(port_cls, jax_cls):
    cfg, jcfg = FmConfig(**_kw()), JaxConfig(**_kw())
    table, acc = _state(cfg)
    lk, jlk = _pair(port_cls, jax_cls, cfg, jcfg, table, acc)
    rng = np.random.default_rng(5)
    for i in range(3):
        ids = _ids(cfg, rng)
        got = lk.gather(torch.from_numpy(ids))
        assert got.dtype == torch.float32 and got.shape == (49, 5)
        if i == 0:  # one state: a copy of the same rows
            assert np.array_equal(got.numpy(), np.asarray(jlk.gather(ids)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlk.gather(ids)),
                                   rtol=1e-6, atol=1e-7)
        grad = rng.normal(0, 0.1, (len(ids), cfg.row_dim)
                          ).astype(np.float32)
        grad[ids == cfg.pad_id] = 0.0
        lk.apply_grad(torch.from_numpy(ids), torch.from_numpy(grad), 0.1)
        jlk.apply_grad(ids, grad, 0.1)
    for got, want in zip(lk.state(), jlk.state()):
        assert got.shape == (cfg.ckpt_rows, cfg.row_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    assert not lk.state()[0][cfg.pad_id:].any()


@pytest.mark.parametrize("port_cls,jax_cls", BACKENDS, ids=IDS)
def test_load_and_for_table_match_jax(port_cls, jax_cls):
    cfg, jcfg = FmConfig(**_kw()), JaxConfig(**_kw())
    table, acc = _state(cfg)
    lk = port_cls(cfg, _init=False, device=CPU)
    assert lk.table is None and lk.acc is None
    for bad in ((3, 3), (cfg.num_rows, cfg.row_dim + 1)):
        with pytest.raises(ValueError, match="shape"):
            lk.load(torch.zeros(bad), torch.zeros(bad))
        with pytest.raises(ValueError, match="shape"):
            jax_cls(jcfg, _init=False).load(np.zeros(bad, np.float32))
    # A restore's [num_rows, D] view is adopted as its stored tensor.
    full = torch.from_numpy(table.copy())
    lk.load(full[:cfg.num_rows], None)
    assert lk.acc is None and lk.table.data_ptr() == full.data_ptr()
    assert lk.table.shape == (cfg.ckpt_rows, cfg.row_dim)
    ids = _ids(cfg, np.random.default_rng(6))
    for layout in (table, table[:cfg.num_rows]):
        port = port_cls.for_table(cfg, torch.from_numpy(layout.copy()),
                                  device=CPU)
        want = jax_cls.for_table(jcfg, layout.copy())
        assert port.acc is None
        assert np.array_equal(port.gather(torch.from_numpy(ids)).numpy(),
                              np.asarray(want.gather(ids)))
    for bad in ((5, 5), (cfg.num_rows + 1, cfg.row_dim)):
        with pytest.raises(ValueError, match="layout"):
            port_cls.for_table(cfg, torch.zeros(bad), device=CPU)
        with pytest.raises(ValueError, match="layout"):
            jax_cls.for_table(jcfg, np.zeros(bad, np.float32))


@pytest.mark.parametrize("port_cls", [lookup.HostOffloadLookup,
                                      lookup.PinnedHostLookup], ids=IDS)
@pytest.mark.parametrize("jax_cls", [jax_lookup.HostOffloadLookup,
                                     jax_lookup.PinnedHostLookup],
                         ids=["jax_host_offload", "jax_pinned"])
def test_reset_rows_matches_jax(port_cls, jax_cls):
    """The eviction hook on one state, against each JAX backend: the
    freed rows zero in the table and ``adagrad_init`` in the
    accumulator, every other row untouched, exactly. A reset past the
    JAX package's 4,096-row chunk and one of the pad row itself
    included. The config's ``adagrad_init``, as train passes it: the JAX
    pinned backend also writes its chunk padding into the alignment
    tail's last row, which already holds those values."""
    cfg = FmConfig(**_kw(vocabulary_size=5000, factor_num=2))
    jcfg = JaxConfig(**_kw(vocabulary_size=5000, factor_num=2))
    table, acc = _state(cfg)
    lk, jlk = _pair(port_cls, jax_cls, cfg, jcfg, table, acc)
    rng = np.random.default_rng(9)
    resets = (np.array([1, 7, 4999], np.int32),
              np.sort(rng.choice(5000, 4500, replace=False)
                      ).astype(np.int32),
              np.array([0, 5000], np.int32))
    for rows in resets:
        lk.reset_rows(rows, adagrad_init=cfg.adagrad_init)
        jlk.reset_rows(rows, adagrad_init=jcfg.adagrad_init)
        got, want = lk.state(), jlk.state()
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    t, a = (x.numpy() for x in lk.state())
    hit = np.unique(np.concatenate(resets))
    assert not t[hit].any()
    assert (a[hit] == np.float32(cfg.adagrad_init)).all()
    kept = np.setdiff1d(np.arange(cfg.ckpt_rows), hit)
    assert np.array_equal(t[kept], table[kept])
    assert np.array_equal(a[kept], acc[kept])


@pytest.mark.parametrize("port_cls", [lookup.HostOffloadLookup,
                                      lookup.PinnedHostLookup], ids=IDS)
def test_reset_rows_without_accumulator(port_cls):
    """A score-only backend (no accumulator): the pinned backend refuses
    the reset, as the JAX pinned backend does; the host backend, as the
    JAX numpy backend, zeroes the table rows alone."""
    cfg = FmConfig(**_kw())
    table, _ = _state(cfg)
    lk = port_cls.for_table(cfg, torch.from_numpy(table.copy()), device=CPU)
    if port_cls is lookup.PinnedHostLookup:
        with pytest.raises(RuntimeError, match="needs the accumulator"):
            lk.reset_rows(np.array([1, 2], np.int32))
        jlk = jax_lookup.PinnedHostLookup.for_table(
            JaxConfig(**_kw()), table.copy())
        with pytest.raises(RuntimeError, match="needs the accumulator"):
            jlk.reset_rows(np.array([1, 2], np.int32))
        return
    lk.reset_rows(np.array([1, 2], np.int32))
    assert not lk.table[[1, 2]].any() and lk.acc is None
    assert torch.equal(lk.table[3], torch.from_numpy(table[3]))


def _batches(jcfg, path, n=10):
    out = []
    for b in jax_batch_iterator(jcfg, [path], training=True, epochs=3,
                                raw_ids=False):
        out.append(jax_fm.batch_args(b))
        if len(out) == n:
            return out
    raise AssertionError(f"only {len(out)} batches")


def _ffm_file(tmp_path, F=3, V=50, n=300):
    rng = np.random.default_rng(8)
    lines = [" ".join([str(int(rng.integers(0, 2)))] + [
        f"{f}:{int(rng.integers(0, V))}:{rng.uniform(0.5, 1.5):.3f}"
        for f in range(F)]) for _ in range(n)]
    path = str(tmp_path / "ffm.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("port_cls", [lookup.HostOffloadLookup,
                                      lookup.PinnedHostLookup], ids=IDS)
@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_offload_train_step_matches_jax(tmp_path, model, port_cls):
    if model == "fm":
        kw = _kw(vocabulary_size=200, factor_num=8, batch_size=128,
                 lookup="host")
        path = os.path.join(REPO, "data", "sample_train.txt")
        jkw = dict(kernel="pallas")
    else:
        kw = _kw(vocabulary_size=50, model_type="ffm", field_num=3,
                 factor_num=2, batch_size=16, lookup="host")
        path = _ffm_file(tmp_path)
        jkw = {}
    cfg, jcfg = FmConfig(**kw), JaxConfig(**kw, **jkw)
    spec, jspec = (port_fm.ModelSpec.from_config(cfg),
                   jax_fm.ModelSpec.from_config(jcfg))
    assert spec.dedup == jspec.dedup == "host"
    table, acc = _state(cfg, seed=9)
    lk, jlk = _pair(port_cls, jax_lookup.PinnedHostLookup, cfg, jcfg,
                    table, acc)
    step = lookup.make_offload_train_step(spec, lk, cfg.learning_rate)
    jstep = jax_lookup.make_offload_train_step(jspec, jlk,
                                               jcfg.learning_rate)
    g0, a0 = ok.gather_launches, ok.adagrad_launches
    for i, args in enumerate(_batches(jcfg, path)):
        loss, scores = step(**{k: torch.from_numpy(np.asarray(v))
                               for k, v in args.items() if v is not None})
        jloss, jscores = jstep(**args)
        for got, want in ((loss, jloss), (scores, jscores)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i}")
    for got, want in zip(lk.state(), jlk.state()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    assert (ok.gather_launches, ok.adagrad_launches) == (g0, a0)
    assert not lk.state()[0][cfg.pad_id].any()


@pytest.mark.parametrize("R,D,U,pads", [(64, 5, 20, 4), (5000, 9, 700, 37),
                                        (300, 17, 1, 0)])
def test_plain_versions_match_numpy(R, D, U, pads):
    rng = np.random.default_rng(R + D)
    table = rng.uniform(-0.1, 0.1, (R, D)).astype(np.float32)
    table[-1] = 0.0
    acc = rng.uniform(0.1, 0.5, (R, D)).astype(np.float32)
    ids = np.concatenate([rng.choice(R - 1, U - pads, replace=False),
                          np.full(pads, R - 1)]).astype(np.int32)
    grad = rng.normal(0, 0.1, (U, D)).astype(np.float32)
    grad[U - pads:] = 0.0
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    rows = ok.offload_gather(t, torch.from_numpy(ids))
    assert np.array_equal(rows.numpy(), table[ids])
    ok.offload_adagrad(t, a, torch.from_numpy(ids), rows,
                       torch.from_numpy(grad), 0.05)
    new_acc = acc[ids] + grad * grad
    want_t, want_a = table.copy(), acc.copy()
    want_a[ids] = new_acc
    want_t[ids] = table[ids] - 0.05 * grad / np.sqrt(new_acc)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-6, atol=1e-7)
    assert not t[-1].any()


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    t, a = torch.zeros(10, 3), torch.zeros(10, 3)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        ok.offload_adagrad(t, a, ids, torch.zeros(2, 3),
                           torch.zeros(2, 3, device="meta"), 0.1)
    with pytest.raises(ValueError, match="int32"):
        ok.offload_gather(t, ids.long())
    with pytest.raises(ValueError, match=r"\[2, 3\]"):
        ok.offload_adagrad(t, a, ids, torch.zeros(2, 4), torch.zeros(2, 4),
                           0.1)
    with pytest.raises(ValueError, match="CPU tensor"):
        ok.offload_gather(t.double(), ids)


def test_chunked_init_layout(monkeypatch):
    monkeypatch.setattr(lookup, "INIT_CHUNK_ROWS", 7)
    cfg = FmConfig(vocabulary_size=300, factor_num=4, seed=11)
    table, acc = lookup.init_host_state(cfg, cfg.seed)
    assert table.shape == acc.shape == (cfg.ckpt_rows, cfg.row_dim)
    want = port_fm.init_table(cfg, CPU,
                              torch.Generator().manual_seed(cfg.seed))
    assert torch.equal(table[:cfg.num_rows], want)
    live = table[:cfg.vocabulary_size]
    assert float(live.abs().max()) <= cfg.init_value_range
    assert (live != 0).float().mean() > 0.99
    assert not table[cfg.pad_id:].any()
    assert torch.equal(acc, torch.full_like(acc, cfg.adagrad_init))
    lk = lookup.make_offload_backend(cfg, cfg.seed, device=CPU)
    assert isinstance(lk, lookup.PinnedHostLookup) and lk.mode == "plain"
    assert torch.equal(lk.table, table) and torch.equal(lk.acc, acc)


@pytest.mark.parametrize("make", [
    lambda cfg: lookup.HostOffloadLookup(cfg, _init=False),
    lambda cfg: lookup.PinnedHostLookup(cfg, _init=False),
    lambda cfg: lookup.make_offload_backend(cfg, cfg.seed),
    lambda cfg: lookup.make_score_backend(cfg, torch.zeros(
        cfg.num_rows, cfg.row_dim))],
    ids=["host_offload", "pinned", "offload_backend", "score_backend"])
def test_backends_default_to_the_card(monkeypatch, make):
    """Without a device a backend asks for the card, as the entry points
    do: with none it raises and never quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(FmConfig(**_kw()))


def test_placement_and_memory_report_on_cpu():
    assert lookup.probe_placement_mode("cpu") == "plain"
    assert lookup.PinnedHostLookup(FmConfig(**_kw()), _init=False,
                                   device=CPU).mode == "plain"
    rep = lookup.memory_report()
    assert rep["host_rss_mb"] > 0 and rep["host_peak_rss_mb"] > 0
    assert rep["device_in_use_mb"] is None
    assert rep["device_peak_mb"] is None and rep["device_limit_mb"] is None


@pytest.mark.parametrize("port_cls", [lookup.HostOffloadLookup,
                                      lookup.PinnedHostLookup], ids=IDS)
def test_from_checkpoint_with_and_without_acc(tmp_path, port_cls):
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    cfg = FmConfig(**_kw(model_file=str(tmp_path / "m" / "fm")))
    table, acc = _state(cfg)
    ckpt = CheckpointState(cfg.model_file, adagrad_init=cfg.adagrad_init)
    ckpt.save(5, torch.from_numpy(table.copy()),
              torch.from_numpy(acc.copy()),
              vocabulary_size=cfg.vocabulary_size, wait=True,
              from_state=True)
    ckpt.close()
    full = port_cls.from_checkpoint(cfg, device=CPU)
    lean = port_cls.from_checkpoint(cfg, with_acc=False, device=CPU)
    assert full.step == lean.step == 5 and lean.acc is None
    assert np.array_equal(full.table.numpy(), table)
    assert np.array_equal(full.acc.numpy(), acc)
    assert np.array_equal(lean.table.numpy(), table)
    with pytest.raises(FileNotFoundError):
        port_cls.from_checkpoint(dataclasses.replace(
            cfg, model_file=str(tmp_path / "none" / "fm")), device=CPU)


def test_from_state_save_needs_wait_and_the_stored_layout(tmp_path):
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    cfg = FmConfig(**_kw())
    table, acc = (torch.from_numpy(a) for a in _state(cfg))
    ckpt = CheckpointState(str(tmp_path / "fm"))
    with pytest.raises(ValueError, match="wait=True"):
        ckpt.save(1, table, acc, vocabulary_size=cfg.vocabulary_size,
                  from_state=True)
    with pytest.raises(ValueError, match="from_state"):
        ckpt.save(1, table[:cfg.num_rows], acc[:cfg.num_rows],
                  vocabulary_size=cfg.vocabulary_size, wait=True,
                  from_state=True)
    ckpt.close()
    assert not os.listdir(tmp_path / "fm.ckpt")
