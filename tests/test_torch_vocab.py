"""The port's admit-mode vocabulary (fast_tffm_tpu_torch/vocab/) against
the JAX package's (fast_tffm_tpu/vocab/), on the CPU, on the same inputs
made with numpy from a seed:

- ``CountMinSketch``: the same id stream, then ``state()`` equal byte
  for byte, and the estimates equal;
- ``VocabRuntime`` over one batch stream of each package's
  ``batch_iterator`` (host-dedup and raw-ids batches): every remapped
  ``uniq_ids`` / ``local_idx`` / ``vocab_obs`` equal, every barrier's
  stats and freed rows equal, and ``state_payload()`` equal (so is its
  crc32); the same stream with a depth-2 ``prefetch`` across the
  barriers, through ``ensure_current``, against the JAX stream without
  prefetch;
- ``load`` round trips across the packages; tampered and mismatched
  payloads refused as the JAX package refuses them; the candidate cap;
  ``eval_view``; ``VocabMap.from_payload``;
- ``reset_table_rows`` in place against the JAX package's, exactly;
- the sidecar: each package reads the other's ``vocab-<step>.json.gz``;
  ``fmckpt`` marks ``+VOCAB``, ``verify`` fails a flipped sidecar byte,
  ``publish`` refuses it, ``gc`` sweeps an orphan sidecar; a restore
  attaches the payload, a quarantine moves the sidecar with its step.
"""

import dataclasses
import gzip
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fast_tffm_tpu import checkpoint as jck
from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from fast_tffm_tpu.vocab import sketch as jsk
from fast_tffm_tpu.vocab import table as jvt
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import (batch_iterator,
                                               plain_batch_iterator,
                                               prefetch)
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.vocab import sketch as psk
from fast_tffm_tpu_torch.vocab import table as pvt

torch.set_num_threads(1)

HASH_SPACE = psk.HASH_SPACE


def test_hash_space_and_constants_match():
    assert psk.HASH_SPACE == jsk.HASH_SPACE == 1 << 30
    assert psk._MULTS == jsk._MULTS
    assert pvt.COLD_ROW == jvt.COLD_ROW == 0
    assert pvt.PAYLOAD_FORMAT == jvt.PAYLOAD_FORMAT


@pytest.mark.parametrize("mb,depth", [(0.01, 4), (0.25, 3), (1.0, 4)])
def test_sketch_state_equals_jax(mb, depth):
    rng = np.random.default_rng(11)
    p = psk.CountMinSketch.from_mb(mb, depth)
    j = jsk.CountMinSketch.from_mb(mb, depth)
    assert (p.width, p.depth) == (j.width, j.depth)
    for k in range(30):
        ids = np.unique(rng.zipf(1.3, 400) % HASH_SPACE).astype(np.int64)
        assert np.array_equal(p.observe_and_estimate(ids),
                              j.observe_and_estimate(ids))
        if k % 7 == 6:
            p.decay(0.5)
            j.decay(0.5)
    p.observe(np.array([HASH_SPACE - 1, 3], np.int64), count=2.5)
    j.observe(np.array([HASH_SPACE - 1, 3], np.int64), count=2.5)
    probe = rng.integers(0, HASH_SPACE, 500)
    assert np.array_equal(p.estimate(probe), j.estimate(probe))
    assert p.fill_fraction() == j.fill_fraction()
    assert json.dumps(p.state(), sort_keys=True) == \
        json.dumps(j.state(), sort_keys=True)
    back = psk.CountMinSketch.from_state(j.state())
    assert back.counts.tobytes() == p.counts.tobytes()


def _corpus(path, rng, n_lines, eras=("a", "b")):
    """Heavy-tailed hashed-string lines: 4 hot tokens of the line's era
    (the label's signal) and 3 tail tokens from a Zipf law over 3,000."""
    lines = []
    for k in range(n_lines):
        era = eras[(k * len(eras)) // n_lines]
        y = k % 2
        toks = [f"{era}hot{(k % 4) * 2 + y}:1"]
        toks += [f"{era}t{int(rng.zipf(1.2)) % 3000}:0.5" for _ in range(3)]
        lines.append(f"{y} " + " ".join(toks))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def _cfgs(**kw):
    base = dict(vocabulary_size=24, factor_num=4, batch_size=32,
                hash_feature_id=True, shuffle=False, vocab_mode="admit",
                vocab_admit_threshold=2.0, vocab_decay=0.25,
                vocab_sketch_mb=0.05, host_threads=1)
    base.update(kw)
    return FmConfig(**base), JaxConfig(**base)


def _runtimes(cfg, jcfg):
    return pvt.VocabRuntime.from_config(cfg), \
        jvt.VocabRuntime.from_config(jcfg)


def _same_batch(p, j):
    assert (p.uniq_ids is None) == (j.uniq_ids is None)
    if p.uniq_ids is not None:
        assert p.uniq_ids.dtype == j.uniq_ids.dtype
        assert np.array_equal(p.uniq_ids, j.uniq_ids)
    assert np.array_equal(p.local_idx, j.local_idx)
    assert np.array_equal(p.vals, j.vals)
    assert np.array_equal(p.vocab_obs, j.vocab_obs)
    assert p.vocab_gen == j.vocab_gen


def _barrier_pair(prt, jrt):
    freed = ([], [])
    sp = prt.barrier(lambda r: freed[0].append(r.copy()))
    sj = jrt.barrier(lambda r: freed[1].append(r.copy()))
    assert sp == sj
    assert len(freed[0]) == len(freed[1])
    for a, b in zip(*freed):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return sp


@pytest.mark.parametrize("raw_ids", [True, False], ids=["raw", "host"])
def test_runtime_over_stream_equals_jax(tmp_path, raw_ids):
    """Both packages' pipelines remap the same corpus through their own
    runtime, with a barrier every 5 stepped batches: the remapped
    batches, the barriers and the payloads agree exactly, and the
    payload crc too. The remapped batches keep the padding invariants
    and each cell's route."""
    rng = np.random.default_rng(5)
    path = _corpus(tmp_path / "c.txt", rng, 1600)
    cfg, jcfg = _cfgs()
    prt, jrt = _runtimes(cfg, jcfg)
    pit = batch_iterator(cfg, [path], training=True, epochs=2,
                         raw_ids=raw_ids, vocab=prt)
    jit_ = jax_batch_iterator(jcfg, [path], training=True, epochs=2,
                              raw_ids=raw_ids, vocab=jrt)
    stats = []
    n = 0
    for p, j in zip(pit, jit_):
        _same_batch(p, j)
        if p.uniq_ids is not None:
            assert p.uniq_ids[-1] == cfg.pad_id
            real = p.uniq_ids != cfg.pad_id
            assert len(np.unique(p.uniq_ids[real])) == int(real.sum())
            src_u, src_li = p.vocab_src
            assert np.array_equal(p.uniq_ids[p.local_idx],
                                  prt.lookup(src_u[src_li]))
        else:
            assert np.array_equal(p.local_idx,
                                  prt.lookup(p.vocab_src[1]))
        assert p.local_idx.max() <= cfg.pad_id
        prt.note_trained(p)
        jrt.note_trained(j)
        n += 1
        if n % 5 == 0:
            stats.append(_barrier_pair(prt, jrt))
    assert n == 100
    assert sum(s["admitted"] for s in stats) > cfg.vocabulary_size
    assert sum(s["evicted"] for s in stats) > 0
    assert all(s["live"] <= cfg.vocabulary_size - 1 for s in stats)
    pp, jp = prt.state_payload(), jrt.state_payload()
    assert pp == jp and pp["crc32"] == jp["crc32"]
    assert pvt.payload_crc_ok(pp) and jvt.payload_crc_ok(pp)


def test_plain_iterator_remaps_as_the_fast_path(tmp_path):
    """``plain_batch_iterator(vocab=)`` gives the C++ stream's remapped
    batches (the plain version chip_smoke holds the builder to)."""
    path = _corpus(tmp_path / "c.txt", np.random.default_rng(2), 500)
    cfg, jcfg = _cfgs()
    rt = pvt.VocabRuntime.from_config(cfg)
    for _ in range(3):
        rt.note_trained(SimpleNamespace(vocab_obs=np.array(
            [int(v) for v in rt.lookup(np.arange(5))], np.int64) + 7))
    rt.barrier()
    got = list(plain_batch_iterator(cfg, [path], training=False,
                                    vocab=rt))
    want = list(batch_iterator(cfg, [path], training=False, vocab=rt))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert np.array_equal(a.local_idx, b.local_idx)
        assert np.array_equal(a.vocab_obs, b.vocab_obs)


def test_prefetched_batches_across_barriers(tmp_path):
    """A depth-2 prefetch holds batches remapped under the old slot map
    when a barrier moves it: ``ensure_current`` redoes them, and the
    stepped stream equals the JAX stream remapped lazily (no prefetch),
    barrier for barrier and payload for payload."""
    path = _corpus(tmp_path / "c.txt", np.random.default_rng(8), 1280)
    cfg, jcfg = _cfgs()
    prt, jrt = _runtimes(cfg, jcfg)
    pit = prefetch(batch_iterator(cfg, [path], training=True, epochs=1,
                                  vocab=prt), depth=2)
    jit_ = jax_batch_iterator(jcfg, [path], training=True, epochs=1,
                              raw_ids=True, vocab=jrt)
    redone = 0
    try:
        for k, (p, j) in enumerate(zip(pit, jit_)):
            stale = p.vocab_gen != prt.generation
            p = prt.ensure_current(p)
            redone += stale
            _same_batch(p, j)
            prt.note_trained(p)
            jrt.note_trained(j)
            if k % 4 == 3:
                _barrier_pair(prt, jrt)
    finally:
        pit.close()
    assert redone > 0, "no prefetched batch crossed a barrier"
    assert prt.state_payload() == jrt.state_payload()


def _admitted_runtime(cls, capacity=8, ids=(100, 200, 300)):
    rt = cls(capacity, pad_id=capacity, threshold=2.0, decay=0.5,
             sketch=(psk if cls is pvt.VocabRuntime else jsk
                     ).CountMinSketch(width=256))
    for _ in range(4):
        rt.note_trained(SimpleNamespace(vocab_obs=np.asarray(ids,
                                                            np.int64)))
    rt.barrier(None)
    return rt


def test_load_round_trips_across_packages():
    cfg, jcfg = _cfgs(vocabulary_size=8, vocab_decay=0.5)
    prt = _admitted_runtime(pvt.VocabRuntime)
    jrt = _admitted_runtime(jvt.VocabRuntime)
    assert prt.state_payload() == jrt.state_payload()
    payload = json.loads(json.dumps(jrt.state_payload()))
    back = pvt.VocabRuntime.from_config(cfg)
    back.load(cfg, payload)
    assert back.state_payload() == payload
    jback = jvt.VocabRuntime.from_config(jcfg)
    jback.load(jcfg, json.loads(json.dumps(prt.state_payload())))
    assert jback.state_payload() == payload
    ids = np.array([100, 200, 300, 400, HASH_SPACE], np.int64)
    assert np.array_equal(back.lookup(ids), jrt.lookup(ids))
    # Both continue identically after the load.
    for rt in (back, jback):
        rt.note_trained(SimpleNamespace(vocab_obs=np.array([5, 6],
                                                           np.int64)))
        rt.note_trained(SimpleNamespace(vocab_obs=np.array([5],
                                                           np.int64)))
    assert back.barrier() == jback.barrier()
    assert back.state_payload() == jback.state_payload()


def _raises_same(fn_port, fn_jax, match):
    with pytest.raises(ValueError, match=match) as ep:
        fn_port()
    with pytest.raises(ValueError, match=match) as ej:
        fn_jax()
    return str(ep.value), str(ej.value)


def test_tampered_and_mismatched_payloads_refused():
    cfg, jcfg = _cfgs(vocabulary_size=8)
    payload = _admitted_runtime(pvt.VocabRuntime).state_payload()
    torn = json.loads(json.dumps(payload))
    torn["state"]["total_admitted"] = 999
    assert not pvt.payload_crc_ok(torn) and not jvt.payload_crc_ok(torn)
    assert not pvt.payload_crc_ok({"state": {}})
    _raises_same(lambda: pvt.VocabMap.from_payload(cfg, torn),
                 lambda: jvt.VocabMap.from_payload(jcfg, torn),
                 r"failed its crc32 check \(torn or bit-rotted\)")
    _raises_same(lambda: pvt.VocabRuntime.from_config(cfg).load(cfg, torn),
                 lambda: jvt.VocabRuntime.from_config(jcfg).load(jcfg,
                                                                 torn),
                 "crc32")
    wrong, jwrong = _cfgs(vocabulary_size=16)
    p, j = _raises_same(lambda: pvt.VocabMap.from_payload(wrong, payload),
                        lambda: jvt.VocabMap.from_payload(jwrong, payload),
                        "vocabulary_size=8")
    assert p == j
    space = json.loads(json.dumps(payload))
    space["state"]["hash_space"] = 1 << 20
    space["crc32"] = pvt._state_crc(space["state"])
    p, j = _raises_same(lambda: pvt.VocabMap.from_payload(cfg, space),
                        lambda: jvt.VocabMap.from_payload(jcfg, space),
                        "slot space")
    assert p == j
    with pytest.raises(ValueError, match="vocabulary_size >= 2"):
        pvt.VocabMap(1, pad_id=1)


def test_candidate_cap_and_dedup_match_jax():
    """A flood of threshold-crossers stops at the cap; an ever-present
    hot id queues once an interval; both as the JAX runtime."""
    for capacity, stream in ((4, [np.arange(1000, dtype=np.int64)] * 3),
                             (1024, [np.arange(5, dtype=np.int64)] * 10)):
        rts = [cls(capacity, pad_id=capacity, threshold=2.0, decay=0.5,
                   sketch=mod.CountMinSketch(width=256))
               for cls, mod in ((pvt.VocabRuntime, psk),
                                (jvt.VocabRuntime, jsk))]
        for ids in stream:
            for rt in rts:
                rt.note_trained(SimpleNamespace(vocab_obs=ids))
        p, j = rts
        assert p._cand_len == j._cand_len <= p._candidate_cap
        assert p._queued == j._queued
        assert p.barrier() == j.barrier()
        assert p.state_payload() == j.state_payload()
    assert rts[0]._cand_len == 0 and not rts[0]._queued


def test_eval_view_and_inference_map():
    cfg, jcfg = _cfgs(vocabulary_size=8)
    prt = _admitted_runtime(pvt.VocabRuntime)
    jrt = _admitted_runtime(jvt.VocabRuntime)
    view = prt.eval_view()
    assert view.count_telemetry is False and prt.count_telemetry
    ids = np.array([[100, 150, 200], [300, HASH_SPACE, 7]], np.int64)
    assert np.array_equal(view.lookup(ids), jrt.eval_view().lookup(ids))
    vm = pvt.VocabMap.from_payload(cfg, prt.state_payload())
    assert vm.live_rows == prt.live_rows == 3
    assert np.array_equal(vm.lookup(ids), prt.lookup(ids))
    # An inference-side raw-ids remap skips the distinct-id pass.
    batch = SimpleNamespace(uniq_ids=None, local_idx=ids.copy())
    vm.remap(batch)
    jbatch = SimpleNamespace(uniq_ids=None, local_idx=ids.copy())
    jvt.VocabMap.from_payload(jcfg, prt.state_payload()).remap(jbatch)
    assert batch.vocab_obs is None and jbatch.vocab_obs is None
    assert np.array_equal(batch.local_idx, jbatch.local_idx)


@pytest.mark.parametrize("n_rows", [3, 4096, 5000])
def test_reset_table_rows_equals_jax(n_rows):
    """The in-place torch reset against the JAX package's chunked
    scatter, exactly: the rows, the pad row the JAX chunks pad with
    (already cold, so left as it is), and nothing else."""
    import jax.numpy as jnp
    V, D = 9000, 5
    rng = np.random.default_rng(n_rows)
    table = rng.normal(size=(V + 1, D)).astype(np.float32)
    table[V] = 0.0
    acc = rng.uniform(0.1, 2.0, (V + 1, D)).astype(np.float32)
    acc[V] = 0.1
    rows = np.sort(rng.choice(V, n_rows, replace=False)).astype(np.int32)
    pt, pa = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    assert pvt.reset_table_rows(pt, pa, rows, 0.1) is None
    jt, ja = jvt.reset_table_rows(jnp.asarray(table), jnp.asarray(acc),
                                  rows, V, 0.1)
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    assert not pt[rows].any() and (pa[rows] == np.float32(0.1)).all()
    pvt.reset_table_rows(pt, pa, np.zeros(0, np.int32), 0.1)
    assert np.array_equal(pt.numpy(), np.asarray(jt))


# -- the sidecar, restore and fmckpt ----------------------------------------


def _save_step(cfg, step, vocab_state, model_file):
    state = ck.CheckpointState(model_file, adagrad_init=cfg.adagrad_init)
    try:
        state.save(step, torch.zeros(cfg.num_rows, cfg.row_dim),
                   torch.full((cfg.num_rows, cfg.row_dim), 0.1),
                   vocabulary_size=cfg.vocabulary_size, wait=True,
                   vocab_state=vocab_state)
    finally:
        state.close()
    return state.directory


def test_sidecar_bytes_cross_packages(tmp_path):
    payload = _admitted_runtime(pvt.VocabRuntime).state_payload()
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    os.makedirs(pdir)
    os.makedirs(jdir)
    ck.write_vocab_sidecar(pdir, 7, payload)
    jck.write_vocab_sidecar(jdir, 7, payload)
    with gzip.open(ck.vocab_sidecar_path(pdir, 7), "rb") as a, \
            gzip.open(jck.vocab_sidecar_path(jdir, 7), "rb") as b:
        assert a.read() == b.read()
    assert jck.read_vocab_sidecar(pdir, 7) == payload
    assert ck.read_vocab_sidecar(jdir, 7) == payload
    assert ck.load_vocab_sidecar(pdir, 8) == (None, None)
    cfg, _ = _cfgs(vocabulary_size=8)
    vm = ck.load_vocab_map(cfg, jdir, 7)
    assert vm.live_rows == 3
    with pytest.raises(FileNotFoundError, match="vocab admission sidecar"):
        ck.load_vocab_map(cfg, jdir, 8)
    with pytest.raises(FileNotFoundError, match="vocab admission sidecar"):
        ck.load_vocab_map(cfg, jdir, None)


def _flip_byte(path, at=-6):
    """Flip one byte; the default lands in the gzip trailer's crc32,
    which both packages' readers report as a torn sidecar."""
    with open(path, "r+b") as fh:
        fh.seek(at, os.SEEK_END)
        b = fh.read(1)
        fh.seek(at, os.SEEK_END)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_restore_save_and_quarantine_carry_the_sidecar(tmp_path):
    cfg, _ = _cfgs(vocabulary_size=8)
    payload = _admitted_runtime(pvt.VocabRuntime).state_payload()
    model = str(tmp_path / "m" / "fm")
    directory = _save_step(cfg, 5, payload, model)
    state = ck.CheckpointState(model)
    restored = state.restore()
    assert restored["vocab_admission"] == payload
    # The same step again with a moved slot map (a forced save after a
    # barrier, which may have cold-started rows) writes the step anew:
    # its arrays, its sidecar and its manifest, leaving no litter. With
    # the same payload again, only the sidecars are written.
    moved = json.loads(json.dumps(payload))
    moved["state"]["total_admitted"] = 4
    moved["crc32"] = pvt._state_crc(moved["state"])
    table = torch.arange(cfg.num_rows * cfg.row_dim,
                         dtype=torch.float32).reshape(cfg.num_rows, -1)
    state.save(5, table, torch.zeros(cfg.num_rows, cfg.row_dim),
               vocabulary_size=8, wait=True, vocab_state=moved)
    assert ck.read_vocab_sidecar(directory, 5) == moved
    again = state.restore(step=5)
    assert torch.equal(again["table"][:cfg.num_rows], table)
    assert not again["acc"][:cfg.num_rows].any()
    assert again["vocab_admission"] == moved
    assert ck.read_manifest(directory, 5) is not None
    assert ck.verify_step_dir(directory, 5, mode="full") is None
    assert not [n for n in os.listdir(directory)
                if n.endswith((".del", ".tmp"))]
    state.save(5, torch.ones(cfg.num_rows, cfg.row_dim),
               torch.ones(cfg.num_rows, cfg.row_dim),
               vocabulary_size=8, force=True, wait=True, vocab_state=moved)
    assert torch.equal(state.restore(step=5)["table"][:cfg.num_rows], table)
    # A fresh save at a new step without a payload leaves none, and a
    # stale same-step sidecar is pruned before a fresh step lands.
    ck.write_vocab_sidecar(directory, 9, payload)
    state.save(9, torch.zeros(cfg.num_rows, cfg.row_dim),
               torch.zeros(cfg.num_rows, cfg.row_dim),
               vocabulary_size=8, wait=True)
    assert not os.path.exists(ck.vocab_sidecar_path(directory, 9))
    # A torn step walks back to the older step and its own sidecar; the
    # quarantine takes the torn step's sidecar along.
    ck.write_vocab_sidecar(directory, 9, payload)
    state.close()
    from fast_tffm_tpu_torch.testing.faults import truncate_checkpoint
    truncate_checkpoint(model, seed=0)
    restored = ck.CheckpointState(model).restore()
    assert restored["step"] == 5 and restored["vocab_admission"] == moved
    assert os.path.exists(os.path.join(directory, "corrupt-9",
                                       "vocab-9.json.gz"))
    # A torn sidecar reads as no admission state: a flipped trailer
    # byte, and a flipped byte inside the deflate stream.
    vp = ck.vocab_sidecar_path(directory, 5)
    with open(vp, "rb") as fh:
        good = fh.read()
    for at in (-6, -len(good) // 2):
        with open(vp, "wb") as fh:
            fh.write(good)
        _flip_byte(vp, at)
        payload_, reason = ck.load_vocab_sidecar(directory, 5)
        assert payload_ is None and "vocab-5.json.gz" in reason
        assert ck.CheckpointState(model).restore()["vocab_admission"] \
            is None


def test_fixed_mode_refusal_keys_on_the_sidecar(tmp_path):
    cfg, jcfg = _cfgs(vocabulary_size=8)
    fixed = dataclasses.replace(cfg, vocab_mode="fixed")
    jfixed = dataclasses.replace(jcfg, vocab_mode="fixed")
    payload = _admitted_runtime(pvt.VocabRuntime).state_payload()
    directory = _save_step(cfg, 3, payload, str(tmp_path / "m" / "fm"))
    for refuse, c in ((ck.refuse_fixed_mode_admit_step, fixed),
                      (jck.refuse_fixed_mode_admit_step, jfixed)):
        with pytest.raises(ValueError, match="vocab admission sidecar"):
            refuse(c, directory, 3)
        refuse(c, directory, 4)
        refuse(c, directory, None)
        with pytest.raises(ValueError, match="vocab_mode = fixed"):
            refuse(c, directory, 4, payload=payload)
    ck.refuse_fixed_mode_admit_step(cfg, directory, 3)


def _run(argv):
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
        rc = fmckpt.main(argv)
    return rc, out.getvalue()


def test_fmckpt_vocab_mark_verify_publish_gc(tmp_path):
    cfg, _ = _cfgs(vocabulary_size=8)
    payload = _admitted_runtime(pvt.VocabRuntime).state_payload()
    model = str(tmp_path / "m" / "fm")
    directory = _save_step(cfg, 4, payload, model)
    _save_step(cfg, 6, None, model)
    rc, text = _run(["ls", model])
    assert rc == 0
    line4 = next(ln for ln in text.splitlines() if "step 4 " in ln)
    line6 = next(ln for ln in text.splitlines() if "step 6 " in ln)
    assert "+VOCAB" in line4 and "+VOCAB" not in line6
    rc, text = _run(["verify", model])
    assert rc == 0 and "step 4: OK (full check, 3 files, +vocab crc OK)" \
        in text, text
    _flip_byte(ck.vocab_sidecar_path(directory, 4))
    rc, text = _run(["verify", model, "--step", "4"])
    assert rc == 1 and "step 4: FAIL — vocab sidecar vocab-4.json.gz" \
        in text, text
    rc, text = _run(["publish", model, "4"])
    assert rc == 1 and "pointer untouched" in text
    assert ck.read_published(directory) is None
    # The JAX tool's verdict on the same directory is the same.
    from tools import fmckpt as jfm
    out = io.StringIO()
    assert jfm.cmd_verify(directory, step=4, out=out) == 1
    # An orphan sidecar (its step gone) is listed and swept.
    ck.write_vocab_sidecar(directory, 99, payload)
    rc, text = _run(["ls", model])
    assert "vocab-99.json.gz  ORPHANED sidecar" in text
    rc, text = _run(["gc", model])
    assert rc == 0 and not os.path.exists(
        ck.vocab_sidecar_path(directory, 99))
    assert os.path.exists(ck.vocab_sidecar_path(directory, 4))
