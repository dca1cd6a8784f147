"""The port's training slice (fast_tffm_tpu_torch/train.py and what it
runs) against the JAX package, on the CPU.

- Stream: the port's ``batch_iterator(training=True)`` equals the JAX
  package's ``batch_iterator(..., raw_ids=True)`` (its C++ fast path)
  array for array, dtype for dtype, over 2 shuffled epochs of
  ``data/sample_train.txt`` split into 3 files (blank lines and a final
  line without its newline included), and over hashed Criteo-shaped
  lines with truncation.
- Step: 10 ``train_step_body`` steps from one shared ``(table, acc)``
  match the JAX step (``kernel = pallas`` in interpret mode, ``dedup =
  device``) on table, accumulator, loss and scores at rtol 1e-4 / atol
  1e-6, the reference's own bound for post-step tables
  (tests/test_pallas_fm.py). An all-padding filler batch has loss 0
  and leaves the state untouched.
- Slice: ``sample.cfg`` trained by the port and by ``run_tffm.py train``
  (a subprocess with one CPU device, so the JAX side takes its
  single-device path) from one shared table: per-epoch validation AUC
  within 1e-3, final loss at rtol 1e-4, exported tables at rtol 1e-4 /
  atol 1e-6, and the two predicts on their own exports at atol 1e-5.
- Refusals: an existing checkpoint in the JAX package's format (orbax)
  raises naming ``save_checkpoint_from_numpy`` and is left in place;
  every unported key raises ``NotImplementedError`` naming a ROADMAP
  item (weight files, tolerant bad-line policies and
  ``max_features_per_example = 0`` are ported now:
  tests/test_torch_fast_pipeline.py). (Resume from the port's own checkpoints is held to the JAX
  package in tests/test_torch_checkpoint.py.)
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.data.pipeline import batch_iterator
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.ops import fm_kernel
from fast_tffm_tpu_torch.train import train

# The plain versions run many small torch ops on the CPU; with one
# intra-op thread, torch's idle OpenMP workers do not spin on every core
# and starve the suite's other test processes.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _sample_lines():
    with open(os.path.join(REPO, "data", "sample_train.txt")) as fh:
        return fh.read().splitlines()


def _split_files(wd, lines):
    """Three files; the middle one holds blank lines, the last one ends
    without its newline."""
    files = []
    for i, (lo, hi) in enumerate([(0, 700), (700, 1300),
                                  (1300, len(lines))]):
        part = lines[lo:hi]
        if i == 1:
            part = part[:5] + ["", "  \t"] + part[5:]
        path = os.path.join(wd, f"part{i}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(part) + ("\n" if i < 2 else ""))
        files.append(path)
    return files


def _criteo_lines(n, seed):
    """Hashed Criteo-shaped lines: 13 numeric tokens, some dropped, and
    26 categorical tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = [str(int(rng.random() < 0.3))]
        toks += [f"I{j}:{rng.random():.3f}" for j in range(13)
                 if rng.random() > 0.1]
        toks += [f"C{f}=v{int(rng.zipf(1.4)) % 50}" for f in range(26)]
        out.append(" ".join(toks))
    return out


def _assert_same_stream(jax_batches, port_batches):
    assert len(port_batches) == len(jax_batches) > 0
    for j, p in zip(jax_batches, port_batches):
        assert j.uniq_ids is None and p.num_real == j.num_real
        for key in ("labels", "weights", "local_idx", "vals"):
            a, b = getattr(j, key), getattr(p, key)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key


@pytest.mark.parametrize("batch_size", [128, 300])
def test_stream_equals_jax_fast_path(tmp_path, batch_size):
    files = _split_files(str(tmp_path), _sample_lines())
    jcfg = dataclasses.replace(
        jax_load_config(os.path.join(REPO, "sample.cfg")),
        batch_size=batch_size)
    cfg = dataclasses.replace(load_config(os.path.join(REPO, "sample.cfg")),
                              batch_size=batch_size)
    assert cfg.shuffle
    want = list(jax_batch_iterator(jcfg, files, training=True, epochs=2,
                                   raw_ids=True))
    got = list(batch_iterator(cfg, files, training=True, epochs=2))
    _assert_same_stream(want, got)
    # Validation order: no shuffle, one epoch.
    want = list(jax_batch_iterator(jcfg, files, training=False,
                                   raw_ids=True))
    got = list(batch_iterator(cfg, files, training=False))
    _assert_same_stream(want, got)


def test_stream_equals_jax_on_hashed_truncated_lines(tmp_path):
    lines = _criteo_lines(600, 4)
    files = []
    for i in range(2):
        path = str(tmp_path / f"c{i}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(lines[i * 300:(i + 1) * 300]) + "\n")
        files.append(path)
    kw = dict(vocabulary_size=1 << 16, hash_feature_id=True, factor_num=4,
              batch_size=96, max_features_per_example=20, queue_size=500,
              seed=3)
    want = list(jax_batch_iterator(JaxConfig(**kw), files, training=True,
                                   epochs=2, raw_ids=True, seed=9))
    got = list(batch_iterator(FmConfig(**kw), files, training=True,
                              epochs=2, seed=9))
    _assert_same_stream(want, got)
    assert got[0].local_idx.shape[1] == 32


def test_stream_parse_error_names_file_and_line(tmp_path):
    lines = _sample_lines()[:10]
    lines[6] = "1 3:x"
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(lines[:3] + [""] + lines[3:]) + "\n")
    cfg = load_config(os.path.join(REPO, "sample.cfg"))
    with pytest.raises(ValueError, match=re.escape(f"{path} line 8: ")):
        list(batch_iterator(cfg, [path], training=False))


@pytest.mark.parametrize("kwargs", [
    (dict(uniq_bucket=1024), {}), ({}, dict(num_shards=2)),
    ({}, dict(fixed_shape=True))])
def test_stream_refuses_unported_modes(kwargs):
    """The modes ROADMAP.md A10 brought: each stream equals the JAX
    package's with the same arguments (host-deduped, as multi-process
    input is), array for array."""
    changes, it_kwargs = kwargs
    cfg = dataclasses.replace(load_config(os.path.join(REPO, "sample.cfg")),
                              max_features_per_example=64,
                              bucket_ladder=(8, 16, 32, 64), **changes)
    jcfg = dataclasses.replace(
        jax_load_config(os.path.join(REPO, "sample.cfg")),
        max_features_per_example=64, bucket_ladder=(8, 16, 32, 64),
        **changes)
    kw = dict(it_kwargs, raw_ids=False, epochs=1)
    want = list(jax_batch_iterator(jcfg, jcfg.train_files, **kw))
    got = list(batch_iterator(cfg, cfg.train_files, **kw))
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert g.num_real == w.num_real
        for k in ("labels", "weights", "uniq_ids", "local_idx", "vals"):
            assert np.array_equal(getattr(w, k), getattr(g, k)), k


def _filler(cfg):
    B = cfg.batch_size
    return dict(labels=np.zeros(B, np.float32),
                weights=np.zeros(B, np.float32),
                local_idx=np.full((B, 8), cfg.pad_id, np.int32),
                vals=np.zeros((B, 8), np.float32))


@pytest.mark.parametrize("loss_type", ["logistic", "mse"])
def test_ten_steps_match_jax_train_step(loss_type):
    cfg = dataclasses.replace(load_config(os.path.join(REPO, "sample.cfg")),
                              loss_type=loss_type)
    jcfg = dataclasses.replace(
        jax_load_config(os.path.join(REPO, "sample.cfg")),
        loss_type=loss_type, kernel="pallas", dedup="device")
    jspec = jax_fm.ModelSpec.from_config(jcfg)
    spec = port_fm.ModelSpec.from_config(cfg)
    rng = np.random.default_rng(17)
    table0 = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                         ).astype(np.float32)
    table0[-1] = 0.0
    acc0 = np.full((cfg.num_rows, cfg.row_dim), cfg.adagrad_init,
                   np.float32)
    batches = []
    for b in jax_batch_iterator(jcfg, jcfg.train_files, training=True,
                                epochs=1, raw_ids=True):
        batches.append(dict(labels=b.labels, weights=b.weights,
                            local_idx=b.local_idx, vals=b.vals))
        if len(batches) == 9:
            break
    batches.insert(4, _filler(cfg))
    jtable, jacc = jnp.asarray(table0), jnp.asarray(acc0)
    table, acc = convert.state_from_numpy(table0, acc0, cfg, CPU)
    for i, b in enumerate(batches):
        jtable, jacc, jloss, jscores = jax_fm.train_step_body(
            jspec, jtable, jacc, uniq_ids=None,
            **{k: jnp.asarray(v) for k, v in b.items()})
        table, acc, loss, scores = port_fm.train_step_body(
            spec, table, acc, **{k: torch.from_numpy(v)
                                 for k, v in b.items()})
        for got, want in ((table, jtable), (acc, jacc), (loss, jloss),
                          (scores, jscores)):
            got = got.numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i}")
        if i == 4:
            assert float(loss) == 0.0 and float(jloss) == 0.0
    assert fm_kernel.launches == 0 and fm_kernel.bwd_launches == 0
    # The pad row stays dead, and rows no batch touched never moved.
    assert not table[cfg.pad_id].any()
    assert np.array_equal(acc[cfg.pad_id].numpy(), acc0[cfg.pad_id])


def test_filler_batch_leaves_state_untouched():
    cfg = load_config(os.path.join(REPO, "sample.cfg"))
    spec = port_fm.ModelSpec.from_config(cfg)
    table, acc = convert.state_from_numpy(
        np.random.default_rng(0).uniform(-1, 1, (cfg.vocabulary_size,
                                                 cfg.row_dim)),
        np.full((cfg.vocabulary_size, cfg.row_dim), 0.1), cfg, CPU)
    t0, a0 = table.clone(), acc.clone()
    b = {k: torch.from_numpy(v) for k, v in _filler(cfg).items()}
    table, acc, loss, scores = port_fm.train_step_body(spec, table, acc,
                                                       **b)
    assert float(loss) == 0.0 and not scores.any()
    assert torch.equal(table, t0) and torch.equal(acc, a0)
    assert float(acc[cfg.pad_id, 0]) == np.float32(0.1)


def test_device_dedup_sorts_pad_last_without_fill():
    cfg = load_config(os.path.join(REPO, "sample.cfg"))
    spec = port_fm.ModelSpec.from_config(cfg)
    raw = torch.tensor([[5, 3, cfg.pad_id], [3, 199, cfg.pad_id]],
                       dtype=torch.int32)
    uniq, local = port_fm._device_dedup(spec, raw)
    assert uniq.tolist() == [3, 5, 199, cfg.pad_id]
    assert uniq.dtype == local.dtype == torch.int32
    assert torch.equal(uniq[local.long()], raw)


def _write_cfg(wd, extra=""):
    with open(os.path.join(REPO, "sample.cfg")) as fh:
        text = fh.read()
    text = (text.replace("./model/fm_model", os.path.join(wd, "fm_model"))
            .replace("./log/fm.log", os.path.join(wd, "fm.log"))
            .replace("./score", os.path.join(wd, "score"))
            .replace("data/", os.path.join(REPO, "data") + "/"))
    path = os.path.join(wd, "sample.cfg")
    with open(path, "w") as fh:
        fh.write(text + extra)
    return path


_JAX_RUN = r'''
import runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.train as jax_train
cfg_path, table = sys.argv[1], np.load(sys.argv[2])
jax_train.init_table = lambda cfg, seed=0: jnp.asarray(table)
assert jax.device_count() == 1, jax.devices()
for mode in ("train", "predict"):
    sys.argv = ["run_tffm.py", mode, cfg_path]
    try:
        runpy.run_path(RUN_TFFM, run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
'''


def _log_values(path):
    with open(path) as fh:
        text = fh.read()
    aucs = [float(a) for a in re.findall(
        r"epoch \d+ validation AUC ([0-9.]+) over 500 examples", text)]
    done = re.findall(r"training done: (\d+) steps, final loss ([0-9.]+),",
                      text)
    assert len(done) == 1, text[-2000:]
    return aucs, int(done[0][0]), float(done[0][1])


def _scores(path):
    with open(path) as fh:
        return np.array([float(s) for s in fh.read().split()])


def test_sample_cfg_train_then_predict_matches_jax(tmp_path):
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jwd)
    os.makedirs(pwd)
    jcfg_path, pcfg_path = _write_cfg(jwd), _write_cfg(pwd)
    cfg = load_config(pcfg_path)
    rng = np.random.default_rng(23)
    table0 = rng.uniform(-cfg.init_value_range, cfg.init_value_range,
                         (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    table0[-1] = 0.0
    np.save(os.path.join(jwd, "table0.npy"), table0)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_RUN.replace("RUN_TFFM",
                              repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run(
        [sys.executable, "-c", script, jcfg_path,
         os.path.join(jwd, "table0.npy")], cwd=jwd, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]

    acc0 = np.full_like(table0, cfg.adagrad_init)
    train(cfg, device="cpu",
          init_state=convert.state_from_numpy(table0, acc0, cfg, CPU))
    assert main(["predict", pcfg_path, "--device", "cpu"]) == 0

    j_auc, j_steps, j_loss = _log_values(os.path.join(jwd, "fm.log"))
    p_auc, p_steps, p_loss = _log_values(os.path.join(pwd, "fm.log"))
    assert p_steps == j_steps == 80 and len(p_auc) == len(j_auc) == 5
    np.testing.assert_allclose(p_auc, j_auc, atol=1e-3)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    with np.load(os.path.join(jwd, "fm_model.npz")) as j, \
            np.load(os.path.join(pwd, "fm_model.npz")) as p:
        assert p["table"].shape == j["table"].shape == (200, 9)
        assert p["table"].dtype == j["table"].dtype == np.float32
        np.testing.assert_allclose(p["table"], j["table"], rtol=1e-4,
                                   atol=1e-6)
    j_scores = _scores(os.path.join(jwd, "score", "sample_test.txt.score"))
    p_scores = _scores(os.path.join(pwd, "score", "sample_test.txt.score"))
    assert p_scores.shape == j_scores.shape == (500,)
    np.testing.assert_allclose(p_scores, j_scores, atol=1e-5)


def test_cli_trains_from_a_fresh_table(tmp_path):
    cfg_path = _write_cfg(str(tmp_path))
    with open(cfg_path) as fh:
        text = fh.read().replace("epoch_num = 5", "epoch_num = 1")
    with open(cfg_path, "w") as fh:
        fh.write(text)
    cfg = load_config(cfg_path)
    assert main(["train", cfg_path, "--device", "cpu"]) == 0
    with np.load(cfg.model_file + ".npz") as npz:
        table = npz["table"]
    assert table.shape == (cfg.vocabulary_size, cfg.row_dim)
    assert np.isfinite(table).all()
    aucs, steps, loss = _log_values(cfg.log_file)
    assert steps == 16 and len(aucs) == 1 and aucs[0] > 0.9
    assert main(["train"]) == 2
    assert main(["train", cfg_path, "--device", "tpu"]) == 2


def test_train_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = load_config(_write_cfg(str(tmp_path)))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train(cfg)


@pytest.mark.parametrize("extra,item", [
    ("[Train]\nuniq_bucket = 1024\n", "A10"),
])
def test_unported_keys_raise(tmp_path, extra, item):
    """A key ROADMAP.md ``item`` ported: ``uniq_bucket`` sizes the
    fixed unique bucket of multi-process input and, on one process, is
    inert, as in the JAX package: the run trains."""
    path = os.path.join(str(tmp_path), "sample.cfg")
    _write_cfg(str(tmp_path))
    with open(path) as fh:
        text = fh.read()
    section, line = extra.split("\n", 1)
    text = text.replace(section, section + "\n" + line, 1)
    with open(path, "w") as fh:
        fh.write(text)
    cfg = dataclasses.replace(load_config(path), epoch_num=1)
    table = train(cfg, device="cpu")
    assert table.shape == (cfg.num_rows, cfg.row_dim)
    assert torch.isfinite(table).all()


@pytest.mark.parametrize("changes,item", [
    (dict(uniq_bucket=1024), "A10"),
    (dict(elastic="shrink"), "A10"),
])
def test_unported_values_raise(tmp_path, changes, item):
    """Values ROADMAP.md ``item`` ported: ``uniq_bucket`` (its first
    slice) and ``elastic`` (its second) act across processes and, on
    one process, are inert as in the JAX package: the run trains, and
    an elastic one leaves no lease directory."""
    cfg = dataclasses.replace(load_config(_write_cfg(str(tmp_path))),
                              epoch_num=1, **changes)
    assert torch.isfinite(train(cfg, device="cpu")).all()
    assert not os.path.exists(cfg.model_file + ".hb")


def test_existing_checkpoint_raises(tmp_path):
    from fast_tffm_tpu.checkpoint import CheckpointState as JaxCkpt
    from fast_tffm_tpu.train import ckpt_state
    path = _write_cfg(str(tmp_path))
    cfg, jcfg = load_config(path), jax_load_config(path)
    jckpt = JaxCkpt(jcfg.model_file)
    jckpt.save(80, *ckpt_state(jcfg, jax_fm.init_table(jcfg),
                               jax_fm.init_accumulator(jcfg)),
               vocabulary_size=jcfg.vocabulary_size, wait=True)
    jckpt.close()
    with pytest.raises(ValueError, match="save_checkpoint_from_numpy"):
        train(cfg, device="cpu")
    assert sorted(os.listdir(cfg.model_file + ".ckpt")) == [
        "80", "manifest-80.json"]
    assert not os.path.exists(cfg.model_file + ".npz")


def test_dist_train_argv_raises(tmp_path, capsys):
    """The ``dist_train`` argv as ``run_tffm.py`` parses it: a task
    index out of range for ``worker_hosts`` raises (a one-host config
    has only worker 0, which trains alone), a ``ps`` role explains
    itself and exits 0, a bad index or role is a usage error, and
    ``train --join`` without ``elastic = grow`` raises naming the knob,
    as in the JAX package."""
    path = _write_cfg(str(tmp_path))
    with pytest.raises(ValueError, match="out of range"):
        main(["train", path, "--device", "cpu", "dist_train", "worker",
              "1"])
    assert main(["train", path, "--device", "cpu", "dist_train", "ps",
                 "0"]) == 0
    assert "no parameter servers" in capsys.readouterr().err
    for rest in (["dist_train", "worker", "x"], ["dist_train", "chief", "0"],
                 ["dist_train", "worker"]):
        assert main(["train", path, "--device", "cpu", *rest]) == 2
    assert main(["predict", path, "--device", "cpu", "--join"]) == 2
    with pytest.raises(ValueError, match="requires elastic = grow"):
        main(["train", path, "--device", "cpu", "--join"])


def test_observability_knobs_are_logged_as_ignored(tmp_path):
    # Every observability key takes effect, protocol_trace included: no
    # key is logged as ignored, and a single process posts no collective,
    # so its traced stream holds spans and no collective event.
    from fast_tffm_tpu_torch.obs.sink import read_events
    path = _write_cfg(str(tmp_path))
    cfg = dataclasses.replace(load_config(path), epoch_num=1,
                              trace_spans=True, protocol_trace=True,
                              metrics_file="auto", validation_files=())
    train(cfg, device="cpu")
    with open(cfg.log_file) as fh:
        text = fh.read()
    assert "is accepted and ignored" not in text
    assert "item A11b" not in text
    kinds = [e["event"] for e in read_events(cfg.model_file
                                             + ".metrics.jsonl")]
    assert "span" in kinds and "collective" not in kinds
