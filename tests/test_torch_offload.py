"""``lookup = host`` runs of the port (fast_tffm_tpu_torch) against the
JAX package's, on the CPU, where the port's offload backend runs in
plain mode (the kernels' plain versions on CPU tensors).

- sample.cfg with ``lookup = host``: ``train``, ``train`` again (resume
  from step 80 to 160) and ``predict`` through the port's CLI against
  ``run_tffm.py`` (a subprocess with one CPU device, its init patched to
  the port's host init of the same seed): step counts, the resume line,
  per-epoch validation AUC within 1e-3, final losses at rtol 1e-4,
  checkpointed tables and accumulators at rtol 1e-4 / atol 1e-6, and
  the score files at atol 1e-5.
- The port's offload run against its own device-lookup run from the same
  seed: tables and accumulators at rtol 1e-4 / atol 1e-6; offload
  predict on the padded and the packed wire equal to device predict byte
  for byte.
- ``restore_partial`` reads no accumulator; ``train()`` returns the host
  table; a multi-process offload run and ``ScorerServer`` are refused
  with the JAX package's messages.
- ``run_mode = stream`` with ``lookup = host`` against the JAX package's
  stream run: steps, watermarks, the published step, tables and
  accumulators.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu import checkpoint as jck
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch import lookup
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.train import checkpoint_template, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_TXT = os.path.join(REPO, "data", "sample_train.txt")
TEST_TXT = os.path.join(REPO, "data", "sample_test.txt")

# run_tffm.py in one process with one CPU device, the offload backend's
# init (models.fm.init_table, read when the backend is built) patched to
# the given table; then each mode in turn.
_JAX_RUN = r'''
import runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.models.fm as jax_fm
cfg_path, table, modes = sys.argv[1], np.load(sys.argv[2]), sys.argv[3:]
jax_fm.init_table = lambda cfg, seed=0: jnp.asarray(table)
assert jax.device_count() == 1, jax.devices()
for mode in modes:
    sys.argv = ["run_tffm.py", mode, cfg_path]
    try:
        runpy.run_path(RUN_TFFM, run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
'''


def _jax_run(wd, cfg_path, table0, *modes):
    np.save(os.path.join(wd, "table0.npy"), table0)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_RUN.replace("RUN_TFFM",
                              repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run(
        [sys.executable, "-c", script, cfg_path,
         os.path.join(wd, "table0.npy"), *modes], cwd=wd, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _write_cfg(wd, general="lookup = host\n", train_extra=""):
    with open(os.path.join(REPO, "sample.cfg")) as fh:
        text = fh.read()
    text = (text.replace("./model/fm_model", os.path.join(wd, "fm_model"))
            .replace("./log/fm.log", os.path.join(wd, "fm.log"))
            .replace("./score", os.path.join(wd, "score"))
            .replace("data/", os.path.join(REPO, "data") + "/")
            .replace("[General]\n", "[General]\n" + general, 1)
            .replace("[Train]\n", "[Train]\n" + train_extra, 1))
    os.makedirs(wd, exist_ok=True)
    path = os.path.join(wd, "sample.cfg")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _host_table0(cfg):
    """The port's offload init of ``cfg.seed``, as the JAX run's table."""
    table, _ = lookup.init_host_state(cfg, cfg.seed)
    return table[:cfg.num_rows].numpy().copy()


def _log(path):
    with open(path) as fh:
        text = fh.read()
    aucs = [float(a) for a in re.findall(
        r"epoch \d+ validation AUC ([0-9.]+) over 500 examples", text)]
    done = [(int(n), float(v)) for n, v in re.findall(
        r"training done: (\d+) steps, final loss ([0-9.]+),", text)]
    return text, aucs, done


def _port_state(cfg, step=None):
    r = ck.CheckpointState(cfg.model_file).restore(
        step=step, template=checkpoint_template(cfg))
    return r["table"].numpy(), r["acc"].numpy()


def _jax_state(jcfg, step):
    from fast_tffm_tpu.train import checkpoint_template as jax_template
    ckpt = jck.CheckpointState(jcfg.model_file)
    try:
        r = ckpt.restore(step=step, template=jax_template(jcfg))
    finally:
        ckpt.close()
    n = jcfg.vocabulary_size + 1
    return np.asarray(r["table"])[:n], np.asarray(r["acc"])[:n]


def _scores(path):
    with open(path) as fh:
        return np.array([float(s) for s in fh.read().split()])


def test_sample_cfg_offload_train_resume_predict_matches_jax(tmp_path):
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath, ppath = _write_cfg(jwd), _write_cfg(pwd)
    cfg, jcfg = load_config(ppath), jax_load_config(jpath)
    assert cfg.lookup == jcfg.lookup == "host"
    _jax_run(jwd, jpath, _host_table0(cfg), "train", "train", "predict")
    for _ in range(2):
        assert main(["train", ppath, "--device", "cpu"]) == 0
    assert main(["predict", ppath, "--device", "cpu"]) == 0

    (jtext, jaucs, jdone), (ptext, paucs, pdone) = (
        _log(os.path.join(jwd, "fm.log")), _log(os.path.join(pwd, "fm.log")))
    assert [n for n, _ in pdone] == [n for n, _ in jdone] == [80, 160]
    for text in (jtext, ptext):
        assert text.count("restored checkpoint at step 80") == 1
        assert "offload lookup [pinned-host" in text
        assert "offload predict [PinnedHostLookup]" in text
    assert "offload lookup [pinned-host (plain)]: table [4096, 9] outside " \
           "HBM (0.00 GB + accumulator)" in ptext
    assert len(paucs) == len(jaucs) == 10
    np.testing.assert_allclose(paucs, jaucs, atol=1e-3)
    np.testing.assert_allclose([v for _, v in pdone],
                               [v for _, v in jdone], rtol=1e-4)
    assert ck.list_step_dirs(cfg.model_file + ".ckpt") == \
        jck.list_step_dirs(jcfg.model_file + ".ckpt") == [80, 160]
    for step in (80, 160):
        for got, want in zip(_port_state(cfg, step),
                             _jax_state(jcfg, step)):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    got = _scores(os.path.join(pwd, "score", "sample_test.txt.score"))
    want = _scores(os.path.join(jwd, "score", "sample_test.txt.score"))
    assert got.shape == want.shape == (500,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_offload_matches_device_lookup_and_predicts_bit_equal(tmp_path):
    """One epoch with lookup = host and with lookup = device from the
    same seed (on the CPU both draw the table from one CPU generator);
    then the offload checkpoint predicted by device lookup and by offload
    lookup on both wires."""
    cfgs = {}
    for name, general in (("host", "lookup = host\n"), ("device", "")):
        path = _write_cfg(str(tmp_path / name), general=general)
        cfgs[name] = dataclasses.replace(load_config(path), epoch_num=1)
        table = train(cfgs[name], device="cpu")
        assert table.shape == (cfgs[name].num_rows, cfgs[name].row_dim)
        if name == "host":
            # train() returns a view of the host state: what was saved.
            assert torch.equal(table, torch.from_numpy(
                _port_state(cfgs[name])[0]))
    for got, want in zip(_port_state(cfgs["host"]),
                         _port_state(cfgs["device"])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    from fast_tffm_tpu_torch.predict import predict
    host = cfgs["host"]
    outs = {}
    for name, change in (("device", dict(lookup="device")),
                         ("padded", {}),
                         ("packed", dict(wire_format="packed"))):
        c = dataclasses.replace(host, score_path=str(tmp_path / name),
                                **change)
        (path,) = predict(c, device="cpu")
        outs[name] = _read(path)
    assert len(outs["device"].splitlines()) == 500
    assert outs["padded"] == outs["device"]
    assert outs["packed"] == outs["device"]
    # A caller-held host table scores the same bytes (for_table).
    c = dataclasses.replace(host, score_path=str(tmp_path / "held"))
    (path,) = predict(c, table=torch.from_numpy(_port_state(host)[0]),
                      device="cpu")
    assert _read(path) == outs["device"]


def test_restore_partial_reads_no_accumulator(tmp_path, monkeypatch):
    cfg = dataclasses.replace(load_config(_write_cfg(str(tmp_path))),
                              epoch_num=1)
    train(cfg, device="cpu")
    loaded = []
    real_load = torch.load

    def spy(path, *args, **kwargs):
        loaded.append(os.path.basename(path))
        return real_load(path, *args, **kwargs)

    monkeypatch.setattr(torch, "load", spy)
    ckpt = ck.CheckpointState(cfg.model_file)
    r = ckpt.restore_partial(checkpoint_template(cfg, acc=False))
    ckpt.close()
    assert loaded == ["table.pt"] and "acc" not in r and r["step"] == 16
    lean = lookup.PinnedHostLookup.from_checkpoint(cfg, with_acc=False,
                                                 device="cpu")
    assert lean.acc is None and loaded == ["table.pt", "table.pt"]
    assert np.array_equal(lean.table[:cfg.num_rows].numpy(),
                          _port_state(cfg)[0])


def test_offload_refusals_use_the_jax_messages(tmp_path):
    from fast_tffm_tpu.serve.server import ScorerServer as JaxServer
    from fast_tffm_tpu_torch.models.convert import \
        save_checkpoint_from_numpy
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    path = _write_cfg(str(tmp_path))
    cfg, jcfg = load_config(path), jax_load_config(path)
    save_checkpoint_from_numpy(cfg, _host_table0(cfg), None, 3)
    with pytest.raises(ValueError) as port_err:
        ScorerServer(cfg, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        JaxServer(jcfg)
    assert str(port_err.value) == str(jax_err.value)
    assert "serving requires lookup = device" in str(port_err.value)
    with pytest.raises(ValueError, match="single-process by design"):
        train(dataclasses.replace(cfg, worker_hosts=("a:1", "b:2")),
              device="cpu")
    with pytest.raises(ValueError, match="init_state"):
        train(cfg, device="cpu", init_state=(torch.zeros(1), torch.zeros(1)))


SHARD_LINES = 640   # 5 batches of 128


def _stream_cfg(wd, side, sd):
    os.makedirs(os.path.join(wd, side), exist_ok=True)
    path = os.path.join(wd, side, "stream.cfg")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = 200
hash_feature_id = False
factor_num = 8
lookup = host
model_file = {os.path.join(wd, side, 'fm_model')}
log_file = {os.path.join(wd, side, 'fm.log')}

[Train]
run_mode = stream
stream_dir = {sd}
stream_poll_seconds = 0.05
seal_policy = done
batch_size = 128
learning_rate = 0.1
log_steps = 5
save_steps = 4
validation_files = {TEST_TXT}
publish_interval_seconds = 3600
publish_min_auc = 0.5
""")
    return path


def test_stream_run_with_offload_matches_jax(tmp_path):
    wd = str(tmp_path)
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    with open(TRAIN_TXT) as fh:
        lines = fh.read().splitlines()
    for k in (0, 1):
        part = os.path.join(sd, f"part-{k:03d}")
        with open(part, "w") as fh:
            fh.write("\n".join(lines[k * SHARD_LINES:(k + 1) * SHARD_LINES])
                     + "\n")
        open(part + ".done", "w").close()
    open(os.path.join(sd, "STOP"), "w").close()
    jpath, ppath = _stream_cfg(wd, "jax", sd), _stream_cfg(wd, "port", sd)
    cfg, jcfg = load_config(ppath), jax_load_config(jpath)
    _jax_run(wd, jpath, _host_table0(cfg), "train")
    train(cfg, device="cpu")
    pdir, jdir = cfg.model_file + ".ckpt", jcfg.model_file + ".ckpt"
    # Periodic saves at 4 and 8, the final save at 10, its exit publish.
    assert ck.list_step_dirs(pdir) == jck.list_step_dirs(jdir) == [4, 8, 10]
    for step in (4, 8, 10):
        assert ck.read_watermark(pdir, step) == \
            jck.read_watermark(jdir, step) is not None
    assert ck.read_published(pdir) == jck.read_published(jdir) == 10
    for got, want in zip(_port_state(cfg, 10), _jax_state(jcfg, 10)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    pb, jb = ck.read_gate_baseline(pdir), ck.read_gate_baseline(jdir)
    assert pb is not None and jb is not None and abs(pb - jb) <= 1e-5
