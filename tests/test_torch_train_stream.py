"""Training on the new streams, against the JAX package, on the CPU, at
the training tolerance (rtol 1e-4 / atol 1e-6 on tables and
accumulators):

- ``sample.cfg`` with ``weight_files`` and ``validation_weight_files``
  (and ``bad_line_policy = quarantine`` over a copy of the train file
  with planted bad lines), trained by the port and by ``run_tffm.py
  train`` (a subprocess with one CPU device) from one shared table: the
  per-epoch weighted validation AUC, the final loss, the exported table
  and the quarantine file;
- ``evaluate`` with validation weight files gives the JAX package's
  weighted AUC on one table;
- ``dedup = host``: 10 steps of host-deduped batches match the JAX
  package's ``dedup = host`` step, and a whole ``sample.cfg`` train with
  ``dedup = host`` matches the port's ``dedup = device`` one.
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

from fast_tffm_tpu import train as jax_train
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.data.pipeline import batch_iterator
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.train import evaluate, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

_JAX_TRAIN = r'''
import runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.train as jax_train
cfg_path, table = sys.argv[1], np.load(sys.argv[2])
jax_train.init_table = lambda cfg, seed=0: jnp.asarray(table)
assert jax.device_count() == 1, jax.devices()
sys.argv = ["run_tffm.py", "train", cfg_path]
try:
    runpy.run_path(RUN_TFFM, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
'''


def _weights(path, out, seed):
    with open(path) as fh:
        n = len(fh.read().splitlines())
    rng = np.random.default_rng(seed)
    with open(out, "w") as fh:
        fh.write("".join(f"{w:.3f}\n" for w in rng.uniform(0.2, 3.0, n)))
    return out


def _write_cfg(wd, train_file, extra):
    with open(os.path.join(REPO, "sample.cfg")) as fh:
        text = fh.read()
    text = (text.replace("./model/fm_model", os.path.join(wd, "fm_model"))
            .replace("./log/fm.log", os.path.join(wd, "fm.log"))
            .replace("./score", os.path.join(wd, "score"))
            .replace("data/sample_train.txt", train_file)
            .replace("data/", os.path.join(REPO, "data") + "/"))
    text = text.replace("[Train]\n", "[Train]\n" + extra, 1)
    path = os.path.join(wd, "sample.cfg")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _log_values(path):
    with open(path) as fh:
        text = fh.read()
    aucs = [float(a) for a in re.findall(
        r"epoch \d+ validation AUC ([0-9.]+) over", text)]
    done = re.findall(r"training done: (\d+) steps, final loss ([0-9.]+),",
                      text)
    assert len(done) == 1, text[-2000:]
    return aucs, int(done[0][0]), float(done[0][1])


def _table0(cfg, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-cfg.init_value_range, cfg.init_value_range,
                    (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    t[-1] = 0.0
    return t


def test_weighted_tolerant_train_matches_jax(tmp_path):
    data = str(tmp_path / "train.txt")
    with open(os.path.join(REPO, "data", "sample_train.txt")) as fh:
        lines = fh.read().splitlines()
    for i in (17, 400, 1203):  # bad lines, with weights of their own
        lines[i] = "1 7:zz"
    with open(data, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    tw = _weights(data, str(tmp_path / "train.w"), 1)
    vw = _weights(os.path.join(REPO, "data", "sample_test.txt"),
                  str(tmp_path / "test.w"), 2)
    extra = (f"weight_files = {tw}\nvalidation_weight_files = {vw}\n"
             "bad_line_policy = quarantine\nmax_bad_fraction = 0.01\n"
             "host_threads = 2\n")
    cfgs = {}
    for side in ("jax", "port"):
        wd = str(tmp_path / side)
        os.makedirs(wd)
        cfgs[side] = _write_cfg(wd, data, extra)
    cfg = load_config(cfgs["port"])
    table0 = _table0(cfg, 29)
    np.save(str(tmp_path / "table0.npy"), table0)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_TRAIN.replace("RUN_TFFM",
                                repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run(
        [sys.executable, "-c", script, cfgs["jax"],
         str(tmp_path / "table0.npy")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    train(cfg, device="cpu", init_state=convert.state_from_numpy(
        table0, np.full_like(table0, cfg.adagrad_init), cfg, CPU))

    j_auc, j_steps, j_loss = _log_values(str(tmp_path / "jax" / "fm.log"))
    p_auc, p_steps, p_loss = _log_values(cfg.log_file)
    assert p_steps == j_steps == 80 and len(p_auc) == len(j_auc) == 5
    np.testing.assert_allclose(p_auc, j_auc, atol=1e-5)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    with np.load(str(tmp_path / "jax" / "fm_model.npz")) as j, \
            np.load(cfg.model_file + ".npz") as p:
        np.testing.assert_allclose(p["table"], j["table"], rtol=1e-4,
                                   atol=1e-6)
    quarantined = []
    for side in ("jax", "port"):
        with open(str(tmp_path / side / "fm_model.quarantine"), "rb") as fh:
            quarantined.append(fh.read())
    assert quarantined[1] == quarantined[0]
    assert quarantined[1].count(b"\n") == 3
    with open(cfg.log_file) as fh:
        log = fh.read()
    assert "host data plane: 2 parallel batch-build workers" not in log
    assert "3 bad line(s) of 2000 scanned" in log


def test_weighted_evaluate_matches_jax(tmp_path):
    path = os.path.join(REPO, "sample.cfg")
    cfg = load_config(path)
    test = os.path.join(REPO, "data", "sample_test.txt")
    vw = _weights(test, str(tmp_path / "test.w"), 3)
    table = np.random.default_rng(4).normal(
        0, 0.3, (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    table[-1] = 0.0
    for dedup in ("device", "host"):
        jcfg = dataclasses.replace(jax_load_config(path), dedup=dedup)
        pcfg = dataclasses.replace(cfg, dedup=dedup)
        want = jax_train.evaluate(jcfg, jnp.asarray(table), [test],
                                  weight_files=[vw])
        got = evaluate(pcfg, torch.from_numpy(table), [test],
                       weight_files=[vw])
        unweighted = evaluate(pcfg, torch.from_numpy(table), [test])
        assert got[1] == want[1] == 500
        assert abs(got[0] - want[0]) <= 1e-6
        assert abs(got[0] - unweighted[0]) > 1e-3


def test_host_dedup_steps_match_jax():
    cfg = dataclasses.replace(load_config(os.path.join(REPO, "sample.cfg")),
                              dedup="host")
    jcfg = dataclasses.replace(
        jax_load_config(os.path.join(REPO, "sample.cfg")), kernel="pallas",
        dedup="host")
    jspec = jax_fm.ModelSpec.from_config(jcfg)
    spec = port_fm.ModelSpec.from_config(cfg)
    assert spec.dedup == jspec.dedup == "host"
    table0 = _table0(cfg, 17)
    acc0 = np.full_like(table0, cfg.adagrad_init)
    jtable, jacc = jnp.asarray(table0), jnp.asarray(acc0)
    table, acc = convert.state_from_numpy(table0.copy(), acc0.copy(), cfg,
                                          CPU)
    batches = list(batch_iterator(cfg, cfg.train_files, training=True,
                                  epochs=1, raw_ids=False))[:10]
    for i, b in enumerate(batches):
        assert b.uniq_ids is not None
        args = {k: getattr(b, k) for k in ("labels", "weights", "uniq_ids",
                                           "local_idx", "vals")}
        jtable, jacc, jloss, jscores = jax_fm.train_step_body(
            jspec, jtable, jacc, **{k: jnp.asarray(v)
                                    for k, v in args.items()})
        table, acc, loss, scores = port_fm.train_step_body(
            spec, table, acc, **port_fm.batch_args(b, CPU))
        for got, want in ((table, jtable), (acc, jacc), (loss, jloss),
                          (scores, jscores)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i}")
    with pytest.raises(ValueError, match="raw_ids=False"):
        port_fm.train_step_body(spec, table, acc, **port_fm.batch_args(
            next(batch_iterator(cfg, cfg.train_files)), CPU))


def test_host_dedup_train_matches_device_dedup(tmp_path):
    tables = {}
    for dedup in ("device", "host"):
        wd = str(tmp_path / dedup)
        os.makedirs(wd)
        cfg = load_config(_write_cfg(
            wd, "data/sample_train.txt", f"dedup = {dedup}\n"))
        assert port_fm.ModelSpec.from_config(cfg).dedup == dedup
        table0 = _table0(cfg, 41)
        train(cfg, device="cpu", init_state=convert.state_from_numpy(
            table0, np.full_like(table0, cfg.adagrad_init), cfg, CPU))
        with np.load(cfg.model_file + ".npz") as npz:
            tables[dedup] = (npz["table"], _log_values(cfg.log_file))
    (t_dev, (a_dev, s_dev, l_dev)), (t_host, (a_host, s_host, l_host)) = (
        tables["device"], tables["host"])
    assert s_dev == s_host == 80
    np.testing.assert_allclose(t_host, t_dev, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(l_host, l_dev, rtol=1e-4)
    np.testing.assert_allclose(a_host, a_dev, atol=1e-5)
