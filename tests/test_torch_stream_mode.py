"""``run_mode = stream`` in the port's ``train`` against ``run_tffm.py
train`` (a subprocess with one CPU device), on the CPU, from one shared
initial table, at the training tolerance (rtol 1e-4 / atol 1e-6 on tables
and accumulators):

- two runs on one stream directory (shards 1-2 and ``STOP``; then shard 3
  and a new ``STOP``): after each, the steps, every ``watermark-<step>``
  sidecar, the published step (the exit publish, and the deterministic
  retention-pressure publish of run 2) and the ``gate_baseline`` agree;
- a gate that holds (labels of the validation copy flipped): the pointer
  does not move, with the JAX package's log line;
- port only: the retention pause under a holding gate, a SIGTERM at a
  seeded step whose resume ends bit for bit at the uninterrupted run's
  table, ``slo_min_auc`` switching the quality sweep on, and
  ``publish_interval_seconds`` inert in ``run_mode = epochs`` (as in
  the JAX package);
- ``PublishGate`` and ``QualityStats`` against the JAX package's on a
  table of cases.

No publish here depends on when the publish clock fires: the interval is
an hour, so publishes are the exit publish and the retention-pressure
publish, both decided by steps.
"""

import dataclasses
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fast_tffm_tpu import checkpoint as jck
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.obs import quality as jq
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.obs import quality as pq
from fast_tffm_tpu_torch.train import checkpoint_template, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SHARD_LINES = 640   # 5 batches of 128
TRAIN_TXT = os.path.join(REPO, "data", "sample_train.txt")
TEST_TXT = os.path.join(REPO, "data", "sample_test.txt")

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


def _sample_lines():
    with open(TRAIN_TXT) as fh:
        return fh.read().splitlines()


def _shard(sd, k, lines=None):
    lines = lines if lines is not None else \
        _sample_lines()[k * SHARD_LINES:(k + 1) * SHARD_LINES]
    path = os.path.join(sd, f"part-{k:03d}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    open(path + ".done", "w").close()


def _stop(sd):
    open(os.path.join(sd, "STOP"), "w").close()


def _cfg_text(wd, side, sd, val, extra="", save_steps=4):
    return f"""[General]
vocabulary_size = 200
hash_feature_id = False
factor_num = 8
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
save_steps = {save_steps}
validation_files = {val}
{extra}
"""


def _write_cfgs(wd, sd, val, extra):
    paths = {}
    for side in ("jax", "port"):
        os.makedirs(os.path.join(wd, side), exist_ok=True)
        paths[side] = os.path.join(wd, side, "stream.cfg")
        with open(paths[side], "w") as fh:
            fh.write(_cfg_text(wd, side, sd, val, extra))
    return paths


def _table0(cfg, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-cfg.init_value_range, cfg.init_value_range,
                    (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    t[-1] = 0.0
    return t


def _jax_train(wd, cfg_path, table0_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_TRAIN.replace("RUN_TFFM",
                                repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run([sys.executable, "-c", script, cfg_path,
                           table0_path], cwd=wd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _read(path):
    with open(path) as fh:
        return fh.read()


def _done_steps(log):
    return [int(n) for n in re.findall(r"training done: (\d+) steps", log)]


def _published_steps(log):
    return [int(n) for n in re.findall(
        r"published checkpoint step (\d+) \(size-verified\)", log)]


def _jax_state(jcfg, step):
    from fast_tffm_tpu.train import checkpoint_template as jax_template
    ckpt = jck.CheckpointState(jcfg.model_file)
    try:
        r = ckpt.restore(step=step, template=jax_template(jcfg))
    finally:
        ckpt.close()
    n = jcfg.vocabulary_size + 1
    return np.asarray(r["table"])[:n], np.asarray(r["acc"])[:n]


def _port_state(cfg, step):
    r = ck.CheckpointState(cfg.model_file).restore(
        step=step, template=checkpoint_template(cfg))
    return r["table"].numpy(), r["acc"].numpy()


def _assert_runs_agree(cfgs, steps):
    jcfg, cfg = cfgs
    jdir, pdir = jcfg.model_file + ".ckpt", cfg.model_file + ".ckpt"
    assert ck.list_step_dirs(pdir) == jck.list_step_dirs(jdir) == steps
    for step in steps:
        assert ck.read_watermark(pdir, step) == \
            jck.read_watermark(jdir, step) is not None, step
    jt, ja = _jax_state(jcfg, steps[-1])
    pt, pa = _port_state(cfg, steps[-1])
    np.testing.assert_allclose(pt, jt, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pa, ja, rtol=1e-4, atol=1e-6)
    assert ck.read_published(pdir) == jck.read_published(jdir)
    pb, jb = ck.read_gate_baseline(pdir), jck.read_gate_baseline(jdir)
    assert pb is not None and jb is not None and abs(pb - jb) <= 1e-5


def test_two_stream_runs_match_jax(tmp_path):
    wd = str(tmp_path)
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    for k in (0, 1):
        _shard(sd, k)
    _stop(sd)
    cfg_paths = _write_cfgs(wd, sd, TEST_TXT,
                            "publish_interval_seconds = 3600\n"
                            "publish_min_auc = 0.5\n")
    cfg, jcfg = load_config(cfg_paths["port"]), jax_load_config(
        cfg_paths["jax"])
    table0 = _table0(cfg, 31)
    np.save(os.path.join(wd, "table0.npy"), table0)

    def run_both(first):
        _jax_train(wd, cfg_paths["jax"], os.path.join(wd, "table0.npy"))
        train(cfg, device="cpu", init_state=None if not first else
              convert.state_from_numpy(
                  table0.copy(), np.full_like(table0, cfg.adagrad_init),
                  cfg, CPU))

    run_both(True)
    # Run 1: periodic saves at 4 and 8, the final save at 10 and the
    # exit publish of step 10.
    _assert_runs_agree((jcfg, cfg), [4, 8, 10])
    assert ck.read_published(cfg.model_file + ".ckpt") == 10
    os.remove(os.path.join(sd, "STOP"))
    _shard(sd, 2)
    _stop(sd)
    run_both(False)
    # Run 2 restores step 10 and its watermark. The save at 12 puts the
    # published step 10 one save from retention (margin 2 under a
    # gate): the pressure arm publishes 12; the exit publishes 15.
    _assert_runs_agree((jcfg, cfg), [10, 12, 15])
    for side in ("jax", "port"):
        log = _read(os.path.join(wd, side, "fm.log"))
        assert _done_steps(log) == [10, 15], side
        assert _published_steps(log) == [10, 12, 15], side
        assert "restored checkpoint at step 10" in log
    wm = ck.read_watermark(cfg.model_file + ".ckpt", 15)
    assert [f["lines"] for f in wm["files"]] == [SHARD_LINES] * 3


def test_holding_gate_matches_jax(tmp_path):
    wd = str(tmp_path)
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    for k in (0, 1):
        _shard(sd, k)
    _stop(sd)
    flipped = os.path.join(wd, "flipped.txt")
    with open(flipped, "w") as fh:
        for line in _read(TEST_TXT).splitlines():
            y, rest = line.split(" ", 1)
            fh.write(f"{1 - int(float(y))} {rest}\n")
    cfg_paths = _write_cfgs(wd, sd, flipped,
                            "publish_interval_seconds = 3600\n"
                            "publish_min_auc = 0.5\n")
    cfg = load_config(cfg_paths["port"])
    table0 = _table0(cfg, 5)
    np.save(os.path.join(wd, "table0.npy"), table0)
    _jax_train(wd, cfg_paths["jax"], os.path.join(wd, "table0.npy"))
    train(cfg, device="cpu", init_state=convert.state_from_numpy(
        table0.copy(), np.full_like(table0, cfg.adagrad_init), cfg, CPU))
    held = {}
    for side in ("jax", "port"):
        d = os.path.join(wd, side, "fm_model.ckpt")
        assert ck.read_published(d) is None
        assert ck.read_gate_baseline(d) is None
        log = _read(os.path.join(wd, side, "fm.log"))
        (line,) = re.findall(r"publish GATE HELD at step .*", log)
        held[side] = line
    auc = {k: float(re.search(r"AUC ([0-9.]+)", v).group(1))
           for k, v in held.items()}
    assert abs(auc["port"] - auc["jax"]) <= 1e-5 and auc["port"] < 0.5
    mask = {k: re.sub(r"AUC [0-9.]+", "AUC x", v) for k, v in held.items()}
    assert mask["port"] == mask["jax"] == (
        "publish GATE HELD at step 10: AUC x below publish_min_auc 0.5 "
        "— the published pointer stays on the last passing step")


def _port_subprocess(cfg_path, out_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    with open(out_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "fast_tffm_tpu_torch", "train", cfg_path,
             "--device", "cpu"], cwd=REPO, env=env, stdout=out,
            stderr=subprocess.STDOUT)


def _wait_for(proc, out_path, fn, what, deadline_s=120.0):
    deadline = time.monotonic() + deadline_s
    while not fn():
        assert proc.poll() is None, (
            f"trainer exited before {what}:\n{_read(out_path)[-3000:]}")
        assert time.monotonic() < deadline, (
            f"timed out waiting for {what}\n{_read(out_path)[-3000:]}")
        time.sleep(0.02)


def test_gate_hold_pauses_retention_and_final_save_spares_pointer(
        tmp_path):
    """The JAX package's retention-pause scenario through the port's CLI:
    while a label-flipped burst holds the gate, periodic saves pause
    once the published step sits at the retention boundary, and the
    final save on STOP leaves that step in place."""
    from tools.fmchaos import _corpus_lines, _write_corpus
    wd = str(tmp_path)
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    val = os.path.join(wd, "val.txt")
    _write_corpus(val, 200, 1)

    def flip(line):
        y, rest = line.split(" ", 1)
        return f"{1 - int(y)} {rest}"

    _shard(sd, 0, _corpus_lines(400, 0))
    cfg_path = os.path.join(wd, "gate.cfg")
    model = os.path.join(wd, "model", "fm")
    with open(cfg_path, "w") as fh:
        fh.write(f"""
[General]
vocabulary_size = 200
factor_num = 4
model_file = {model}
log_file = {os.path.join(wd, 'trainer.log')}

[Train]
run_mode = stream
stream_dir = {sd}
stream_poll_seconds = 0.05
seal_policy = done
shuffle = false
batch_size = 32
learning_rate = 0.1
log_steps = 0
save_steps = 3
publish_interval_seconds = 0.2
publish_min_auc = 0.7
validation_files = {val}
""")
    out_path = os.path.join(wd, "trainer.out")
    ckpt_dir = model + ".ckpt"
    proc = _port_subprocess(cfg_path, out_path)
    try:
        _wait_for(proc, out_path,
                  lambda: ck.read_published(ckpt_dir) is not None,
                  "first publish")
        _shard(sd, 1, [flip(ln) for ln in _corpus_lines(1600, 3)])
        _wait_for(proc, out_path, lambda: "GATE HELD" in _read(out_path),
                  "gate hold")
        _shard(sd, 2, [flip(ln) for ln in _corpus_lines(1600, 4)])
        _wait_for(proc, out_path,
                  lambda: "pausing periodic saves" in _read(out_path),
                  "retention pause")
        pub = ck.read_published(ckpt_dir)
        _stop(sd)
        assert proc.wait(timeout=120) == 0, _read(out_path)[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert ck.read_published(ckpt_dir) == pub
    assert os.path.isdir(os.path.join(ckpt_dir, str(pub))), sorted(
        os.listdir(ckpt_dir))
    assert ck.verify_step_dir(ckpt_dir, pub, "size") is None


def _write_prefix(sd, lines, lo, hi):
    """Lines [lo, hi) of a stream of two 960-line shards, appended to
    their files; a shard is sealed once it is complete."""
    for k in (0, 1):
        a, b = max(lo, 960 * k), min(hi, 960 * (k + 1))
        if a >= b:
            continue
        path = os.path.join(sd, f"part-{k:03d}")
        with open(path, "a") as fh:
            fh.write("\n".join(lines[a:b]) + "\n")
        if b == 960 * (k + 1):
            open(path + ".done", "w").close()


def test_sigterm_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    wd = str(tmp_path)
    lines = _sample_lines()[:1920]
    cut = int(np.random.default_rng(20261017).integers(1, 15)) * 128
    cfg_paths, sds = {}, {}
    for side in ("whole", "cut"):
        sds[side] = os.path.join(wd, side, "stream")
        os.makedirs(sds[side])
        cfg_paths[side] = os.path.join(wd, side, "s.cfg")
        with open(cfg_paths[side], "w") as fh:
            # save_steps = 1: a committed step shows the trainer's
            # progress (saves leave the table as it is).
            fh.write(_cfg_text(wd, side, sds[side], TEST_TXT,
                               "host_threads = 1\n", save_steps=1))
    _write_prefix(sds["whole"], lines, 0, 1920)
    _stop(sds["whole"])
    whole = load_config(cfg_paths["whole"])
    want = train(whole, device="cpu").numpy()

    # The interrupted run: the first ``cut`` lines arrive, the trainer
    # steps them, then SIGTERM; the rest arrives before the restart.
    cut_cfg = load_config(cfg_paths["cut"])
    _write_prefix(sds["cut"], lines, 0, cut)
    out_path = os.path.join(wd, "cut", "run1.out")
    d = cut_cfg.model_file + ".ckpt"
    proc = _port_subprocess(cfg_paths["cut"], out_path)
    try:
        _wait_for(proc, out_path,
                  lambda: cut // 128 in ck.list_step_dirs(d),
                  "the arrived lines' steps")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, _read(out_path)[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log = _read(out_path)
    assert "preemption signalled; saving the stream position" in log
    assert ck.list_step_dirs(d)[-1] == cut // 128
    wm = ck.read_watermark(d, cut // 128)
    assert sum(f["lines"] for f in wm["files"]) == cut
    _write_prefix(sds["cut"], lines, cut, 1920)
    _stop(sds["cut"])
    got = train(cut_cfg, device="cpu").numpy()
    assert f"restored checkpoint at step {cut // 128}" in _read(
        cut_cfg.log_file)
    np.testing.assert_array_equal(got, want)
    for cfg in (whole, cut_cfg):
        d = cfg.model_file + ".ckpt"
        assert ck.list_step_dirs(d)[-1] == 15
        wm = ck.read_watermark(d, 15)
        assert [f["lines"] for f in wm["files"]] == [960, 960]


def test_slo_min_auc_switches_the_quality_sweep_on(tmp_path):
    wd = str(tmp_path)
    sd = os.path.join(wd, "stream")
    os.makedirs(sd)
    _shard(sd, 0)
    _stop(sd)
    with open(os.path.join(wd, "s.cfg"), "w") as fh:
        fh.write(_cfg_text(wd, "port", sd, TEST_TXT,
                           "publish_interval_seconds = 3600\n"
                           "[SLO]\nslo_min_auc = 0.6\n"))
    os.makedirs(os.path.join(wd, "port"))
    cfg = load_config(os.path.join(wd, "s.cfg"))
    train(cfg, device="cpu")
    log = _read(cfg.log_file)
    assert "publish quality eval at step 5: AUC" in log
    assert "slo_min_auc = " not in log and "publish gate armed" not in log
    assert "final validation AUC" not in log
    assert ck.read_published(cfg.model_file + ".ckpt") == 5
    # Without publishing, the quality sweep is off: one final
    # validation. slo_min_auc is not logged as ignored: on one process
    # it rides the metrics stream as the slo/min_auc gauge.
    cfg2 = dataclasses.replace(
        cfg, publish_interval_seconds=0.0,
        model_file=os.path.join(wd, "p2", "fm"),
        log_file=os.path.join(wd, "p2", "fm.log"))
    train(cfg2, device="cpu")
    log2 = _read(cfg2.log_file)
    assert "final validation AUC" in log2
    assert "publish quality eval" not in log2
    assert "slo_min_auc = " not in log2
    assert ck.read_published(cfg2.model_file + ".ckpt") is None


def test_publish_interval_is_inert_in_epochs_mode(tmp_path):
    # As in the JAX package: FmConfig accepts the knob in epochs mode,
    # and train never publishes or writes a watermark there.
    assert JaxFmConfig(publish_interval_seconds=5.0).run_mode == "epochs"
    cfg = FmConfig(vocabulary_size=200, factor_num=4, batch_size=128,
                   epoch_num=1, save_steps=4,
                   train_files=(TRAIN_TXT,), validation_files=(TEST_TXT,),
                   publish_interval_seconds=5.0,
                   model_file=str(tmp_path / "m" / "fm"),
                   log_file=str(tmp_path / "fm.log"))
    train(cfg, device="cpu")
    d = cfg.model_file + ".ckpt"
    assert ck.list_step_dirs(d)[-1] == 16
    assert ck.read_published(d) is None
    assert not [n for n in os.listdir(d) if n.startswith("watermark")]
    assert "epoch 0 validation AUC" in _read(cfg.log_file)


# --- the copies of PublishGate and QualityStats -----------------------------


GATE_CASES = [
    # (min_auc, max_drop, published AUCs so far, AUC to decide)
    (0.8, 0.05, [], 0.82),
    (0.8, 0.05, [], 0.7),
    (0.0, 0.05, [0.9], 0.86),
    (0.0, 0.05, [0.9], 0.84),
    (0.0, 0.05, [0.9, 0.84], 0.89),
    (0.5, 0.0, [], float("nan")),
    (0.0, 0.1, [0.9, float("nan")], float("nan")),
    (0.0, 0.1, [], float("nan")),
    (0.0, 0.1, [], 0.8),
    (0.7, 0.02, [0.75], 0.7),
    (0.7, 0.02, [0.75], 0.6999999),
]


@pytest.mark.parametrize("min_auc,max_drop,published,auc", GATE_CASES)
def test_publish_gate_matches_jax(min_auc, max_drop, published, auc):
    gates = [mod.PublishGate(min_auc=min_auc, max_drop=max_drop)
             for mod in (pq, jq)]
    for g in gates:
        for a in published:
            g.note_published(a)
    got, want = (g.decide(auc, step=7) for g in gates)
    assert repr(got) == repr(want)
    assert repr(gates[0].baseline) == repr(gates[1].baseline)


@pytest.mark.parametrize("knobs", [
    dict(), dict(publish_min_auc=0.6), dict(publish_max_auc_drop=0.02),
    dict(publish_min_auc=0.6, publish_max_auc_drop=0.02)])
def test_publish_gate_from_config_matches_jax(knobs):
    kw = dict(run_mode="stream", stream_dir="/tmp/x",
              publish_interval_seconds=1.0, validation_files=("v.txt",),
              **knobs)
    got = pq.PublishGate.from_config(FmConfig(**kw))
    want = jq.PublishGate.from_config(JaxFmConfig(**kw))
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.min_auc, got.max_drop) == (want.min_auc, want.max_drop)


@pytest.mark.parametrize("loss_type", ["logistic", "mse"])
@pytest.mark.parametrize("case", ["mixed", "saturated", "no_positives",
                                  "empty"])
def test_quality_stats_match_jax(loss_type, case):
    rng = np.random.default_rng(11)
    n = 0 if case == "empty" else 257
    scores = rng.normal(0, 2, n)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    weights = rng.uniform(0, 2, n).astype(np.float32)
    if case == "saturated":
        scores[::3] = 80.0
        scores[1::3] = -80.0
    if case == "no_positives":
        labels[:] = 0.0
    stats = [mod.QualityStats(loss_type) for mod in (pq, jq)]
    for s in stats:
        for lo in range(0, max(n, 1), 100):
            s.update(scores[lo:lo + 100], labels[lo:lo + 100],
                     weights[lo:lo + 100])
    got, want = stats
    assert (got.loss_sum, got.weight_sum, got.pred_sum, got.label_sum) == (
        want.loss_sum, want.weight_sum, want.pred_sum, want.label_sum)
    assert repr(got.loss) == repr(want.loss)
    assert repr(got.calibration) == repr(want.calibration)
