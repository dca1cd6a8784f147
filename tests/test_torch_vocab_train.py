"""``vocab_mode = admit`` through the port's ``train`` and ``predict``
against ``run_tffm.py train`` / ``predict`` (a subprocess with one CPU
device, its table init patched to the port's init of the same seed), on
the CPU.

The corpus has more distinct hashed ids than ``vocabulary_size`` (so
admission runs out of rows) and two eras: the first command trains two
epochs on era A, the second resumes and trains two more on era B, so
era A's rows decay below the floor and are evicted. After each command:
every step's ``vocab-<step>.json.gz`` payload equal, the barrier log
lines equal, per-epoch validation AUC within 1e-3, the final loss at
rtol 1e-4, the exported table at rtol 1e-4 / atol 1e-6; after the last,
predict's scores at atol 1e-5. The same with ``lookup = host``.

Port only, from the same start: the resume (two commands of one era)
equal to the one-command run, slot map exactly and tables at tolerance;
a fixed-mode resume and a fixed-mode predict of an admit step refused;
an admit predict of a caller-held table refused; and fresh admission
over a restored step without its sidecar cold-starts every row, as the
JAX package does (the same log lines, the same table).
"""

import base64
import dataclasses
import gzip
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch import lookup
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.train import checkpoint_template, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
VOCAB = 32

# run_tffm.py in one process with one CPU device, both table inits (the
# device path's and the offload backend's) patched to the given table;
# then each "mode=cfg_path" in turn.
_JAX_RUN = r'''
import runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.models.fm as jax_fm
import fast_tffm_tpu.train as jax_train
table = np.load(sys.argv[1])
jax_fm.init_table = lambda cfg, seed=0: jnp.asarray(table)
jax_train.init_table = jax_fm.init_table
assert jax.device_count() == 1, jax.devices()
for arg in sys.argv[2:]:
    mode, cfg_path = arg.split("=", 1)
    sys.argv = ["run_tffm.py", mode, cfg_path]
    try:
        runpy.run_path(RUN_TFFM, run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
'''


def _corpus(path, rng, n_lines, era):
    """Hashed-string lines: one hot token of the era decides the label;
    three tail tokens from a Zipf law over 400 per era."""
    lines = []
    for k in range(n_lines):
        y = int(rng.random() < 0.5)
        toks = [f"{era}hot{int(rng.integers(0, 4)) * 2 + y}:1"]
        toks += [f"{era}t{int(rng.zipf(1.3)) % 400}:0.5" for _ in range(3)]
        lines.append(f"{y} " + " ".join(toks))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab_data")
    rng = np.random.default_rng(41)
    a = _corpus(d / "a.txt", rng, 640, "a")
    b = _corpus(d / "b.txt", rng, 640, "b")
    val = str(d / "v.txt")
    with open(a) as fa, open(b) as fb, open(val, "w") as fv:
        fv.write("".join(fa.readlines()[:160] + fb.readlines()[:160]))
    return {"a": a, "b": b, "val": val}


def _write_cfg(wd, train_file, val_file, epochs, general="", extra="",
               save_steps=7):
    os.makedirs(wd, exist_ok=True)
    text = f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = 4
model_file = {wd}/fm_model
log_file = {wd}/fm.log
{general}
[Train]
train_files = {train_file}
validation_files = {val_file}
epoch_num = {epochs}
batch_size = 64
learning_rate = 0.1
init_value_range = 0.05
log_steps = 5
save_steps = {save_steps}
seed = 3
{extra}
[Predict]
predict_files = {val_file}
score_path = {wd}/score

[Vocab]
vocab_mode = admit
vocab_admit_threshold = 2
vocab_decay = 0.25
vocab_sketch_mb = 0.05
"""
    path = os.path.join(wd, f"e{epochs}-{os.path.basename(train_file)}.cfg")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _table0(cfg):
    """The port's host init of ``cfg.seed``: both packages start there."""
    table, _ = lookup.init_host_state(cfg, cfg.seed)
    return table[:cfg.num_rows].numpy().copy()


def _jax_run(wd, table0, *runs):
    path = os.path.join(wd, "table0.npy")
    np.save(path, table0)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_RUN.replace("RUN_TFFM",
                              repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run(
        [sys.executable, "-c", script, path,
         *(f"{m}={c}" for m, c in runs)], cwd=wd, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _port_train(cfg_path, table0=None):
    cfg = load_config(cfg_path)
    init = None
    if table0 is not None and cfg.lookup == "device":
        init = convert.state_from_numpy(
            table0, np.full_like(table0, cfg.adagrad_init), cfg, CPU)
    train(cfg, device="cpu", init_state=init)
    return cfg


def _sidecars(cfg):
    d = cfg.model_file + ".ckpt"
    out = {}
    for name in os.listdir(d):
        m = re.fullmatch(r"vocab-(\d+)\.json\.gz", name)
        if m:
            with gzip.open(os.path.join(d, name), "rt") as fh:
                out[int(m.group(1))] = json.load(fh)
    return out


def _log(cfg):
    with open(cfg.log_file) as fh:
        text = fh.read()
    return {
        "text": text,
        "barriers": re.findall(r"vocab barrier \(.*", text),
        "auc": [float(a) for a in re.findall(
            r"epoch \d+ validation AUC ([0-9.]+) over", text)],
        "done": [(int(n), float(v)) for n, v in re.findall(
            r"training done: (\d+) steps, final loss ([0-9.]+),", text)],
    }


def _npz(cfg):
    with np.load(cfg.model_file + ".npz") as z:
        return z["table"]


def _compare(jcfg, pcfg):
    js, ps = _sidecars(jcfg), _sidecars(pcfg)
    assert sorted(js) == sorted(ps) and js
    for step in js:
        assert ps[step] == js[step], f"sidecar of step {step}"
    jl, pl = _log(jcfg), _log(pcfg)
    assert pl["barriers"] == jl["barriers"]
    np.testing.assert_allclose(pl["auc"], jl["auc"], atol=1e-3)
    assert [n for n, _ in pl["done"]] == [n for n, _ in jl["done"]]
    np.testing.assert_allclose([v for _, v in pl["done"]],
                               [v for _, v in jl["done"]], rtol=1e-4)
    np.testing.assert_allclose(_npz(pcfg), _npz(jcfg), rtol=1e-4,
                               atol=1e-6)
    return pl


def _scores(cfg):
    with open(os.path.join(cfg.score_path, "v.txt.score")) as fh:
        return np.array([float(s) for s in fh.read().split()])


@pytest.mark.parametrize("general", ["", "lookup = host\n"],
                         ids=["device", "host"])
def test_two_eras_train_then_predict_match_jax(tmp_path, data, general):
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    runs = {}
    for wd in (jwd, pwd):
        runs[wd] = (_write_cfg(wd, data["a"], data["val"], 2, general),
                    _write_cfg(wd, data["b"], data["val"], 4, general))
    table0 = _table0(load_config(runs[pwd][0]))
    _jax_run(jwd, table0, ("train", runs[jwd][0]))
    _port_train(runs[pwd][0], table0)
    log = _compare(load_config(runs[jwd][0]), load_config(runs[pwd][0]))
    assert log["done"] == [(20, log["done"][0][1])]
    _jax_run(jwd, table0, ("train", runs[jwd][1]),
             ("predict", runs[jwd][1]))
    _port_train(runs[pwd][1])
    assert main(["predict", runs[pwd][1], "--device", "cpu"]) == 0
    jcfg, pcfg = load_config(runs[jwd][1]), load_config(runs[pwd][1])
    log = _compare(jcfg, pcfg)
    assert "restored vocab admission state at step 20" in log["text"]
    admitted = [int(m) for m in re.findall(r"\+(\d+) admitted", log["text"])]
    evicted = [int(m) for m in re.findall(r"-(\d+) evicted", log["text"])]
    assert sum(admitted) >= VOCAB and sum(evicted) > 0
    live = [int(m) for m in re.findall(r"(\d+)/31 live rows", log["text"])]
    assert live and max(live) <= VOCAB - 1
    # Admission ran out of rows: the first barrier filled the table.
    assert live[0] == VOCAB - 1
    np.testing.assert_allclose(_scores(pcfg), _scores(jcfg), atol=1e-5)
    # Every slot row lies in [1, vocabulary_size).
    rows = np.frombuffer(base64.b64decode(
        _sidecars(pcfg)[40]["state"]["slot_rows"]), np.int32)
    assert rows.min() >= 1 and rows.max() < VOCAB


def test_resume_equals_one_command_run(tmp_path, data):
    one = _write_cfg(str(tmp_path / "one"), data["a"], data["val"], 2)
    two = (_write_cfg(str(tmp_path / "two"), data["a"], data["val"], 1),
           _write_cfg(str(tmp_path / "two"), data["a"], data["val"], 2))
    table0 = _table0(load_config(one))
    c1 = _port_train(one, table0)
    _port_train(two[0], table0)
    c2 = _port_train(two[1])
    s1, s2 = _sidecars(c1), _sidecars(c2)
    assert s1[20] == s2[20]
    r1 = ck.CheckpointState(c1.model_file).restore(
        template=checkpoint_template(c1))
    r2 = ck.CheckpointState(c2.model_file).restore(
        template=checkpoint_template(c2))
    assert r1["step"] == r2["step"] == 20
    for key in ("table", "acc"):
        np.testing.assert_allclose(r2[key].numpy(), r1[key].numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert "resuming interrupted epoch schedule at epoch 1/2" in \
        _log(c2)["text"]


def test_save_on_a_barrier_step_keeps_the_post_barrier_table(tmp_path,
                                                              data):
    """save_steps dividing the 10-step epoch: the periodic save at step
    20 lands before era B's first barrier, which evicts era A's ids and
    cold-starts their rows, and the final save then lands on step 20.
    Step 20 must hold the post-barrier table (the one its slot map
    names): restored, it equals the live table exactly, its freed rows
    are cold, and a resume from it equals the run that trained on
    through that barrier (slot map exactly, tables at rtol 1e-4 / atol
    1e-6). The JAX package keeps the pre-barrier arrays at such a step
    (ROADMAP.md §C), so the JAX parity tests above save every 7 steps."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    a1 = {wd: _write_cfg(wd, data["a"], data["val"], 1, save_steps=5)
          for wd in (one, two)}
    table0 = _table0(load_config(a1[one]))
    for wd in (one, two):
        _port_train(a1[wd], table0)
    # Two: era B's first epoch alone (to step 20), then its second.
    b2 = _write_cfg(two, data["b"], data["val"], 2, save_steps=5)
    cfg = _port_train(b2)
    text = _log(cfg)["text"]
    assert "checkpoint step 20 committed" in text
    m = re.search(r"vocab barrier \(epoch 1\): \+\d+ admitted, -(\d+) "
                  r"evicted", text)
    assert m and int(m.group(1)) > 0, text
    live = _npz(cfg)
    state = ck.CheckpointState(cfg.model_file)
    r = state.restore(template=checkpoint_template(cfg))
    state.close()
    assert r["step"] == 20
    assert np.array_equal(r["table"].numpy()[:len(live)], live)
    (k10, r10), (k20, _) = (
        (np.frombuffer(base64.b64decode(p["state"]["slot_keys"]),
                       np.int64),
         np.frombuffer(base64.b64decode(p["state"]["slot_rows"]),
                       np.int32))
        for p in (_sidecars(cfg)[10], _sidecars(cfg)[20]))
    freed = r10[~np.isin(k10, k20)].tolist()
    assert freed and not r["table"][freed].any()
    assert (r["acc"][freed] == np.float32(cfg.adagrad_init)).all()
    b3 = {wd: _write_cfg(wd, data["b"], data["val"], 3, save_steps=5)
          for wd in (one, two)}
    c2 = _port_train(b3[two])
    assert "restored checkpoint at step 20" in _log(c2)["text"]
    # One: era B's two epochs in one command, through that barrier.
    c1 = _port_train(b3[one])
    assert _sidecars(c1)[30] == _sidecars(c2)[30]
    r1, r2 = (ck.CheckpointState(c.model_file).restore(
        template=checkpoint_template(c)) for c in (c1, c2))
    assert r1["step"] == r2["step"] == 30
    for key in ("table", "acc"):
        np.testing.assert_allclose(r2[key].numpy(), r1[key].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_fixed_mode_refuses_an_admit_step(tmp_path, data):
    path = _write_cfg(str(tmp_path), data["a"], data["val"], 1)
    cfg = _port_train(path)
    fixed = dataclasses.replace(cfg, vocab_mode="fixed", epoch_num=2)
    with pytest.raises(ValueError, match="vocab admission sidecar"):
        train(fixed, device="cpu")
    with pytest.raises(ValueError, match="vocab admission sidecar"):
        predict(fixed, device="cpu")
    table = torch.zeros(cfg.num_rows, cfg.row_dim)
    with pytest.raises(ValueError, match="caller-held table"):
        predict(cfg, table=table, device="cpu")


def test_fresh_admission_over_sidecarless_restore_matches_jax(tmp_path,
                                                              data):
    """A restored step without its sidecar: admission starts fresh and
    every row, the cold row included, is cold-started, in both packages
    (each package's first command writes its own checkpoint format).
    The resuming command's train file is empty, so what is exported is
    the cold-started table itself: zero in both, and the same log lines.
    (Training on from a zero table would not compare: every score is
    exactly 0.0 there, where the JAX package's logistic-loss gradient
    takes jnp.abs's derivative 1 at 0 and the port's torch.abs's 0;
    ROADMAP.md §C.)"""
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").close()
    paths = {wd: (_write_cfg(wd, data["a"], data["val"], 1),
                  _write_cfg(wd, empty, data["val"], 2))
             for wd in (jwd, pwd)}
    table0 = _table0(load_config(paths[pwd][0]))
    _jax_run(jwd, table0, ("train", paths[jwd][0]))
    _port_train(paths[pwd][0], table0)
    _compare(load_config(paths[jwd][0]), load_config(paths[pwd][0]))
    for wd in (jwd, pwd):
        d = os.path.join(wd, "fm_model.ckpt")
        for name in os.listdir(d):
            if name.startswith("vocab-"):
                os.remove(os.path.join(d, name))
    _jax_run(jwd, table0, ("train", paths[jwd][1]))
    pcfg = _port_train(paths[pwd][1])
    jcfg = load_config(paths[jwd][1])
    for cfg in (jcfg, pcfg):
        text = _log(cfg)["text"]
        assert "admission state starts FRESH" in text
        assert f"cold-started {VOCAB} table rows" in text
    assert not _npz(pcfg).any() and not _npz(jcfg).any()
    _compare(jcfg, pcfg)


def test_admit_tables_depend_on_summation_order(tmp_path):
    """Why the card's admit control is held to its own rerun spread, not
    to rtol 1e-4 / atol 1e-6 (chip_smoke.py's admit phase): until the
    first barrier every id trains through the cold row, and after it the
    fresh ids of a new era do, one row taking a large share of a batch's
    slots; merely summing a batch's examples in another order (what the
    backward's atomics do from run to run) then moves the tables past
    that tolerance, while in fixed mode the same reordering stays within
    it. Same streams, same initial table, the CPU's plain versions."""
    from fast_tffm_tpu_torch.config import FmConfig
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.vocab.table import (VocabRuntime,
                                                 reset_table_rows)
    rng = np.random.default_rng(61)
    files = []
    for era in ("v", "w"):
        lines = []
        for k in range(16384):
            y = int(rng.random() < 0.3)
            toks = [f"I{j}:{np.log1p(rng.lognormal(1.0, 1.2)):.3f}"
                    for j in range(13)]
            toks += [f"p{int(rng.integers(0, 6)) * 2 + y}"]
            toks += [f"C{f}={era}{int(rng.zipf(1.35)) % 5000}"
                     for f in range(25)]
            lines.append(f"{y} " + " ".join(toks))
        files.append(str(tmp_path / f"{era}.txt"))
        with open(files[-1], "w") as fh:
            fh.write("\n".join(lines) + "\n")
    out = {}
    for mode in ("fixed", "admit"):
        cfg = FmConfig(vocabulary_size=1 << 16, factor_num=8,
                       batch_size=2048, learning_rate=0.1,
                       hash_feature_id=True, vocab_mode=mode,
                       host_threads=1)
        spec = port_fm.ModelSpec.from_config(cfg)
        table0 = np.random.default_rng(3).uniform(
            -0.01, 0.01, (cfg.num_rows, cfg.row_dim)).astype(np.float32)
        table0[-1] = 0.0
        runs = []
        for perm in (None, 5):
            rt = VocabRuntime.from_config(cfg) if mode == "admit" else None
            t, a = convert.state_from_numpy(
                table0, np.full_like(table0, cfg.adagrad_init), cfg, CPU)
            order = np.random.default_rng(perm)
            for epoch, path in enumerate(files):
                for b in batch_iterator(cfg, [path], epochs=1, seed=epoch,
                                        vocab=rt):
                    args = port_fm.batch_args(b, CPU)
                    if perm is not None:
                        p = torch.from_numpy(order.permutation(
                            len(b.labels)))
                        args = {k: v[p] for k, v in args.items()}
                    port_fm.train_step_body(spec, t, a, **args)
                    if rt is not None:
                        rt.note_trained(b)
                if rt is not None:
                    rt.barrier(lambda rows: reset_table_rows(
                        t, a, rows, cfg.adagrad_init))
            runs.append(t.numpy())
        d = np.abs(runs[0] - runs[1])
        out[mode] = int((d > 1e-6 + 1e-4 * np.abs(runs[1])).sum())
    assert out["fixed"] == 0 and out["admit"] > 0, out
