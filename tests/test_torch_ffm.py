"""Field-aware FM and higher-order FM (ANOVA) in the port, against the
JAX package on the CPU.

The same inputs go through both packages: batches from one seed made
with numpy (or the port's stream, equal to the JAX package's), and one
table loaded from one array (``models/convert`` carries it across).

- Scores: ``ops/interaction.ffm_batch_scores`` and
  ``anova_batch_scores`` against JAX ``ffm_batch_scores`` and
  ``fm_batch_scores(order=3|4)`` at rtol 1e-5 / atol 1e-6, and against
  the NumPy oracle (``models/oracle.py``: ``ffm_score``,
  ``_anova_interactions``) in float64 on a few examples.
- Row gradients (``grad_body``) and a few train steps
  (``train_step_body``: table, accumulator, loss, scores) at rtol 1e-4 /
  atol 1e-6, for ``dedup`` device and host.
- The stream carries ``fields`` through every route, shuffled with the
  rows, equal to the JAX package's array for array.
- The slice: ``python -m fast_tffm_tpu_torch train`` then ``predict``
  (``--device cpu``) against ``run_tffm.py`` on the same files from one
  table, with shuffle on, at ``host_threads`` 1 and 4 and both dedup
  modes: validation AUC within 1e-3, final loss at rtol 1e-4, exported
  tables at rtol 1e-4 / atol 1e-6, score files at atol 1e-5. Then the
  port's server answers with bodies equal to the port's predict lines
  byte for byte.
"""

import dataclasses
import http.client
import json
import logging
import os
import re
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.models import oracle
from fast_tffm_tpu.ops import interaction as jax_interaction
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.data.pipeline import batch_iterator
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.ops import interaction
from fast_tffm_tpu_torch.scoring import format_scores
from fast_tffm_tpu_torch.serve.frontend import make_http_server
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.train import train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
VOCAB = 300
FIELDS = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_batch(seed, U, D, B, L, F=FIELDS):
    """Rows [U, D], a padded batch into them (pad tail: the zero row
    U-1, value 0, field 0), fields."""
    rng = np.random.default_rng(seed)
    params = rng.normal(0.0, 0.3, (U, D)).astype(np.float32)
    params[-1] = 0.0
    idx = rng.integers(0, U - 1, (B, L)).astype(np.int32)
    vals = rng.random((B, L)).astype(np.float32)
    fields = rng.integers(0, F, (B, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, B)
    tail = np.arange(L)[None, :] >= lengths[:, None]
    idx[tail], vals[tail], fields[tail] = U - 1, 0.0, 0
    return params, idx, vals, fields


@pytest.mark.parametrize("B,L", [(1, 1), (7, 5), (33, 16)])
def test_ffm_scores_match_jax(B, L):
    k = 3
    params, idx, vals, fields = _random_batch(B * 100 + L, 60,
                                              FIELDS * k + 1, B, L)
    want = np.asarray(jax_interaction.ffm_batch_scores(
        jnp.asarray(params), FIELDS, jnp.asarray(idx), jnp.asarray(fields),
        jnp.asarray(vals)))
    got = interaction.ffm_batch_scores(_t(params), FIELDS, _t(idx),
                                       _t(fields), _t(vals))
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("order", [3, 4])
@pytest.mark.parametrize("B,L", [(1, 1), (7, 5), (33, 16)])
def test_anova_scores_match_jax(order, B, L):
    params, idx, vals, _ = _random_batch(B * 10 + L + order, 60, 5, B, L)
    want = np.asarray(jax_interaction.fm_batch_scores(
        jnp.asarray(params), jnp.asarray(idx), jnp.asarray(vals),
        order=order))
    got = interaction.anova_batch_scores(_t(params), _t(idx), _t(vals),
                                         order)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_anova_order_two_is_the_fm_identity():
    params, idx, vals, _ = _random_batch(5, 40, 5, 9, 8)
    np.testing.assert_allclose(
        interaction.anova_batch_scores(_t(params), _t(idx), _t(vals),
                                       2).numpy(),
        interaction.fm_batch_scores(_t(params), _t(idx), _t(vals)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_scorers_match_the_numpy_oracle():
    k = 3
    params, idx, vals, fields = _random_batch(11, 50, FIELDS * k + 1, 6, 7)
    got = interaction.ffm_batch_scores(_t(params).double(), FIELDS,
                                       _t(idx), _t(fields),
                                       _t(vals).double()).numpy()
    # A float64 table: the oracle forms each pair's dot product in the
    # table's own dtype.
    want = [oracle.ffm_score(params.astype(np.float64), FIELDS, idx[b],
                             fields[b], vals[b]) for b in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    params, idx, vals, _ = _random_batch(12, 50, 5, 6, 7)
    for order in (3, 4):
        got = interaction.anova_batch_scores(
            _t(params).double(), _t(idx), _t(vals).double(), order).numpy()
        want = [oracle.fm_score(params, idx[b], vals[b], order=order)
                for b in range(6)]
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        v = params[idx[0], :-1].astype(np.float64)
        x = vals[0].astype(np.float64)
        z = _t(v[None] * x[None, :, None])
        np.testing.assert_allclose(
            float(interaction._anova_terms(z, order)[0]),
            oracle._anova_interactions(v, x, order), rtol=1e-10)


MODELS = {
    "ffm": dict(model_type="ffm", field_num=FIELDS, factor_num=3),
    "order3": dict(order=3, factor_num=4),
}


def _specs(model, dedup, **extra):
    kw = dict(vocabulary_size=VOCAB, learning_rate=0.2,
              factor_lambda=1e-3, bias_lambda=1e-3, dedup=dedup,
              **MODELS[model], **extra)
    cfg, jcfg = FmConfig(**kw), JaxConfig(**kw)
    return (cfg, jcfg, port_fm.ModelSpec.from_config(cfg),
            jax_fm.ModelSpec.from_config(jcfg))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_row_gradients_match_jax(model):
    cfg, _, spec, jspec = _specs(model, "host")
    U, B, L = 40, 12, 9
    params, idx, vals, fields = _random_batch(21, U, cfg.row_dim, B, L)
    rng = np.random.default_rng(22)
    labels = (rng.random(B) < 0.5).astype(np.float32)
    weights = rng.random(B).astype(np.float32)
    uniq = np.arange(U, dtype=np.int32)
    uniq[-1] = cfg.pad_id
    fld = fields if model == "ffm" else None
    jloss, jscores, jgrad = jax_fm.grad_body(
        jspec, jnp.asarray(params), jnp.asarray(labels),
        jnp.asarray(weights), jnp.asarray(uniq), jnp.asarray(idx),
        jnp.asarray(vals), None if fld is None else jnp.asarray(fld))
    loss, scores, grad = port_fm.grad_body(
        spec, _t(params), _t(labels), _t(weights), _t(uniq), _t(idx),
        _t(vals), None if fld is None else _t(fld))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert np.abs(np.asarray(jgrad)).max() > 1e-3
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-6)
    assert not grad[-1].any()   # the pad row gets no gradient


def _ffm_lines(n, seed, nnz_max=9):
    """Field-aware lines ``label field:id:value`` (some without a
    value), with a blank line; ids skewed so that batches share rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nnz = int(rng.integers(1, nnz_max + 1))
        toks = [str(int(rng.random() < 0.4))]
        for _ in range(nnz):
            f = int(rng.integers(0, FIELDS))
            fid = int(rng.zipf(1.3)) % VOCAB
            toks.append(f"{f}:{fid}" if rng.random() < 0.3
                        else f"{f}:{fid}:{rng.random():.3f}")
        out.append(" ".join(toks))
    out.insert(n // 2, "")
    return out


def _fm_lines(n, seed, nnz_max=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nnz = int(rng.integers(1, nnz_max + 1))
        ids = rng.zipf(1.3, size=nnz) % VOCAB
        out.append(" ".join([str(int(rng.random() < 0.4))]
                            + [f"{int(i)}:{rng.random():.3f}"
                               for i in ids]))
    return out


def _lines(model, n, seed):
    return (_ffm_lines if model == "ffm" else _fm_lines)(n, seed)


@pytest.mark.parametrize("host_threads", [1, 4])
@pytest.mark.parametrize("dedup", ["device", "host"])
def test_ffm_stream_carries_fields_like_jax(tmp_path, dedup, host_threads):
    path = str(tmp_path / "ffm.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(_ffm_lines(700, 3)) + "\n")
    kw = dict(vocabulary_size=VOCAB, batch_size=64, queue_size=300,
              host_threads=host_threads, **MODELS["ffm"])
    raw = dedup == "device"
    want = list(jax_batch_iterator(JaxConfig(**kw), [path], training=True,
                                   epochs=2, raw_ids=raw, seed=5))
    got = list(batch_iterator(FmConfig(**kw), [path], training=True,
                              epochs=2, raw_ids=raw, seed=5))
    assert len(got) == len(want) > 4
    for j, p in zip(want, got):
        assert p.num_real == j.num_real
        for key in ("labels", "weights", "local_idx", "vals", "fields",
                    "uniq_ids"):
            a, b = getattr(j, key), getattr(p, key)
            if a is None:
                assert b is None and raw, key
                continue
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert any(b.fields[:b.num_real].any() for b in got)


def test_ffm_generic_and_plain_streams_carry_fields(tmp_path):
    """The generic path (weight sidecar) and the plain Python stream
    carry the fields too, equal to the JAX package's and the fast
    path's."""
    from fast_tffm_tpu_torch.data.pipeline import plain_batch_iterator
    lines = _ffm_lines(300, 4)
    path, wpath = str(tmp_path / "f.txt"), str(tmp_path / "f.w")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(wpath, "w") as fh:
        fh.write("\n".join("0.5" for _ in lines) + "\n")
    kw = dict(vocabulary_size=VOCAB, batch_size=64, **MODELS["ffm"])
    want = list(jax_batch_iterator(JaxConfig(**kw), [path], training=False,
                                   weight_files=[wpath], raw_ids=True))
    got = list(batch_iterator(FmConfig(**kw), [path], training=False,
                              weight_files=[wpath]))
    assert len(got) == len(want) == 5
    for j, p in zip(want, got):
        assert np.array_equal(j.fields, p.fields)
        assert np.array_equal(j.weights, p.weights)
    fast = list(batch_iterator(FmConfig(**kw), [path], training=True,
                               seed=2))
    plain = list(plain_batch_iterator(FmConfig(**kw), [path], training=True,
                                      seed=2))
    assert len(fast) == len(plain)
    for a, b in zip(fast, plain):
        assert np.array_equal(a.fields, b.fields)
        assert np.array_equal(a.local_idx, b.local_idx)


@pytest.mark.parametrize("dedup", ["device", "host"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_steps_match_jax(tmp_path, model, dedup):
    path = str(tmp_path / "t.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(_lines(model, 400, 7)) + "\n")
    cfg, jcfg, spec, jspec = _specs(model, dedup, batch_size=64)
    raw = dedup == "device"
    rng = np.random.default_rng(8)
    table0 = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                         ).astype(np.float32)
    table0[-1] = 0.0
    acc0 = np.full_like(table0, cfg.adagrad_init)
    jtable, jacc = jnp.asarray(table0), jnp.asarray(acc0)
    table, acc = convert.state_from_numpy(table0, acc0, cfg, CPU)
    n = 0
    for b in batch_iterator(cfg, [path], training=True, epochs=1,
                            raw_ids=raw, seed=1):
        jtable, jacc, jloss, jscores = jax_fm.train_step_body(
            jspec, jtable, jacc, **{
                k: (None if v is None else jnp.asarray(v))
                for k, v in jax_fm.batch_args(b).items()})
        table, acc, loss, scores = port_fm.train_step_body(
            spec, table, acc, **port_fm.batch_args(b, CPU))
        for got, want in ((table, jtable), (acc, jacc), (loss, jloss),
                          (scores, jscores)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {n}")
        n += 1
    assert n == 7
    assert not table[cfg.pad_id].any()
    assert not np.array_equal(table.numpy(), table0)


# --- the slice through both command lines -----------------------------------

CASES = {
    # name: (model, dedup, host_threads)
    "ffm-device-1": ("ffm", "device", 1),
    "ffm-host-4": ("ffm", "host", 4),
    "order3-device-4": ("order3", "device", 4),
    "order3-host-1": ("order3", "host", 1),
}


def _write_case(wd, model, dedup, host_threads):
    os.makedirs(wd)
    spec = MODELS[model]
    extra = "".join(f"{k} = {v}\n" for k, v in spec.items())
    with open(os.path.join(wd, "fm.cfg"), "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
model_file = {os.path.join(wd, 'model', 'fm')}
log_file = {os.path.join(wd, 'fm.log')}
dedup = {dedup}
{extra}
[Train]
train_files = {os.path.join(wd, 'train.txt')}
validation_files = {os.path.join(wd, 'val.txt')}
epoch_num = 3
batch_size = 64
queue_size = 400
shuffle = True
learning_rate = 0.2
factor_lambda = 0.001
bias_lambda = 0.001
host_threads = {host_threads}
log_steps = 4

[Predict]
predict_files = {os.path.join(wd, 'val.txt')}
score_path = {os.path.join(wd, 'score')}

[Serve]
serve_port = 0
serve_max_batch = 32
serve_max_wait_ms = 1
""")
    return os.path.join(wd, "fm.cfg")


_JAX_RUNS = r'''
import json, logging, runpy, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.train as jax_train
assert jax.device_count() == 1, jax.devices()
for cfg_path, table_path in json.loads(sys.argv[1]):
    table = np.load(table_path)
    jax_train.init_table = lambda cfg, seed=0, t=table: jnp.asarray(t)
    for mode in ("train", "predict"):
        sys.argv = ["run_tffm.py", mode, cfg_path]
        try:
            runpy.run_path(RUN_TFFM, run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
    lg = logging.getLogger("fast_tffm_tpu")
    for h in [h for h in lg.handlers if isinstance(h, logging.FileHandler)]:
        lg.removeHandler(h)
        h.close()
'''


def _detach_file_logs():
    """Each case logs to its own file: drop the port logger's file
    handlers between runs in this process."""
    lg = logging.getLogger("fast_tffm_tpu_torch")
    for h in [h for h in lg.handlers
              if isinstance(h, logging.FileHandler)]:
        lg.removeHandler(h)
        h.close()


def _log_values(path):
    with open(path) as fh:
        text = fh.read()
    aucs = [float(a) for a in re.findall(
        r"epoch \d+ validation AUC ([0-9.]+) over", text)]
    done = re.findall(r"training done: (\d+) steps, final loss ([0-9.]+),",
                      text)
    assert len(done) == 1, text[-2000:]
    return aucs, int(done[0][0]), float(done[0][1])


def _score_file(wd):
    with open(os.path.join(wd, "score", "val.txt.score")) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every case trained and predicted by both packages' command lines
    from one table: the JAX runs in one single-device subprocess."""
    base = str(tmp_path_factory.mktemp("ffm_cli"))
    runs, jobs = {}, []
    for i, (name, (model, dedup, threads)) in enumerate(sorted(
            CASES.items())):
        train_lines = _lines(model, 900, 30 + i)
        val_lines = _lines(model, 200, 60 + i)
        paths = {}
        for side in ("jax", "port"):
            wd = os.path.join(base, name, side)
            paths[side] = _write_case(wd, model, dedup, threads)
            for fname, lines in (("train.txt", train_lines),
                                 ("val.txt", val_lines)):
                with open(os.path.join(wd, fname), "w") as fh:
                    fh.write("\n".join(lines) + "\n")
        cfg = load_config(paths["port"])
        rng = np.random.default_rng(90 + i)
        table0 = rng.uniform(-cfg.init_value_range, cfg.init_value_range,
                             (cfg.num_rows, cfg.row_dim)).astype(np.float32)
        table0[-1] = 0.0
        table_path = os.path.join(base, name, "table0.npy")
        np.save(table_path, table0)
        jobs.append((paths["jax"], table_path))
        runs[name] = dict(cfg=cfg, cfg_path=paths["port"], table0=table0,
                          jax_wd=os.path.dirname(paths["jax"]),
                          port_wd=os.path.dirname(paths["port"]),
                          val_lines=val_lines)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_RUNS.replace("RUN_TFFM",
                               repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(jobs)],
                          cwd=base, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for run in runs.values():
        cfg = run["cfg"]
        acc0 = np.full_like(run["table0"], cfg.adagrad_init)
        train(cfg, device="cpu", init_state=convert.state_from_numpy(
            run["table0"].copy(), acc0, cfg, CPU))
        assert main(["predict", run["cfg_path"], "--device", "cpu"]) == 0
        _detach_file_logs()
    return runs


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_train_then_predict_matches_jax(cli_runs, name):
    run = cli_runs[name]
    j_auc, j_steps, j_loss = _log_values(os.path.join(run["jax_wd"],
                                                      "fm.log"))
    p_auc, p_steps, p_loss = _log_values(os.path.join(run["port_wd"],
                                                      "fm.log"))
    assert p_steps == j_steps == 3 * 15 and len(p_auc) == len(j_auc) == 3
    np.testing.assert_allclose(p_auc, j_auc, atol=1e-3)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)
    with np.load(os.path.join(run["jax_wd"], "model", "fm.npz")) as j, \
            np.load(os.path.join(run["port_wd"], "model", "fm.npz")) as p:
        assert p["table"].shape == j["table"].shape == (
            VOCAB, run["cfg"].row_dim)
        np.testing.assert_allclose(p["table"], j["table"], rtol=1e-4,
                                   atol=1e-6)
        assert not np.array_equal(p["table"], run["table0"][:VOCAB])
    j_scores = np.array(_score_file(run["jax_wd"]).split(), dtype=float)
    p_scores = np.array(_score_file(run["port_wd"]).split(), dtype=float)
    assert p_scores.shape == j_scores.shape == (len(run["val_lines"]),)
    np.testing.assert_allclose(p_scores, j_scores, atol=1e-5)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/score", body=body.encode())
        resp = conn.getresponse()
        return resp.status, resp.read().decode(), resp.getheader("X-FM-Step")
    finally:
        conn.close()


@pytest.mark.parametrize("name", ["ffm-host-4", "order3-device-4"])
def test_serve_answers_equal_predict_lines(cli_runs, name):
    run = cli_runs[name]
    cfg = run["cfg"]
    assert fmckpt.main(["publish", cfg.model_file, "45"]) == 0
    want = _score_file(run["port_wd"]).splitlines(keepends=True)
    lines = run["val_lines"]
    server = ScorerServer(cfg, device="cpu", watch=False)
    httpd = make_http_server(server, 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        for lo, hi in ((0, 1), (1, 33), (33, 60), (60, len(lines))):
            chunk = lines[lo:hi]
            for start in range(0, len(chunk), 32):
                part = chunk[start:start + 32]
                got = server.score_lines(part, timeout=60)
                assert got.step == 45
                assert format_scores(got.scores) == "".join(
                    want[lo + start:lo + start + len(part)])
        status, body, step = _post(httpd.server_address[1],
                                   "\n".join(lines[:20]) + "\n")
        assert status == 200 and step == "45"
        assert body == "".join(want[:20])
        assert server.stats()["flush_errors"] == 0
        assert server.stats()["kernel"] == "torch"
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        server.close()


def test_ffm_checkpoint_holds_the_ffm_row_width(cli_runs):
    """The port's checkpoint, export and template carry F·k+1 columns,
    and a model of another width refuses to restore it."""
    from fast_tffm_tpu_torch.predict import load_table
    from fast_tffm_tpu_torch.train import checkpoint_template
    run = cli_runs["ffm-device-1"]
    cfg = run["cfg"]
    assert cfg.row_dim == FIELDS * 3 + 1
    assert checkpoint_template(cfg)["table"] == (VOCAB + 1, cfg.row_dim)
    table = load_table(cfg, CPU)
    with np.load(cfg.model_file + ".npz") as npz:
        assert np.array_equal(table[:VOCAB].numpy(), npz["table"])
    other = dataclasses.replace(cfg, field_num=FIELDS + 1)
    with pytest.raises(ValueError, match="field_num"):
        load_table(other, CPU, step=45)
