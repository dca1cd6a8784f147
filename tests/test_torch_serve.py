"""The port's serving slice as a whole, on the CPU: ``sample.cfg``'s
model (vocabulary 200, k = 8) from one ``.npz`` export.

- JAX ``predict_scores`` (kernel = pallas in interpret mode, dedup =
  device — conftest's 8 CPU devices would otherwise resolve dedup = auto
  to host) through sigmoid matches the port's predict score file at
  atol 1e-6 (the file's own %.6f rounding is 5e-7 of that);
- the port's ScorerServer, answering over HTTP on an ephemeral port,
  returns bodies byte-identical to the port's score file;
- a malformed line gets a 400; bad argv exits 2; without a card and
  without ``--device cpu`` the entry points raise.
"""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from fast_tffm_tpu.checkpoint import export_npz
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.metrics import sigmoid as jax_sigmoid
from fast_tffm_tpu.predict import predict_scores as jax_predict_scores
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.serve.frontend import make_http_server
from fast_tffm_tpu_torch.serve.server import ScorerServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_cfg(wd, extra=""):
    with open(os.path.join(REPO, "sample.cfg")) as fh:
        text = fh.read()
    text = (text.replace("./model/fm_model", os.path.join(wd, "fm_model"))
            .replace("./log/fm.log", os.path.join(wd, "fm.log"))
            .replace("./score", os.path.join(wd, "score"))
            .replace("data/sample_test.txt", os.path.join(wd, "in.txt"))
            .replace("data/sample_train.txt",
                     os.path.join(REPO, "data", "sample_train.txt")))
    path = os.path.join(wd, "sample.cfg")
    with open(path, "w") as fh:
        fh.write(text + extra)
    return path


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """One model, one predict file (with blank lines and no final
    newline), the port's predict output, and the JAX raw scores."""
    wd = str(tmp_path_factory.mktemp("torch_serve"))
    with open(os.path.join(REPO, "data", "sample_test.txt")) as fh:
        lines = fh.read().splitlines()
    lines = lines[:7] + [""] + lines[7:300] + ["  "] + lines[300:]
    with open(os.path.join(wd, "in.txt"), "w") as fh:
        fh.write("\n".join(lines))
    cfg_path = _write_cfg(wd, "\n[Serve]\nserve_port = 0\n"
                              "serve_max_batch = 64\n"
                              "serve_max_wait_ms = 5\n")
    cfg = load_config(cfg_path)
    rng = np.random.default_rng(11)
    table = (rng.normal(size=(cfg.num_rows, cfg.row_dim)) * 0.1
             ).astype(np.float32)
    table[-1] = 0.0
    export_npz(jnp.asarray(table), cfg.model_file + ".npz",
               vocabulary_size=cfg.vocabulary_size)
    assert main(["predict", cfg_path, "--device", "cpu"]) == 0
    with open(os.path.join(cfg.score_path, "in.txt.score")) as fh:
        score_lines = fh.read().splitlines(keepends=True)
    jcfg = dataclasses.replace(jax_load_config(cfg_path), kernel="pallas",
                               dedup="device")
    jax_raw = jax_predict_scores(jcfg, jnp.asarray(table),
                                 [os.path.join(wd, "in.txt")])
    return dict(cfg=cfg, cfg_path=cfg_path, lines=lines,
                score_lines=score_lines, jax_raw=jax_raw)


def test_predict_matches_jax_predict(slice_run):
    lines, score_lines = slice_run["lines"], slice_run["score_lines"]
    assert len(score_lines) == len(lines) == 502
    got = np.array([float(s) for s in score_lines])
    want = jax_sigmoid(slice_run["jax_raw"])
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_predict_is_independent_of_batch_size(slice_run, tmp_path):
    cfg = dataclasses.replace(slice_run["cfg"], batch_size=7,
                              score_path=str(tmp_path))
    predict(cfg, device="cpu")
    with open(tmp_path / "in.txt.score") as fh:
        assert fh.read() == "".join(slice_run["score_lines"])


def _post(port, body, path="/score"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_serve_bodies_byte_identical_to_predict(slice_run):
    cfg, lines = slice_run["cfg"], slice_run["lines"]
    score_lines = slice_run["score_lines"]
    server = ScorerServer(cfg, device="cpu")
    httpd = make_http_server(server, 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    port = httpd.server_address[1]
    rng = np.random.default_rng(5)
    spans = []
    for _ in range(24):
        n = int(rng.integers(1, 65))
        lo = int(rng.integers(0, len(lines) - n + 1))
        spans.append((lo, n))
    results = {}

    def client(i, lo, n):
        results[i] = _post(port, "\n".join(lines[lo:lo + n]) + "\n")

    try:
        threads = [threading.Thread(target=client, args=(i, lo, n))
                   for i, (lo, n) in enumerate(spans)]
        for th in threads:
            th.start()
        bad_status, bad_body, _ = _post(port, lines[0] + "\n1 abc:1.0\n")
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        for i, (lo, n) in enumerate(spans):
            status, body, headers = results[i]
            assert status == 200
            assert headers["X-FM-Step"] == "-1"
            assert body == "".join(score_lines[lo:lo + n]).encode()
        assert bad_status == 400 and b"non-integer feature id" in bad_body
        assert _post(port, "", path="/nope")[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/score")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        assert conn.getresponse().status == 411
        conn.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["alive"] and health["ready"]
        assert health["requests"] == len(spans)
        assert health["flush_errors"] == 0
        assert health["device"] == "cpu" and health["kernel"] == "plain"
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        server.close()
    assert not server.is_ready()
    with pytest.raises(RuntimeError, match="closed"):
        server.score_lines(lines[:1])


def test_server_refuses_oversized_and_scores_empty(slice_run):
    server = ScorerServer(slice_run["cfg"], device="cpu")
    try:
        with pytest.raises(ValueError, match="serve_max_batch"):
            server.score_lines(slice_run["lines"][:65])
        assert server.score_lines([], timeout=30).scores.shape == (0,)
        res = server.score_lines(slice_run["lines"][:3], timeout=30)
        assert res.scores.dtype == np.float64 and res.step == -1
        assert server.stats()["requests"] == 1
    finally:
        server.close()


@pytest.mark.parametrize("argv", [[], ["predict"], ["train", "x.cfg"],
                                  ["serve", "x.cfg", "--device"],
                                  ["serve", "x.cfg", "--device", "tpu"],
                                  ["predict", "x.cfg", "extra"]])
def test_bad_argv_exits_2(argv):
    assert main(argv) == 2


def test_module_entry_point_exit_codes(slice_run):
    cmd = [sys.executable, "-m", "fast_tffm_tpu_torch"]
    bad = subprocess.run(cmd + ["bogus"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode == 2 and "--device" in bad.stderr
    no_card = subprocess.run(cmd + ["predict", slice_run["cfg_path"]],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=120)
    assert no_card.returncode != 0
    assert "RuntimeError" in no_card.stderr
    assert "--device cpu" in no_card.stderr


def test_entry_points_raise_without_a_card(slice_run):
    cfg = slice_run["cfg"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ScorerServer(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["predict", slice_run["cfg_path"]])


@pytest.mark.parametrize("change,item", [
    (dict(model_type="ffm", field_num=2), "A6"),
    (dict(order=3), "A6"),
    (dict(vocab_mode="admit"), "A8"),
    (dict(lookup="host"), "A7"),
    (dict(wire_format="packed"), "A5"),
    (dict(serve_replicas=2, serve_port=7070), "A9"),
])
def test_unported_config_values_raise(slice_run, change, item):
    cfg = dataclasses.replace(slice_run["cfg"], **change)
    for call in (lambda: predict(cfg, device="cpu"),
                 lambda: ScorerServer(cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match=item):
            call()


@pytest.mark.parametrize("rest,item", [(["dist_train", "worker", "0"], "A10"),
                                       (["--replicas", "2"], "A9")])
def test_unported_argv_raises(slice_run, rest, item):
    with pytest.raises(NotImplementedError, match=item):
        main(["serve", slice_run["cfg_path"], "--device", "cpu", *rest])
