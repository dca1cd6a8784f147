"""The port's serving slice as a whole, on the CPU: ``sample.cfg``'s
model (vocabulary 200, k = 8) from one checkpoint step, written by
``save_checkpoint_from_numpy`` and published with the port's ``fmckpt``.

- JAX ``predict_scores`` (kernel = pallas in interpret mode, dedup =
  device — conftest's 8 CPU devices would otherwise resolve dedup = auto
  to host) through sigmoid matches the port's predict score file at
  atol 1e-6 (the file's own %.6f rounding is 5e-7 of that);
- the port's ScorerServer, answering over HTTP on an ephemeral port,
  returns bodies byte-identical to the port's score file, each tagged
  with the published step in ``X-FM-Step``;
- a malformed line gets a 400; bad argv exits 2; without a card and
  without ``--device cpu`` the entry points raise;
- ``vocab_mode = admit``: steps written with a slot map
  (``vocab-<step>.json.gz``); the port's admit predict against JAX
  ``predict_scores`` through the same map (atol 1e-6 after sigmoid); an
  admit server's bodies equal the port's admit predict lines byte for
  byte; a hot reload swaps the (table, slot map, step) triple; a step
  whose sidecar has a flipped byte fails its reload whole and the old
  triple keeps serving; a fixed-mode server refuses an admit step.
"""

import base64
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.metrics import sigmoid as jax_sigmoid
from fast_tffm_tpu.predict import predict_scores as jax_predict_scores
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.predict import predict
from fast_tffm_tpu_torch.scoring import format_scores
from fast_tffm_tpu_torch.serve.frontend import make_http_server
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.tools import fmckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkpoint step the slice's model is written and published at.
STEP = 7


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
    save_checkpoint_from_numpy(cfg, table, None, STEP)
    assert fmckpt.main(["publish", cfg.model_file, str(STEP)]) == 0
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
            assert headers["X-FM-Step"] == str(STEP)
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
        assert res.scores.dtype == np.float64 and res.step == STEP
        assert server.stats()["requests"] == 1
    finally:
        server.close()


@pytest.mark.parametrize("fail", [False, True], ids=["warms", "fails"])
def test_background_warmup_is_alive_before_ready(slice_run, monkeypatch,
                                                 fail):
    """``warmup="background"`` (the serve entry point's): the server
    answers alive and not ready while the ladder warms, ready once it is
    warm; a warmup that fails leaves it alive, never ready, with
    ``serve/warmup_errors`` counted."""
    from fast_tffm_tpu_torch.scoring import CompiledScorer
    gate = threading.Event()
    score_batch = CompiledScorer.score_batch

    def gated(self, table, batch):
        if threading.current_thread().name == "fmt-serve-warmup":
            assert gate.wait(60)
            if fail:
                raise RuntimeError("warmup broke")
        return score_batch(self, table, batch)

    monkeypatch.setattr(CompiledScorer, "score_batch", gated)
    server = ScorerServer(slice_run["cfg"], device="cpu", watch=False,
                          warmup="background")
    try:
        before = server.stats()
        gate.set()
        deadline = time.monotonic() + 60
        while not (server.is_ready() or server.stats()["warmup_errors"]):
            assert time.monotonic() < deadline, "warmup never ended"
            time.sleep(0.01)
        after = server.stats()
        res = server.score_lines(slice_run["lines"][:5], timeout=30)
    finally:
        server.close()
    assert before["alive"] and not before["ready"] and not before["warmed"]
    assert after["alive"] and after["ready"] is not fail
    assert after["warmed"] is not fail
    assert after["warmup_errors"] == int(fail)
    # Requests score either way: readiness only steers the proxy.
    assert format_scores(res.scores) == "".join(slice_run["score_lines"][:5])


@pytest.mark.parametrize("argv", [[], ["predict"],
                                  ["train", "x.cfg", "--device"],
                                  ["serve", "x.cfg", "--device"],
                                  ["serve", "x.cfg", "--device", "tpu"],
                                  ["predict", "x.cfg", "extra"],
                                  ["serve", "x.cfg", "--replicas"],
                                  ["serve", "x.cfg", "--replicas", "two"],
                                  ["serve", "x.cfg", "--replicas", "0"],
                                  ["serve", "x.cfg", "--replicas", "2", "x"],
                                  ["train", "x.cfg", "--replicas", "2"]])
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
    (dict(lookup="host"), "serving requires lookup = device"),
])
def test_unported_config_values_raise(slice_run, change, item, tmp_path):
    cfg = dataclasses.replace(slice_run["cfg"], **change)
    # Offload predict is ported and prints the device lookup's bytes;
    # serving refuses it with the JAX package's ValueError.
    predict(dataclasses.replace(cfg, score_path=str(tmp_path)),
            device="cpu")
    with open(tmp_path / "in.txt.score") as fh:
        assert fh.read() == "".join(slice_run["score_lines"])
    with pytest.raises(ValueError, match=item):
        ScorerServer(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    dict(serve_replicas=2, serve_port=7070),
    dict(serve_replicas=3, serve_port=7070, serve_reload_mode="external",
         serve_canary_fraction=0.25),
])
def test_fleet_config_values_predict_and_serve(slice_run, change, tmp_path):
    """The fleet's keys leave predict and a replica's ScorerServer as
    they are: the same lines, the same bodies."""
    cfg = dataclasses.replace(slice_run["cfg"], **change)
    predict(dataclasses.replace(cfg, score_path=str(tmp_path)),
            device="cpu")
    with open(tmp_path / "in.txt.score") as fh:
        assert fh.read() == "".join(slice_run["score_lines"])
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        res = server.score_lines(slice_run["lines"][:9], timeout=30)
    finally:
        server.close()
    assert res.step == STEP
    assert format_scores(res.scores) == "".join(
        slice_run["score_lines"][:9])


@pytest.mark.parametrize("rest,item", [(["dist_train", "worker", "0"], "A10")])
def test_unported_argv_raises(slice_run, rest, item, capsys):
    """``dist_train`` (ported with ROADMAP.md ``item``) is a train and
    predict role; serve refuses a role as the JAX CLI does: a message
    and the usage, exit 2."""
    assert main(["serve", slice_run["cfg_path"], "--device", "cpu",
                 *rest]) == 2
    assert "serve takes no dist_train role" in capsys.readouterr().err


@pytest.mark.parametrize("in_cfg,rest,want", [
    (1, [], ("serve", None)),
    (1, ["--replicas", "1"], ("serve", None)),
    (1, ["--replicas", "2"], ("fleet", 2)),
    (3, [], ("fleet", 3)),
    (3, ["--replicas", "1"], ("serve", None)),
    (3, ["--replicas", "4"], ("fleet", 4)),
])
def test_serve_argv_picks_the_server_or_the_fleet(slice_run, monkeypatch,
                                                  tmp_path, in_cfg, rest,
                                                  want):
    """``serve`` runs the single server unless ``--replicas N`` (N >= 2)
    or ``serve_replicas`` > 1 asks for a fleet, as ``run_tffm.py``."""
    from fast_tffm_tpu_torch.serve import fleet, frontend
    calls = []
    monkeypatch.setattr(frontend, "run_serve", lambda cfg, device=None:
                        calls.append(("serve", None, device)) or 0)
    monkeypatch.setattr(fleet, "run_fleet",
                        lambda cfg, path, replicas=None, device=None:
                        calls.append(("fleet", replicas, device)) or 0)
    cfg_path = str(tmp_path / "fleet.cfg")
    with open(slice_run["cfg_path"]) as fh:
        text = fh.read().replace("serve_port = 0", "serve_port = 7070")
    with open(cfg_path, "w") as fh:
        fh.write(text + f"serve_replicas = {in_cfg}\n")
    assert main(["serve", cfg_path, "--device", "cpu", *rest]) == 0
    assert calls == [want + ("cpu",)]


def _admit_step(cfg, step, lines, seed):
    """A random table and a slot map admitting the ids of ``lines``'
    first half, written as ``step`` with its vocab sidecar."""
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch.vocab.table import VocabRuntime
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(cfg.num_rows, cfg.row_dim)) * 0.1
             ).astype(np.float32)
    table[-1] = 0.0
    ids = sorted({int(t.split(":")[0]) for ln in lines[:len(lines) // 2]
                  for t in ln.split()[1:]})
    rt = VocabRuntime.from_config(cfg)
    pick = np.asarray(ids[seed % 3::2], np.int64)
    for _ in range(3):
        rt.note_trained(SimpleNamespace(vocab_obs=pick))
    rt.barrier()
    assert 0 < rt.live_rows <= cfg.vocabulary_size - 1
    save_checkpoint_from_numpy(cfg, table, None, step)
    directory = os.path.abspath(cfg.model_file) + ".ckpt"
    ck.write_vocab_sidecar(directory, step, rt.state_payload())
    return table, rt.state_payload()


def _admit_predict(cfg, tmp_path, name):
    out = str(tmp_path / name)
    predict(dataclasses.replace(cfg, score_path=out), device="cpu")
    with open(os.path.join(out, "in.txt.score")) as fh:
        return fh.read().splitlines(keepends=True)


def test_admit_server_hot_reload_and_torn_sidecar(slice_run, tmp_path):
    from fast_tffm_tpu.vocab.table import VocabMap as JaxVocabMap
    from fast_tffm_tpu_torch import checkpoint as ck
    base, lines = slice_run["cfg"], slice_run["lines"]
    wd = str(tmp_path)
    cfg = dataclasses.replace(base, vocab_mode="admit", vocabulary_size=64,
                              model_file=os.path.join(wd, "m", "fm"))
    directory = os.path.abspath(cfg.model_file) + ".ckpt"
    table1, payload1 = _admit_step(cfg, 3, lines, 1)
    assert fmckpt.main(["publish", cfg.model_file, "3"]) == 0
    want1 = _admit_predict(cfg, tmp_path, "s3")
    # JAX predict_scores through the same slot map.
    jcfg = dataclasses.replace(jax_load_config(slice_run["cfg_path"]),
                               kernel="pallas", dedup="device",
                               vocab_mode="admit", vocabulary_size=64)
    jraw = jax_predict_scores(jcfg, jnp.asarray(table1),
                              [os.path.join(os.path.dirname(
                                  slice_run["cfg_path"]), "in.txt")],
                              vocab=JaxVocabMap.from_payload(jcfg,
                                                             payload1))
    np.testing.assert_allclose([float(v) for v in want1],
                               jax_sigmoid(jraw), rtol=0, atol=1e-6)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        assert server.served_step == 3
        assert server._reg.gauge("serve/vocab_live_rows").value == \
            len(np.frombuffer(base64.b64decode(
                payload1["state"]["slot_keys"]), np.int64))

        def check(want, step, n=None):
            for lo, k in ((0, 64), (100, 37), (460, 42), (200, 1)):
                res = server.score_lines(lines[lo:lo + k], timeout=60)
                assert res.step == step
                got = "".join(f"{v:.6f}\n" for v in res.scores)
                assert got == "".join(want[lo:lo + k])

        check(want1, 3)
        # A new step with another table and slot map: the hot reload
        # swaps the triple.
        _admit_step(cfg, 5, lines, 2)
        want2 = _admit_predict(cfg, tmp_path, "s5")
        assert want2 != want1
        assert server.reload_step(5)
        check(want2, 5)
        # A step whose sidecar has one flipped byte: the reload fails
        # whole, and step 5's triple keeps serving.
        _admit_step(cfg, 8, lines, 3)
        with open(ck.vocab_sidecar_path(directory, 8), "r+b") as fh:
            fh.seek(-6, os.SEEK_END)
            b = fh.read(1)
            fh.seek(-6, os.SEEK_END)
            fh.write(bytes([b[0] ^ 0xFF]))
        assert not server.reload_step(8)
        stats = server.stats()
        assert stats["served_step"] == 5 and stats["reload_failures"] == 1
        assert stats["reloads"] == 1
        check(want2, 5)
        # And a step with no sidecar at all.
        save_checkpoint_from_numpy(cfg, table1, None, 9)
        assert not server.reload_step(9)
        check(want2, 5)
    finally:
        server.close()
    fixed = dataclasses.replace(cfg, vocab_mode="fixed")
    assert fmckpt.main(["publish", cfg.model_file, "5"]) == 0
    with pytest.raises(ValueError, match="vocab admission sidecar"):
        ScorerServer(fixed, device="cpu", watch=False)
