"""Serving that follows training, on the CPU: the port's ``ScorerServer``
loads the step the ``published`` pointer names and its ``ReloadWatcher``
hot-swaps each newly published step (fast_tffm_tpu_torch/serve/).

- ``ReloadWatcher.next_wait`` gives the JAX package's jittered sequence
  for a seed.
- With no pointer the server refuses to start, naming the port's
  ``fmckpt publish``, in either reload mode.
- ``serve_reload_mode = external`` (a fleet replica): the watcher
  records the pointer but never reloads; ``POST /reload`` meets the JAX
  front end's contract (``fast_tffm_tpu/serve/frontend.py``,
  ``server.py:external_reload``): an empty body resolves the pointer,
  the step already served is a no-op (200), a missing or torn step is a
  503 with the old step serving, a non-integer body a 400, and the
  server is not ready for the length of a reload.
- A reload under concurrent HTTP clients swaps the table, and every
  response body equals the port's batch predict lines for the step its
  ``X-FM-Step`` names, byte for byte; ``/healthz`` counts the reload.
- A torn published step keeps the old step serving and counts a reload
  failure; a garbled pointer heals on the next poll.
"""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fast_tffm_tpu.serve.reload import ReloadWatcher as JaxReloadWatcher
from fast_tffm_tpu_torch.checkpoint import read_published, write_published
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.predict import load_table, predict
from fast_tffm_tpu_torch.serve.frontend import make_http_server
from fast_tffm_tpu_torch.serve.reload import ReloadWatcher
from fast_tffm_tpu_torch.serve.server import ScorerServer
from fast_tffm_tpu_torch.testing.faults import truncate_checkpoint
from fast_tffm_tpu_torch.tools import fmckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STEPS = (3, 5)


def _write_cfg(wd, poll_seconds=0.05):
    with open(os.path.join(REPO, "sample.cfg")) as fh:
        text = fh.read()
    text = (text.replace("./model/fm_model", os.path.join(wd, "fm_model"))
            .replace("./log/fm.log", os.path.join(wd, "fm.log"))
            .replace("./score", os.path.join(wd, "score"))
            .replace("data/sample_test.txt", os.path.join(wd, "in.txt"))
            .replace("data/", os.path.join(REPO, "data") + "/"))
    text += ("\n[Serve]\nserve_port = 0\nserve_max_batch = 64\n"
             f"serve_max_wait_ms = 2\nserve_poll_seconds = {poll_seconds}\n")
    path = os.path.join(wd, "sample.cfg")
    with open(path, "w") as fh:
        fh.write(text)
    return path


@pytest.fixture
def model(tmp_path):
    """Two checkpoint steps of sample.cfg's model, and the port's predict
    lines of each over the predict file (blank lines included)."""
    wd = str(tmp_path)
    with open(os.path.join(REPO, "data", "sample_test.txt")) as fh:
        lines = fh.read().splitlines()
    lines = lines[:5] + [""] + lines[5:]
    with open(os.path.join(wd, "in.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    cfg = load_config(_write_cfg(wd))
    rng = np.random.default_rng(3)
    predicted = {}
    for step in STEPS:
        table = (rng.normal(size=(cfg.num_rows, cfg.row_dim)) * 0.3
                 ).astype(np.float32)
        save_checkpoint_from_numpy(cfg, table, None, step)
        step_cfg = dataclasses.replace(
            cfg, score_path=os.path.join(wd, f"score{step}"))
        predict(step_cfg, table=load_table(cfg, CPU, step=step),
                device="cpu")
        with open(os.path.join(step_cfg.score_path, "in.txt.score")) as fh:
            predicted[step] = fh.read().splitlines(keepends=True)
        assert len(predicted[step]) == len(lines)
    assert predicted[3] != predicted[5]
    return dict(cfg=cfg, lines=lines, predicted=predicted)


def test_next_wait_matches_the_jax_watcher():
    for poll, jitter, seed in ((2.0, 0.2, 7070), (0.5, 0.0, 1),
                               (1.0, 0.999, 0), (1.0, 5.0, 3)):
        port = ReloadWatcher(None, poll, jitter=jitter, seed=seed)
        ref = JaxReloadWatcher(None, poll, jitter=jitter, seed=seed)
        assert [port.next_wait() for _ in range(50)] == \
            [ref.next_wait() for _ in range(50)]


def test_server_refuses_to_start_without_a_pointer(model):
    with pytest.raises(FileNotFoundError,
                       match="fast_tffm_tpu_torch.tools.fmckpt publish"):
        ScorerServer(model["cfg"], device="cpu")
    cfg = dataclasses.replace(model["cfg"], serve_reload_mode="external")
    with pytest.raises(FileNotFoundError,
                       match="fast_tffm_tpu_torch.tools.fmckpt publish"):
        ScorerServer(cfg, device="cpu")


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read(), resp.headers["X-FM-Step"]


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_reload_swaps_and_tags_every_response(model):
    cfg, lines, predicted = model["cfg"], model["lines"], model["predicted"]
    assert fmckpt.main(["publish", cfg.model_file, "3"]) == 0
    server = ScorerServer(cfg, device="cpu")
    httpd = make_http_server(server, 0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    results = []
    flipped = threading.Event()
    lock = threading.Lock()

    def client(k):
        rng = np.random.default_rng(k)
        rounds_after_flip = 0
        while rounds_after_flip < 5:
            n = int(rng.integers(1, 65))
            lo = int(rng.integers(0, len(lines) - n + 1))
            after = flipped.is_set()
            status, body, step = _post(port,
                                       "\n".join(lines[lo:lo + n]) + "\n")
            with lock:
                results.append((lo, n, status, body, int(step), after))
            if after:
                rounds_after_flip += 1

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(6)]
        for th in threads:
            th.start()
        health = _healthz(port)
        assert health["served_step"] == health["published_step"] == 3
        while len(results) < 6 and all(th.is_alive() for th in threads):
            time.sleep(0.01)
        assert fmckpt.main(["publish", cfg.model_file, "5"]) == 0
        deadline = time.monotonic() + 30
        while server.served_step != 5 and time.monotonic() < deadline:
            time.sleep(0.01)  # the watcher thread polls every 0.05 s
        flipped.set()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        health = _healthz(port)
    finally:
        sys.setswitchinterval(switch)
        httpd.shutdown()
        http_thread.join(timeout=30)
        httpd.server_close()
        server.close()
    assert health["served_step"] == health["published_step"] == 5
    assert health["reloads"] == 1 and health["reload_failures"] == 0
    assert not health["reloading"] and health["flush_errors"] == 0
    seen = set()
    for lo, n, status, body, step, after in results:
        assert status == 200
        assert body == "".join(predicted[step][lo:lo + n]).encode()
        seen.add(step)
        # a request sent once the swap was seen never gets the old step
        assert step == 5 or not after
    assert seen == {3, 5}


def test_torn_published_step_keeps_the_old_step_serving(model):
    cfg, lines, predicted = model["cfg"], model["lines"], model["predicted"]
    write_published(cfg.model_file + ".ckpt", 3)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        truncate_checkpoint(cfg.model_file, step=5)
        write_published(cfg.model_file + ".ckpt", 5)  # torn after publish
        watcher = ReloadWatcher(server, 1.0)
        assert watcher.poll_once()
        res = server.score_lines(lines[:9], timeout=30)
        stats = server.stats()
    finally:
        server.close()
    assert res.step == 3 and stats["served_step"] == 3
    assert stats["published_step"] == 5
    assert stats["reload_failures"] == 1 and stats["reloads"] == 0
    assert stats["ready"] and not stats["reloading"]
    from fast_tffm_tpu_torch.scoring import format_scores
    assert format_scores(res.scores) == "".join(predicted[3][:9])


def test_garbled_pointer_heals_on_the_next_poll(model):
    cfg, lines, predicted = model["cfg"], model["lines"], model["predicted"]
    directory = cfg.model_file + ".ckpt"
    write_published(directory, 3)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        watcher = ReloadWatcher(server, 1.0)
        assert not watcher.poll_once()  # nothing new
        with open(os.path.join(directory, "published"), "w") as fh:
            fh.write("5\x00garbage")
        assert read_published(directory) is None
        assert not watcher.poll_once()
        assert server.served_step == 3
        write_published(directory, 5)
        assert watcher.poll_once()
        res = server.score_lines(lines[:4], timeout=30)
        stats = server.stats()
    finally:
        server.close()
    assert res.step == 5 and stats["reloads"] == 1
    assert stats["reload_failures"] == 0
    from fast_tffm_tpu_torch.scoring import format_scores
    assert format_scores(res.scores) == "".join(predicted[5][:4])


def test_canary_pointer_falls_back_to_published(model):
    cfg = dataclasses.replace(model["cfg"], serve_pointer="canary")
    directory = cfg.model_file + ".ckpt"
    write_published(directory, 3)
    server = ScorerServer(cfg, device="cpu", watch=False)
    try:
        assert server.served_step == 3
        assert fmckpt.main(["publish", cfg.model_file, "5",
                            "--canary"]) == 0
        assert ReloadWatcher(server, 1.0).poll_once()
        assert server.served_step == 5 and read_published(directory) == 3
    finally:
        server.close()


def _post_reload(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/reload",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_post_reload_meets_the_jax_contract(model):
    cfg, lines, predicted = model["cfg"], model["lines"], model["predicted"]
    cfg = dataclasses.replace(cfg, serve_reload_mode="external")
    directory = cfg.model_file + ".ckpt"
    write_published(directory, 3)
    server = ScorerServer(cfg, device="cpu")
    httpd = make_http_server(server, 0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    ready_during = []
    load_step = server._load_step

    def observed_load(step):
        ready_during.append((server.is_ready(), server.stats()["ready"]))
        load_step(step)

    server._load_step = observed_load
    try:
        write_published(directory, 5)
        deadline = time.monotonic() + 30
        while server.published_step != 5:
            assert time.monotonic() < deadline, "the watcher never polled"
            time.sleep(0.01)
        time.sleep(0.2)  # four more polls: none reloads
        assert server.served_step == 3 and server.stats()["reloads"] == 0
        replies = [_post_reload(port, body)
                   for body in ("3", "", " 5\n", "five", "7")]
        truncate_checkpoint(cfg.model_file, step=3)
        replies.append(_post_reload(port, "3"))
        status, body, step = _post(port, "\n".join(lines[:6]) + "\n")
        stats = _healthz(port)
    finally:
        httpd.shutdown()
        http_thread.join(timeout=30)
        httpd.server_close()
        server.close()
    codes = [code for code, _ in replies]
    assert codes == [200, 200, 200, 400, 503, 503]
    assert [json.loads(b) for _, b in replies[:3]] == [
        {"ok": True, "step": 3}, {"ok": True, "step": 5},
        {"ok": True, "step": 5}]
    assert b"five" in replies[3][1]
    assert [json.loads(b) for _, b in replies[4:]] == [
        {"ok": False, "step": 5}, {"ok": False, "step": 5}]
    # One load for the pointer's step 5, one each for the failed 7 and 3.
    assert ready_during == [(False, False)] * 3
    assert (status, step) == (200, "5")
    assert body == "".join(predicted[5][:6]).encode()
    assert stats["served_step"] == 5 and stats["ready"]
    assert stats["reloads"] == 1 and stats["reload_failures"] == 2
