"""``vocab_mode = admit`` in the port's ``run_mode = stream``, on the CPU:
the JAX package's ``vocab-churn`` contract (tools/fmchaos ``scenario_
vocab_churn``) held on the port, and the port's published slot maps held
to the JAX stream's (``run_tffm.py train``, a subprocess with one CPU
device, from the same initial table) on the same shards.

Heavy-tailed hashed ids, 10x the ``vocabulary_size`` distinct ids and
more: an era A whose hot ids go cold, then an era B. Publishes are the
barriers. So that they land at the same steps in every run, a writer
releases shard k+1 only once the step that closes shard k has been
published (its step directory exists), with no periodic saves and a
publish interval well above a shard's stepping time. The first shard
is a single batch: the JAX step compiles on it, and a publish can only
fall between steps, so however long the compile takes, the barrier
after it lands on step 1.

- JAX against the port, uninterrupted: the slot map published at each
  shard boundary equal payload for payload, the kept steps' sidecars and
  the published step equal, the final tables at rtol 1e-4 / atol 1e-6;
  live rows <= vocabulary_size - 1 and every slot row in [1,
  vocabulary_size) at every publish; era A's rows admitted then evicted.
- The port alone: SIGTERM once shard 2's step is published, the newest
  step torn, then a resume that walks back to the older step and its own
  sidecar (the log names its live rows) and finishes the stream: its
  final sidecar equals the uninterrupted run's, its table at tolerance,
  and the published step scores an evicted id from the cold row.
"""

import base64
import gzip
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.data.hashing import murmur64
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.predict import load_table
from fast_tffm_tpu_torch.scoring import CompiledScorer
from fast_tffm_tpu_torch.testing.faults import truncate_checkpoint
from fast_tffm_tpu_torch.train import checkpoint_template, train
from fast_tffm_tpu_torch.vocab.sketch import HASH_SPACE

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
V = 16
B = 32
# (era, batches) per shard: a one-batch warm-up, then era A, era B, B.
SHARDS = (("W", 1), ("A", 12), ("B", 12), ("B", 12))
BOUNDARY = [sum(n for _, n in SHARDS[:k + 1]) for k in range(len(SHARDS))]
PUBLISH_SECONDS = 4.0
WAIT_SECONDS = 240

# The port's train in a subprocess (it takes the SIGTERM), from a table.
_PORT_TRAIN = r'''
import sys
import numpy as np
import torch
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.train import train
cfg = load_config(sys.argv[1])
table = np.load(sys.argv[2])
train(cfg, device="cpu", init_state=convert.state_from_numpy(
    table, np.full_like(table, cfg.adagrad_init), cfg,
    torch.device("cpu")))
'''

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


def _shard_lines(k):
    """Shard k of its era: the label decided by one of 4 hot ids of the
    era, one tail id from 20,000 a line."""
    rng = np.random.default_rng(100 + k)
    era, batches = SHARDS[k]
    lines = []
    for i in range(batches * B):
        y = i % 2
        hot = f"hot{era}{(i % 4) // 2 * 2 + y}"
        lines.append(f"{y} {hot}:1 u{int(rng.integers(0, 20000))}:0.5")
    return lines


def _cfg_text(wd, sd):
    return f"""[General]
vocabulary_size = {V}
hash_feature_id = True
factor_num = 4
model_file = {wd}/fm_model
log_file = {wd}/fm.log

[Train]
run_mode = stream
stream_dir = {sd}
stream_poll_seconds = 0.05
seal_policy = done
batch_size = {B}
learning_rate = 0.1
init_value_range = 0.05
log_steps = 0
save_steps = 0
publish_interval_seconds = {PUBLISH_SECONDS}

[Vocab]
vocab_mode = admit
vocab_admit_threshold = 2
vocab_decay = 0.25
vocab_sketch_mb = 0.25
"""


def _setup(root, name):
    wd, sd = os.path.join(root, name), os.path.join(root, name, "stream")
    os.makedirs(sd)
    path = os.path.join(wd, "stream.cfg")
    with open(path, "w") as fh:
        fh.write(_cfg_text(wd, sd))
    return path, wd, sd


def _read_sidecar(directory, step):
    with gzip.open(ck.vocab_sidecar_path(directory, step), "rt") as fh:
        return json.load(fh)


class _Writer(threading.Thread):
    """Release shards ``ks`` one at a time: shard k is written and sealed
    once the step that closes the shard before it is committed (after
    ``after`` holds, when given). At each shard boundary the committed
    step's vocab sidecar is kept. Then ``finish`` (default: ``STOP``)."""

    def __init__(self, sd, directory, ks, finish=None, after=None):
        super().__init__(name="vocab-stream-writer", daemon=True)
        self.sd, self.directory = sd, directory
        self.ks = ks
        self.finish = finish or (lambda: open(
            os.path.join(sd, "STOP"), "w").close())
        self.after = after or (lambda: True)
        self.published = {}
        self.error = None

    def _wait_step(self, step):
        deadline = time.monotonic() + WAIT_SECONDS
        path = ck.vocab_sidecar_path(self.directory, step)
        while time.monotonic() < deadline:
            if self.after() and step in ck.list_step_dirs(
                    self.directory) and os.path.exists(path):
                try:
                    return _read_sidecar(self.directory, step)
                except (OSError, ValueError, EOFError):
                    pass  # the rename of a sidecar being written
            time.sleep(0.01)
        raise TimeoutError(f"step {step} never committed with a sidecar")

    def run(self):
        try:
            self._wait_step(BOUNDARY[self.ks[0] - 1] if self.ks[0] else 0)
            for k in self.ks:
                path = os.path.join(self.sd, f"part-{k:03d}")
                with open(path, "w") as fh:
                    fh.write("\n".join(_shard_lines(k)) + "\n")
                open(path + ".done", "w").close()
                self.published[BOUNDARY[k]] = self._wait_step(BOUNDARY[k])
            self.finish()
        except BaseException as e:  # raised by the test
            self.error = e
            open(os.path.join(self.sd, "STOP"), "w").close()


def _table0(cfg):
    rng = np.random.default_rng(9)
    t = rng.uniform(-cfg.init_value_range, cfg.init_value_range,
                    (cfg.num_rows, cfg.row_dim)).astype(np.float32)
    t[-1] = 0.0
    return t


def _port_run(cfg_path, writer, table0=None):
    cfg = load_config(cfg_path)
    init = None
    if table0 is not None:
        init = convert.state_from_numpy(
            table0, np.full_like(table0, cfg.adagrad_init), cfg, CPU)
    writer.start()
    try:
        train(cfg, device="cpu", init_state=init)
    finally:
        writer.join(timeout=WAIT_SECONDS)
    assert writer.error is None, writer.error
    return cfg


def _rows(payload):
    return np.frombuffer(base64.b64decode(payload["state"]["slot_rows"]),
                         np.int32)


def _keys(payload):
    return set(np.frombuffer(base64.b64decode(
        payload["state"]["slot_keys"]), np.int64).tolist())


def _state(cfg, step):
    r = ck.CheckpointState(cfg.model_file).restore(
        step=step, template=checkpoint_template(cfg))
    return r["table"].numpy(), r["acc"].numpy()


def _hashed(token):
    return murmur64(token.encode()) % HASH_SPACE


def test_vocab_churn_matches_jax_and_survives_a_walk_back(tmp_path):
    root = str(tmp_path)
    last = BOUNDARY[-1]
    distinct = {t.split(":")[0] for k in range(len(SHARDS))
                for ln in _shard_lines(k) for t in ln.split()[1:]}
    assert len(distinct) >= 10 * V

    # The JAX stream, uninterrupted.
    jpath, jwd, jsd = _setup(root, "jax")
    jdir = os.path.join(jwd, "fm_model.ckpt")
    table0 = _table0(load_config(jpath))
    np.save(os.path.join(jwd, "table0.npy"), table0)
    jwriter = _Writer(jsd, jdir, range(len(SHARDS)))
    jwriter.start()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    script = _JAX_TRAIN.replace("RUN_TFFM",
                                repr(os.path.join(REPO, "run_tffm.py")))
    proc = subprocess.run([sys.executable, "-c", script, jpath,
                           os.path.join(jwd, "table0.npy")], cwd=jwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    jwriter.join(timeout=WAIT_SECONDS)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert jwriter.error is None, jwriter.error

    # The port, uninterrupted.
    cpath, cwd, csd = _setup(root, "control")
    cdir = os.path.join(cwd, "fm_model.ckpt")
    cwriter = _Writer(csd, cdir, range(len(SHARDS)))
    ccfg = _port_run(cpath, cwriter, table0)

    assert sorted(cwriter.published) == sorted(jwriter.published) == \
        BOUNDARY
    for step, payload in cwriter.published.items():
        assert payload == jwriter.published[step], f"step {step}"
        rows = _rows(payload)
        assert len(rows) <= V - 1
        assert rows.size == 0 or (rows.min() >= 1 and rows.max() < V)
    assert ck.list_step_dirs(cdir) == ck.list_step_dirs(jdir)
    for step in ck.list_step_dirs(cdir):
        assert _read_sidecar(cdir, step) == _read_sidecar(jdir, step)
    assert ck.read_published(cdir) == ck.read_published(jdir) == last
    from fast_tffm_tpu import checkpoint as jck
    from fast_tffm_tpu.config import load_config as jax_load_config
    from fast_tffm_tpu.train import checkpoint_template as jax_template
    jcfg = jax_load_config(jpath)
    jstate = jck.CheckpointState(jcfg.model_file)
    try:
        r = jstate.restore(step=last, template=jax_template(jcfg))
    finally:
        jstate.close()
    pt, pa = _state(ccfg, last)
    np.testing.assert_allclose(pt, np.asarray(r["table"])[:V + 1],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pa, np.asarray(r["acc"])[:V + 1],
                               rtol=1e-4, atol=1e-6)
    era_a = {_hashed(f"hotA{i}") for i in range(4)}
    first = cwriter.published[BOUNDARY[1]]
    final = _read_sidecar(cdir, last)
    assert era_a <= _keys(first), "era A was never admitted"
    assert not era_a & _keys(final), "era A was never evicted"
    with open(ccfg.log_file) as fh:
        log = fh.read()
    assert sum(int(n) for n in re.findall(r"-(\d+) evicted", log)) >= 4

    # The port: SIGTERM at shard 2's publish, a torn newest step, then a
    # resume through the walk-back.
    ppath, pwd, psd = _setup(root, "port")
    pdir = os.path.join(pwd, "fm_model.ckpt")
    pcfg = load_config(ppath)
    np.save(os.path.join(pwd, "table0.npy"), table0)
    penv = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    penv["PYTHONPATH"] = REPO
    proc = subprocess.Popen([sys.executable, "-c", _PORT_TRAIN, ppath,
                             os.path.join(pwd, "table0.npy")], cwd=pwd,
                            env=penv, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    pwriter = _Writer(psd, pdir, range(3),
                      finish=lambda: proc.send_signal(signal.SIGTERM))
    pwriter.start()
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
        pwriter.join(timeout=WAIT_SECONDS)
    assert proc.returncode == 0, err[-4000:]
    assert pwriter.error is None, pwriter.error
    with open(pcfg.log_file) as fh:
        assert "preemption signalled" in fh.read()
    steps = ck.list_step_dirs(pdir)
    assert steps[-1] == BOUNDARY[2], steps
    victim = truncate_checkpoint(pcfg.model_file, seed=0)
    assert f"{os.sep}{steps[-1]}{os.sep}" in victim
    older = BOUNDARY[1]
    older_live = len(_rows(_read_sidecar(pdir, older)))
    # The resume retrains shard 2 from the older step; its writer waits
    # for the walk-back's quarantine first (the torn step is no publish
    # of the resumed run), then for the retrained step.
    resume = _Writer(psd, pdir, range(3, len(SHARDS)),
                     after=lambda: os.path.isdir(os.path.join(
                         pdir, f"corrupt-{BOUNDARY[2]}")))
    _port_run(ppath, resume)
    with open(pcfg.log_file) as fh:
        log = fh.read()
    assert f"restored checkpoint at step {older}" in log
    assert (f"restored vocab admission state at step {older}: "
            f"{older_live} live rows") in log
    assert os.path.isdir(os.path.join(pdir, f"corrupt-{BOUNDARY[2]}"))
    assert _read_sidecar(pdir, last) == final
    for got, want in zip(_state(pcfg, last), _state(ccfg, last)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    # The published step scores an evicted id through the cold row: as
    # a never-seen id, not its stale embedding.
    vmap = ck.load_vocab_map(pcfg, pdir, ck.read_published(pdir))
    table = load_table(pcfg, CPU, step=ck.read_published(pdir))
    probe = str(tmp_path / "probe.txt")
    with open(probe, "w") as fh:
        fh.write("0 hotA0:1\n0 never_seen_xyzzy:1\n")
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    scorer = CompiledScorer(pcfg, CPU)
    batch = next(batch_iterator(pcfg, [probe], training=False,
                                keep_empty=True, vocab=vmap))
    s = scorer.score_batch(table, batch).numpy()[:2]
    assert s[0] == s[1]
