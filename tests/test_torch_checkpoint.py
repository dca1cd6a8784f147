"""The port's checkpoint plane (fast_tffm_tpu_torch/checkpoint.py and
what reads and writes it) against the JAX package's, on the CPU.

- The copied host helpers against the originals on the same
  directories: ``compute_manifest``, ``verify_step_dir`` (intact /
  truncated / missing file / garbled manifest / no manifest, at ``size``
  and ``full``), ``SIDECAR_RE``/``sidecar_step``, the pointer files
  (written by one package, read by the other), ``resume_start_epoch``,
  ``truncate_checkpoint``, ``retry_io``.
- ``CheckpointState``'s contracts, as tests/test_checkpoint_verify.py and
  tests/test_checkpoint_async.py state them for the JAX package, on the
  port's format — the three that the JAX package fails on this tree
  included (a load error walks back without a manifest; the last
  candidate's load error raises without quarantine; ``ckpt_verify =
  off`` still walks back) — plus a snapshot that an in-place update
  right after ``save`` cannot tear, and an orbax step directory that is
  refused without being quarantined.
- Training across runs, each scenario run by both packages from the JAX
  package's ``init_table`` array (the JAX side in a subprocess with one
  CPU device, so it takes its single-device path) and held at rtol 1e-4
  / atol 1e-6 on the table and accumulator of every run's checkpoint
  (ROADMAP.md's training tolerance): (a) ``epoch_num`` 1 then 2 with
  ``save_steps`` dividing the epoch (the final save collides with the
  last periodic one and writes the epoch override); (b) a second train
  on a completed checkpoint runs a fresh schedule on top, 80 -> 160
  steps on ``sample.cfg``; (c) a SIGTERM mid-epoch saves the cut step
  with the cut epoch not completed, and the resumed run replays that
  epoch with ``global_step`` continuing.
- Predict from a checkpoint equals the JAX package's predict of the same
  model within the reference's score tolerance; the port's ``fmckpt``
  prints what ``tools.fmckpt`` prints over the same port directory.
"""

import dataclasses
import io
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_tffm_tpu.checkpoint as jck
from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.testing.faults import \
    truncate_checkpoint as jax_truncate_checkpoint
from fast_tffm_tpu.train import ckpt_state as jax_ckpt_state
from fast_tffm_tpu.train import resume_start_epoch as jax_resume_start_epoch
from fast_tffm_tpu.utils import retry as jax_retry
from fast_tffm_tpu_torch import checkpoint as ck
from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.checkpoint import (QUARANTINE_PREFIX,
                                            CheckpointState, list_step_dirs,
                                            manifest_path, read_manifest,
                                            verify_step_dir, write_manifest)
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.models import convert
from fast_tffm_tpu_torch.testing.faults import truncate_checkpoint
from fast_tffm_tpu_torch.tools import fmckpt
from fast_tffm_tpu_torch.train import (checkpoint_template,
                                       resume_start_epoch, train)
from fast_tffm_tpu_torch.utils import retry
from tests.test_torch_train import _write_cfg as _write_sample_cfg

# One intra-op thread: torch's idle OpenMP workers would otherwise spin
# on every core and starve the suite's other test processes.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mk_state(tmp_path, vocab=1000, factors=4, **kw):
    """A port config, a (table, acc) pair of its shapes, and a
    CheckpointState at its model_file."""
    cfg = FmConfig(vocabulary_size=vocab, factor_num=factors,
                   model_file=str(tmp_path / "m" / "fm"))
    rng = np.random.default_rng(vocab)
    table = torch.from_numpy(rng.normal(
        size=(cfg.num_rows, cfg.row_dim)).astype(np.float32))
    acc = torch.full((cfg.num_rows, cfg.row_dim), cfg.adagrad_init)
    ckpt = CheckpointState(cfg.model_file, adagrad_init=cfg.adagrad_init,
                           **kw)
    return cfg, table, acc, ckpt


def _save(ckpt, cfg, table, acc, step, epoch=0, **kw):
    ckpt.save(step, table, acc, vocabulary_size=cfg.vocabulary_size,
              epoch=epoch, **kw)


# --- the copied helpers against the originals -------------------------------


def test_compute_manifest_equals_the_jax_package(tmp_path):
    d = tmp_path / "c.ckpt" / "7" / "sub"
    d.mkdir(parents=True)
    (d / "a.bin").write_bytes(b"x" * 1000)
    (d.parent / "b.bin").write_bytes(bytes(range(256)) * 3)
    directory = str(tmp_path / "c.ckpt")
    payload = {"epoch": 3, "vocab": 9}
    assert ck.compute_manifest(directory, 7, payload) == \
        jck.compute_manifest(directory, 7, payload)
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 4, epoch=1, wait=True)
    ckpt.close()
    man = ck.compute_manifest(ckpt.directory, 4, {"epoch": 1,
                                                  "vocab": 1000})
    assert man == jck.compute_manifest(ckpt.directory, 4,
                                       {"epoch": 1, "vocab": 1000})
    assert man == read_manifest(ckpt.directory, 4)
    assert sorted(man["files"]) == ["acc.pt", "meta.json", "table.pt"]


def _break_step(directory, step, state):
    step_dir = os.path.join(directory, str(step))
    if state == "truncated":
        with open(os.path.join(step_dir, "table.pt"), "r+b") as fh:
            fh.truncate(8)
    elif state == "missing_file":
        os.remove(os.path.join(step_dir, "acc.pt"))
    elif state == "garbled_manifest":
        with open(manifest_path(directory, step), "w") as fh:
            fh.write("{not json")
    elif state == "no_manifest":
        os.remove(manifest_path(directory, step))
    elif state == "bit_flip":
        path = os.path.join(step_dir, "acc.pt")
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) - 100)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("mode", ["size", "full"])
@pytest.mark.parametrize("state,failing", [
    ("intact", ()), ("truncated", ("size", "full")),
    ("missing_file", ("size", "full")),
    ("garbled_manifest", ("size", "full")), ("no_manifest", ()),
    ("bit_flip", ("full",))])
def test_verify_step_dir_verdicts_match(tmp_path, state, failing, mode):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 3, wait=True)
    ckpt.close()
    _break_step(ckpt.directory, 3, state)
    got = verify_step_dir(ckpt.directory, 3, mode)
    assert got == jck.verify_step_dir(ckpt.directory, 3, mode)
    assert (got is not None) == (mode in failing), got


def test_sidecar_names_agree():
    names = ["epoch_override-12", "manifest-3.json", "manifest-3.json.tmp",
             "watermark-9.json", "watermark-9.json.tmp", "vocab-4.json.gz",
             "vocab-4.json.gz.tmp", "published", "published-canary", "12",
             "12.tmp", "corrupt-12", "manifest-x.json", "epoch_override-",
             "manifest-3.jsonx", "table.pt"]
    for name in names:
        assert ck.sidecar_step(name) == jck.sidecar_step(name), name
        assert bool(ck.SIDECAR_RE.fullmatch(name)) == bool(
            jck.SIDECAR_RE.fullmatch(name)), name
    assert ck.SIDECAR_RE.pattern == jck.SIDECAR_RE.pattern


def test_pointers_written_by_one_package_read_by_the_other(tmp_path):
    d = str(tmp_path)
    for writer, reader in ((ck, jck), (jck, ck)):
        assert reader.read_published(d) is None
        assert reader.read_pointer(d, "canary") is None
        writer.write_published(d, 40)
        assert reader.read_published(d) == 40
        assert reader.read_pointer(d, "canary") == 40  # falls back
        writer.write_canary(d, 48)
        assert reader.read_canary(d) == 48
        assert reader.read_pointer(d, "canary") == 48
        assert reader.read_pointer(d, "published") == 40
        with open(os.path.join(d, "published")) as a:
            assert a.read() == "40\n"
        with open(os.path.join(d, "published"), "w") as fh:
            fh.write("4x\n")  # garbled: reads as never published
        assert reader.read_published(d) is None
        assert reader.wait_for_published(d, timeout=0.05,
                                         poll_seconds=0.01) is None
        os.remove(os.path.join(d, "published"))
        os.remove(os.path.join(d, "published-canary"))
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


def test_resume_start_epoch_agrees_over_a_grid():
    for stored in range(0, 8):
        for epoch_num in range(1, 7):
            assert resume_start_epoch(stored, epoch_num) == \
                jax_resume_start_epoch(stored, epoch_num)


@pytest.mark.parametrize("seed,step", [(0, None), (1, None), (3, 2),
                                       (7, 1)])
def test_truncate_checkpoint_picks_the_same_file(tmp_path, seed, step):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    for s in (1, 2):
        _save(ckpt, cfg, table, acc, s, wait=True)
    ckpt.close()
    twin = str(tmp_path / "twin" / "fm")
    shutil.copytree(ckpt.directory, twin + ".ckpt")
    got = truncate_checkpoint(cfg.model_file, seed=seed, step=step)
    want = jax_truncate_checkpoint(twin, seed=seed, step=step)
    assert os.path.relpath(got, ckpt.directory) == \
        os.path.relpath(want, twin + ".ckpt")
    assert os.path.getsize(got) == os.path.getsize(want) == 8
    assert truncate_checkpoint(str(tmp_path / "none")) is None


def test_retry_io_backs_off_as_the_jax_package(tmp_path):
    def flaky(n):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= n:
                raise OSError(5, "EIO")
            return len(calls)
        return fn

    for n, retries in ((0, 2), (2, 2), (3, 2)):
        sleeps = {}
        out = {}
        for name, mod in (("port", retry), ("jax", jax_retry)):
            sleeps[name] = []
            policy = mod.RetryPolicy(retries=retries, backoff_seconds=0.1,
                                     seed=4)
            try:
                out[name] = mod.retry_io(flaky(n), policy=policy,
                                         op="checkpoint_restore",
                                         sleep=sleeps[name].append)
            except OSError as e:
                out[name] = f"raised {e.errno}"
        assert out["port"] == out["jax"] and sleeps["port"] == sleeps["jax"]
    missing = retry.RetryPolicy(retries=5)
    with pytest.raises(FileNotFoundError):
        retry.retry_io(open, str(tmp_path / "nope"), policy=missing,
                       sleep=lambda s: pytest.fail("retried a fatal error"))
    cfg = FmConfig(io_retries=4, io_backoff_seconds=0.5, seed=9)
    assert retry.RetryPolicy.from_config(cfg) == retry.RetryPolicy(4, 0.5,
                                                                   9)


# --- CheckpointState: the JAX package's contracts on the port's format -------


def test_committed_save_writes_manifest_with_payload_echo(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 5, epoch=2, wait=True)
    man = read_manifest(ckpt.directory, 5)
    assert man is not None and man["format"] == 1
    assert man["step"] == 5 and man["epoch"] == 2
    assert man["vocab"] == cfg.vocabulary_size
    step_dir = os.path.join(ckpt.directory, "5")
    assert man["files"]
    for rel, info in man["files"].items():
        assert os.path.getsize(os.path.join(step_dir, rel)) == info["size"]
    with open(os.path.join(step_dir, "meta.json")) as fh:
        assert json.load(fh) == {"format": "fast_tffm_tpu_torch/1",
                                 "step": 5, "epoch": 2, "vocab": 1000}
    stored = torch.load(os.path.join(step_dir, "acc.pt"), weights_only=True)
    assert tuple(stored.shape) == (cfg.ckpt_rows, cfg.row_dim)
    assert stored.dtype == torch.float32
    # the stored layout pads as the JAX package's ckpt_state does
    t = torch.load(os.path.join(step_dir, "table.pt"), weights_only=True)
    assert torch.equal(t[:cfg.num_rows], table)
    assert not t[cfg.num_rows:].any()
    assert (stored[cfg.num_rows:] == np.float32(cfg.adagrad_init)).all()
    ckpt.close()


def test_async_save_manifest_flushes_on_close_and_next_save(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1)           # async: manifest owed
    _save(ckpt, cfg, table, acc, 2)           # waits for step 1's
    assert read_manifest(ckpt.directory, 1) is not None
    ckpt.wait_until_finished()                # settles 2's
    assert read_manifest(ckpt.directory, 2) is not None
    _save(ckpt, cfg, table, acc, 3)           # async again
    ckpt.close()                              # close settles step 3's
    assert read_manifest(ckpt.directory, 3) is not None


def test_manifests_pruned_with_gc_and_fresh_same_step_save(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    try:
        for s in (10, 20, 30, 40):            # max_to_keep=3 drops 10
            _save(ckpt, cfg, table, acc, s, wait=True)
        assert list_step_dirs(ckpt.directory) == [20, 30, 40]
        assert not os.path.exists(manifest_path(ckpt.directory, 10))
        assert os.path.exists(manifest_path(ckpt.directory, 40))
    finally:
        ckpt.close()
    stale = {"format": 1, "step": 50, "files": {"bogus": {
        "size": 1, "crc32": 0}}}
    write_manifest(ckpt.directory, 50, stale)
    ckpt2 = CheckpointState(cfg.model_file)
    try:
        _save(ckpt2, cfg, table, acc, 50, wait=True)
        man = read_manifest(ckpt2.directory, 50)
        assert "bogus" not in man["files"]
        assert ckpt2.verify_step(50) is None
    finally:
        ckpt2.close()


def test_verify_modes_size_and_full(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    assert ckpt.verify_step(1) is None
    assert verify_step_dir(ckpt.directory, 1, "full") is None
    _break_step(ckpt.directory, 1, "bit_flip")
    assert verify_step_dir(ckpt.directory, 1, "size") is None
    reason = verify_step_dir(ckpt.directory, 1, "full")
    assert reason and "crc32 mismatch" in reason
    assert verify_step_dir(ckpt.directory, 1, "off") is None
    truncate_checkpoint(cfg.model_file, step=1)
    reason = ckpt.verify_step(1)
    assert reason and "size mismatch" in reason
    with pytest.raises(ValueError, match="unknown ckpt_verify"):
        CheckpointState(cfg.model_file, verify="md5")
    ckpt.close()


def test_verify_without_manifest_is_unverifiable_not_fail(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    os.remove(manifest_path(ckpt.directory, 1))
    assert ckpt.verify_step(1) is None
    ckpt.close()


def test_garbled_manifest_reads_as_corrupt(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    with open(manifest_path(ckpt.directory, 1), "w") as fh:
        fh.write("{not json")
    reason = ckpt.verify_step(1)
    assert reason and "manifest" in reason
    ckpt.close()


def test_restore_falls_back_and_quarantines_torn_step(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, epoch=0, wait=True)
    _save(ckpt, cfg, table + 1, acc, 2, epoch=1, wait=True)
    victim = truncate_checkpoint(cfg.model_file)
    assert victim
    restored = ckpt.restore(template=checkpoint_template(cfg))
    assert restored["step"] == 1 and restored["epoch"] == 0
    assert torch.equal(restored["table"], table)
    assert torch.equal(restored["acc"], acc)
    qdir = os.path.join(ckpt.directory, f"{QUARANTINE_PREFIX}2")
    assert os.path.isdir(qdir)
    rel = os.path.relpath(victim, os.path.join(ckpt.directory, "2"))
    assert os.path.exists(os.path.join(qdir, rel))
    assert os.path.exists(os.path.join(qdir, "QUARANTINE"))
    assert os.path.exists(os.path.join(qdir, "manifest-2.json"))
    assert list_step_dirs(ckpt.directory) == [1]
    assert ckpt.latest_step() == 1
    ckpt.close()


def test_restore_exception_walks_back_without_manifest(tmp_path):
    """Steps without a manifest: verification can't see the tear, so the
    load error itself triggers quarantine + walk-back."""
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    _save(ckpt, cfg, table, acc, 2, wait=True)
    for s in (1, 2):
        os.remove(manifest_path(ckpt.directory, s))
    truncate_checkpoint(cfg.model_file)  # tears step 2
    restored = ckpt.restore(template=checkpoint_template(cfg))
    assert restored["step"] == 1
    qdir = os.path.join(ckpt.directory, f"{QUARANTINE_PREFIX}2")
    assert os.path.isdir(qdir)
    with open(os.path.join(qdir, "QUARANTINE")) as fh:
        assert "restore failed: RuntimeError" in fh.read()
    ckpt.close()


def test_restore_last_candidate_error_raises_without_quarantine(tmp_path):
    """A load failure on the LAST remaining step stays a loud error, not
    a quarantine followed by a silent fresh start."""
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    os.remove(manifest_path(ckpt.directory, 1))  # hide it from verify
    truncate_checkpoint(cfg.model_file, step=1)
    with pytest.raises(ValueError, match="could not be restored"):
        ckpt.restore(template=checkpoint_template(cfg))
    assert list_step_dirs(ckpt.directory) == [1]
    ckpt.close()


def test_restore_all_steps_failing_verification_raises(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    _save(ckpt, cfg, table, acc, 2, wait=True)
    truncate_checkpoint(cfg.model_file, step=1)
    truncate_checkpoint(cfg.model_file, step=2)
    with pytest.raises(ValueError, match="failed integrity"):
        ckpt.restore(template=checkpoint_template(cfg))
    assert list_step_dirs(ckpt.directory) == []
    names = sorted(os.listdir(ckpt.directory))
    assert f"{QUARANTINE_PREFIX}1" in names
    assert f"{QUARANTINE_PREFIX}2" in names
    ckpt.close()


def test_restore_empty_directory_still_fresh_start(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    assert ckpt.restore(template=checkpoint_template(cfg)) is None
    assert ckpt.latest_step() is None
    ckpt.close()


def test_restore_explicit_step_verify_failure_raises_no_quarantine(
        tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    _save(ckpt, cfg, table, acc, 2, wait=True)
    truncate_checkpoint(cfg.model_file, step=2)
    with pytest.raises(ValueError, match="never quarantined"):
        ckpt.restore(step=2, template=checkpoint_template(cfg))
    assert list_step_dirs(ckpt.directory) == [1, 2]
    assert ckpt.restore(step=1)["step"] == 1
    ckpt.close()


def test_verify_off_restores_historical_behavior(tmp_path):
    """ckpt_verify=off: the torn newest step raises on restore, and as
    an older step remains, the load-error walk-back still heals."""
    cfg, table, acc, ckpt = _mk_state(tmp_path, verify="off")
    _save(ckpt, cfg, table, acc, 1, wait=True)
    _save(ckpt, cfg, table, acc, 2, wait=True)
    truncate_checkpoint(cfg.model_file)
    restored = ckpt.restore(template=checkpoint_template(cfg))
    assert restored["step"] == 1
    assert list_step_dirs(ckpt.directory) == [1]
    ckpt.close()


def test_restore_refuses_another_config_layout(tmp_path):
    """A config mismatch is a load failure: the walk-back quarantines
    newer steps only while an older one remains, then raises the newest
    step's error."""
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    wider = checkpoint_template(dataclasses.replace(cfg, factor_num=8))
    with pytest.raises(ValueError, match="could not be restored"):
        ckpt.restore(template=wider)
    assert list_step_dirs(ckpt.directory) == [1]
    # A vocabulary in the same 4096-row bucket restores; train's vocab
    # check then refuses it by name, and nothing is quarantined.
    _save(ckpt, cfg, table, acc, 2, wait=True)
    other = dataclasses.replace(cfg, vocabulary_size=1001)
    restored = ckpt.restore(template=checkpoint_template(other))
    assert restored["step"] == 2 and restored["vocab"] == 1000
    with pytest.raises(ValueError, match="vocabulary_size=1000"):
        train(other, device="cpu")
    assert list_step_dirs(ckpt.directory) == [1, 2]
    ckpt.close()


def test_quarantine_suffix_on_repeat(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    ckpt.quarantine_step(1, "test A")
    _save(ckpt, cfg, table, acc, 1, wait=True, force=True)
    ckpt.quarantine_step(1, "test B")
    names = sorted(os.listdir(ckpt.directory))
    assert f"{QUARANTINE_PREFIX}1" in names
    assert f"{QUARANTINE_PREFIX}1.1" in names
    ckpt.close()


def test_async_save_returns_before_commit_and_restores(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path, vocab=200_000, factors=8)
    t0 = time.perf_counter()
    _save(ckpt, cfg, table, acc, 1)
    t_async = time.perf_counter() - t0
    ckpt.wait_until_finished()
    t0 = time.perf_counter()
    _save(ckpt, cfg, table, acc, 2, wait=True)
    t_sync = time.perf_counter() - t0
    # The async call skips the write; it must be visibly cheaper than
    # the full committed write (and hash) of the same ~14 MB state.
    assert t_async < t_sync, (t_async, t_sync)
    restored = ckpt.restore(template=checkpoint_template(cfg))
    assert restored["step"] == 2
    assert torch.equal(restored["table"], table)
    ckpt.close()


def test_snapshot_survives_an_in_place_update_after_save(tmp_path):
    """The train step updates the table in place right after a periodic
    save returns: the saved bytes must be the table as it was."""
    cfg, table, acc, ckpt = _mk_state(tmp_path, vocab=100_000)
    want_t, want_a = table.clone(), acc.clone()
    _save(ckpt, cfg, table, acc, 1)
    table.add_(1.0)
    acc.mul_(3.0)
    _save(ckpt, cfg, table, acc, 2)
    table.zero_()
    ckpt.wait_until_finished()
    r1 = ckpt.restore(step=1)
    assert torch.equal(r1["table"], want_t)
    assert torch.equal(r1["acc"], want_a)
    r2 = ckpt.restore(step=2)
    assert torch.equal(r2["table"], want_t + 1.0)
    assert torch.equal(r2["acc"], want_a * 3.0)
    ckpt.close()


def test_same_step_resave_updates_stale_epoch(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 40, epoch=7, wait=True)
    _save(ckpt, cfg, table + 5, acc, 40, epoch=8, force=True, wait=True,
          rewrite_stale_metadata=True)
    restored = ckpt.restore(template=checkpoint_template(cfg))
    assert restored["epoch"] == 8 and restored["step"] == 40
    # the arrays at a step are never rewritten
    assert torch.equal(restored["table"], table)
    ckpt.close()


def test_save_at_or_below_the_newest_step_needs_force(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 10, wait=True)
    _save(ckpt, cfg, table, acc, 5, wait=True)             # skipped
    _save(ckpt, cfg, table, acc, 10, epoch=3, wait=True,
          rewrite_stale_metadata=True)                     # skipped
    assert list_step_dirs(ckpt.directory) == [10]
    assert ck.read_epoch_override(ckpt.directory, 10) is None
    _save(ckpt, cfg, table, acc, 5, wait=True, force=True)
    assert list_step_dirs(ckpt.directory) == [5, 10]
    with pytest.raises(ValueError, match="does not match"):
        _save(ckpt, cfg, table[:-1], acc[:-1], 11)
    ckpt.close()


def test_epoch_sidecar_pruned_and_not_leaked(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path, max_to_keep=2)
    _save(ckpt, cfg, table, acc, 10, wait=True, epoch=1)
    _save(ckpt, cfg, table, acc, 10, force=True, wait=True, epoch=2,
          rewrite_stale_metadata=True)
    sc = ckpt._epoch_sidecar(10)
    assert os.path.exists(sc)
    assert ckpt.restore(template=checkpoint_template(cfg))["epoch"] == 2
    _save(ckpt, cfg, table, acc, 20, wait=True, epoch=3)
    _save(ckpt, cfg, table, acc, 30, wait=True, epoch=4)
    assert not os.path.exists(sc)
    assert sorted(os.listdir(ckpt.directory)) == [
        "20", "30", "manifest-20.json", "manifest-30.json"]
    ckpt.close()
    ckpt2 = CheckpointState(cfg.model_file)
    with open(ckpt2._epoch_sidecar(40), "w") as fh:
        fh.write("99")
    _save(ckpt2, cfg, table, acc, 40, wait=True, epoch=5)
    assert ckpt2.restore(template=checkpoint_template(cfg))["epoch"] == 5
    ckpt2.close()


def test_killed_writer_litter_is_never_a_step_and_is_swept(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    for name in ("7.tmp", "3.del"):
        os.makedirs(os.path.join(ckpt.directory, name, "x"))
    assert list_step_dirs(ckpt.directory) == []
    reader = CheckpointState(cfg.model_file)
    assert reader.restore() is None
    assert os.path.isdir(os.path.join(ckpt.directory, "7.tmp"))
    reader.close()
    _save(ckpt, cfg, table, acc, 1, wait=True)
    assert sorted(os.listdir(ckpt.directory)) == ["1", "manifest-1.json"]
    ckpt.close()


def test_failed_write_surfaces_at_the_next_save(tmp_path, monkeypatch):
    cfg, table, acc, ckpt = _mk_state(tmp_path)

    def fail(*a, **k):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(ck.torch, "save", fail)
    _save(ckpt, cfg, table, acc, 1)
    with pytest.raises(OSError, match="No space left"):
        _save(ckpt, cfg, table, acc, 2)
    monkeypatch.undo()
    assert sorted(os.listdir(ckpt.directory)) == []
    _save(ckpt, cfg, table, acc, 2, wait=True)
    assert list_step_dirs(ckpt.directory) == [2]
    ckpt.close()


def test_restore_retries_transient_io(tmp_path, monkeypatch):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, wait=True)
    ckpt.close()
    real_load, calls = torch.load, []

    def flaky_load(*args, **kwargs):
        calls.append(args[0])
        if len(calls) == 1:
            raise OSError(5, "EIO")
        return real_load(*args, **kwargs)
    monkeypatch.setattr(ck.torch, "load", flaky_load)
    retrying = CheckpointState(cfg.model_file, retry=retry.RetryPolicy(
        retries=2, backoff_seconds=0.0))
    assert torch.equal(retrying.restore()["table"], table)
    assert len(calls) == 3  # table.pt twice, then acc.pt
    calls.clear()
    failing = CheckpointState(cfg.model_file)  # no retries
    with pytest.raises(ValueError, match="EIO"):
        failing.restore()
    assert list_step_dirs(ckpt.directory) == [1]


def test_table_only_restore_never_reads_the_accumulator(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    _save(ckpt, cfg, table, acc, 1, epoch=2, wait=True)
    os.remove(manifest_path(ckpt.directory, 1))
    with open(os.path.join(ckpt.directory, "1", "acc.pt"), "r+b") as fh:
        fh.truncate(8)
    restored = ckpt.restore(template=checkpoint_template(cfg, acc=False))
    assert "acc" not in restored and restored["epoch"] == 2
    assert torch.equal(restored["table"], table)
    ckpt.close()


def test_orbax_step_is_refused_and_never_quarantined(tmp_path):
    """The JAX package's checkpoints share <model_file>.ckpt/: the port
    names the way across and leaves every JAX step where it is, even a
    torn one its manifest would fail."""
    jcfg = JaxConfig(vocabulary_size=1000, factor_num=4,
                     model_file=str(tmp_path / "m" / "fm"))
    jckpt = jck.CheckpointState(jcfg.model_file)
    state = jax_ckpt_state(jcfg, jax_fm.init_table(jcfg),
                           jax_fm.init_accumulator(jcfg))
    for s in (1, 2):
        jckpt.save(s, *state, vocabulary_size=1000, wait=True)
    jckpt.close()
    jax_truncate_checkpoint(jcfg.model_file)
    before = sorted(os.listdir(jckpt.directory))
    cfg = FmConfig(vocabulary_size=1000, factor_num=4,
                   model_file=jcfg.model_file)
    ckpt = CheckpointState(cfg.model_file)
    for call in (lambda: ckpt.restore(template=checkpoint_template(cfg)),
                 lambda: ckpt.restore(step=1)):
        with pytest.raises(ValueError, match="save_checkpoint_from_numpy"):
            call()
    ckpt.close()
    assert sorted(os.listdir(jckpt.directory)) == before
    assert not [n for n in before if n.startswith(QUARANTINE_PREFIX)]


def test_publish_step_verifies_and_retention_risk(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    for s in (1, 2):
        _save(ckpt, cfg, table, acc, s, wait=True)
    assert not ckpt.published_at_risk()
    assert ckpt.publish_step(1).endswith("published")
    assert ck.read_published(ckpt.directory) == 1
    assert not ckpt.published_at_risk()
    assert ckpt.published_at_risk(margin=2)
    truncate_checkpoint(cfg.model_file, step=2)
    assert ckpt.publish_step(2) is None
    assert ck.read_published(ckpt.directory) == 1
    _save(ckpt, cfg, table, acc, 3, wait=True)
    _save(ckpt, cfg, table, acc, 4, wait=True)  # retention drops step 1
    assert ckpt.published_at_risk()
    ckpt.close()


@pytest.mark.parametrize("layout", ["npz", "num_rows", "ckpt_rows"])
def test_save_checkpoint_from_numpy_carries_jax_arrays(tmp_path, layout):
    cfg = FmConfig(vocabulary_size=300, factor_num=4,
                   model_file=str(tmp_path / "fm"))
    jcfg = JaxConfig(vocabulary_size=300, factor_num=4)
    table, acc = jax_ckpt_state(jcfg, jax_fm.init_table(jcfg, 3),
                                jax_fm.init_accumulator(jcfg) * 2)
    table, acc = np.array(table), np.array(acc)
    rows = {"npz": cfg.vocabulary_size, "num_rows": cfg.num_rows,
            "ckpt_rows": cfg.ckpt_rows}[layout]
    path = convert.save_checkpoint_from_numpy(cfg, table[:rows], None, 12,
                                              epoch=2)
    assert path == os.path.join(cfg.model_file + ".ckpt", "12")
    path = convert.save_checkpoint_from_numpy(cfg, table[:rows],
                                              acc[:rows], 13)
    ckpt = CheckpointState(cfg.model_file)
    r12 = ckpt.restore(step=12)
    r13 = ckpt.restore()
    ckpt.close()
    assert r12["epoch"] == 2 and r13["step"] == 13 and r13["epoch"] == 0
    np.testing.assert_array_equal(r12["table"][:300].numpy(), table[:300])
    assert not r12["table"][300].any()
    assert (r12["acc"] == np.float32(cfg.adagrad_init)).all()
    np.testing.assert_array_equal(r13["acc"][:300].numpy(), acc[:300])
    assert ck.verify_step_dir(cfg.model_file + ".ckpt", 13, "full") is None
    with pytest.raises(FileExistsError):
        convert.save_checkpoint_from_numpy(cfg, table, acc, 13)


# --- training across runs, against the JAX package ---------------------------

_JAX_RUNS = r'''
import dataclasses, json, logging, os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import fast_tffm_tpu.train as jax_train
from fast_tffm_tpu.checkpoint import CheckpointState, read_epoch_override
from fast_tffm_tpu.config import load_config
from fast_tffm_tpu.testing.faults import preempt_after_steps
assert jax.device_count() == 1, jax.devices()
plan = json.loads(sys.argv[1])
table0 = np.load(plan["table0"])
jax_train.init_table = lambda cfg, seed=0: jnp.asarray(table0)
for run in plan["runs"]:
    cfg = dataclasses.replace(load_config(run["cfg"]), **run["changes"])
    if run["preempt"]:
        with preempt_after_steps(run["preempt"]):
            jax_train.train(cfg)
    else:
        jax_train.train(cfg)
    ckpt = CheckpointState(cfg.model_file)
    r = ckpt.restore(template=jax_train.checkpoint_template(cfg))
    ckpt.close()
    s = int(r["step"])
    np.savez(run["out"], table=np.asarray(r["table"])[:cfg.num_rows],
             acc=np.asarray(r["acc"])[:cfg.num_rows], step=s,
             epoch=int(r["epoch"]),
             override=read_epoch_override(ckpt.directory, s) or -1)
    lg = logging.getLogger("fast_tffm_tpu")
    for h in [h for h in lg.handlers if isinstance(h, logging.FileHandler)]:
        lg.removeHandler(h)
        h.close()
'''

# Each scenario: its runs' config changes over sample.cfg, and the step
# after which a SIGTERM arrives (None: none).
SCENARIOS = {
    "a_epoch_override": [(dict(epoch_num=1, save_steps=8), None),
                         (dict(epoch_num=2, save_steps=8), None)],
    "b_completed_reruns": [(dict(), None), (dict(), None)],
    "c_sigterm_mid_epoch": [(dict(epoch_num=2), 21), (dict(epoch_num=2),
                                                      None)],
}


def _log_events(path):
    """(restored steps, resumed-at lines, 'training done' step counts)."""
    import re
    with open(path) as fh:
        text = fh.read()
    return (re.findall(r"restored checkpoint at step (\d+)", text),
            re.findall(r"resuming interrupted epoch schedule at epoch "
                       r"(\d+/\d+)", text),
            re.findall(r"training done: (\d+) steps", text))


def _detach_file_logs():
    lg = logging.getLogger("fast_tffm_tpu_torch")
    for h in [h for h in lg.handlers
              if isinstance(h, logging.FileHandler)]:
        lg.removeHandler(h)
        h.close()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every scenario's runs by the JAX package, in one subprocess:
    per run the newest checkpoint's arrays, step, epoch and override."""
    base = str(tmp_path_factory.mktemp("resume"))
    jcfg = jax_load_config(os.path.join(REPO, "sample.cfg"))
    table0 = np.array(jax_fm.init_table(jcfg, jcfg.seed))
    np.save(os.path.join(base, "table0.npy"), table0)
    runs = []
    for name, plan in SCENARIOS.items():
        wd = os.path.join(base, "jax", name)
        os.makedirs(wd)
        path = _write_sample_cfg(wd)
        for i, (changes, preempt) in enumerate(plan):
            runs.append(dict(cfg=path, changes=changes, preempt=preempt,
                             out=os.path.join(wd, f"run{i}.npz")))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RUNS,
         json.dumps({"table0": os.path.join(base, "table0.npy"),
                     "runs": runs})], cwd=base, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(base=base, table0=table0,
                acc0=np.array(jax_fm.init_accumulator(jcfg)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_resumed_training_matches_the_jax_package(jax_runs, name,
                                                  monkeypatch):
    from fast_tffm_tpu_torch.utils.timing import StepTimer
    wd = os.path.join(jax_runs["base"], "port", name)
    os.makedirs(wd)
    path = _write_sample_cfg(wd)
    try:
        for i, (changes, preempt) in enumerate(SCENARIOS[name]):
            cfg = dataclasses.replace(load_config(path), **changes)
            init = None
            if i == 0:
                init = convert.state_from_numpy(jax_runs["table0"],
                                                jax_runs["acc0"], cfg, CPU)
            if preempt:
                real_tick, ticks = StepTimer.tick, []

                def tick(self, n, real_tick=real_tick, ticks=ticks,
                         at=preempt):
                    real_tick(self, n)
                    ticks.append(n)
                    if len(ticks) == at:
                        signal.raise_signal(signal.SIGTERM)
                monkeypatch.setattr(StepTimer, "tick", tick)
            train(cfg, device="cpu", init_state=init)
            monkeypatch.undo()
            ckpt = CheckpointState(cfg.model_file)
            got = ckpt.restore(template=checkpoint_template(cfg))
            ckpt.close()
            want = np.load(os.path.join(jax_runs["base"], "jax", name,
                                        f"run{i}.npz"))
            assert got["step"] == int(want["step"]), i
            assert got["epoch"] == int(want["epoch"]), i
            assert (ck.read_epoch_override(ckpt.directory, got["step"])
                    or -1) == int(want["override"]), i
            for key in ("table", "acc"):
                np.testing.assert_allclose(got[key].numpy(), want[key],
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"run {i} {key}")
    finally:
        _detach_file_logs()
    events = _log_events(os.path.join(wd, "fm.log"))
    assert events == _log_events(os.path.join(jax_runs["base"], "jax",
                                              name, "fm.log"))
    expected = {"a_epoch_override": (["16"], ["1/2"], ["16", "32"]),
                "b_completed_reruns": (["80"], [], ["80", "160"]),
                "c_sigterm_mid_epoch": (["21"], ["1/2"], ["21", "37"])}
    assert events == tuple(expected[name])


def test_save_every_step_train_is_resumable(tmp_path):
    """save_steps = 1: every step starts an async save; the run ends
    with a committed, restorable checkpoint at the final step, the
    three newest kept."""
    cfg = dataclasses.replace(
        load_config(_write_sample_cfg(str(tmp_path))), epoch_num=1,
        save_steps=1, validation_files=())
    try:
        train(cfg, device="cpu")
    finally:
        _detach_file_logs()
    ckpt = CheckpointState(cfg.model_file)
    restored = ckpt.restore(template=checkpoint_template(cfg))
    ckpt.close()
    assert restored["step"] == 16 and restored["epoch"] == 1
    assert list_step_dirs(ckpt.directory) == [14, 15, 16]
    assert torch.isfinite(restored["table"]).all()


# --- predict from a checkpoint, and the fmckpt tool --------------------------


def test_predict_from_checkpoint_matches_jax_predict(tmp_path):
    from fast_tffm_tpu.metrics import sigmoid as jax_sigmoid
    from fast_tffm_tpu.predict import load_table as jax_load_table
    from fast_tffm_tpu.predict import predict_scores as jax_predict_scores
    from fast_tffm_tpu_torch.predict import load_table
    wds = {k: str(tmp_path / k) for k in ("port", "jax")}
    for wd in wds.values():
        os.makedirs(wd)
    pcfg = load_config(_write_sample_cfg(wds["port"]))
    jcfg = dataclasses.replace(
        jax_load_config(_write_sample_cfg(wds["jax"])), kernel="pallas",
        dedup="device")
    rng = np.random.default_rng(31)
    table = (rng.normal(size=(pcfg.num_rows, pcfg.row_dim)) * 0.2
             ).astype(np.float32)
    table[-1] = 0.0
    acc = np.full_like(table, pcfg.adagrad_init)
    jckpt = jck.CheckpointState(jcfg.model_file)
    jckpt.save(30, *jax_ckpt_state(jcfg, jnp.asarray(table),
                                   jnp.asarray(acc)),
               vocabulary_size=jcfg.vocabulary_size, wait=True)
    jckpt.close()
    convert.save_checkpoint_from_numpy(pcfg, table, acc, 30)
    with pytest.raises(FileNotFoundError, match="run training first"):
        load_table(dataclasses.replace(
            pcfg, model_file=str(tmp_path / "none" / "fm")), CPU)
    got_table, step = load_table(pcfg, CPU, with_step=True)
    assert step == 30 and got_table.shape == (pcfg.num_rows, pcfg.row_dim)
    try:
        assert main(["predict", _write_sample_cfg(wds["port"]), "--device",
                     "cpu"]) == 0
    finally:
        _detach_file_logs()
    with open(os.path.join(pcfg.score_path, "sample_test.txt.score")) as fh:
        got = np.array([float(s) for s in fh.read().split()])
    jtable = jax_load_table(jcfg)
    want = jax_sigmoid(jax_predict_scores(jcfg, jtable,
                                          list(jcfg.predict_files)))
    assert got.shape == want.shape == (500,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _fmckpt_outputs(directory, calls):
    """Each call's (exit code, output) from both tools, paths in the
    output replaced by <dir>."""
    from tools import fmckpt as jax_fmckpt
    outs = []
    for mod in (fmckpt, jax_fmckpt):
        got = []
        for name, args in calls:
            buf = io.StringIO()
            rc = getattr(mod, name)(directory[mod is jax_fmckpt], *args,
                                    out=buf)
            got.append((rc, buf.getvalue().replace(
                directory[mod is jax_fmckpt], "<dir>")))
        outs.append(got)
    return outs


def test_fmckpt_prints_what_the_jax_tool_prints(tmp_path):
    cfg, table, acc, ckpt = _mk_state(tmp_path)
    for s, epoch in ((4, 0), (8, 1), (12, 1), (16, 2)):
        _save(ckpt, cfg, table, acc, s, epoch=epoch, wait=True)
    _save(ckpt, cfg, table, acc, 16, epoch=3, force=True, wait=True,
          rewrite_stale_metadata=True)
    ckpt.quarantine_step(8, "test")
    os.remove(manifest_path(ckpt.directory, 12))
    with open(os.path.join(ckpt.directory, "epoch_override-2"), "w") as fh:
        fh.write("1")  # an orphan
    ckpt.close()
    twin = str(tmp_path / "twin.ckpt")
    shutil.copytree(ckpt.directory, twin)
    dirs = (ckpt.directory, twin)
    calls = [("cmd_ls", ()), ("cmd_verify", ()), ("cmd_verify", ("size",)),
             ("cmd_verify", ("full", 16)), ("cmd_verify", ("full", 99)),
             ("cmd_publish", (16,)), ("cmd_publish", (12, "full", True)),
             ("cmd_ls", ()), ("cmd_publish", (99,)), ("cmd_gc", (True,))]
    port, jax = _fmckpt_outputs(dirs, calls)
    assert port == jax
    assert [rc for rc, _ in port] == [0, 0, 0, 0, 1, 0, 0, 0, 1, 0]
    assert "PUBLISHED" in port[7][1] and "CANARY" in port[7][1]
    assert "ORPHANED" in port[0][1] and "QUARANTINED" in port[0][1]
    # a torn step: verify fails, publish exits 1, the pointer stays
    for d in dirs:
        truncate_checkpoint(d[:-len(".ckpt")], step=16)
    port, jax = _fmckpt_outputs(dirs, [("cmd_verify", ()),
                                       ("cmd_publish", (16,)),
                                       ("cmd_gc", (False,)),
                                       ("cmd_ls", ())])
    assert port == jax
    assert [rc for rc, _ in port] == [1, 1, 0, 0]
    assert "FAIL — size mismatch on table.pt" in port[1][1]
    assert ck.read_published(ckpt.directory) == 16
    assert fmckpt.main(["ls", str(tmp_path / "nowhere")]) == 2
    assert fmckpt.main(["publish", cfg.model_file, "16"]) == 1
