"""Two-rank ``run_mode = stream`` jobs of the port on the CPU: ``python -m
fast_tffm_tpu_torch train <cfg> --device cpu dist_train worker <i>``
over gloo (tests/torch_dist_ranks.py; the rank processes import no jax).

- The lockstep stream against the JAX mesh step: two sealed shards of
  unequal length are present at the start (the chief's probe sizes the
  unique bucket from them), two more arrive mid-run in torn appends,
  then STOP. Each rank's stepped batches equal the JAX package's own
  fixed-shape stream batches of that owner (``StreamSource`` with its
  ``shard_index``) array for array, at least one step has a filler on a
  dry rank, and the JAX ``make_sharded_train_step`` replayed over the
  same schedule from the same starting step gives the final table and
  Adagrad accumulator at rtol 1e-4 / atol 1e-6. Every merged watermark
  equals JAX's ``merge_watermark_payloads`` of the two ranks' payloads,
  the final one covers every byte and line and seals every file, the
  exit publish's quality numbers (whose sums rode the AUC all-gather)
  equal a single-process sweep of the final table, and every host
  collective of each rank, the flags all-gather and the discovery
  broadcast included, was issued from its main thread.
- A gate that holds (``publish_min_auc = 0.99`` over flipped labels):
  every rank logs the hold, no rank saves or publishes on a held tick,
  ``published`` is never written, and both exit 0.
- SIGTERM to rank 0 between phases: both ranks save the merged
  watermark and exit 0; a restart finishes the stream, and its final
  table and accumulator are bit-identical to an uninterrupted 2-rank
  control over the same phase-gated corpus.
"""

import dataclasses
import json
import os
import re
import signal
import sys

import jax
import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.data import stream as jsl
from fast_tffm_tpu.data.pipeline import empty_batch as jax_empty_batch
from fast_tffm_tpu.models.fm import ModelSpec as JaxSpec
from fast_tffm_tpu.parallel.sharded import (make_mesh as jax_make_mesh,
                                            make_sharded_train_step,
                                            offset_local_idx,
                                            place_table as jax_place_table,
                                            shard_batch)
from fast_tffm_tpu_torch.checkpoint import (CheckpointState,
                                            list_step_dirs, read_watermark,
                                            write_watermark)
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
from fast_tffm_tpu_torch.obs.quality import QualityStats
from fast_tffm_tpu_torch.train import checkpoint_template, evaluate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
KEYS = ("labels", "weights", "uniq_ids", "local_idx", "vals")


def _spawn(wd, faults="none", tags=("w0", "w1")):
    argv = ["train", os.path.join(wd, "stream.cfg"), "--device", "cpu",
            "dist_train", "worker"]
    return {t: ranks.spawn_cli(wd, t, faults, argv + [str(i)])
            for i, t in enumerate(tags)}


def _final(cfg):
    ckpt = CheckpointState(cfg.model_file)
    try:
        return ckpt.restore(template=checkpoint_template(cfg))
    finally:
        ckpt.close()


def _assert_exactly_once(cfg, step, n_files):
    """The watermark of ``step`` covers every byte and line of the
    ``n_files`` shards, each sealed on disk by its ``.done`` marker."""
    wm = read_watermark(cfg.model_file + ".ckpt", step)
    assert len(wm["files"]) == n_files
    for f in wm["files"]:
        with open(f["path"], "rb") as fh:
            blob = fh.read()
        assert (f["bytes"], f["lines"]) == (len(blob),
                                            blob.count(b"\n")), f
        assert os.path.exists(f["path"] + ".done"), f


def _jax_cfg(cfg, uniq_bucket):
    return JaxConfig(vocabulary_size=cfg.vocabulary_size,
                     factor_num=cfg.factor_num, batch_size=cfg.batch_size,
                     learning_rate=cfg.learning_rate,
                     factor_lambda=cfg.factor_lambda,
                     bias_lambda=cfg.bias_lambda,
                     init_value_range=cfg.init_value_range,
                     max_features_per_example=cfg.max_features_per_example,
                     bucket_ladder=cfg.bucket_ladder, dedup="host",
                     uniq_bucket=uniq_bucket)


def _jax_owner_batches(sd, jcfg, owner, bucket):
    """The JAX package's fixed-shape stream batches of ``owner`` over
    the final (sealed, STOPped) stream directory."""
    tr = jsl.StreamTracker(sd, 0.05, "done", shard_index=owner,
                           num_shards=2)
    src = jsl.StreamSource(jcfg, tr, fixed_shape=True, uniq_bucket=bucket,
                           raw_ids=False)
    out = []
    try:
        while True:
            b = src.next_batch(block=True)
            if b is jsl.DONE:
                return out
            out.append(b)
    finally:
        src.close()


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("dist_stream"))
    cfg_path = ranks.write_stream_run(wd, uniq_bucket=0, val_batches=0)
    cfg = load_config(cfg_path)
    # The starting state: a committed step 0 the ranks restore (with an
    # empty watermark), so the JAX replay starts from the same bytes.
    rng = np.random.default_rng(11)
    table = rng.uniform(-0.01, 0.01, (cfg.num_rows, cfg.row_dim)
                        ).astype(np.float32)
    table[-1] = 0.0
    acc = np.full_like(table, cfg.adagrad_init)
    save_checkpoint_from_numpy(cfg, table, acc, 0)
    write_watermark(cfg.model_file + ".ckpt", 0,
                    {"format": 1, "files": []})
    # Unequal shards: rank 1 runs dry first and steps filler.
    ranks.stage_shard(wd, 0, ranks.stream_shard_lines(0, 80))
    ranks.stage_shard(wd, 1, ranks.stream_shard_lines(1, 48))
    procs = _spawn(wd, "record-steps,record-threads")
    ranks.wait_for(lambda: ranks.published_step(cfg.model_file) >= 5,
                   procs, wd, "the first shards' steps published")
    ranks.stage_shard(wd, 2, ranks.stream_shard_lines(2, 70))
    ranks.stage_shard(wd, 3, ranks.stream_shard_lines(3, 30))
    ranks.stop_stream(wd)
    rcs, logs = ranks.wait_all(procs, wd)
    assert rcs == [0, 0], ranks.log_tails(logs)
    bucket = int(re.search(r"fixed unique-row bucket: (\d+)",
                           logs["w0"]).group(1))
    steps = [dict(np.load(os.path.join(wd, f"steps-{procs[t].pid}.npz")))
             for t in ("w0", "w1")]
    merges = [_load_json(os.path.join(wd, f"watermarks-{procs[t].pid}.json"))
              for t in ("w0", "w1")]
    threads = [_load_json(os.path.join(wd, f"threads-{procs[t].pid}.json"))
               for t in ("w0", "w1")]
    return dict(wd=wd, cfg=cfg, table0=table, acc0=acc, bucket=bucket,
                steps=steps, merges=merges, threads=threads, logs=logs)


def _schedule(steps):
    n = len([k for k in steps[0] if k.endswith("/filler")])
    assert n == len([k for k in steps[1] if k.endswith("/filler")])
    return n, [[bool(r[f"b{s}/filler"]) for s in range(n)] for r in steps]


def test_ranks_step_the_jax_owner_batches(parity_run):
    run = parity_run
    jcfg = _jax_cfg(run["cfg"], run["bucket"])
    n, fill = _schedule(run["steps"])
    assert any(f0 != f1 for f0, f1 in zip(*fill))  # a filler step
    assert any(not f0 and not f1 for f0, f1 in zip(*fill))
    for r in (0, 1):
        want = _jax_owner_batches(os.path.join(run["wd"], "stream"), jcfg,
                                  r, run["bucket"])
        real = [s for s in range(n) if not fill[r][s]]
        assert len(real) == len(want) > 0
        for s, j in zip(real, want):
            for k in KEYS:
                np.testing.assert_array_equal(
                    run["steps"][r][f"b{s}/{k}"], getattr(j, k),
                    err_msg=f"rank {r} step {s} {k}")
    # The final state is the last step's: n steps from step 0.
    assert int(_final(run["cfg"])["step"]) == n


def test_final_state_matches_the_jax_mesh_step(parity_run):
    run = parity_run
    cfg, bucket = run["cfg"], run["bucket"]
    jcfg = _jax_cfg(cfg, bucket)
    spec = JaxSpec.from_config(jcfg)
    assert spec.dedup == "host"
    mesh = jax_make_mesh(jax.devices()[:2])
    table = jax_place_table(jcfg, mesh, run["table0"])
    acc = jax_place_table(jcfg, mesh, np.full(
        (jcfg.ckpt_rows, jcfg.row_dim), jcfg.adagrad_init, np.float32))
    step = make_sharded_train_step(spec, mesh)
    filler = jax_empty_batch(jcfg, uniq_bucket=bucket)
    owners = [iter(_jax_owner_batches(os.path.join(run["wd"], "stream"),
                                      jcfg, r, bucket)) for r in (0, 1)]
    n, fill = _schedule(run["steps"])
    for s in range(n):
        parts = [filler if fill[r][s] else next(owners[r]) for r in (0, 1)]
        glob_args = {k: np.concatenate(
            [offset_local_idx(getattr(p, k), i, bucket) if k == "local_idx"
             else getattr(p, k) for i, p in enumerate(parts)])
            for k in KEYS}
        table, acc, _, _ = step(table, acc, **shard_batch(mesh, **glob_args))
    final = _final(cfg)
    nr = cfg.num_rows
    np.testing.assert_allclose(final["table"].numpy(),
                               np.asarray(table)[:nr], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(final["acc"].numpy(), np.asarray(acc)[:nr],
                               rtol=RTOL, atol=ATOL)
    assert not np.allclose(final["table"].numpy(), run["table0"])


def test_merged_watermarks_equal_the_jax_merge(parity_run):
    run = parity_run
    m0, m1 = run["merges"]
    assert len(m0) == len(m1) > 2
    for (l0, g0), (l1, g1) in zip(m0, m1):
        assert g0 == g1 == jsl.merge_watermark_payloads([l0, l1], 2)
    n, _ = _schedule(run["steps"])
    assert m0[-1][1] == read_watermark(run["cfg"].model_file + ".ckpt", n)
    _assert_exactly_once(run["cfg"], n, 4)


def test_quality_sums_ride_the_auc_merge(parity_run):
    """The exit publish's sweep (each rank's half of the validation
    file, the four sums merged with the AUC histograms) equals one
    single-process sweep of the final table over the whole file."""
    run = parity_run
    cfg = run["cfg"]
    m = re.findall(r"publish quality eval at step (\d+): AUC ([0-9.]+), "
                   r"loss ([0-9.]+), calibration ([0-9.]+) over (\d+) "
                   r"examples", run["logs"]["w0"])
    assert m and "publish quality eval" not in run["logs"]["w1"]
    step, auc, loss, calib, n = m[-1]
    final = _final(cfg)
    assert int(step) == int(final["step"])
    stats = QualityStats(cfg.loss_type)
    single = dataclasses.replace(cfg, worker_hosts=())
    want_auc, want_n = evaluate(single, final["table"], cfg.validation_files,
                                collect=stats)
    assert int(n) == want_n == 500
    assert float(auc) == pytest.approx(want_auc, abs=1e-6)
    assert float(loss) == pytest.approx(stats.loss, abs=1e-6)
    assert float(calib) == pytest.approx(stats.calibration, abs=1e-4)


def test_collectives_come_from_one_thread_per_rank(parity_run):
    for seen in parity_run["threads"]:
        labels = {label for label, _ in seen}
        for want in ("stream/step_flags", "stream/discovery",
                     "stream/uniq_bucket", "stream/watermark_merge",
                     "quality/gate_decision", "validation/auc_merge"):
            assert want in labels, (want, sorted(labels))
        assert {thread for _, thread in seen} == {"MainThread"}


def test_held_gate_saves_and_publishes_nothing(tmp_path):
    wd = str(tmp_path)
    flipped = os.path.join(wd, "flipped.txt")
    with open(os.path.join(ranks.REPO, "data", "sample_test.txt")) as fh:
        lines = fh.read().splitlines()
    with open(flipped, "w") as fh:
        fh.write("\n".join(("0" if ln.split()[0] == "1" else "1")
                           + ln[ln.index(" "):] for ln in lines) + "\n")
    cfg = load_config(ranks.write_stream_run(
        wd, min_auc=0.99, save_steps=0, validation=flipped))
    procs = _spawn(wd)
    ranks.stage_shard(wd, 0, ranks.stream_shard_lines(0))
    ranks.wait_for(lambda: all(ranks.log_has(wd, t, "publish GATE HELD at "
                                             f"step {ranks.STREAM_STEPS}")
                               for t in procs), procs, wd, "a held tick")
    ranks.stop_stream(wd)
    rcs, logs = ranks.wait_all(procs, wd)
    assert rcs == [0, 0], ranks.log_tails(logs)
    d = cfg.model_file + ".ckpt"
    # The final save alone: no held tick saved, nothing was published.
    assert list_step_dirs(d) == [ranks.STREAM_STEPS]
    assert not os.path.exists(os.path.join(d, "published"))
    assert not os.path.exists(os.path.join(d, "gate_baseline"))
    for t in procs:
        assert "published checkpoint step" not in logs[t]
        assert logs[t].count("publish GATE HELD") >= 2  # ticks and exit
    assert logs["w0"].count("checkpoint step 4 committed") == 1
    _assert_exactly_once(cfg, ranks.STREAM_STEPS, 1)


def _phases(wd, cfg, procs, shards):
    for i in shards:
        ranks.stage_shard(wd, i, ranks.stream_shard_lines(i))
        ranks.wait_for(lambda: ranks.published_step(cfg.model_file)
                       >= ranks.STREAM_STEPS * (i + 1), procs, wd,
                       f"shard {i}'s steps published")


def _stream_run(wd, preempt):
    cfg = load_config(ranks.write_stream_run(wd))
    procs = _spawn(wd)
    _phases(wd, cfg, procs, (0, 1))
    if preempt:
        procs["w0"].send_signal(signal.SIGTERM)
        rcs, logs = ranks.wait_all(procs, wd)
        assert rcs == [0, 0], ranks.log_tails(logs)
        cut = 2 * ranks.STREAM_STEPS
        for t in procs:
            assert "preemption signalled; saving the stream position" in \
                logs[t], ranks.log_tails(logs)
        assert list_step_dirs(cfg.model_file + ".ckpt")[-1] == cut
        wm = read_watermark(cfg.model_file + ".ckpt", cut)
        assert [(f["bytes"], f["lines"]) for f in wm["files"]] == [
            (os.path.getsize(f["path"]), ranks.STREAM_SHARD_LINES)
            for f in wm["files"]]
        assert len(wm["files"]) == 2
        procs = _spawn(wd, tags=("r0", "r1"))
        ranks.wait_for(lambda: all(
            ranks.log_has(wd, t, f"restored checkpoint at step {cut}")
            for t in procs), procs, wd, "the restart's restore")
    _phases(wd, cfg, procs, (2, 3))
    ranks.stop_stream(wd)
    rcs, logs = ranks.wait_all(procs, wd)
    assert rcs == [0, 0], ranks.log_tails(logs)
    return cfg


def test_sigterm_resume_is_bit_identical_to_the_control(tmp_path):
    cut = _stream_run(str(tmp_path / "cut"), preempt=True)
    whole = _stream_run(str(tmp_path / "whole"), preempt=False)
    fc, fw = _final(cut), _final(whole)
    assert int(fc["step"]) == int(fw["step"]) == 4 * ranks.STREAM_STEPS
    for k in ("table", "acc"):
        assert torch.equal(fc[k], fw[k]), (
            k, float((fc[k] - fw[k]).abs().max()))
    for cfg in (cut, whole):
        _assert_exactly_once(cfg, 4 * ranks.STREAM_STEPS, 4)
