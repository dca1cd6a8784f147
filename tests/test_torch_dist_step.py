"""The port's row-sharded step and score (models/fm.py
``sharded_train_step_body`` and ``sharded_score_body`` over
parallel/sharded.py's ``ProcessMesh``) against the JAX package's
``make_sharded_train_step`` and ``make_sharded_score_fn`` on an
in-process 2-device CPU mesh, on the CPU.

Two port ranks (subprocesses over gloo on a free port, importing no
jax: tests/torch_dist_ranks.py) each read their byte range of one file
into fixed-shape host-deduped batches and take 4 sharded steps of an FM,
an FFM and an order-3 FM from one dense starting state (in the last,
rank 1 steps the all-padding filler of a rank whose shard ran dry, so
the global batch's weight, the loss's normaliser, is rank 0's alone),
then score their next batch. The JAX side runs the same steps on the global batch, the
ranks' batches concatenated with ``local_idx`` offset into the
concatenated unique axis (``offset_local_idx``), as its ``global_batch``
assembles it. Held: the loss at rtol 1e-5; the post-step table and
Adagrad accumulator, gathered from the ranks' shards, at rtol 1e-4 /
atol 1e-6 (the reference's bound for post-step tables); the scores at
rtol 1e-5 / atol 1e-6. The batches share ids across the ranks, so an id
hot on both ranks takes one slot per rank on both sides. Also: the
checkpoint's step decisions under 2 ranks (``_broadcast_int`` gives the
chief's value, ``_all_agree`` is true only when every rank is).
"""

import os
import sys

import jax
import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxConfig
from fast_tffm_tpu.models.fm import ModelSpec as JaxSpec
from fast_tffm_tpu.parallel.sharded import (make_mesh as jax_make_mesh,
                                            make_sharded_score_fn,
                                            make_sharded_train_step,
                                            offset_local_idx,
                                            place_table as jax_place_table,
                                            shard_batch)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("dist_step"))
    ranks.write_step_inputs(wd)
    return wd, ranks.run_ranks("step", wd)


def _global(results, name, s, U, keys):
    """Rank batches concatenated, local_idx offset per rank."""
    out = {}
    for k in keys:
        key = f"{name}/b{s}/{k}"
        if key not in results[0]:
            continue
        parts = [r[key] for r in results]
        if k == "local_idx":
            parts = [offset_local_idx(p, i, U) for i, p in enumerate(parts)]
        out[k] = np.concatenate(parts)
    return out


def _jax_run(wd, results, name, kw):
    cfg = JaxConfig(**kw)
    spec = JaxSpec.from_config(cfg)
    assert spec.dedup == "host" and spec.kernel == "xla"
    mesh = jax_make_mesh(jax.devices()[:2])
    init = np.load(os.path.join(wd, f"{name}-init.npz"))
    table = jax_place_table(cfg, mesh, init["table"])
    acc = jax_place_table(cfg, mesh, np.full(
        (cfg.ckpt_rows, cfg.row_dim), cfg.adagrad_init, np.float32))
    step = make_sharded_train_step(spec, mesh)
    U = len(results[0][f"{name}/b0/uniq_ids"])
    keys = ("labels", "weights", "uniq_ids", "local_idx", "vals", "fields")
    losses = []
    for s in range(ranks.STEPS):
        args = shard_batch(mesh, **_global(results, name, s, U, keys))
        table, acc, loss, _ = step(table, acc, **args)
        losses.append(float(loss))
    score = make_sharded_score_fn(spec, mesh)
    args = _global(results, name, ranks.STEPS, U,
                   ("uniq_ids", "local_idx", "vals", "fields"))
    scores = np.asarray(score(table, **shard_batch(mesh, **args)))
    return losses, np.asarray(table), np.asarray(acc), scores


CASES = [name for name, _ in ranks.step_cases()]


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_the_jax_mesh_step(step_run, name):
    wd, results = step_run
    kw = dict(ranks.step_cases())[name]
    losses, table, acc, _ = _jax_run(wd, results, name, kw)
    # An id sits on both ranks: the global unique axis holds it twice.
    ids = [set(r[f"{name}/b0/uniq_ids"].tolist()) - {256} for r in results]
    assert ids[0] & ids[1]
    got = [float(results[0][f"{name}/loss{s}"])
           for s in range(ranks.STEPS)]
    assert got == [float(results[1][f"{name}/loss{s}"])
                   for s in range(ranks.STEPS)]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    for key, want in (("table", table), ("acc", acc)):
        shards = np.concatenate([r[f"{name}/{key}"] for r in results])
        assert shards.shape == want.shape
        np.testing.assert_allclose(shards, want, rtol=1e-4, atol=1e-6)
    # The steps moved the state.
    init = np.load(os.path.join(wd, f"{name}-init.npz"))["table"]
    assert not np.allclose(table[:len(init)], init)


@pytest.mark.parametrize("name", CASES)
def test_sharded_score_matches_the_jax_mesh_score(step_run, name):
    wd, results = step_run
    kw = dict(ranks.step_cases())[name]
    _, _, _, scores = _jax_run(wd, results, name, kw)
    got = np.concatenate([r[f"{name}/scores"] for r in results])
    np.testing.assert_allclose(got, scores, rtol=1e-5, atol=1e-6)


def test_checkpoint_decisions_under_two_ranks(step_run):
    _, results = step_run
    for r in results:
        assert int(r["broadcast_int"]) == 7  # the chief's value
        assert bool(r["agree_true"])
        assert not bool(r["agree_one_false"])
