"""The port's NumPy oracle (fast_tffm_tpu_torch/models/oracle.py)
against ``fast_tffm_tpu.models.oracle``: every public function on the
same seeded inputs, equal to the bit (the same numpy code). Then the
port's plain scorers — the 2nd-order FM behind ``ops/fm_kernel``, the
order-3 ANOVA and the field-aware FM of ``ops/interaction`` — against
the port's oracle on seeded batches at rtol 1e-5 / atol 1e-6 (float32
scores against float64 sums), and the FM wrapper's row gradient against
the oracle's finite differences at rtol 1e-4 / atol 1e-6."""

import numpy as np
import pytest
import torch

from fast_tffm_tpu.models import oracle as jax_oracle
from fast_tffm_tpu_torch.models import oracle
from fast_tffm_tpu_torch.ops import fm_kernel, interaction

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
V, K, F = 40, 4, 3


def _table(seed, cols=K + 1):
    return np.random.default_rng(seed).normal(0.0, 0.3, size=(V, cols))


def _batch(seed, n=6, fields=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(1, 9))
        ids = rng.choice(V, size=m, replace=False).tolist()
        vals = rng.uniform(-1.5, 1.5, size=m).round(3).tolist()
        if fields:
            out.append((ids, rng.integers(0, F, size=m).tolist(), vals))
        else:
            out.append((ids, vals))
    return out


def _labels(seed, n=6):
    return np.random.default_rng(seed).integers(0, 2, size=n).astype(
        np.float64)


def _weights(seed, n=6):
    return np.random.default_rng(seed).uniform(0.2, 2.0, size=n)


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
        return
    assert type(a) is type(b) and a == b


CASES = {
    "fm_score_order2": lambda m: [
        m.fm_score(_table(1), ids, vals) for ids, vals in _batch(2)],
    "fm_score_order3": lambda m: [
        m.fm_score(_table(1), ids, vals, order=3) for ids, vals in _batch(3)],
    "fm_score_order4": lambda m: [
        m.fm_score(_table(1), ids, vals, order=4) for ids, vals in _batch(4)],
    "anova_interactions": lambda m: [
        m._anova_interactions(_table(5)[np.asarray(ids), :K],
                              np.asarray(vals), order)
        for order in (2, 3, 5) for ids, vals in _batch(6)],
    "ffm_score": lambda m: [
        m.ffm_score(_table(7, F * K + 1), F, ids, flds, vals)
        for ids, flds, vals in _batch(8, fields=True)],
    "batch_scores": lambda m: (m.batch_scores(_table(9), _batch(10)),
                               m.batch_scores(_table(9), _batch(10), 3)),
    "regularization": lambda m: (
        m.regularization(_table(11), _batch(12), 1e-2, 3e-3),
        m.regularization(_table(11), [], 1e-2, 3e-3)),
    "logistic_loss": lambda m: (
        m.logistic_loss(np.linspace(-3, 3, 6), _labels(13)),
        m.logistic_loss(np.linspace(-3, 3, 6), _labels(13), _weights(14)),
        m.logistic_loss(np.linspace(-3, 3, 6), _labels(13), np.zeros(6))),
    "mse_loss": lambda m: (
        m.mse_loss(np.linspace(-1, 2, 6), _labels(15)),
        m.mse_loss(np.linspace(-1, 2, 6), _labels(15), _weights(16))),
    "grad_fd_logistic": lambda m: m.grad_fd(
        _table(17), _batch(18, n=3), _labels(19, n=3), 1e-2, 2e-3),
    "grad_fd_mse_order3_weighted": lambda m: m.grad_fd(
        _table(20), _batch(21, n=2), _labels(22, n=2), order=3,
        loss="mse", weights=_weights(23, n=2)),
    "adagrad_step": lambda m: m.adagrad_step(
        _table(24), np.abs(_table(25)) * (np.arange(V)[:, None] % 2),
        _table(26) * (np.arange(V)[:, None] % 3 == 0), 0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_function_equals_the_jax_copy(case):
    want, got = CASES[case](jax_oracle), CASES[case](oracle)
    if isinstance(want, list):
        want, got = tuple(want), tuple(got)
    _same(want, got)


def test_example_aliases_match():
    assert oracle.Example == jax_oracle.Example
    assert oracle.FFMExample == jax_oracle.FFMExample


def _padded(batch, pad_id, fields=False):
    """A batch of oracle examples as the port's padded [B, L] arrays:
    pad slots point at the dead row ``pad_id`` with x = 0 (field 0)."""
    L = max(len(ex[0]) for ex in batch) + 2
    idx = np.full((len(batch), L), pad_id, np.int32)
    vals = np.zeros((len(batch), L), np.float32)
    flds = np.zeros((len(batch), L), np.int64)
    for b, ex in enumerate(batch):
        ids, x = ex[0], ex[-1]
        idx[b, :len(ids)] = ids
        vals[b, :len(ids)] = x
        if fields:
            flds[b, :len(ids)] = ex[1]
    return (torch.from_numpy(idx), torch.from_numpy(vals),
            torch.from_numpy(flds))


def _with_pad_row(table):
    return torch.from_numpy(np.concatenate(
        [table, np.zeros((1, table.shape[1]))]).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scorer", ["fm", "order3", "ffm"])
def test_port_plain_scorers_match_the_oracle(seed, scorer):
    fields = scorer == "ffm"
    table = _table(100 + seed, F * K + 1 if fields else K + 1)
    batch = _batch(200 + seed, n=16, fields=fields)
    idx, vals, flds = _padded(batch, V, fields)
    params = _with_pad_row(table)
    # The oracle scores the table the port holds (its float32 values).
    table32 = params.double().numpy()[:V]
    if scorer == "fm":
        got = fm_kernel.fm_batch_scores(params, idx, vals)
        want = [oracle.fm_score(table32, ids, x) for ids, x in batch]
    elif scorer == "order3":
        got = interaction.anova_batch_scores(params, idx, vals, 3)
        want = [oracle.fm_score(table32, ids, x, order=3)
                for ids, x in batch]
    else:
        got = interaction.ffm_batch_scores(params, F, idx, flds, vals)
        want = [oracle.ffm_score(table32, F, ids, f, x)
                for ids, f, x in batch]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_fm_gradient_matches_oracle_finite_differences(seed):
    """dLoss/dtable through the port's ``FmScores`` (its plain backward
    on the CPU, in float64) against ``oracle.grad_fd``: the weighted-mean
    logistic loss plus L2 over the batch's unique rows."""
    table = _table(300 + seed)
    batch = _batch(400 + seed, n=5)
    labels = _labels(500 + seed, n=5)
    flam, blam = 1e-2, 3e-3
    idx, vals, _ = _padded(batch, V)
    params = torch.from_numpy(np.concatenate(
        [table, np.zeros((1, K + 1))])).requires_grad_(True)
    scores = fm_kernel.FmScores.apply(params, idx, vals.double())
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        scores, torch.from_numpy(labels))
    uniq = torch.from_numpy(np.unique(np.concatenate(
        [np.asarray(ids) for ids, _ in batch])))
    rows = params[uniq]
    loss = loss + flam * (rows[:, :K] ** 2).sum() + blam * (
        rows[:, K] ** 2).sum()
    (got,) = torch.autograd.grad(loss, params)
    want = oracle.grad_fd(table, batch, labels, flam, blam)
    np.testing.assert_allclose(got.numpy()[:V], want, rtol=1e-4, atol=ATOL)
    assert not want[np.setdiff1d(np.arange(V), uniq.numpy())].any()
