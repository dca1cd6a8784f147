"""Pure-NumPy factorization-machine oracle — a copy of
``fast_tffm_tpu/models/oracle.py`` that imports numpy only, so the
port's tests and scripts have a witness that shares no model code with
either package. Nothing on the port's train, predict or serve path
imports it.

It implements exactly the math the reference's C++ ``fm_scorer``
computes (SURVEY.md §3.5):

    linear  = sum_j w[id_j] * x_j
    pair    = 1/2 * sum_f [ (sum_j v[id_j,f] x_j)^2 - sum_j v[id_j,f]^2 x_j^2 ]
    score_e = linear + pair
    reg     = factor_lambda * sum_{unique rows} ||v||^2
            + bias_lambda   * sum_{unique rows} w^2

plus higher-order FM via the ANOVA kernel and field-aware FM (per-field
latent tables). Everything is straightforward O(k * nnz) / O(L^2 k)
loops — slow, obvious, and trusted.

Examples are (ids, vals) lists; tables are dense numpy arrays with the
reference's row layout ``[vocab, k + 1]`` — k latent factors then one
linear weight per row (SURVEY §2 "Model parameters"). Callers hand it
physical row ids.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Example = Tuple[Sequence[int], Sequence[float]]          # (ids, vals)
FFMExample = Tuple[Sequence[int], Sequence[int], Sequence[float]]  # (+fields)


def fm_score(table: np.ndarray, ids: Sequence[int],
             vals: Sequence[float], order: int = 2) -> float:
    """Score one example. table: [V, k+1] (v factors cols 0..k-1, w col k)."""
    ids = np.asarray(ids, dtype=np.int64)
    x = np.asarray(vals, dtype=np.float64)
    k = table.shape[1] - 1
    v = table[ids, :k].astype(np.float64)        # [n, k]
    w = table[ids, k].astype(np.float64)         # [n]
    score = float(np.dot(w, x))
    if order == 2:
        s = v.T @ x                              # [k]
        q = (v * v).T @ (x * x)                  # [k]
        score += 0.5 * float(np.sum(s * s - q))
    else:
        score += _anova_interactions(v, x, order)
    return score


def _anova_interactions(v: np.ndarray, x: np.ndarray, order: int) -> float:
    """Sum over interaction degrees 2..order of the ANOVA kernel.

    ANOVA kernel A_t(z_1..z_n) = sum over subsets of size t of the product,
    computed per latent dim with the classic DP: a[t] += a[t-1] * z_j,
    iterating t downward per feature. Degree-2 term equals the
    (Σv)²−Σv² identity's result, which the tests assert.
    """
    n, k = v.shape
    total = 0.0
    z = v * x[:, None]                           # [n, k]
    a = np.zeros((order + 1, k), dtype=np.float64)
    a[0] = 1.0
    for j in range(n):
        for t in range(min(j + 1, order), 0, -1):
            a[t] += a[t - 1] * z[j]
    for t in range(2, order + 1):
        total += float(np.sum(a[t]))
    return total


def ffm_score(table: np.ndarray, field_num: int, ids: Sequence[int],
              fields: Sequence[int], vals: Sequence[float]) -> float:
    """Field-aware FM: row layout [V, field_num*k + 1]; v[i, f] is the
    latent vector feature i uses when interacting with a feature of field f.

        score = sum_j w_j x_j
              + sum_{i<j} <v[id_i, field_j], v[id_j, field_i]> x_i x_j
    """
    ids = np.asarray(ids, dtype=np.int64)
    flds = np.asarray(fields, dtype=np.int64)
    x = np.asarray(vals, dtype=np.float64)
    k = (table.shape[1] - 1) // field_num
    w = table[ids, -1].astype(np.float64)
    score = float(np.dot(w, x))
    n = len(ids)
    for i in range(n):
        vi = table[ids[i], : field_num * k].reshape(field_num, k)
        for j in range(i + 1, n):
            vj = table[ids[j], : field_num * k].reshape(field_num, k)
            score += float(np.dot(vi[flds[j]], vj[flds[i]])) * x[i] * x[j]
    return score


def batch_scores(table: np.ndarray, batch: List[Example],
                 order: int = 2) -> np.ndarray:
    return np.array([fm_score(table, ids, vals, order) for ids, vals in batch],
                    dtype=np.float64)


def regularization(table: np.ndarray, batch: List[Example],
                   factor_lambda: float, bias_lambda: float) -> float:
    """L2 over rows touched by the batch, each unique row counted once
    (SURVEY §3.5: the reference's scorer emits this alongside the scores)."""
    uniq = np.unique(np.concatenate(
        [np.asarray(ids, dtype=np.int64) for ids, _ in batch]
        if batch else [np.zeros(0, dtype=np.int64)]))
    k = table.shape[1] - 1
    v = table[uniq, :k].astype(np.float64)
    w = table[uniq, k].astype(np.float64)
    return float(factor_lambda * np.sum(v * v) + bias_lambda * np.sum(w * w))


def _weighted_mean(per: np.ndarray,
                   weights: np.ndarray | None) -> float:
    """The trainer's weighted-mean contract (fm.loss_and_scores):
    sum(per*w)/sum(w), tiny floor only for the all-zero-weight case.
    Plain mean when no weights — the two coincide at unit weights."""
    if weights is None:
        return float(np.mean(per))
    w = np.asarray(weights, dtype=np.float64)
    return float((per * w).sum() / max(w.sum(), 1e-8))


def logistic_loss(scores: np.ndarray, labels: np.ndarray,
                  weights: np.ndarray | None = None) -> float:
    """Weighted-MEAN sigmoid cross-entropy with {0,1} labels (matching
    the trainer's normalization, not mean-over-batch)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    # log(1 + exp(-yz)) in the stable form used by TF's
    # sigmoid_cross_entropy_with_logits: max(z,0) - z*y + log1p(exp(-|z|))
    per = np.maximum(scores, 0) - scores * labels + np.log1p(
        np.exp(-np.abs(scores)))
    return _weighted_mean(per, weights)


def mse_loss(scores: np.ndarray, labels: np.ndarray,
             weights: np.ndarray | None = None) -> float:
    per = (np.asarray(scores, np.float64) - np.asarray(labels, np.float64)) ** 2
    return _weighted_mean(per, weights)


def grad_fd(table: np.ndarray, batch: List[Example], labels: np.ndarray,
            factor_lambda: float = 0.0, bias_lambda: float = 0.0,
            order: int = 2, loss: str = "logistic",
            eps: float = 1e-5,
            weights: np.ndarray | None = None) -> np.ndarray:
    """Finite-difference dLoss/dTable over batch-touched rows — the oracle
    for the backward pass (the reference's ``fm_grad``). Dense [V, k+1];
    rows not touched by the batch are exactly zero. ``weights`` rides
    the loss's weighted-mean normalization (the trainer's contract)."""
    loss_fn = logistic_loss if loss == "logistic" else mse_loss

    def total(t):
        s = batch_scores(t, batch, order)
        return loss_fn(s, labels, weights) + regularization(
            t, batch, factor_lambda, bias_lambda)

    g = np.zeros_like(table, dtype=np.float64)
    touched = np.unique(np.concatenate(
        [np.asarray(ids, dtype=np.int64) for ids, _ in batch]))
    for r in touched:
        for c in range(table.shape[1]):
            t = table.astype(np.float64).copy()
            t[r, c] += eps
            up = total(t)
            t[r, c] -= 2 * eps
            dn = total(t)
            g[r, c] = (up - dn) / (2 * eps)
    return g


def adagrad_step(table: np.ndarray, acc: np.ndarray, grad: np.ndarray,
                 lr: float) -> Tuple[np.ndarray, np.ndarray]:
    """Reference optimizer: Adagrad with sparse per-row application
    (SURVEY §2 "Loss + optimizer"). Dense oracle form; grad rows of
    untouched rows are zero so acc/table only change where touched —
    which requires guarding the zero-grad entries: with acc 0 there
    too, grad/sqrt(acc) is 0/0 = NaN and would poison every untouched
    row (the trainer never hits this because adagrad_init > 0)."""
    acc = acc + grad * grad
    update = np.divide(grad, np.sqrt(acc),
                       out=np.zeros_like(grad), where=grad != 0)
    table = table - lr * update
    return table, acc
