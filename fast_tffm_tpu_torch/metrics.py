"""Score transform, streaming AUC and exact AUC — copies of ``sigmoid``,
``StreamingAUC`` and ``exact_auc`` from ``fast_tffm_tpu/metrics.py``.

``sigmoid`` returns float64, which is what the ``%.6f`` score lines of
predict and serve format, so both surfaces print the same bytes.
"""

from __future__ import annotations

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


class StreamingAUC:
    """Binned Mann-Whitney AUC over a monotone squash of the scores.

    update() takes raw scores (logits) and {0,1} labels; ties within a bin
    contribute 1/2 (trapezoidal), so with enough bins this converges to the
    exact rank statistic. Weights: examples with weight 0 (batch padding)
    are dropped; other weights scale their example's contribution.

    The squash is arctan(x/4), not the sigmoid: sigmoid binning collapses
    every logit past ~ln(num_bins) into one tie bin, where arctan keeps
    logits distinguishable out to |x| ~ 4*num_bins/pi. NaN scores raise.
    """

    def __init__(self, num_bins: int = 1 << 14):
        self.num_bins = num_bins
        self.pos = np.zeros(num_bins, dtype=np.float64)
        self.neg = np.zeros(num_bins, dtype=np.float64)

    def update(self, scores: np.ndarray, labels: np.ndarray,
               weights: np.ndarray | None = None) -> None:
        scores = np.asarray(scores, dtype=np.float64).ravel()
        labels = np.asarray(labels, dtype=np.float64).ravel()
        w = (np.ones_like(scores) if weights is None
             else np.asarray(weights, dtype=np.float64).ravel())
        keep = w > 0
        scores, labels, w = scores[keep], labels[keep], w[keep]
        if np.isnan(scores).any():
            raise ValueError(
                "NaN scores passed to StreamingAUC.update — the model "
                "has diverged (check learning_rate / init_value_range)")
        u = 0.5 + np.arctan(scores / 4.0) / np.pi
        bins = np.minimum((u * self.num_bins).astype(np.int64),
                          self.num_bins - 1)
        is_pos = labels >= 0.5
        np.add.at(self.pos, bins[is_pos], w[is_pos])
        np.add.at(self.neg, bins[~is_pos], w[~is_pos])

    def result(self) -> float:
        """AUC = P(score_pos > score_neg) + 0.5 P(tie)."""
        n_pos = self.pos.sum()
        n_neg = self.neg.sum()
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        neg_below = np.cumsum(self.neg) - self.neg   # negatives in lower bins
        pairs = np.sum(self.pos * (neg_below + 0.5 * self.neg))
        return float(pairs / (n_pos * n_neg))

    def reset(self) -> None:
        self.pos[:] = 0.0
        self.neg[:] = 0.0


def exact_auc(scores: np.ndarray, labels: np.ndarray,
              weights: np.ndarray | None = None) -> float:
    """O(n log n) exact AUC (Mann-Whitney, ties half).

    With ``weights``, each (pos, neg) pair contributes w_pos * w_neg
    (ties half) and the result is pairs / (W_pos * W_neg).
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel() >= 0.5
    w = (np.ones_like(scores) if weights is None
         else np.asarray(weights, dtype=np.float64).ravel())
    order = np.argsort(scores, kind="mergesort")
    s, y, w = scores[order], labels[order], w[order]
    n = len(s)
    wpos = np.where(y, w, 0.0)
    wneg = np.where(y, 0.0, w)
    neg_below = np.cumsum(wneg) - wneg  # strictly-lower negative weight
    pairs = 0.0
    i = 0
    while i < n:  # tie groups share one (neg_below, group-neg) context
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        g_pos = wpos[i:j + 1].sum()
        g_neg = wneg[i:j + 1].sum()
        pairs += g_pos * (neg_below[i] + 0.5 * g_neg)
        i = j + 1
    W_pos, W_neg = wpos.sum(), wneg.sum()
    if W_pos == 0 or W_neg == 0:
        return float("nan")
    return float(pairs / (W_pos * W_neg))
