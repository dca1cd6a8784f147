"""Score transform and exact AUC — copies of ``sigmoid`` and
``exact_auc`` from ``fast_tffm_tpu/metrics.py``.

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
