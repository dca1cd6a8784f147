"""Per-publish model quality and the publish gate — a copy of
``QualityStats`` and ``PublishGate`` from ``fast_tffm_tpu/obs/quality.py``.

A streaming trainer with ``validation_files`` runs one validation sweep
at every publish; the sweep's AUC gates the ``published`` pointer: when
validation regressed past ``publish_min_auc`` / ``publish_max_auc_drop``
the pointer does NOT move, and scorers keep hot-reloading the last
passing step while the trainer keeps consuming. ``QualityStats`` is fed
the same host score chunks the validation AUC consumes
(``train.evaluate``'s ``collect``), so the quality numbers cost no
device fetch of their own.

The train loop logs each sweep and each hold with the JAX package's
lines, and with a run's telemetry on, ``emit_quality`` lands the sweep's
gauges and counters and ``emit_gate_held`` a hold's ``health:
gate_held`` event (copies of the JAX package's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from fast_tffm_tpu_torch.metrics import sigmoid

# Probability clip for the logistic log-loss: a saturated score costs a
# large but finite loss, not an inf that poisons the mean.
LOGLOSS_EPS = 1e-7

# Values of ``QualityStats.sums()``: the tail of the multi-process AUC
# merge payload (train.evaluate_distributed).
SUMS_WIDTH = 4


class QualityStats:
    """Accumulator for the per-publish quality numbers: ``update(scores,
    labels, weights)`` takes the raw (pre-sigmoid) score chunks the
    validation sweep fetched."""

    def __init__(self, loss_type: str = "logistic"):
        self.loss_type = loss_type
        self.loss_sum = 0.0
        self.weight_sum = 0.0
        self.pred_sum = 0.0
        self.label_sum = 0.0

    def update(self, scores, labels, weights) -> None:
        s = np.asarray(scores, dtype=np.float64)
        y = np.asarray(labels, dtype=np.float64)
        w = np.asarray(weights, dtype=np.float64)
        if self.loss_type == "logistic":
            # The scorer's overflow-stable sigmoid: the gate's
            # probability is the serving probability.
            p = sigmoid(s)
            pc = np.clip(p, LOGLOSS_EPS, 1.0 - LOGLOSS_EPS)
            loss = -(y * np.log(pc) + (1.0 - y) * np.log(1.0 - pc))
        else:  # mse: the "prediction" is the raw score itself
            p = s
            loss = (s - y) ** 2
        self.loss_sum += float((w * loss).sum())
        self.weight_sum += float(w.sum())
        self.pred_sum += float((w * p).sum())
        self.label_sum += float((w * y).sum())

    def sums(self) -> np.ndarray:
        return np.asarray([self.loss_sum, self.weight_sum,
                           self.pred_sum, self.label_sum], np.float64)

    def load_sums(self, vals) -> None:
        """Replace the local sums with the job-wide totals: the tail of
        the multi-process AUC merge payload."""
        vals = np.asarray(vals, dtype=np.float64).reshape(-1)
        if vals.shape[0] != SUMS_WIDTH:
            raise ValueError(
                f"quality sums payload must have {SUMS_WIDTH} values, "
                f"got {vals.shape[0]}")
        self.loss_sum, self.weight_sum, self.pred_sum, self.label_sum = (
            float(v) for v in vals)

    @property
    def loss(self) -> Optional[float]:
        """Weighted mean validation loss (log-loss for logistic, MSE for
        mse), or None on an empty sweep."""
        if self.weight_sum <= 0:
            return None
        return self.loss_sum / self.weight_sum

    @property
    def calibration(self) -> Optional[float]:
        """Sum(predicted) / sum(label): 1.0 is calibrated, > 1
        over-predicts. None when the sweep held no positive mass."""
        if self.label_sum <= 0:
            return None
        return self.pred_sum / self.label_sum


class PublishGate:
    """The publish gate's decision state. ``decide(auc, step)`` is pure
    and returns a JSON-safe decision dict; ``note_published(auc)``
    advances the drop baseline only once a publish landed. Before the
    first publish there is no baseline, so only ``publish_min_auc``
    applies."""

    def __init__(self, min_auc: float = 0.0, max_drop: float = 0.0):
        self.min_auc = float(min_auc)
        self.max_drop = float(max_drop)
        # AUC of the last SUCCESSFUL publish; None until one lands.
        self.baseline: Optional[float] = None

    @classmethod
    def from_config(cls, cfg) -> Optional["PublishGate"]:
        min_auc = float(cfg.publish_min_auc)
        max_drop = float(cfg.publish_max_auc_drop)
        if not min_auc and not max_drop:
            return None
        return cls(min_auc=min_auc, max_drop=max_drop)

    def decide(self, auc: float, step: int) -> Dict[str, Any]:
        auc = float(auc)
        reasons = []
        # A non-finite AUC (an empty or single-class sweep) holds any
        # configured gate, even a max_drop-only gate on its first
        # publish, where neither comparison below would fire.
        if not np.isfinite(auc):
            reasons.append(
                f"validation AUC is {auc} (empty or single-class "
                "sweep): a configured gate never passes an "
                "unevaluable model")
        if self.min_auc and not auc >= self.min_auc:
            reasons.append(
                f"AUC {auc:.6f} below publish_min_auc {self.min_auc}")
        if (self.max_drop and self.baseline is not None
                and not auc >= self.baseline - self.max_drop):
            reasons.append(
                f"AUC {auc:.6f} dropped {self.baseline - auc:.6f} from "
                f"the last published {self.baseline:.6f} "
                f"(publish_max_auc_drop {self.max_drop})")
        return {
            "held": bool(reasons),
            "step": int(step),
            "auc": auc,
            "baseline": self.baseline,
            "min_auc": self.min_auc,
            "max_auc_drop": self.max_drop,
            "reasons": reasons,
        }

    def note_published(self, auc: Optional[float]) -> None:
        """Record a LANDED publish's AUC as the next drop baseline; a
        non-finite value never becomes one (a NaN baseline would disarm
        the drop check for good)."""
        if auc is not None and np.isfinite(auc):
            self.baseline = float(auc)


def emit_gate_held(tel, decision: Dict[str, Any]) -> None:
    """A hold's evidence: a ``health: gate_held`` event and the
    ``quality/gate_held`` counter, flushed to disk at once. No-op
    without telemetry."""
    if tel is None:
        return
    tel.count("quality/gate_held")
    tel.sink.emit("health", {
        "status": "gate_held",
        "step": int(decision.get("step", -1)),
        "auc": decision.get("auc"),
        "baseline": decision.get("baseline"),
        "reasons": list(decision.get("reasons") or []),
    })
    tel.sink.flush()


def emit_quality(tel, step: int, auc: float, stats: QualityStats,
                 n_examples: int, eval_seconds: float) -> None:
    """The sweep's gauges, counters and one scalar, all host floats
    computed from the already-fetched score chunks. Sets
    ``validation/auc`` too: the sweep is the stream's validation."""
    if tel is None:
        return
    tel.count("quality/evals")
    tel.count("quality/eval_seconds", float(eval_seconds))
    tel.count("quality/examples", float(n_examples))
    tel.set("quality/auc", float(auc))
    tel.set("validation/auc", float(auc))
    if stats.loss is not None:
        tel.set("quality/loss", float(stats.loss))
    if stats.calibration is not None:
        tel.set("quality/calibration", float(stats.calibration))
    tel.add_scalar("quality/auc", int(step), float(auc))
