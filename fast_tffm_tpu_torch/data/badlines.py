"""Bad-line policy bookkeeping: skip/quarantine accounting and the
``max_bad_fraction`` circuit breaker — a copy of
``fast_tffm_tpu/data/badlines.py`` for one process.

One ``BadLineTracker`` follows one run's pipeline (train passes a
single tracker through every epoch's iterators; evaluate and predict
create their own), so the fraction, the per-file tally and the
quarantine dedupe see the whole run:

- ``quarantine`` appends one JSON line per offending input line —
  ``{"file", "lineno", "error", "raw"}`` — to the quarantine file
  (``<metrics_file>.quarantine``, or ``<model_file>.quarantine`` when
  metrics are off), once per (file, lineno) however many epochs read it;
- the breaker trips when ``bad / total > max_bad_fraction`` and at least
  ``MIN_BAD_LINES_TO_TRIP`` lines are bad, naming the worst file.

With a run's telemetry active, each bad line counts
``pipeline/bad_lines``, and ``health: bad_input`` events are emitted at
the 1st, 2nd, 4th, 8th, ... bad line (the JAX package's rate limit).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Set, Tuple

# Absolute floor before the fraction breaker may trip: the fraction
# estimate over fewer bad lines than this is too noisy to abort on.
MIN_BAD_LINES_TO_TRIP = 8


class BadInputError(ValueError):
    """The max_bad_fraction circuit breaker: too much of the corpus is
    malformed for skip/quarantine to be safe."""


def quarantine_path(cfg) -> str:
    """Where offending lines are quarantined: beside the metrics file
    when one is configured (``auto`` = ``<model_file>.metrics.jsonl``,
    the JAX package's rule), beside the model file otherwise."""
    base = cfg.metrics_file
    if base == "auto":
        base = cfg.model_file + ".metrics.jsonl"
    return (base or cfg.model_file) + ".quarantine"


class BadLineTracker:
    """Accounting for one run's bad-line policy; see module docstring.

    ``record()`` raises BadInputError when the breaker trips — the
    pipeline lets it propagate, aborting the run with the worst file
    named. ``count_ok(n)`` feeds the denominator. Thread-safe: the
    prefetch thread and the parallel data plane's workers record at
    once."""

    def __init__(self, policy: str, max_bad_fraction: float,
                 quarantine_file: Optional[str] = None):
        if policy not in ("skip", "quarantine"):
            raise ValueError(
                f"BadLineTracker is for tolerant policies, got "
                f"{policy!r}")
        self.policy = policy
        self.max_bad_fraction = float(max_bad_fraction)
        self.quarantine_file = quarantine_file
        self.total = 0          # lines scanned (good + bad)
        self.bad = 0            # lines skipped
        self.by_file: Dict[str, int] = {}
        self._quarantined: Set[Tuple[str, int]] = set()
        self._q_fh = None
        self._breaker: Optional[BadInputError] = None
        self._lock = threading.Lock()
        self._next_emit = 1  # the bad count of the next bad_input event

    @classmethod
    def from_config(cls, cfg) -> Optional["BadLineTracker"]:
        """A tracker per the config's policy, or None for ``error``."""
        if cfg.bad_line_policy == "error":
            return None
        return cls(cfg.bad_line_policy, cfg.max_bad_fraction,
                   quarantine_file=(quarantine_path(cfg)
                                    if cfg.bad_line_policy == "quarantine"
                                    else None))

    def count_ok(self, n: int) -> None:
        with self._lock:
            self.total += n

    def record(self, path: str, lineno: int, raw: str,
               error: str) -> None:
        """One bad line skipped: count, attribute, maybe quarantine,
        check the breaker (which raises); with telemetry active, count
        it and maybe emit a ``health: bad_input`` event."""
        from fast_tffm_tpu_torch.obs.telemetry import active
        tel = active()
        with self._lock:
            if self._breaker is not None:
                # The breaker trips once: every worker that reaches it
                # later raises the same stored diagnosis.
                raise self._breaker
            self.total += 1
            self.bad += 1
            self.by_file[path] = self.by_file.get(path, 0) + 1
            if tel is not None:
                tel.count("pipeline/bad_lines")
                if self.bad >= self._next_emit:
                    while self._next_emit <= self.bad:
                        self._next_emit *= 2
                    tel.sink.emit("health", {
                        "status": "bad_input",
                        "policy": self.policy,
                        "bad_lines": self.bad,
                        "total_lines": self.total,
                        "file": path,
                        "lineno": lineno,
                        "error": error[:200],
                    })
            if (self.quarantine_file is not None
                    and (path, lineno) not in self._quarantined):
                self._quarantined.add((path, lineno))
                if self._q_fh is None:
                    d = os.path.dirname(os.path.abspath(
                        self.quarantine_file))
                    os.makedirs(d, exist_ok=True)
                    self._q_fh = open(self.quarantine_file, "a",
                                      encoding="utf-8")
                self._q_fh.write(json.dumps(
                    {"file": path, "lineno": lineno, "error": error,
                     "raw": raw}) + "\n")
                self._q_fh.flush()  # must survive a later crash
            self._check_breaker()

    def _check_breaker(self) -> None:
        # The caller holds the lock.
        if (self.bad >= MIN_BAD_LINES_TO_TRIP and self.total
                and self.bad / self.total > self.max_bad_fraction):
            worst, n_worst = max(self.by_file.items(),
                                 key=lambda kv: kv[1])
            self._breaker = BadInputError(
                f"aborting: {self.bad} of {self.total} input lines "
                f"({self.bad / self.total:.2%}) are malformed, over "
                f"the max_bad_fraction ceiling "
                f"({self.max_bad_fraction:.2%}); worst file: {worst} "
                f"({n_worst} bad lines). The corpus looks corrupt — "
                "fix the data (see the quarantine file if "
                "bad_line_policy = quarantine) or raise "
                "max_bad_fraction if this corruption level is "
                "expected.")
            raise self._breaker

    def describe(self) -> str:
        frac = self.bad / self.total if self.total else 0.0
        return (f"{self.bad} bad line(s) of {self.total} scanned "
                f"({frac:.3%}) under policy {self.policy}"
                + (f"; quarantined to {self.quarantine_file}"
                   if self.quarantine_file else ""))

    def close(self) -> None:
        with self._lock:
            if self._q_fh is not None:
                self._q_fh.close()
                self._q_fh = None
