"""Step timing — a copy of ``StepTimer`` from
``fast_tffm_tpu/utils/timing.py`` (the JAX package's profiler hooks are
not ported)."""

from __future__ import annotations

import time


class StepTimer:
    """Examples/sec over the WINDOW since the rate was last read; call
    ``tick(n_examples)`` after each step is dispatched.

    ``consume_window_rate()`` reports and resets the window, so
    consecutive log lines show the rate between logs rather than a
    cumulative average anchored at construction.
    ``total_examples_per_sec`` keeps the whole-run figure (including
    validation and export pauses) for end-of-run summaries."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._win_t0 = self._t0
        self._examples = 0
        self._win_examples = 0
        self._steps = 0

    def tick(self, n_examples: int) -> None:
        self._examples += n_examples
        self._win_examples += n_examples
        self._steps += 1

    def consume_window_rate(self) -> float:
        """Examples/sec since the previous call, consuming the window."""
        now = time.perf_counter()
        dt = now - self._win_t0
        rate = self._win_examples / dt if dt > 0 else 0.0
        self._win_t0 = now
        self._win_examples = 0
        return rate

    @property
    def total_examples_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._examples / dt if dt > 0 else 0.0

    @property
    def steps(self) -> int:
        return self._steps
