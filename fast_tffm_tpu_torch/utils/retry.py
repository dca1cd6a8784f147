"""Transient-IO retry with exponential backoff — a copy of
``RetryPolicy``, ``retry_io`` and ``open_with_retry`` from
``fast_tffm_tpu/utils/retry.py``, with its telemetry: each retry counts
``io/retries``, ``io/retries/<op>`` and ``io/retry_sleep_seconds`` and
its backoff is an ``io/retry`` span.

The checkpoint restore path and the input pipeline wrap their file
reads in ``retry_io`` (``open_with_retry`` for opens):
``OSError``/``TimeoutError`` retry, except the definitely-fatal family
(a missing or forbidden path), which fails on the first raise, as does
everything that is not IO. Backoff before retry k is
``backoff_seconds * 2^k`` times a jitter in [0.5, 1.5) drawn from a
``random.Random`` seeded with ``(seed, op)``, so reruns back off
identically. Knobs: ``io_retries`` / ``io_backoff_seconds`` in
``[Train]``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, TypeVar

from fast_tffm_tpu_torch.obs.telemetry import active
from fast_tffm_tpu_torch.obs.trace import span

T = TypeVar("T")

# Errors that retrying can never fix: the path itself is wrong (or
# forbidden).
FATAL_IO_ERRORS = (FileNotFoundError, IsADirectoryError,
                   NotADirectoryError, PermissionError)


def is_retryable(exc: BaseException) -> bool:
    """Whether a retry has any chance of helping: transient-IO classes
    (``OSError``/``TimeoutError``) minus the definitely-fatal family."""
    if isinstance(exc, FATAL_IO_ERRORS):
        return False
    return isinstance(exc, (OSError, TimeoutError))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How many extra attempts a retryable failure gets, and how long
    the backoff waits. ``retries`` counts attempts AFTER the first
    (0 = fail fast)."""
    retries: int = 2
    backoff_seconds: float = 0.1
    seed: int = 0

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        return cls(retries=cfg.io_retries,
                   backoff_seconds=cfg.io_backoff_seconds, seed=cfg.seed)


def retry_io(fn: Callable[..., T], *args,
             policy: Optional[RetryPolicy] = None, op: str = "io",
             sleep: Callable[[float], None] = time.sleep,
             **kwargs) -> T:
    """Call ``fn(*args, **kwargs)``, retrying retryable IO failures per
    ``policy`` (None = the default RetryPolicy). ``op`` seeds the jitter
    stream; ``sleep`` is injectable so tests pin the backoff without
    real waits."""
    p = policy or RetryPolicy()
    rng = random.Random(f"{p.seed}/{op}")
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if not is_retryable(e) or attempt >= p.retries:
                raise
            delay = p.backoff_seconds * (2 ** attempt) * (
                0.5 + rng.random())
            tel = active()
            if tel is not None:
                tel.count("io/retries")
                tel.count(f"io/retries/{op}")
                tel.count("io/retry_sleep_seconds", delay)
            with span("io/retry", op=op, attempt=attempt,
                      error=f"{type(e).__name__}: {e}"[:200]):
                if delay > 0:
                    sleep(delay)
            attempt += 1


def open_with_retry(path: str, mode: str = "r",
                    policy: Optional[RetryPolicy] = None,
                    op: str = "open", **kwargs):
    """``open()`` with transient-failure retry, for the pipeline's file
    opens. A missing file still raises ``FileNotFoundError`` on the
    first attempt (fatal class)."""
    return retry_io(open, path, mode, policy=policy, op=op, **kwargs)
