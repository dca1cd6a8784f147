"""Config keys the port accepts and ignores, until the ROADMAP.md item
that brings each lands.

The port loads every ``FmConfig`` key the JAX package loads, so one
config file serves both. A key whose subsystem is not ported yet must
not pass in silence: each entry point (``train``, ``predict``,
``serve``) logs every key of ``IGNORED_KEYS`` that is set away from its
default, naming the item. Keys the port refuses outright raise
``NotImplementedError`` elsewhere (``models/fm.check_supported``,
``train.check_train_supported``, the serve server).
"""

from __future__ import annotations

from fast_tffm_tpu_torch.config import FmConfig

# (key, ROADMAP.md queue A item, what the item ports).
IGNORED_KEYS = (
    ("metrics_file", "A11", "observability"),
    ("metrics_flush_steps", "A11", "observability"),
    ("trace_spans", "A11", "observability"),
    ("save_summaries_steps", "A11", "observability"),
    ("profile_dir", "A11", "observability"),
    ("profile_start_step", "A11", "observability"),
    ("profile_num_steps", "A11", "observability"),
    ("watchdog_stall_seconds", "A11", "observability"),
    ("mem_pressure_fraction", "A11", "observability"),
    ("anatomy", "A11", "observability"),
    ("protocol_trace", "A11", "observability"),
    ("slo_publish_staleness_seconds", "A11", "observability"),
    ("slo_p99_ms", "A11", "observability"),
    ("slo_max_bad_fraction", "A11", "observability"),
    ("slo_min_auc", "A13", "the stream run mode's publish gate"),
)


def ignored_keys_set(cfg: FmConfig):
    """``(key, value, item, what)`` for each ignored key that ``cfg``
    sets away from its default, in ``IGNORED_KEYS`` order."""
    defaults = FmConfig()
    return [(key, getattr(cfg, key), item, what)
            for key, item, what in IGNORED_KEYS
            if getattr(cfg, key) != getattr(defaults, key)]


def log_ignored_keys(cfg: FmConfig, logger) -> None:
    """One log line per ignored key ``cfg`` sets, naming its item."""
    for key, value, item, what in ignored_keys_set(cfg):
        logger.info(
            "%s = %r is accepted and ignored: %s is not ported to "
            "fast_tffm_tpu_torch yet (ROADMAP.md, queue A, item %s)",
            key, value, what, item)
