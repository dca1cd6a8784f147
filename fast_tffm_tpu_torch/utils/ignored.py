"""Config keys the port accepts and ignores, until the ROADMAP.md item
that brings each lands.

The port loads every ``FmConfig`` key the JAX package loads, so one
config file serves both. A key whose subsystem is not ported yet must
not pass in silence: each entry point (``train``, ``predict``,
``serve``) logs every key of ``IGNORED_KEYS`` that is set away from its
default, naming the item, unless the caller says the key takes effect
there (``in_effect``). Keys the port refuses outright raise
``NotImplementedError`` elsewhere (``train.check_train_supported``,
the data pipeline).
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
    # In a stream run with validation files that publishes, slo_min_auc
    # does take effect: under publish_quality_eval = auto it switches
    # the publish quality sweep on (train passes it in ``in_effect``).
    ("slo_min_auc", "A11",
     "the SLO verdict (slo_min_auc only switches the publish quality "
     "sweep on, under publish_quality_eval = auto, in a stream run with "
     "validation files that publishes)"),
)


def ignored_keys_set(cfg: FmConfig):
    """``(key, value, item, what)`` for each ignored key that ``cfg``
    sets away from its default, in ``IGNORED_KEYS`` order."""
    defaults = FmConfig()
    return [(key, getattr(cfg, key), item, what)
            for key, item, what in IGNORED_KEYS
            if getattr(cfg, key) != getattr(defaults, key)]


def log_ignored_keys(cfg: FmConfig, logger, in_effect=()) -> None:
    """One log line per ignored key ``cfg`` sets, naming its item;
    the keys in ``in_effect`` take effect in the caller's run and are
    not logged."""
    for key, value, item, what in ignored_keys_set(cfg):
        if key in in_effect:
            continue
        logger.info(
            "%s = %r is accepted and ignored: %s is not ported to "
            "fast_tffm_tpu_torch yet (ROADMAP.md, queue A, item %s)",
            key, value, what, item)
