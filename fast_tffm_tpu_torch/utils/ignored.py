"""Config keys the port accepts and ignores, until the ROADMAP.md item
that brings each lands.

The port loads every ``FmConfig`` key the JAX package loads, so one
config file serves both. A key whose subsystem is not ported yet must
not pass in silence: each entry point (``train``, ``predict``,
``serve``, the fleet supervisor) logs every key of ``IGNORED_KEYS``
that is set away from its default, naming the item, unless the caller
says the key takes effect there (``in_effect``). The run-telemetry keys
(``TELEMETRY_KEYS``) take effect on one process and are logged by the
entry points that do not write a stream yet: the ``dist_train`` arms and
the fleet supervisor. ``kernel`` is logged
with a message of its own when set to ``xla`` or ``pallas``: no item
will port it, since the port has one route per model (a 2nd-order FM
runs the CUDA kernels on the card and their plain versions on the CPU;
FFM and order > 2 run torch ops). Keys the port refuses outright raise
elsewhere (``train.check_train_supported`` and ``__main__.py``).
"""

from __future__ import annotations

from fast_tffm_tpu_torch.config import FmConfig

# (key, ROADMAP.md queue A item, what the item ports): ignored by every
# entry point.
IGNORED_KEYS = (
    ("protocol_trace", "A11b",
     "protocol tracing of the multi-process collectives"),
)

# The run-telemetry keys: in effect in single-process train, predict and
# serve (obs/); ignored by the dist_train arms and the fleet supervisor
# (``telemetry_off``) until their telemetry is ported. In a stream run
# with validation files that publishes, slo_min_auc also switches the
# publish quality sweep on (under publish_quality_eval = auto), across
# ranks too (train passes it in ``in_effect`` there).
TELEMETRY_KEYS = tuple(
    (key, "A11b", "the run telemetry of dist_train and the serving fleet's "
     "supervisor")
    for key in ("metrics_file", "metrics_flush_steps", "trace_spans",
                "save_summaries_steps", "profile_dir", "profile_start_step",
                "profile_num_steps", "watchdog_stall_seconds",
                "mem_pressure_fraction", "anatomy",
                "slo_publish_staleness_seconds", "slo_p99_ms",
                "slo_max_bad_fraction", "slo_min_auc"))


def ignored_keys_set(cfg: FmConfig, telemetry_off: bool = False):
    """``(key, value, item, what)`` for each ignored key that ``cfg``
    sets away from its default, in ``TELEMETRY_KEYS`` (when
    ``telemetry_off``) then ``IGNORED_KEYS`` order."""
    defaults = FmConfig()
    keys = (TELEMETRY_KEYS if telemetry_off else ()) + IGNORED_KEYS
    return [(key, getattr(cfg, key), item, what)
            for key, item, what in keys
            if getattr(cfg, key) != getattr(defaults, key)]


# ``kernel`` values the port has no route for (``auto``, the default,
# is what the port does anyway).
NO_EFFECT_KERNELS = ("xla", "pallas")


def kernel_key_message(cfg: FmConfig):
    """The line a ``kernel`` set to ``xla`` or ``pallas`` is logged
    with, or None."""
    if cfg.kernel not in NO_EFFECT_KERNELS:
        return None
    return (f"kernel = {cfg.kernel!r} has no effect in fast_tffm_tpu_torch "
            "and no ROADMAP.md item will give it one: a 2nd-order FM runs "
            "the hand-written CUDA kernels on the card and their plain "
            "PyTorch versions on the CPU; FFM and order > 2 run torch ops")


def log_ignored_keys(cfg: FmConfig, logger, in_effect=(),
                     telemetry_off: bool = False) -> None:
    """One log line per ignored key ``cfg`` sets, naming its item, and
    the ``kernel`` line; ``telemetry_off`` (the dist_train arms, the
    fleet supervisor) adds the telemetry keys. The keys in ``in_effect``
    take effect in the caller's run and are not logged."""
    msg = kernel_key_message(cfg)
    if msg is not None:
        logger.info("%s", msg)
    for key, value, item, what in ignored_keys_set(cfg, telemetry_off):
        if key in in_effect:
            continue
        logger.info(
            "%s = %r is accepted and ignored: %s is not ported to "
            "fast_tffm_tpu_torch yet (ROADMAP.md, queue A, item %s)",
            key, value, what, item)
