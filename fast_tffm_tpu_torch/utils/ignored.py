"""Config keys the port accepts and ignores, and the ``kernel`` key's
message.

The port loads every ``FmConfig`` key the JAX package loads, so one
config file serves both. A key whose subsystem is not ported must not
pass in silence: each entry point (``train``, ``predict``, ``serve``,
the fleet supervisor) logs every key of ``IGNORED_KEYS`` that is set
away from its default, naming the ROADMAP.md item that brings it. Every
key takes effect today, so the list is empty. ``kernel`` is logged
with a message of its own when set to ``xla`` or ``pallas``: no item
will port it, since the port has one route per model (a 2nd-order FM
runs the CUDA kernels on the card and their plain versions on the CPU;
FFM and order > 2 run torch ops). Keys the port refuses outright raise
elsewhere (``train.check_train_supported`` and ``__main__.py``).
"""

from __future__ import annotations

from fast_tffm_tpu_torch.config import FmConfig

# (key, ROADMAP.md queue A item, what the item ports): ignored by every
# entry point. Empty: the run telemetry and protocol_trace of every arm
# are ported.
IGNORED_KEYS: tuple = ()


def ignored_keys_set(cfg: FmConfig):
    """``(key, value, item, what)`` for each ignored key that ``cfg``
    sets away from its default, in ``IGNORED_KEYS`` order."""
    defaults = FmConfig()
    return [(key, getattr(cfg, key), item, what)
            for key, item, what in IGNORED_KEYS
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


def log_ignored_keys(cfg: FmConfig, logger) -> None:
    """One log line per ignored key ``cfg`` sets, naming its item, and
    the ``kernel`` line."""
    msg = kernel_key_message(cfg)
    if msg is not None:
        logger.info("%s", msg)
    for key, value, item, what in ignored_keys_set(cfg):
        logger.info(
            "%s = %r is accepted and ignored: %s is not ported to "
            "fast_tffm_tpu_torch yet (ROADMAP.md, queue A, item %s)",
            key, value, what, item)
