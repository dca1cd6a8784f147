"""A fleet replica: ``python -m fast_tffm_tpu_torch.serve.replica <cfg>
[--device cuda|cpu]`` — the port's counterpart of
``fast_tffm_tpu/serve/replica.py``.

One supervised ScorerServer process (serve/fleet.py spawns it): it loads
the config file it is given, applies the ``FM_<KNOB>`` overrides the
supervisor set for it (its ``serve_port``, ``serve_reload_mode =
external``, ``serve_pointer = canary`` on the canary replica), and runs
the single-process serve entry point, whose drain on SIGTERM the
supervisor's terminate-and-reap relies on. With the config's
``metrics_file`` set, the supervisor names the replica's own stream in
``FM_METRICS_FILE`` (``<metrics_file>.r<i>``), which its server writes.
There is no compile cache to set up: each replica loads the
content-hashed kernel library that ``ops/build.py`` built, and replicas
building it at once on a cold build directory each compile to a private
name and rename.
"""

from __future__ import annotations

import sys

_USAGE = ("usage: python -m fast_tffm_tpu_torch.serve.replica <cfg> "
          "[--device cuda|cpu]")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if len(argv) == 3 and argv[1] == "--device" and \
            argv[2] in ("cuda", "cpu"):
        device = argv[2]
    elif len(argv) != 1:
        print(_USAGE, file=sys.stderr)
        return 2
    from fast_tffm_tpu_torch.config import apply_env_overrides, load_config
    from fast_tffm_tpu_torch.serve.frontend import run_serve
    cfg = apply_env_overrides(load_config(argv[0]))
    return run_serve(cfg, device=device)


if __name__ == "__main__":
    sys.exit(main())
