"""Command line of the PyTorch/CUDA port — the predict and serve surface
of ``run_tffm.py``:

    python -m fast_tffm_tpu_torch predict <cfg> [--device cuda|cpu]
    python -m fast_tffm_tpu_torch serve   <cfg> [--device cuda|cpu]

Both read the same INI configs as ``run_tffm.py`` and load the dense
table export ``<model_file>.npz`` that a JAX train writes. They run on
the CUDA card unless ``--device cpu`` asks for the CPU; without a card
they raise. ``train``, ``dist_train`` roles and ``serve --replicas``
are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import sys

from fast_tffm_tpu_torch.config import apply_env_overrides, load_config


def _usage() -> int:
    print(__doc__, file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] not in ("predict", "serve"):
        return _usage()
    mode, cfg_path, rest = argv[0], argv[1], argv[2:]
    device = None
    if rest[:1] == ["--device"]:
        if len(rest) < 2 or rest[1] not in ("cuda", "cpu"):
            print("--device wants cuda or cpu", file=sys.stderr)
            return _usage()
        device, rest = rest[1], rest[2:]
    if rest[:1] == ["dist_train"]:
        raise NotImplementedError(
            "multi-process dist_train is not ported to "
            "fast_tffm_tpu_torch yet (ROADMAP.md, queue A, item A10)")
    if rest[:1] == ["--replicas"]:
        raise NotImplementedError(
            "the serving fleet (--replicas) is not ported to "
            "fast_tffm_tpu_torch yet (ROADMAP.md, queue A, item A9)")
    if rest:
        return _usage()
    cfg = apply_env_overrides(load_config(cfg_path))
    if mode == "predict":
        from fast_tffm_tpu_torch.predict import predict
        predict(cfg, device=device)
        return 0
    from fast_tffm_tpu_torch.serve.frontend import run_serve
    return run_serve(cfg, device=device)


if __name__ == "__main__":
    sys.exit(main())
