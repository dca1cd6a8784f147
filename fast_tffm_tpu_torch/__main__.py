"""Command line of the PyTorch/CUDA port — the train, predict and serve
surface of ``run_tffm.py``:

    python -m fast_tffm_tpu_torch train   <cfg> [--device cuda|cpu]
                                                [dist_train worker <i>
                                                 | --join]
    python -m fast_tffm_tpu_torch predict <cfg> [--device cuda|cpu]
                                                [dist_train worker <i>]
    python -m fast_tffm_tpu_torch serve   <cfg> [--device cuda|cpu]
                                                [--replicas N]

All read the same INI configs as ``run_tffm.py``. ``train`` resumes
from and saves to the checkpoint directory ``<model_file>.ckpt/``
(every ``save_steps`` steps, at the end, and on SIGTERM/SIGINT) and
exports ``<model_file>.npz``; ``predict`` reads the newest intact
checkpoint step; ``serve`` loads the step the ``published`` pointer
names and hot-reloads each newly published one (publish a step with
``python -m fast_tffm_tpu_torch.tools.fmckpt publish <model_file>
<step>``). ``serve --replicas N`` with N >= 2, or ``serve_replicas = N``
in the config, runs a fleet: N replica processes on ``serve_port + i``
behind a failover proxy on ``serve_proxy_port``, restarted when they
die and reloaded in turn when the pointer moves (``--replicas 1`` runs
the single server whatever the config says). The port's checkpoints
are in torch's format, not the JAX package's: give the two packages
different model_files
(``models/convert.save_checkpoint_from_numpy`` carries a JAX model
across). They run on the CUDA card unless ``--device cpu`` asks for the
CPU; without a card they raise.

``train|predict <cfg> dist_train worker <i>`` runs rank i of the
cluster the config's ``[Cluster] worker_hosts`` lists: one process per
entry, started alike, training one model in lockstep with the table
row-sharded over them (rank 0 hosts the rendezvous at worker_hosts[0]'s
port + 1000; ranks sharing one card talk over gloo). With ``[Cluster]
elastic = shrink`` the survivors of a dead worker reform and finish the
schedule; with ``elastic = grow`` a replacement started as ``train <cfg>
--join`` is admitted into the dead worker's slot at the next epoch
boundary. ``dist_train ps <i>`` explains that there are no parameter
servers and exits 0; ``serve`` takes no role.
"""

from __future__ import annotations

import sys

from fast_tffm_tpu_torch.config import apply_env_overrides, load_config


def _usage() -> int:
    print(__doc__, file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] not in ("train", "predict", "serve"):
        return _usage()
    mode, cfg_path, rest = argv[0], argv[1], argv[2:]
    device = None
    if rest[:1] == ["--device"]:
        if len(rest) < 2 or rest[1] not in ("cuda", "cpu"):
            print("--device wants cuda or cpu", file=sys.stderr)
            return _usage()
        device, rest = rest[1], rest[2:]
    if mode == "serve" and rest[:1] == ["dist_train"]:
        print("serve takes no dist_train role: the scorer is "
              "single-process; a multi-replica fleet is "
              "`serve <cfg> --replicas N`", file=sys.stderr)
        return _usage()
    job_name = task_index = None
    join = False
    if mode != "serve" and rest == ["--join"]:
        if mode != "train":
            print("--join is a train mode: a replacement worker joins a "
                  "running elastic = grow training cluster",
                  file=sys.stderr)
            return _usage()
        join, rest = True, []
    if mode != "serve" and rest:
        if len(rest) != 3 or rest[0] != "dist_train":
            return _usage()
        job_name = rest[1]
        try:
            task_index = int(rest[2])
        except ValueError:
            print(f"dist_train task index must be an integer, got "
                  f"{rest[2]!r}", file=sys.stderr)
            return _usage()
        if job_name == "ps":
            print("fast_tffm_tpu has no parameter servers: the table is "
                  "row-sharded across the device mesh. Launch worker "
                  "roles only.", file=sys.stderr)
            return 0
        if job_name != "worker":
            return _usage()
        rest = []
    replicas = None
    if mode == "serve" and rest[:1] == ["--replicas"]:
        try:
            replicas = int(rest[1])
        except (IndexError, ValueError):
            print("--replicas wants an integer", file=sys.stderr)
            return _usage()
        if replicas < 1:
            print("--replicas must be >= 1", file=sys.stderr)
            return _usage()
        rest = rest[2:]
    if rest:
        return _usage()
    cfg = apply_env_overrides(load_config(cfg_path))
    if mode == "train":
        from fast_tffm_tpu_torch.train import train
        train(cfg, device=device, job_name=job_name, task_index=task_index,
              join=join)
        return 0
    if mode == "predict":
        from fast_tffm_tpu_torch.predict import predict
        predict(cfg, device=device, job_name=job_name,
                task_index=task_index)
        return 0
    n = replicas if replicas is not None else cfg.serve_replicas
    if n > 1:
        from fast_tffm_tpu_torch.serve.fleet import run_fleet
        return run_fleet(cfg, cfg_path, replicas=n, device=device)
    from fast_tffm_tpu_torch.serve.frontend import run_serve
    return run_serve(cfg, device=device)


if __name__ == "__main__":
    sys.exit(main())
