"""Rank processes for the port's multi-process tests (not a test module).

    python tests/torch_dist_ranks.py <scenario> <rank> <world> <port> <wd>
                                     [<device>]
    python tests/torch_dist_ranks.py cli <fault> -- <argv of the port's CLI>

Each rank joins a ``world``-rank gloo group whose rendezvous listens on
``port`` (worker_hosts[0] = localhost:<port - 1000>), runs
``scenario`` through the port's own modules and writes what it saw to
``<wd>/<scenario>-rank<rank>.npz``. It imports torch, numpy and the
port, never jax: the tests hold these results against the JAX package
in the parent process.

Scenarios:
- ``step``: for an FM, an FFM and an order-3 FM (``step_cases``), this
  rank's fixed-shape local batches of ``<wd>/<model>.txt`` (its byte
  range) through ``STEPS`` sharded train steps from the dense starting
  state ``<wd>/<model>-init.npz`` (rank 1 stepping the all-padding
  filler in the last, as a rank whose shard ran dry does), then one
  sharded score of its next
  batch; saves the batches, the losses, the post-step shards and the
  scores. Then the checkpoint's step decisions (``_broadcast_int``,
  ``_all_agree``) under ``world`` ranks.

``cli`` runs ``python -m fast_tffm_tpu_torch <argv>`` with faults (a
comma-separated list) at fixed points, so a test's kill lands at the
same step on a loaded host: ``kill-at-step-<n>`` SIGKILLs this process
as it begins its step n + 1 (after step n's periodic save was
gathered), ``kill-in-save-after-step-<n>`` / ``stop-in-save-after-step-<n>``
SIGKILL / SIGSTOP it as it enters the gather to the chief of its first
save past step n, ``kill-at-announce`` as soon as a joiner has announced its
generation (its ticket and worker lease left behind, as a dead process
leaves them); ``keep-steps`` retires no checkpoint step past
``max_to_keep`` (the test reads the step a survivor restored after the
run); ``record-steps`` writes every stepped batch (its arrays and
whether it was a lockstep filler) to ``steps-<pid>.npz`` in the working
directory as the command returns, and every watermark exchange (this
rank's payload and the merged one) to ``watermarks-<pid>.json``;
``record-threads`` writes the thread of every host collective
(``ProcessMesh.all_gather_host`` and ``broadcast_object``, by label) to
``threads-<pid>.json``; ``none`` runs the command as it is.

The stream runs (``write_stream_run``, ``stage_shard``) are
``run_mode = stream`` jobs over ``<wd>/stream``, phase-gated: a shard is
staged in torn appends, then sealed, and the next one waits until the
published pointer names the step after it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 4
# The last step's rank 1 has run dry: it steps the all-padding filler,
# so the global batch's weight is rank 0's alone.
FILLER_STEP = STEPS - 1
UNIQ_BUCKET = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    """A free TCP port for a rendezvous (its worker port is 1000 below),
    below the host's ephemeral range: a rank that keeps connecting to a
    port in that range before its store listens can be handed the same
    port as its own source port and connect to itself, which holds the
    port against the store and fails the bring-up."""
    import random
    from fast_tffm_tpu_torch.serve.fleet import ephemeral_port_range
    top = min(ephemeral_port_range()[0], 32768)
    rng = random.Random()
    while True:
        port = rng.randrange(11000, top)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def worker_hosts(port: int, world: int) -> str:
    """The ``worker_hosts`` value whose rendezvous listens on ``port``."""
    return ",".join(f"localhost:{port - 1000 + i}" for i in range(world))


def run_ranks(scenario: str, wd: str, world: int = 2,
              timeout: float = 120.0, device: str = "cpu") -> list:
    """Run ``world`` rank processes of ``scenario`` (the parent side);
    their saved results, rank by rank."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(port), wd, device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        finally:
            p.kill()
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(os.path.join(wd, f"{scenario}-rank{r}.npz")))
            for r in range(world)]


ELASTIC_CFG = """[General]
vocabulary_size = 200
factor_num = 4
model_file = {wd}/model/fm
[Train]
train_files = {wd}/train.txt
validation_files = {repo}/data/sample_test.txt
epoch_num = {epochs}
batch_size = 16
learning_rate = 0.1
factor_lambda = 1e-6
bias_lambda = 1e-6
init_value_range = 0.01
log_steps = 4
save_steps = 12
max_features_per_example = 32
bucket_ladder = 8,16,32
uniq_bucket = 256
host_threads = 1
[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = 1.0
collective_timeout_seconds = 60
cluster_connect_timeout_seconds = 90
elastic = {elastic}
join_settle_seconds = 1
join_timeout_seconds = 180
"""

# The elastic runs' corpus: the first lines of data/sample_train.txt, a
# pass of 40 single-process steps at batch 16 (20 a rank at two ranks).
ELASTIC_LINES = 640
ELASTIC_BATCH = 16


def write_elastic_run(wd: str, epochs: int, elastic: str) -> str:
    """A 2-worker ``elastic`` config over ``ELASTIC_LINES`` lines in
    ``wd`` (explicit ``uniq_bucket`` above the vocabulary: no batch
    spills, so every pass has a fixed step count); returns its path."""
    with open(os.path.join(REPO, "data", "sample_train.txt")) as fh:
        lines = fh.read().splitlines()[:ELASTIC_LINES]
    with open(os.path.join(wd, "train.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    path = os.path.join(wd, "elastic.cfg")
    with open(path, "w") as fh:
        fh.write(ELASTIC_CFG.format(
            wd=wd, repo=REPO, epochs=epochs, elastic=elastic,
            hosts=worker_hosts(free_port(), 2)))
    return path


def spawn_cli(wd: str, tag: str, faults: str, argv) -> subprocess.Popen:
    """``python -m fast_tffm_tpu_torch <argv>`` under ``faults`` (the
    ``cli`` runner), logging to ``<wd>/<tag>.log``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    with open(os.path.join(wd, f"{tag}.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "cli", faults, "--",
             *argv], cwd=wd, env=env, stdout=log, stderr=subprocess.STDOUT)


def wait_all(procs, wd: str, timeout: float = 240.0) -> tuple:
    """Every process's exit code, each wait bounded (a process still
    running is killed and reads as None); then the logs, by tag."""
    rcs = []
    deadline = time.monotonic() + timeout
    for p in procs.values():
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append(None)
    logs = {}
    for tag in procs:
        with open(os.path.join(wd, f"{tag}.log")) as fh:
            logs[tag] = fh.read()
    return rcs, logs


def log_tails(logs: dict, n: int = 3000) -> str:
    """Each process's log tail, labelled: what a failing test prints."""
    return "".join(f"\n----- {tag} (last {n} chars) -----\n{text[-n:]}"
                   for tag, text in logs.items())


STREAM_CFG = """[General]
vocabulary_size = 200
factor_num = 4
model_file = {wd}/model/fm
[Train]
run_mode = stream
stream_dir = {wd}/stream
stream_poll_seconds = 0.05
seal_policy = done
publish_interval_seconds = 0.5
validation_files = {validation}
publish_min_auc = {min_auc}
validation_max_batches = {val_batches}
batch_size = 16
learning_rate = 0.1
factor_lambda = 1e-6
bias_lambda = 1e-6
init_value_range = 0.01
log_steps = 4
save_steps = {save_steps}
max_features_per_example = 32
bucket_ladder = 8,16,32
uniq_bucket = {uniq_bucket}
host_threads = 1
{metrics}[Cluster]
worker_hosts = {hosts}
heartbeat_seconds = 1.0
collective_timeout_seconds = {collective_timeout}
cluster_connect_timeout_seconds = 90
elastic = {elastic}
join_settle_seconds = 1
join_timeout_seconds = 180
"""

# A stream shard of STREAM_SHARD_LINES lines is STREAM_STEPS exact
# batches of STREAM_BATCH (a rank's batch): no batch spans two shards,
# so one shard staged at a time gives one step schedule (its owner's
# batches, the other rank's filler) whatever the membership.
STREAM_BATCH = 16
STREAM_STEPS = 4
STREAM_SHARD_LINES = STREAM_BATCH * STREAM_STEPS


def stream_shard_lines(i: int, n: int = STREAM_SHARD_LINES) -> list:
    """Shard ``i``'s lines: ``n`` lines of data/sample_train.txt from
    line ``i * 100``."""
    with open(os.path.join(REPO, "data", "sample_train.txt")) as fh:
        lines = fh.read().splitlines()
    return lines[i * 100:i * 100 + n]


def write_stream_run(wd: str, elastic: str = "off", min_auc: float = 0.5,
                     save_steps: int = 4, uniq_bucket: int = 256,
                     validation: str = "", val_batches: int = 8,
                     collective_timeout: float = 60,
                     metrics: bool = False) -> str:
    """A 2-worker stream config over ``<wd>/stream`` (created empty);
    ``validation`` defaults to data/sample_test.txt, swept
    ``val_batches`` batches a rank (0: all of it); ``metrics``: each
    worker writes its stream shard of ``<wd>/m.jsonl``, flushed every
    step. Returns its path."""
    os.makedirs(os.path.join(wd, "stream"), exist_ok=True)
    path = os.path.join(wd, "stream.cfg")
    with open(path, "w") as fh:
        fh.write(STREAM_CFG.format(
            wd=wd, elastic=elastic, min_auc=min_auc, save_steps=save_steps,
            uniq_bucket=uniq_bucket, val_batches=val_batches,
            collective_timeout=collective_timeout,
            metrics=("metrics_file = {}\nmetrics_flush_steps = 1\n"
                     .format(os.path.join(wd, "m.jsonl")) if metrics
                     else ""),
            validation=validation or os.path.join(REPO, "data",
                                                  "sample_test.txt"),
            hosts=worker_hosts(free_port(), 2)))
    return path


def stage_shard(wd: str, i: int, lines: list, pieces: int = 3) -> str:
    """Write ``<wd>/stream/part-<i>`` in ``pieces`` torn appends (each
    cut mid-line), then its ``.done`` marker."""
    path = os.path.join(wd, "stream", f"part-{i:05d}")
    blob = ("\n".join(lines) + "\n").encode()
    cuts = [len(blob) * k // pieces + 3 for k in range(1, pieces)]
    with open(path, "wb") as fh:
        prev = 0
        for cut in cuts + [len(blob)]:
            fh.write(blob[prev:cut])
            fh.flush()
            prev = cut
            time.sleep(0.05)
    open(path + ".done", "w").close()
    return path


def stop_stream(wd: str) -> None:
    open(os.path.join(wd, "stream", "STOP"), "w").close()


def wait_for(pred, procs: dict, wd: str, what: str,
             timeout: float = 180.0) -> None:
    """Poll ``pred()`` until true; fail with the logs if a process in
    ``procs`` exits first or ``timeout`` passes."""
    deadline = time.monotonic() + timeout
    while not pred():
        dead = {t: p.returncode for t, p in procs.items()
                if p.poll() is not None}
        if dead or time.monotonic() > deadline:
            logs = {t: open(os.path.join(wd, f"{t}.log")).read()
                    for t in procs}
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
            raise AssertionError(f"waiting for {what}: exited {dead}"
                                 + log_tails(logs))
        time.sleep(0.05)


def published_step(model_file: str) -> int:
    try:
        with open(os.path.join(model_file + ".ckpt", "published")) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return -1


def log_has(wd: str, tag: str, text: str) -> bool:
    with open(os.path.join(wd, f"{tag}.log")) as fh:
        return text in fh.read()


def step_cases():
    """(name, config keywords) of the step scenario's models."""
    base = dict(vocabulary_size=256, factor_num=4, batch_size=32,
                bucket_ladder=(8, 16), max_features_per_example=16,
                learning_rate=0.1, factor_lambda=1e-3, bias_lambda=1e-3,
                shuffle=False, init_value_range=0.1, dedup="host")
    return [("fm", dict(base)),
            ("ffm", dict(base, model_type="ffm", field_num=3)),
            ("order3", dict(base, order=3))]


def _lines(name, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = [str(int(rng.random() < 0.45))]
        k = int(rng.integers(1, 15))
        # Zipf ids: the hot ones appear on both ranks.
        ids = np.unique(np.minimum(rng.zipf(1.4, size=k), 255))
        for fid in ids:
            v = f"{rng.random() + 0.1:.4f}"
            toks.append(f"{int(rng.integers(0, 3))}:{fid}:{v}"
                        if name == "ffm" else f"{fid}:{v}")
        out.append(" ".join(toks))
    return out


def write_step_inputs(wd: str) -> None:
    """The step scenario's files: ``<model>.txt`` (600 lines) and the
    dense starting state ``<model>-init.npz`` of each case."""
    from fast_tffm_tpu_torch.config import FmConfig
    for i, (name, kw) in enumerate(step_cases()):
        with open(os.path.join(wd, f"{name}.txt"), "w") as fh:
            fh.write("\n".join(_lines(name, 600, 30 + i)) + "\n")
        cfg = FmConfig(**kw)
        rng = np.random.default_rng(40 + i)
        table = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                            ).astype(np.float32)
        table[-1] = 0.0
        np.savez(os.path.join(wd, f"{name}-init.npz"), table=table,
                 acc=np.full_like(table, cfg.adagrad_init))


def _cfg(wd, port, world, **kw):
    from fast_tffm_tpu_torch.config import FmConfig
    return FmConfig(worker_hosts=tuple(worker_hosts(port, world).split(",")),
                    heartbeat_seconds=0.0, collective_timeout_seconds=60.0,
                    cluster_connect_timeout_seconds=60.0,
                    model_file=os.path.join(wd, "model", "fm"), **kw)


def _step(rank, world, port, wd, device):
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator, empty_batch
    from fast_tffm_tpu_torch.models.fm import (ModelSpec, batch_args,
                                               sharded_score_body,
                                               sharded_train_step_body)
    from fast_tffm_tpu_torch.parallel.distributed import init_from_cluster
    from fast_tffm_tpu_torch.parallel.sharded import make_mesh, place_table
    out = {}
    first = True
    for name, kw in step_cases():
        cfg = _cfg(wd, port, world, **kw)
        if first:
            init_from_cluster(cfg, "worker", rank)
            first = False
        mesh = make_mesh(cfg, rank, world)
        spec = ModelSpec.from_config(cfg, num_processes=world)
        init = np.load(os.path.join(wd, f"{name}-init.npz"))
        table = place_table(cfg, mesh, init["table"], device)
        acc = place_table(cfg, mesh, init["acc"], device,
                          fill=cfg.adagrad_init)
        it = batch_iterator(cfg, [os.path.join(wd, f"{name}.txt")],
                            training=False, epochs=1, shard_index=rank,
                            num_shards=world, fixed_shape=True,
                            uniq_bucket=UNIQ_BUCKET, raw_ids=False)
        for s in range(STEPS + 1):
            batch = next(it)
            if s == FILLER_STEP and rank == 1:
                batch = empty_batch(cfg, uniq_bucket=UNIQ_BUCKET)
            for k in ("labels", "weights", "uniq_ids", "local_idx", "vals",
                      "fields"):
                v = getattr(batch, k)
                if v is not None:
                    out[f"{name}/b{s}/{k}"] = v
            args = batch_args(batch, device)
            args["uniq_ids"] = batch.uniq_ids
            if s < STEPS:
                table, acc, loss, _ = sharded_train_step_body(
                    spec, mesh, table, acc, **args)
                out[f"{name}/loss{s}"] = np.float32(loss.item())
            else:
                del args["labels"], args["weights"]
                with torch.no_grad():
                    out[f"{name}/scores"] = sharded_score_body(
                        spec, mesh, table, **args).cpu().numpy()
        out[f"{name}/table"] = table.cpu().numpy()
        out[f"{name}/acc"] = acc.cpu().numpy()
    ckpt = CheckpointState(cfg.model_file, mesh=mesh)
    out["broadcast_int"] = ckpt._broadcast_int(7 + 10 * rank)
    out["agree_true"] = ckpt._all_agree(True)
    out["agree_one_false"] = ckpt._all_agree(rank == 0)
    ckpt.close()
    return out


def _cli(faults, argv):
    """The port's CLI with ``faults`` planted (the module docstring)."""
    import signal

    def die():
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    records = []

    for fault in faults.split(","):
        if fault.startswith("kill-at-step-"):
            from fast_tffm_tpu_torch import train as port_train
            last = int(fault[len("kill-at-step-"):])
            real_step = port_train._Stepper.step

            def step(self, batch, epoch):
                if self.global_step >= last:
                    die()
                return real_step(self, batch, epoch)
            port_train._Stepper.step = step
        elif fault.startswith(("kill-in-save-after-step-",
                               "stop-in-save-after-step-")):
            _lost_in_save(int(fault.rsplit("-", 1)[1]),
                          signal.SIGKILL if fault.startswith("kill")
                          else signal.SIGSTOP)
        elif fault == "kill-at-announce":
            from fast_tffm_tpu_torch.parallel import liveness
            real_announce = liveness.HeartbeatLease.announce_reform

            def announce(self, generation):
                real_announce(self, generation)
                die()
            liveness.HeartbeatLease.announce_reform = announce
        elif fault == "keep-steps":
            from fast_tffm_tpu_torch.checkpoint import CheckpointState
            CheckpointState._delete_old_steps = lambda self: None
        elif fault == "record-steps":
            _record_steps(records)
        elif fault == "record-threads":
            _record_threads(records)
        elif fault != "none":
            raise ValueError(f"unknown fault {fault!r}")
    from fast_tffm_tpu_torch.__main__ import main as cli
    try:
        return cli(argv)
    finally:
        for write in records:
            write()


def _lost_in_save(last: int, sig) -> None:
    """Send this process ``sig`` as it enters the first gather to the
    chief of the first save past step ``last``: the chief is then in
    that save's gather on a peer that never sends (SIGKILL closes its
    connections; SIGSTOP keeps them open, as a killed process that is
    slow to die does)."""
    from fast_tffm_tpu_torch import train as port_train
    from fast_tffm_tpu_torch.parallel.sharded import ProcessMesh
    real_save = port_train._Stepper.save
    real_gather = ProcessMesh.gather_to_chief
    saving = []

    def save(self, *args, **kwargs):
        if self.global_step > last:
            saving.append(self.global_step)
        return real_save(self, *args, **kwargs)

    def gather(self, t, label):
        if saving and label.startswith("checkpoint/"):
            sys.stdout.flush()
            os.kill(os.getpid(), sig)
        return real_gather(self, t, label)
    port_train._Stepper.save = save
    ProcessMesh.gather_to_chief = gather


def _record_steps(records: list) -> None:
    import json
    from fast_tffm_tpu_torch import train as port_train
    real_step = port_train._Stepper.step
    real_exchange = port_train.exchange_watermarks
    seen = {}
    merges = []

    def exchange(local, mesh):
        merged = real_exchange(local, mesh)
        merges.append([local, merged])
        return merged
    port_train.exchange_watermarks = exchange

    def write_merges():
        with open(f"watermarks-{os.getpid()}.json", "w") as fh:
            json.dump(merges, fh)
    records.append(write_merges)

    def step(self, batch, epoch):
        s = len([k for k in seen if k.endswith("/filler")])
        seen[f"b{s}/filler"] = np.asarray(batch.stream_pos is None)
        for k in ("labels", "weights", "uniq_ids", "local_idx", "vals"):
            seen[f"b{s}/{k}"] = np.asarray(getattr(batch, k))
        return real_step(self, batch, epoch)
    port_train._Stepper.step = step
    records.append(lambda: np.savez(f"steps-{os.getpid()}.npz", **seen))


def _record_threads(records: list) -> None:
    import json
    import threading
    from fast_tffm_tpu_torch.parallel.sharded import ProcessMesh
    seen = []
    for name in ("all_gather_host", "broadcast_object"):
        real = getattr(ProcessMesh, name)

        def wrapped(self, *args, _real=real, **kwargs):
            label = args[-1] if args and isinstance(args[-1], str) \
                else kwargs.get("label")
            seen.append([label, threading.current_thread().name])
            return _real(self, *args, **kwargs)
        setattr(ProcessMesh, name, wrapped)

    def write():
        with open(f"threads-{os.getpid()}.json", "w") as fh:
            json.dump(seen, fh)
    records.append(write)


def main(argv):
    if argv[0] == "cli":
        assert argv[2] == "--", argv
        return _cli(argv[1], argv[3:])
    scenario, rank, world, port, wd = argv[:5]
    device = torch.device(argv[5] if len(argv) > 5 else "cpu")
    rank, world, port = int(rank), int(world), int(port)
    torch.set_num_threads(1)
    out = {"step": _step}[scenario](rank, world, port, wd, device)
    np.savez(os.path.join(wd, f"{scenario}-rank{rank}.npz"), **out)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
