"""Row-sharded multi-process training and scoring — the port's
counterpart of ``fast_tffm_tpu/parallel/sharded.py``.

The JAX package runs SPMD over a ``("data", "model")`` mesh: the batch
is sharded over ``data`` and the table and its Adagrad accumulator are
row-sharded over every device, so the mesh is the parameter server.
The port's mesh is the process group (``ProcessMesh``): one device per
rank, the data over all ranks (each reads its own byte range of the
input), and the table rows over all ranks — rank r holds the rows
``[r·R/W, (r+1)·R/W)`` of the ``[cfg.ckpt_rows, D]`` layout (R rows, W
ranks), the checkpoint's own layout, so a step saved by W ranks
restores on any power-of-two count. A ``model`` axis longer than one
has no counterpart with one device per rank and is refused.

A step is the JAX single-device ``train_step_body`` on the GLOBAL
batch, the ranks' local batches concatenated
(models/fm.sharded_train_step_body): the ranks' ``uniq_ids`` are
all-gathered on the host, each rank fills the rows it owns and an
all-reduce sums them, so every rank holds the global ``[W·U, D]`` row
block; each rank runs the forward and backward through the usual
scorers (the CUDA kernels for a 2nd-order FM on the card) on its local
batch, its ``local_idx`` offset into its own block
(``offset_local_idx``); a second all-reduce sums the row gradients, and
each owner applies Adagrad to its rows over the concatenated (ids,
gradients) in slot order. An id hot on two ranks takes one slot per
rank, as in the JAX package's ``global_batch``: its accumulator gains
the sum of the per-rank squared gradients and its L2 term counts once
per rank. The loss is normalised by the global batch's weight.

Collectives ride torch.distributed's gloo group: host arrays (the ids,
the lockstep flags) as CPU tensors, the row blocks as tensors on the
card (the card's torch accepts gloo's all-reduce, all-gather, broadcast
and gather on CUDA tensors, so nothing is staged by hand). Every
collective is issued asynchronously and waited on under the deadline
guard (parallel/liveness.py ``guarded_work``), so an elastic job can
abandon one that a dead peer left pending.

``lockstep_score_batches`` is the one implementation of the windowed
lockstep protocol that distributed validation and multi-process predict
share: the ranks agree once per ``LOCKSTEP_WINDOW`` batches on how many
score programs to run (a rank whose shard ran dry scores all-padding
filler), and a SIGTERM on one rank stops every rank at the same window.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.parallel.liveness import guarded_work

# Batches agreed on per lockstep round: one flags all-gather covers this
# many score programs.
LOCKSTEP_WINDOW = 8


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The process group as a mesh: ``size`` ranks, this one ``rank``,
    each owning ``rows // size`` rows of the ``[rows, D]`` table layout
    (``rows`` = ``cfg.ckpt_rows``), over torch.distributed's default
    group."""
    rank: int
    size: int
    rows: int

    @property
    def rows_per_rank(self) -> int:
        return self.rows // self.size

    @property
    def lo(self) -> int:
        return self.rank * self.rows_per_rank

    @property
    def hi(self) -> int:
        return self.lo + self.rows_per_rank

    # -- host collectives (CPU tensors) ------------------------------------
    def all_gather_host(self, arr, label: str) -> np.ndarray:
        """``[size, *arr.shape]``: every rank's ``arr`` (same shape and
        dtype on every rank), in rank order."""
        import torch.distributed as dist
        t = torch.as_tensor(np.ascontiguousarray(arr))
        out = [torch.empty_like(t) for _ in range(self.size)]
        guarded_work(lambda: dist.all_gather(out, t, async_op=True), label)
        return torch.stack(out).numpy()

    def broadcast_object(self, obj, label: str):
        """Rank 0's picklable ``obj`` on every rank: its pickle's length,
        then its bytes, broadcast from rank 0."""
        import pickle

        import torch.distributed as dist
        blob = pickle.dumps(obj) if self.rank == 0 else b""
        n = torch.tensor([len(blob)], dtype=torch.int64)
        guarded_work(lambda: dist.broadcast(n, src=0, async_op=True), label)
        buf = (torch.frombuffer(bytearray(blob), dtype=torch.uint8)
               if self.rank == 0 else torch.empty(int(n), dtype=torch.uint8))
        guarded_work(lambda: dist.broadcast(buf, src=0, async_op=True),
                     label)
        return obj if self.rank == 0 else pickle.loads(buf.numpy().tobytes())

    def barrier(self, label: str) -> None:
        self.all_gather_host(np.zeros(1, np.int32), label)

    # -- device collectives -------------------------------------------------
    def all_reduce_(self, t: torch.Tensor, label: str) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (on the card or the CPU)."""
        import torch.distributed as dist
        guarded_work(lambda: dist.all_reduce(t, async_op=True), label)
        return t

    def gather_to_chief(self, t: torch.Tensor, label: str
                        ) -> Optional[list]:
        """Rank 0 gets every rank's ``t`` (a CPU tensor of one shape on
        every rank), in rank order; the others get None."""
        import torch.distributed as dist
        out = ([torch.empty_like(t) for _ in range(self.size)]
               if self.rank == 0 else None)
        guarded_work(lambda: dist.gather(t, out, dst=0, async_op=True),
                     label)
        return out

    # -- the row exchange ------------------------------------------------------
    def owned(self, ids: torch.Tensor) -> torch.Tensor:
        """Mask of the ``ids`` whose rows this rank holds."""
        return (ids >= self.lo) & (ids < self.hi)

    def gather_rows(self, shard: torch.Tensor, ids: torch.Tensor,
                    extra: Optional[torch.Tensor] = None,
                    label: str = "rows/gather"
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The rows ``ids`` name (global row ids, any rank's), from the
        owners' shards: each rank fills the rows it owns and an
        all-reduce sums the blocks (one owner a row: the sum is the row,
        exactly). ``extra``, a scalar per rank, rides the same
        all-reduce and comes back summed."""
        n, d = int(ids.shape[0]), int(shard.shape[1])
        buf = torch.zeros((n + 1, d), dtype=shard.dtype, device=shard.device)
        mask = self.owned(ids)
        if extra is not None:
            buf[n, 0] = extra
        buf[:n][mask] = shard.index_select(0, ids[mask] - self.lo)
        self.all_reduce_(buf, label)
        return buf[:n], (buf[n, 0] if extra is not None else None)


def make_mesh(cfg: FmConfig, rank: int, size: int,
              model_axis: int = 1) -> ProcessMesh:
    """The process group as a mesh over ``size`` ranks, with the JAX
    ``make_mesh``'s checks: a power-of-two count (<= 4096, so the
    4096-aligned ``ckpt_rows`` shard evenly; <= 64 on the data axis, so
    the power-of-two unique buckets split evenly)."""
    if model_axis != 1:
        raise ValueError(
            f"model_axis = {model_axis}: with one device per process the "
            "port's mesh is the process group alone (data over all ranks, "
            "table rows over all ranks); a model axis has no counterpart")
    n = int(size)
    if n <= 0 or n & (n - 1) or n > 4096:
        raise ValueError(
            f"process count {n} must be a power of two <= 4096 so the "
            "4096-aligned table rows (FmConfig.ckpt_rows) shard evenly")
    if n > 64:
        raise ValueError(
            f"data axis size {n} must be a power of two <= 64 so the "
            "pipeline's power-of-two unique-id buckets shard evenly")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} out of range for {n} processes")
    return ProcessMesh(rank=int(rank), size=n, rows=padded_num_rows(cfg, n))


def padded_num_rows(cfg: FmConfig, size: int) -> int:
    """Table rows over the mesh: the checkpoint's row layout
    (``cfg.ckpt_rows``, a multiple of 4096), so runtime, save and restore
    share one shape on any topology. The rows past ``pad_id`` are never
    gathered or updated."""
    rows = cfg.ckpt_rows
    assert rows % size == 0, (rows, size)  # make_mesh: pow2 <= 4096
    return rows


def _require_host_dedup(spec) -> None:
    """Sharded steps take the host-side unique contract (fixed-U
    ``uniq_ids``, local_idx into them); a raw-ids spec would feed slot
    indices as row ids. ``dedup = auto`` resolves to host on more than
    one rank (models/fm.ModelSpec.from_config)."""
    if spec.dedup == "device":
        raise ValueError(
            "dedup = device is for the single-device step only; sharded "
            "steps require dedup = host (dedup = auto resolves to host "
            "when more than one process runs)")


def init_sharded_state(cfg: FmConfig, mesh: ProcessMesh, seed: int,
                       device: torch.device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``(table, acc)`` shards, ``[rows_per_rank, D]`` each,
    drawn on ``device`` alone (a 10^9-row table never exists on one
    host): table rows uniform(±init_value_range) from a generator seeded
    ``seed`` and the rank, zero from ``pad_id`` on; the accumulator
    ``adagrad_init`` everywhere, as the JAX package's sharded init."""
    r = cfg.init_value_range
    gen = torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + mesh.rank)
    shape = (mesh.rows_per_rank, cfg.row_dim)
    table = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32) * (2.0 * r) - r
    dead = max(cfg.pad_id - mesh.lo, 0)
    if dead < mesh.rows_per_rank:
        table[dead:] = 0.0
    acc = torch.full(shape, cfg.adagrad_init, dtype=torch.float32,
                     device=device)
    return table, acc


def place_table(cfg: FmConfig, mesh: ProcessMesh, table,
                device: torch.device, fill: float = 0.0) -> torch.Tensor:
    """This rank's shard of a dense ``[num_rows or ckpt_rows, D]`` table
    (numpy or torch), the rows past it filled with ``fill`` (0 for a
    table, ``adagrad_init`` for an accumulator), on ``device``."""
    t = torch.as_tensor(np.asarray(table) if not torch.is_tensor(table)
                        else table).to(torch.float32)
    out = torch.full((mesh.rows_per_rank, int(t.shape[1])), float(fill),
                     dtype=torch.float32)
    n = max(0, min(int(t.shape[0]), mesh.hi) - mesh.lo)
    if n:
        out[:n] = t[mesh.lo:mesh.lo + n].cpu()
    return out.to(device)


def offset_local_idx(local_idx, process_index: int,
                     local_uniq_size: int):
    """Rank p's ``local_idx`` index its own unique block; shifted by
    ``p · U`` they index the concatenated global unique axis (numpy or
    torch). The JAX package's ``global_batch`` assembles the global
    arrays with it; the port's ranks never assemble them (the row
    exchange gives each rank the global row block it indexes)."""
    return local_idx + int(process_index) * int(local_uniq_size)


def lockstep_score_batches(cfg: FmConfig, it: Iterator, mesh: ProcessMesh,
                           score_fn, table: torch.Tensor, uniq_bucket: int,
                           max_batches: Optional[int] = None,
                           preempt=None):
    """Drive a rank's batch iterator through the sharded ``score_fn``
    (``score_fn(table, batch) -> [B]`` scores on the card, a collective)
    in lockstep: yields ``(batch, local scores as numpy)`` per batch of
    ``it``. Once per window the ranks all-gather how many batches each
    holds (up to LOCKSTEP_WINDOW; at most ``max_batches`` real ones in
    all) and a preemption flag; every rank then runs the window's
    maximum of score programs, its own batches first and all-padding
    filler after. A flag on any rank ends the sweep on every rank at
    that window, before any of its programs; a window in which every
    rank is dry ends it. Each window's scores are fetched after its
    programs, one copy to the host."""
    from fast_tffm_tpu_torch.data.pipeline import empty_batch
    n_real = 0
    filler = None
    while True:
        window = []
        while len(window) < LOCKSTEP_WINDOW:
            if max_batches and n_real + len(window) >= max_batches:
                break
            b = next(it, None)
            if b is None:
                break
            window.append(b)
        stop = 1 if (preempt is not None and preempt()) else 0
        flags = mesh.all_gather_host(
            np.asarray([len(window), stop], np.int64),
            "lockstep/window_fill").reshape(-1, 2)
        if flags[:, 1].any():
            return
        rounds = int(flags[:, 0].max())
        if rounds == 0:
            return
        scores = []
        for i in range(rounds):
            if i < len(window):
                batch = window[i]
            else:
                if filler is None:
                    filler = empty_batch(cfg, uniq_bucket=uniq_bucket)
                batch = filler
            s = score_fn(table, batch)
            if i < len(window):
                scores.append(s)
        n_real += len(window)
        if scores:
            host = torch.stack(scores).cpu().numpy()
            for batch, local in zip(window, host):
                yield batch, local
