"""Embedding-lookup backends for ``lookup = host`` — the port's
counterpart of ``fast_tffm_tpu/lookup.py`` (BASELINE config #5: a
10⁹-feature hashed table and its Adagrad accumulator, 8·(k+1) GB each,
do not fit beside anything else in the card's memory).

The seam is the JAX package's: the card computes everything between
"gathered rows in" and "row gradients out" (``models/fm.grad_body``,
``rows_score_body``); a backend owns the storage and three methods:

- ``gather(uniq_ids) -> [U, D]`` rows on the backend's device (pad
  slots, ``uniq_ids == pad_id``, read the zero pad row);
- ``apply_grad(uniq_ids, grad_rows, lr)``: sparse Adagrad on those rows
  (duplicate pad slots carry zero gradient);
- ``state() -> (table, acc)``: ``[ckpt_rows, D]`` float32 CPU tensors in
  the checkpoint layout, safe to read from the host when it returns.

Backends:

- ``PinnedHostLookup`` (what ``make_offload_backend`` builds): the state
  is page-locked in place (``ops/offload_kernel.register_host``) and
  mapped for the card; the step's gather and its Adagrad write-back are
  two kernels (``csrc/offload_rows.cu``) on the current stream that
  read and write that host memory directly, so a step never blocks
  Python — what ``compute_on("device_host")`` gives the JAX package.
  The card only holds each batch's ``[U, D]`` rows and their gradient.
  On the CPU (``mode = "plain"``) the state is plain CPU tensors and
  the kernels' plain versions run.
- ``HostOffloadLookup``: the JAX package's numpy backend. ``gather`` is
  an ``index_select`` into a pinned staging block copied to the card;
  ``apply_grad`` copies the gradient to the host — a blocking copy,
  the backend's nature — and updates the rows on the CPU. Built only by
  direct construction.

Backends run on the card unless the caller asks for the CPU
(``device="cpu"``), as the port's entry points do
(``utils/device.resolve_device``). Deliberate difference from the JAX
package: on the card a failed build or launch of the offload kernels
raises; nothing falls back to ``HostOffloadLookup`` (the JAX probe does,
with a warning).

The table is drawn on the CPU in chunks from a ``torch.Generator``
seeded with ``seed``, straight into the state tensor
(``init_host_state``): no device copy and no second copy. On the CPU it
equals ``models/fm.init_table`` drawn from the same seed. Rows past the
pad row are 0 in the table and ``adagrad_init`` in the accumulator, as a
checkpoint pads them. A restored state is adopted and page-locked in
place.

``reset_rows(rows, adagrad_init)`` is the backends' half of the
vocabulary eviction seam (``vocab_mode = admit``, vocab/table.py): the
barrier's freed rows are cold-started in place on the CPU, zero in the
table and ``adagrad_init`` in the accumulator. ``PinnedHostLookup``
waits for the card's queued writes into its page-locked state first
(``state()``), and returns with the writes done, so the next gather
reads them.
"""

from __future__ import annotations

import os
import resource
from typing import Optional, Tuple

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.memory import (FAKE_CAPACITY_ENV,
                                            device_memory_stats, table_bytes)
from fast_tffm_tpu_torch.ops import offload_kernel
from fast_tffm_tpu_torch.ops.offload_kernel import (offload_adagrad,
                                                    offload_gather)
from fast_tffm_tpu_torch.utils.device import resolve_device
from fast_tffm_tpu_torch.vocab.table import reset_table_rows

# Rows drawn per chunk of the host init: 2^22 rows of 9 floats is 151 MB
# of generator output at a time.
INIT_CHUNK_ROWS = 1 << 22


def init_host_state(cfg: FmConfig, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table, acc)`` ``[ckpt_rows, D]`` float32 CPU tensors: rows below
    the pad row uniform(-init_value_range, +init_value_range), drawn in
    chunks from a CPU generator into the table itself; the pad row and
    the alignment tail 0; the accumulator ``adagrad_init`` throughout."""
    rows, dim = cfg.ckpt_rows, cfg.row_dim
    table = torch.empty((rows, dim), dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    r = cfg.init_value_range
    live = cfg.num_rows - 1
    for a in range(0, live, INIT_CHUNK_ROWS):
        b = min(a + INIT_CHUNK_ROWS, live)
        chunk = table[a:b]
        torch.rand((b - a, dim), generator=gen, out=chunk)
        # init_table's arithmetic: rand * (2r) - r.
        chunk.mul_(2.0 * r).sub_(r)
    table[live:].zero_()
    acc = torch.full((rows, dim), cfg.adagrad_init, dtype=torch.float32)
    return table, acc


def _stored_layout(t: torch.Tensor, rows: int, dim: int,
                  what: str = "restored table") -> torch.Tensor:
    """``t`` as the full ``[rows, D]`` float32 tensor it is or heads: a
    restore hands back ``[num_rows, D]`` views of the stored tensors, and
    the state adopts the stored tensor itself (no copy)."""
    if t.dtype != torch.float32 or t.device.type != "cpu" or t.dim() != 2:
        raise ValueError(f"{what} must be a float32 CPU tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(t.shape) == (rows, dim) and t.is_contiguous():
        return t
    storage = t.untyped_storage()
    if (t.storage_offset() == 0 and t.shape[1] == dim and t.shape[0] <= rows
            and t.stride() == (dim, 1)
            and storage.nbytes() == table_bytes(rows=rows, dim=dim)):
        return torch.empty(0, dtype=torch.float32).set_(storage, 0,
                                                        (rows, dim))
    raise ValueError(f"{what} shape {tuple(t.shape)} != {(rows, dim)}")


def _restore(cfg: FmConfig, with_acc: bool):
    """The newest intact checkpoint step as CPU tensors, table only
    unless ``with_acc``."""
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    from fast_tffm_tpu_torch.train import (check_restored_vocab,
                                           checkpoint_template)
    from fast_tffm_tpu_torch.utils.retry import RetryPolicy
    ckpt = CheckpointState(cfg.model_file,
                           retry=RetryPolicy.from_config(cfg),
                           verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init)
    try:
        template = checkpoint_template(cfg, acc=with_acc)
        restored = (ckpt.restore(template=template) if with_acc
                    else ckpt.restore_partial(template))
    finally:
        ckpt.close()
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint found under {cfg.model_file}.ckpt")
    check_restored_vocab(cfg, restored)
    return restored


def _check_for_table(cfg: FmConfig, table: torch.Tensor) -> None:
    if (table.dim() != 2 or table.shape[0] not in (cfg.num_rows,
                                                  cfg.ckpt_rows)
            or table.shape[1] != cfg.row_dim):
        raise ValueError(
            f"table shape {tuple(table.shape)} matches neither the "
            f"logical [{cfg.num_rows}, {cfg.row_dim}] nor the checkpoint "
            f"[{cfg.ckpt_rows}, {cfg.row_dim}] layout")


def _as_ids(uniq_ids, device: torch.device) -> torch.Tensor:
    """Ids as a contiguous int32 tensor on ``device`` (numpy arrays from the
    packed wire's withheld ``host_uniq`` go through pinned memory)."""
    if isinstance(uniq_ids, np.ndarray):
        uniq_ids = torch.from_numpy(np.ascontiguousarray(uniq_ids,
                                                         dtype=np.int32))
    uniq_ids = uniq_ids.to(dtype=torch.int32)
    if uniq_ids.device.type == "cpu" and device.type == "cuda":
        return uniq_ids.pin_memory().to(device, non_blocking=True)
    return uniq_ids.to(device).contiguous()


class HostOffloadLookup:
    """Host-RAM embedding store with a blocking per-step update: the
    JAX package's numpy backend. ``device`` is where ``gather`` returns
    rows; the state always stays on the CPU."""

    def __init__(self, cfg: FmConfig, seed: int = 0, _init: bool = True,
                 device=None):
        self.cfg = cfg
        self.rows = cfg.ckpt_rows
        self.dim = cfg.row_dim
        self.device = resolve_device(device)
        self.table: Optional[torch.Tensor] = None
        self.acc: Optional[torch.Tensor] = None
        if _init:
            self.table, self.acc = init_host_state(cfg, seed)

    def gather(self, uniq_ids) -> torch.Tensor:
        """[U] ids -> [U, D] rows on ``device``: an ``index_select`` into
        a pinned staging block (caching host allocator: a block is not
        reused before its copy ends), copied to the card."""
        ids = _as_ids(uniq_ids, torch.device("cpu")).long()
        if self.device.type != "cuda":
            return self.table.index_select(0, ids)
        stage = torch.empty((ids.shape[0], self.dim), dtype=torch.float32,
                            pin_memory=True)
        torch.index_select(self.table, 0, ids, out=stage)
        return stage.to(self.device, non_blocking=True)

    def apply_grad(self, uniq_ids, grad_rows, lr: float,
                   rows=None) -> None:
        """acc += g²; table -= lr·g/√acc on the touched rows, on the CPU;
        the gradient's copy to the host blocks until the step that made
        it has run. ``rows`` (the gathered rows) is not read: the host
        holds the same rows."""
        ids = _as_ids(uniq_ids, torch.device("cpu")).long()
        g = torch.as_tensor(grad_rows).to("cpu", torch.float32)
        a = self.acc.index_select(0, ids) + torch.square(g)
        self.acc.index_copy_(0, ids, a)
        self.table.index_copy_(
            0, ids, self.table.index_select(0, ids) - lr * g / torch.sqrt(a))

    def state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(table, acc) in the checkpoint layout; every update is already
        on the host."""
        return self.table, self.acc

    def reset_rows(self, rows, adagrad_init: float = 0.1) -> None:
        """Cold-start the given physical rows (the vocab barrier's
        eviction hook): zero embeddings and, when the backend holds one,
        the accumulator at ``adagrad_init``. Every step's update is
        already on the host (``apply_grad`` blocks), so the rows are
        written at once."""
        reset_table_rows(self.table, self.acc, rows, adagrad_init)

    def load(self, table: torch.Tensor,
             acc: Optional[torch.Tensor] = None) -> None:
        """Adopt restored tensors without a copy; ``acc=None`` leaves the
        accumulator unset (score-only use)."""
        self.table = _stored_layout(table, self.rows, self.dim)
        self.acc = (None if acc is None else
                    _stored_layout(acc, self.rows, self.dim, "restored acc"))

    @classmethod
    def for_table(cls, cfg: FmConfig, table: torch.Tensor,
                  device=None) -> "HostOffloadLookup":
        """Score-only backend around a caller-held CPU table, logical
        ``[num_rows, D]`` or checkpoint ``[ckpt_rows, D]`` layout (gather
        never reads past the pad row); no copy of a float32 table."""
        table = torch.as_tensor(table)
        _check_for_table(cfg, table)
        self = cls(cfg, _init=False, device=device)
        self.table = table.to("cpu", torch.float32).contiguous()
        return self

    @classmethod
    def from_checkpoint(cls, cfg: FmConfig, with_acc: bool = True,
                        device=None) -> "HostOffloadLookup":
        """Restore the newest intact step into host RAM; ``with_acc =
        False`` (predict) never reads the accumulator."""
        restored = _restore(cfg, with_acc)
        self = cls(cfg, _init=False, device=device)
        self.load(restored["table"], restored["acc"] if with_acc else None)
        self.step = int(restored["step"])
        return self


def probe_placement_mode(device) -> str:
    """``"plain"`` on the CPU; ``"pinned"`` on the card once the offload
    kernels' library is built and loaded. A failed build raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain"
    offload_kernel._library()
    return "pinned"


class PinnedHostLookup:
    """The offload backend: state in page-locked host memory the card
    addresses (``mode = "pinned"``, on the card), or plain CPU tensors
    (``mode = "plain"``, on the CPU); the gather and the write-back are
    the offload kernels, or their plain versions."""

    def __init__(self, cfg: FmConfig, seed: int = 0, _init: bool = True,
                 device=None):
        self.cfg = cfg
        self.rows = cfg.ckpt_rows
        self.dim = cfg.row_dim
        self.device = resolve_device(device)
        self.mode = probe_placement_mode(self.device)
        self.table: Optional[torch.Tensor] = None
        self.acc: Optional[torch.Tensor] = None
        if _init:
            self._adopt(*init_host_state(cfg, seed))

    def _adopt(self, table: torch.Tensor,
               acc: Optional[torch.Tensor]) -> None:
        """Take ``table`` and ``acc`` as the state, page-locked in place
        in pinned mode (unregistered when the tensors are collected)."""
        if self.mode == "pinned":
            for t in (table, acc):
                if t is not None:
                    offload_kernel.register_host(t, self.device)
        self.table, self.acc = table, acc

    def gather(self, uniq_ids) -> torch.Tensor:
        """[U] ids -> [U, D] rows on ``device`` (the gather kernel)."""
        return offload_gather(self.table, _as_ids(uniq_ids, self.device))

    def apply_grad(self, uniq_ids, grad_rows: torch.Tensor, lr: float,
                   rows: Optional[torch.Tensor] = None) -> None:
        """Sparse Adagrad on the touched rows (the write-back kernel),
        in the stream: the gradient never comes to the host. ``rows``:
        the rows this step gathered; without them the rows are gathered
        again."""
        ids = _as_ids(uniq_ids, self.device)
        if rows is None:
            rows = self.gather(ids)
        offload_adagrad(self.table, self.acc, ids, rows,
                        grad_rows.to(self.device, torch.float32)
                        .contiguous(), lr)

    def sync(self) -> None:
        """Wait until the card's pending writes to the state are done."""
        if self.mode == "pinned":
            torch.cuda.synchronize(self.device)

    def state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(table, acc) in the checkpoint layout, once every write the
        card has queued to them is done: the host reads them next."""
        self.sync()
        return self.table, self.acc

    def reset_rows(self, rows, adagrad_init: float = 0.1) -> None:
        """Cold-start the given physical rows in place (the vocab
        barrier's eviction hook). The card may still have write-backs
        queued into the page-locked state: ``state()`` waits for them
        before the CPU writes the rows, and the writes are done when
        this returns, before the next gather is launched."""
        if self.acc is None:
            raise RuntimeError(
                "reset_rows needs the accumulator: eviction resets are "
                "a training-side operation (score-only backends never "
                "see a barrier)")
        table, acc = self.state()
        reset_table_rows(table, acc, rows, adagrad_init)

    def load(self, table: torch.Tensor,
             acc: Optional[torch.Tensor] = None) -> None:
        """Adopt restored CPU tensors as the state, page-locked in place
        (no copy); ``acc=None`` for score-only use."""
        self._adopt(_stored_layout(table, self.rows, self.dim),
                    None if acc is None else
                    _stored_layout(acc, self.rows, self.dim, "restored acc"))

    @classmethod
    def for_table(cls, cfg: FmConfig, table: torch.Tensor,
                  device=None) -> "PinnedHostLookup":
        """Score-only backend around a caller-held CPU table (logical or
        checkpoint layout): used in place when its memory is page-locked
        already (``train()``'s return), else page-locked in place."""
        table = torch.as_tensor(table)
        _check_for_table(cfg, table)
        self = cls(cfg, _init=False, device=device)
        table = table.to("cpu", torch.float32).contiguous()
        if self.mode == "pinned" and offload_kernel.is_page_locked(table):
            self.table = table
        else:
            self._adopt(table, None)
        return self

    @classmethod
    def from_checkpoint(cls, cfg: FmConfig, with_acc: bool = True,
                        device=None) -> "PinnedHostLookup":
        """Restore the newest intact step and adopt it as the state;
        ``with_acc = False`` (predict) never reads the accumulator."""
        restored = _restore(cfg, with_acc)
        self = cls(cfg, _init=False, device=device)
        self.load(restored["table"], restored["acc"] if with_acc else None)
        self.step = int(restored["step"])
        return self


def make_offload_backend(cfg: FmConfig, seed: int = 0, restored=None,
                         device=None) -> PinnedHostLookup:
    """The ``lookup = host`` train backend: ``PinnedHostLookup``, pinned
    on the card and plain on the CPU. ``restored``: a checkpoint already
    restored (train's restore at start), whose tensors are adopted."""
    lk = PinnedHostLookup(cfg, seed, _init=restored is None, device=device)
    if restored is not None:
        lk.load(restored["table"], restored["acc"])
    return lk


def make_score_backend(cfg: FmConfig, table: Optional[torch.Tensor] = None,
                       device=None) -> PinnedHostLookup:
    """The ``lookup = host`` predict backend: the newest intact step's
    table (no accumulator) or a caller-held table, score-only."""
    if table is None:
        return PinnedHostLookup.from_checkpoint(cfg, with_acc=False,
                                                device=device)
    return PinnedHostLookup.for_table(cfg, table, device=device)


def make_offload_train_step(spec, lk, lr: float):
    """One train step over a backend: ``step(labels, weights, uniq_ids,
    local_idx, vals, fields=None) -> (loss, scores)`` on the device,
    updating the backend's state in place: ``gather`` → ``grad_body`` →
    ``apply_grad`` on the gathered rows. ``PinnedHostLookup`` runs all
    three on the current stream; ``HostOffloadLookup``'s ``apply_grad``
    waits for the gradient."""
    from fast_tffm_tpu_torch.models.fm import grad_body

    def step(labels, weights, uniq_ids, local_idx, vals, fields=None):
        gathered = lk.gather(uniq_ids)
        loss, scores, grad = grad_body(spec, gathered, labels, weights,
                                       uniq_ids, local_idx, vals, fields)
        lk.apply_grad(uniq_ids, grad, lr, rows=gathered)
        return loss, scores

    return step


def memory_report() -> dict:
    """Host RSS now and at its peak, and the card's allocated bytes now,
    at their peak and in all, in MB. The host figures are /proc's VmRSS
    and VmHWM, this process image's own; where /proc lacks VmHWM (some
    container runtimes) the peak is getrusage's ru_maxrss, which can
    keep the RSS of the parent that forked the process across the exec.
    A device value is None when it was not measured (no card, or no
    statistic), never a fake 0."""
    rss = peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    try:
        with open("/proc/self/status") as fh:
            for ln in fh:
                if ln.startswith("VmRSS:"):
                    rss = int(ln.split()[1]) // 1024
                elif ln.startswith("VmHWM:"):
                    peak = int(ln.split()[1]) // 1024
    except OSError:
        pass
    out = {"host_rss_mb": rss, "host_peak_rss_mb": peak}
    # Through the one memory seam (obs/memory.device_memory_stats), and
    # only once this process has touched the card.
    stats = None
    if os.environ.get(FAKE_CAPACITY_ENV) or (torch.cuda.is_available()
                                             and torch.cuda.is_initialized()):
        stats = device_memory_stats()
    for key, name in (("device_in_use_mb", "bytes_in_use"),
                      ("device_peak_mb", "peak_bytes_in_use"),
                      ("device_limit_mb", "bytes_limit")):
        out[key] = (stats[name] >> 20 if stats and name in stats else None)
    return out
