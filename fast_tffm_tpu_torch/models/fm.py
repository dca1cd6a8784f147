"""Model assembly for the port: spec, table init, the score path and the
train step.

The single-device subset of ``fast_tffm_tpu/models/fm.py``:
``ModelSpec``, ``init_table``, ``init_accumulator``, ``resolved_kernel``,
``_scores``, ``rows_score_body``, ``score_body`` and ``train_step_body``:
(``_device_dedup`` for a raw-ids batch, none for a host-deduped one) →
gather → ``grad_body`` (``loss_and_scores`` and its gradient with respect
to the gathered rows) → ``sparse_adagrad_apply``; the packed wire's
``packed_train_step_body`` and ``packed_score_body``, which rebuild the
padded rectangles on the device (``wire.unpack_rectangles``) and run the
same bodies; and the offload seam's score side (lookup.py):
``packed_rows_score_body``, ``ships_raw_batches`` and
``make_batch_scorer``, whose backend arm scores the row block a backend
gathered.

``_scores`` dispatches as the JAX package's: FFM
(``model_type = ffm``) scores through ``ops/interaction.ffm_batch_scores``
and a higher-order FM (``order`` > 2) through ``anova_batch_scores``,
torch ops on the CPU and on the card alike (XLA ran them in the JAX
package; no Pallas kernel was involved). A 2nd-order FM scores through
``ops/fm_kernel.fm_batch_scores``: the CUDA kernels for tensors on the
card (forward, and in training the hand-written backward), their plain
versions for tensors on the CPU. The ``kernel`` key is accepted and
ignored (each entry point logs a ``kernel`` set to ``xla`` or
``pallas`` as having no effect: utils/ignored.py): on the card an
order-2 FM always runs the kernels. ``dedup`` resolves as the JAX
package resolves it (``auto`` → ``device`` on one process with ``lookup
= device``; ``host`` with ``lookup = host``, whose backend gathers by the
host-side unique, and on more than one process, whose sharded step needs
the host-side unique contract): ``device`` steps take raw-ids batches
and run the unique on the card, ``host`` steps take the pipeline's
host-deduped batches (``uniq_ids`` set), whose U is a ladder rung the
host picked, so the step never waits for the card to learn it.

Multi-process (``dist_train``; parallel/sharded.py):
``sharded_train_step_body`` is ``train_step_body`` on the global batch
of the ranks' local batches, over a row-sharded table, and
``sharded_score_body`` its forward; each rank scores its local batch
through the same ``_scores`` (the CUDA kernels on the card: the sharded
form of the JAX package's ``fm_batch_scores_pallas`` wrapper).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import DeviceBatch
from fast_tffm_tpu_torch.ops.fm_kernel import fm_batch_scores
from fast_tffm_tpu_torch.ops.interaction import (anova_batch_scores,
                                                 batch_reg,
                                                 ffm_batch_scores,
                                                 gather_rows)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The static subset of FmConfig the score path reads."""
    model_type: str
    order: int
    factor_num: int
    field_num: int
    vocabulary_size: int
    loss_type: str
    factor_lambda: float
    bias_lambda: float
    learning_rate: float
    dedup: str = "device"    # "device" or "host"; never "auto"

    @classmethod
    def from_config(cls, cfg: FmConfig,
                    num_processes: int = 1) -> "ModelSpec":
        """``num_processes``: the job's process count (train and predict
        pass theirs; every other caller runs one process)."""
        dedup = cfg.dedup
        if dedup == "auto":
            # Device dedup where it applies: one process with the table
            # on the card. The offload backend gathers by the host-side
            # unique (config.py refuses an explicit dedup = device
            # there), and the sharded step exchanges its rows.
            dedup = ("device" if num_processes == 1
                     and cfg.lookup == "device" else "host")
        return cls(model_type=cfg.model_type, order=cfg.order,
                   factor_num=cfg.factor_num, field_num=cfg.field_num,
                   vocabulary_size=cfg.vocabulary_size,
                   loss_type=cfg.loss_type, factor_lambda=cfg.factor_lambda,
                   bias_lambda=cfg.bias_lambda,
                   learning_rate=cfg.learning_rate, dedup=dedup)

    @property
    def row_dim(self) -> int:
        if self.model_type == "ffm":
            return self.factor_num * self.field_num + 1
        return self.factor_num + 1


def init_table(cfg: FmConfig, device: torch.device,
               generator: torch.Generator) -> torch.Tensor:
    """[vocab+1, D] uniform(-init_value_range, +init_value_range) — the
    reference's init — with the final padding row zeroed (it must stay
    dead). ``generator`` lives on ``device``; torch's generator gives
    other numbers than jax's PRNG from the same seed."""
    r = cfg.init_value_range
    t = torch.rand((cfg.num_rows, cfg.row_dim), generator=generator,
                   device=device, dtype=torch.float32)
    t = t * (2.0 * r) - r
    t[-1] = 0.0
    return t


def init_accumulator(cfg: FmConfig, device: torch.device) -> torch.Tensor:
    """Adagrad accumulator, full table size, constant ``adagrad_init``."""
    return torch.full((cfg.num_rows, cfg.row_dim), cfg.adagrad_init,
                      dtype=torch.float32, device=device)


def resolved_kernel(device: torch.device, spec: Optional[ModelSpec] = None
                    ) -> str:
    """What scores a batch on ``device``: for a 2nd-order FM the CUDA
    kernel on the card and its plain PyTorch version on the CPU; for FFM
    and a higher-order FM (``spec``) the torch ops everywhere."""
    if spec is not None and (spec.model_type == "ffm" or spec.order > 2):
        return "torch"
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _scores(spec: ModelSpec, params: torch.Tensor, local_idx: torch.Tensor,
            vals: torch.Tensor,
            fields: Optional[torch.Tensor]) -> torch.Tensor:
    if spec.model_type == "ffm":
        return ffm_batch_scores(params, spec.field_num, local_idx, fields,
                                vals)
    if spec.order > 2:
        return anova_batch_scores(params, local_idx, vals, spec.order)
    return fm_batch_scores(params, local_idx, vals)


def rows_score_body(spec: ModelSpec, gathered: torch.Tensor,
                    local_idx: torch.Tensor, vals: torch.Tensor,
                    fields: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference forward from a row block ``local_idx`` addresses."""
    return _scores(spec, gathered, local_idx, vals, fields)


def score_body(spec: ModelSpec, table: torch.Tensor, local_idx: torch.Tensor,
               vals: torch.Tensor, uniq_ids: Optional[torch.Tensor] = None,
               fields: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference forward. Raw-ids batch (``uniq_ids`` None): ``local_idx``
    holds raw table rows (pad cells = pad_id); the JAX package gathers
    ``table[local_idx]`` and scores the gathered block. Here every scorer
    reads ``table[local_idx]`` itself: the order-2 kernel in its row
    loads, the FFM and ANOVA scorers by their first gather. Host-deduped
    batch: the rows ``table[uniq_ids]`` are gathered and ``local_idx``
    indexes them. Both sum the same rows in the same slot order: the
    scores are equal to the bit."""
    if uniq_ids is not None:
        table = gather_rows(table, uniq_ids)
    return rows_score_body(spec, table, local_idx, vals, fields)


def _per_example_loss(spec: ModelSpec, scores: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    if spec.loss_type == "logistic":
        # Stable sigmoid cross-entropy with {0,1} labels. torch.maximum
        # splits the gradient of a tie at 0 evenly, as jnp.maximum does.
        return (torch.maximum(scores, torch.zeros_like(scores))
                - scores * labels
                + torch.log1p(torch.exp(-torch.abs(scores))))
    return torch.square(scores - labels)


def loss_and_scores(spec: ModelSpec, gathered: torch.Tensor,
                    labels: torch.Tensor, weights: torch.Tensor,
                    uniq_ids: torch.Tensor, local_idx: torch.Tensor,
                    vals: torch.Tensor,
                    fields: Optional[torch.Tensor] = None,
                    weight_sum: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-mean data loss + batch-active L2 reg. Zero-weight padding
    examples drop out of both value and gradient. ``weight_sum``: the
    normaliser, when these examples are a rank's part of a global batch
    (the global batch's weight; default this batch's)."""
    scores = _scores(spec, gathered, local_idx, vals, fields)
    per = _per_example_loss(spec, scores, labels)
    # Double where for the all-padding filler batch (sum(w) = 0): the
    # divisor is 1 there, so neither the value nor the gradient of the
    # branch not taken divides 0 by 0.
    wsum = weights.sum() if weight_sum is None else weight_sum
    nonzero = wsum > 0.0
    den = torch.where(nonzero, wsum, torch.ones_like(wsum))
    data_loss = torch.where(nonzero, (per * weights).sum() / den,
                            torch.zeros_like(wsum))
    reg = batch_reg(gathered, uniq_ids, spec.vocabulary_size,
                    spec.factor_lambda, spec.bias_lambda)
    return data_loss + reg, scores


def _device_dedup(spec: ModelSpec, raw_idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device unique of a raw-ids batch [B, L] (pad cells = pad_id):
    the sorted unique ids [U] and each cell's index into them [B, L],
    both int32. pad_id is the largest value, so it sorts last, as in
    the JAX package; the unpadded U needs no fill slots (the JAX
    package pads to B*L+1 only because its shapes are static)."""
    uniq, inv = torch.unique(raw_idx.reshape(-1), sorted=True,
                             return_inverse=True)
    return (uniq.to(torch.int32),
            inv.reshape(raw_idx.shape).to(torch.int32))


def sparse_adagrad_apply(table: torch.Tensor, acc: torch.Tensor,
                         uniq_ids: torch.Tensor, grad_rows: torch.Tensor,
                         lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """acc[rows] += g²; table[rows] -= lr * g / sqrt(acc[rows]), in place
    (the JAX package returns new arrays; here the update writes the
    touched rows of the resident table and accumulator). ``uniq_ids``
    are unique and padding rows carry zero gradients."""
    with torch.no_grad():
        rows = uniq_ids.long()
        acc.index_add_(0, rows, torch.square(grad_rows))
        upd = (-lr * grad_rows) * torch.rsqrt(acc.index_select(0, rows))
        table.index_add_(0, rows, upd)
    return table, acc


def grad_body(spec: ModelSpec, gathered: torch.Tensor,
              labels: torch.Tensor, weights: torch.Tensor,
              uniq_ids: torch.Tensor, local_idx: torch.Tensor,
              vals: torch.Tensor, fields: Optional[torch.Tensor] = None,
              weight_sum: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Loss, scores and the gradient with respect to the gathered
    ``[U, D]`` rows, padding rows masked to zero."""
    with torch.enable_grad():
        rows = gathered.detach().requires_grad_(True)
        loss, scores = loss_and_scores(spec, rows, labels, weights,
                                       uniq_ids, local_idx, vals, fields,
                                       weight_sum=weight_sum)
        (grad,) = torch.autograd.grad(loss, rows)
    live = (uniq_ids < spec.vocabulary_size).to(grad.dtype)[:, None]
    return loss.detach(), scores.detach(), grad * live


def train_step_body(spec: ModelSpec, table: torch.Tensor,
                    acc: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, local_idx: torch.Tensor,
                    vals: torch.Tensor,
                    uniq_ids: Optional[torch.Tensor] = None,
                    fields: Optional[torch.Tensor] = None):
    """One training step: gather → loss and gradient → sparse Adagrad.
    ``dedup = device``: a raw-ids batch (``uniq_ids`` None), uniqued on
    the device first. ``dedup = host``: the batch's ``uniq_ids`` (pad_id
    padding, whose rows get zero gradient) and ``local_idx`` into them.
    ``fields``: an FFM batch's. Returns ``(table, acc, loss, scores)``;
    ``table`` and ``acc`` are updated in place."""
    if (uniq_ids is None) != (spec.dedup == "device"):
        # Slot indices read as feature ids (or the reverse) would
        # silently train the wrong rows.
        raise ValueError(
            f"dedup = {spec.dedup} step got a "
            f"{'raw-ids' if uniq_ids is None else 'host-deduped'} batch; "
            f"build batches with raw_ids={spec.dedup == 'device'}")
    if uniq_ids is None:
        uniq_ids, local_idx = _device_dedup(spec, local_idx)
    gathered = gather_rows(table, uniq_ids)
    loss, scores, grad = grad_body(spec, gathered, labels, weights,
                                   uniq_ids, local_idx, vals, fields)
    table, acc = sparse_adagrad_apply(table, acc, uniq_ids, grad,
                                      spec.learning_rate)
    return table, acc, loss, scores


def _global_rows(spec: ModelSpec, mesh, table: torch.Tensor,
                 uniq_ids, extra: Optional[torch.Tensor] = None):
    """The row exchange's first half: the ranks' ``uniq_ids`` (a host
    array or CPU tensor of the one fixed U) all-gathered into the global
    unique axis, and its ``[W·U, D]`` rows from their owners' shards.
    Returns ``(global ids on the table's device, rows, U, summed
    extra)``."""
    ids = np.asarray(uniq_ids.numpy() if torch.is_tensor(uniq_ids)
                     else uniq_ids, dtype=np.int32)
    gids = torch.from_numpy(
        mesh.all_gather_host(ids, "step/uniq_ids").reshape(-1)
        .astype(np.int64)).to(table.device)
    rows, total = mesh.gather_rows(table, gids, extra)
    return gids, rows, len(ids), total


def sharded_train_step_body(spec: ModelSpec, mesh, table: torch.Tensor,
                            acc: torch.Tensor, labels: torch.Tensor,
                            weights: torch.Tensor, local_idx: torch.Tensor,
                            vals: torch.Tensor, uniq_ids,
                            fields: Optional[torch.Tensor] = None):
    """One step of ``train_step_body`` on the global batch — the ranks'
    local batches concatenated — over the row-sharded ``table`` and
    ``acc`` (this rank's ``[rows_per_rank, D]`` shards of a
    ``parallel.sharded.ProcessMesh``, updated in place). Every rank
    calls it at the same step with a fixed-shape, host-deduped local
    batch: ``uniq_ids`` on the host (they are all-gathered there), the
    other arrays on the table's device.

    The ranks' row blocks come from their owners (``_global_rows``);
    this rank's examples score through ``_scores`` on its own block
    (``local_idx`` offset by rank·U) against the global batch's weight,
    and its regulariser covers its own slots, so its gradient is its
    part of the global one; an all-reduce sums the parts (the loss with
    them), and each owner applies ``sparse_adagrad_apply``'s update to
    its rows over the concatenated (ids, gradients): every rank's block
    adds its squared gradients to the accumulator in slot order, then
    every slot's update reads the summed accumulator. Returns ``(table,
    acc, global loss, local scores)``."""
    from fast_tffm_tpu_torch.parallel.sharded import offset_local_idx
    gids, rows, U, wsum = _global_rows(spec, mesh, table, uniq_ids,
                                       extra=weights.sum())
    own = torch.zeros_like(gids, dtype=torch.bool)
    own[mesh.rank * U:(mesh.rank + 1) * U] = True
    # Slots of other ranks count as padding here: masked out of this
    # rank's regulariser and gradient (their owners add them).
    reg_ids = torch.where(own, gids, torch.full_like(gids,
                                                     spec.vocabulary_size))
    loss, scores, grad = grad_body(
        spec, rows, labels, weights, reg_ids,
        offset_local_idx(local_idx, mesh.rank, U), vals, fields,
        weight_sum=wsum)
    n, d = grad.shape
    gbuf = torch.empty((n + 1, d), dtype=grad.dtype, device=grad.device)
    gbuf[:n] = grad
    gbuf[n] = 0.0
    gbuf[n, 0] = loss
    mesh.all_reduce_(gbuf, "step/row_grads")
    grad, loss = gbuf[:n], gbuf[n, 0]
    with torch.no_grad():
        mine = mesh.owned(gids)
        blocks = []
        for r in range(mesh.size):
            m = mine[r * U:(r + 1) * U]
            blocks.append((gids[r * U:(r + 1) * U][m] - mesh.lo,
                           grad[r * U:(r + 1) * U][m]))
        # Slot order: rank 0's block first. Within a block the ids are
        # unique (pad slots carry zero gradients), so each index_add_
        # adds every row once and the result repeats to the bit.
        for rows_r, g in blocks:
            acc.index_add_(0, rows_r, torch.square(g))
        for rows_r, g in blocks:
            upd = (-spec.learning_rate * g) * torch.rsqrt(
                acc.index_select(0, rows_r))
            table.index_add_(0, rows_r, upd)
    return table, acc, loss, scores


def sharded_score_body(spec: ModelSpec, mesh, table: torch.Tensor,
                       local_idx: torch.Tensor, vals: torch.Tensor,
                       uniq_ids, fields: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The sharded forward: the global row block from the owners, then
    this rank's local batch through ``_scores`` (a 2nd-order FM through
    the CUDA forward kernel on the card). A collective: every rank calls
    it with a batch of the one fixed shape."""
    from fast_tffm_tpu_torch.parallel.sharded import offset_local_idx
    _, rows, U, _ = _global_rows(spec, mesh, table, uniq_ids)
    return _scores(spec, rows, offset_local_idx(local_idx, mesh.rank, U),
                   vals, fields)


def _unpack_wire(spec: ModelSpec, L: int, uniq_ids, lengths, flat_idx,
                 flat_vals, flat_fields):
    """The packed bodies' shared unpack: the [B, L] rectangles rebuilt
    on the batch's device with the padding this layout uses — the uniq
    table's last slot in host-dedup mode, the model's pad id
    (vocabulary_size) in raw-ids mode. Narrow-mode f16 values come back
    as f32 here, before any model math."""
    from fast_tffm_tpu_torch.wire import unpack_rectangles
    pad = (spec.vocabulary_size if uniq_ids is None
           else uniq_ids.shape[0] - 1)
    return unpack_rectangles(L, pad, lengths, flat_idx, flat_vals,
                             flat_fields)


def packed_train_step_body(spec: ModelSpec, L: int, table: torch.Tensor,
                           acc: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor, lengths: torch.Tensor,
                           flat_idx: torch.Tensor, flat_vals: torch.Tensor,
                           uniq_ids: Optional[torch.Tensor] = None,
                           flat_fields: Optional[torch.Tensor] = None):
    """One training step from the packed wire (wire.py): unpack the flat
    CSR into the padded rectangles, then the exact ``train_step_body``.
    ``L`` is the rectangle width the encoder recorded."""
    local_idx, vals, fields = _unpack_wire(spec, L, uniq_ids, lengths,
                                           flat_idx, flat_vals, flat_fields)
    return train_step_body(spec, table, acc, labels.float(),
                           weights.float(), local_idx, vals,
                           uniq_ids=uniq_ids, fields=fields)


def packed_score_body(spec: ModelSpec, L: int, table: torch.Tensor,
                      lengths: torch.Tensor, flat_idx: torch.Tensor,
                      flat_vals: torch.Tensor,
                      uniq_ids: Optional[torch.Tensor] = None,
                      flat_fields: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Inference forward from the packed wire: unpack, then the exact
    ``score_body``. In wide mode the rectangles are the padded wire's,
    so the scores are equal to the bit."""
    local_idx, vals, fields = _unpack_wire(spec, L, uniq_ids, lengths,
                                           flat_idx, flat_vals, flat_fields)
    return score_body(spec, table, local_idx, vals, uniq_ids=uniq_ids,
                      fields=fields)


def packed_rows_score_body(spec: ModelSpec, L: int, gathered: torch.Tensor,
                           lengths: torch.Tensor, flat_idx: torch.Tensor,
                           flat_vals: torch.Tensor,
                           flat_fields: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The offload score path on the packed wire: a backend gathered the
    ``[U, D]`` rows from the withheld uniq ids (``WireBatch.host_uniq``)
    and only those rows and the flat CSR reach the card. Padding indexes
    the block's last row, as in ``rows_score_body``'s padded batches."""
    from fast_tffm_tpu_torch.wire import unpack_rectangles
    local_idx, vals, fields = unpack_rectangles(
        L, gathered.shape[0] - 1, lengths, flat_idx, flat_vals, flat_fields)
    return rows_score_body(spec, gathered, local_idx, vals, fields)


def ships_raw_batches(spec: ModelSpec, backend=None) -> bool:
    """Whether an inference path builds raw-ids batches for this spec:
    the one place the policy lives (an offload backend gathers by the
    host-side unique whatever ``spec.dedup`` says)."""
    return spec.dedup == "device" and backend is None


def make_batch_scorer(spec: ModelSpec, backend=None):
    """``score(table, args) -> [B]`` raw scores for a padded batch's
    ``batch_args`` without labels and weights. With a lookup backend
    (lookup.py) the backend gathers the rows of ``args["uniq_ids"]``
    (popped) and the card scores that block, ``table`` unused; else
    ``score_body`` on ``table``."""
    if backend is not None:
        def score(table, args):
            gathered = backend.gather(args.pop("uniq_ids"))
            return rows_score_body(spec, gathered, **args)
    else:
        def score(table, args):
            return score_body(spec, table, **args)
    return score


def batch_args(batch: DeviceBatch,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``, keyed as
    ``train_step_body`` takes them (``uniq_ids`` only when the batch is
    host-deduped, ``fields`` only for FFM): the one padded layout, which
    the wire encoder (wire.py) delegates to. On the CPU the tensors
    share the batch's arrays."""
    keys = ("labels", "weights", "local_idx", "vals") + tuple(
        k for k in ("uniq_ids", "fields") if getattr(batch, k) is not None)
    return {k: torch.from_numpy(getattr(batch, k)).to(device)
            for k in keys}
