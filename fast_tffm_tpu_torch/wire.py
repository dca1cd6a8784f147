"""Wire format: how a built batch crosses from the host to the device —
the port's counterpart of ``fast_tffm_tpu/wire.py``.

- ``wire_format = padded`` (the default): the ``[B, L]`` rectangles of
  ``models/fm.batch_args`` ship as they are.
- ``wire_format = packed``: the wire carries the CSR substance — flat
  feature cells, per-example lengths (and the uniq table in host-dedup
  mode), bucketed to a quarter-octave flat ladder — and the packed
  bodies of ``models/fm.py`` rebuild the padded rectangles on the device
  (``unpack_rectangles``) before the exact padded math. In wide mode the
  scores and the trained table equal the padded wire's to the bit.
- ``wire_dtypes = narrow`` (packed only): values and weights ship as
  float16 and come back as f32 on the device before any model math; ids
  stay int32 and labels f32.

``WireEncoder`` is the one encoder every surface ships through: the
train steps and ``evaluate``, predict's sweep and the serving flush
(``scoring.CompiledScorer`` owns one). Its ``device_put`` is the
double-buffered H2D: on the card, each batch's arrays are staged in
pinned host memory and copied on a stream of the encoder's own, so the
copy of batch N+1 runs while step N computes, and the compute stream
waits for the copy's event before it reads them.

``resolve_wire`` keeps the JAX package's downgrades (the mesh,
multi-process lockstep and the offload train step need the padded
layout): the offload train step (lookup.py) and the multi-process
lockstep (``dist_train``, whose row exchange ships the padded host-deduped
batch) run padded-wide with a warning; the port has no in-process mesh.
An offload scorer's encoder (``host_uniq``) withholds a packed batch's
uniq ids for the backend's gather (``WireBatch.host_uniq``). Each
``device_put`` upserts the memory ledger's ``wire_buffers`` entry (two
batches' wire bytes: the one in flight and the one a step reads).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import DeviceBatch
from fast_tffm_tpu_torch.obs.memory import LEDGER
from fast_tffm_tpu_torch.obs.telemetry import batch_payload_bytes

# Narrow-mode wire dtype for values and weights: a 10-bit mantissa, for
# near-unit libsvm values and example weights, upcast to f32 on the
# device before any model math.
NARROW_VALUE_DTYPE = np.float16

# Smallest flat-ladder rung: a one-line serve flush must not pad past
# its own rectangle.
FLAT_LADDER_FLOOR = 8


def flat_bucket(nnz: int) -> int:
    """The quarter-octave flat-array bucket covering ``nnz`` feature
    cells: rungs ``m * 2^(k-3)`` for m in {5, 6, 7, 8}, four per octave,
    so the flat array's own padding never exceeds 25%."""
    if nnz <= FLAT_LADDER_FLOOR:
        return FLAT_LADDER_FLOOR
    k = (nnz - 1).bit_length()     # 2^(k-1) < nnz <= 2^k
    base = 1 << (k - 3)            # quarter-octave step
    return -(-nnz // base) * base


def rect_fraction_rungs(B: int, L: int):
    """The serve flat ladder for one [B, L] cell: power-of-two fractions
    of the rectangle (B*L/8 .. B*L) plus the floor — at most five rungs,
    so the serve warmup walks a bounded matrix."""
    cells = B * L
    out = {FLAT_LADDER_FLOOR}
    for j in (3, 2, 1, 0):
        out.add(max(FLAT_LADDER_FLOOR, cells >> j))
    return tuple(sorted(out))


def flat_rungs(B: int, L: int):
    """Every flat rung a [B, L] serve flush can encode to."""
    return rect_fraction_rungs(B, L)


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """The resolved (format, dtypes) pair a dispatch path runs under."""
    format: str = "padded"   # "padded" | "packed"
    dtypes: str = "wide"     # "wide" | "narrow"

    @property
    def packed(self) -> bool:
        return self.format == "packed"

    @property
    def narrow(self) -> bool:
        return self.dtypes == "narrow"

    def describe(self) -> str:
        return f"{self.format}-{self.dtypes}"


def resolve_wire(cfg: FmConfig, mesh=None, backend=None,
                 multi_process: bool = False,
                 train: bool = False) -> WireSpec:
    """The one resolution of the wire knobs for a dispatch path. Paths
    that need the padded layout — mesh sharding, multi-process lockstep,
    the offload train step — resolve to padded-wide with a warning, as
    in the JAX package (the port has the last two)."""
    spec = WireSpec(cfg.wire_format, cfg.wire_dtypes)
    if not spec.packed:
        return spec
    blockers = []
    if mesh is not None:
        blockers.append("mesh sharding assembles padded shard arrays")
    if multi_process:
        blockers.append("multi-process lockstep assembles padded "
                        "global arrays")
    if train and backend is not None:
        blockers.append("the offload train step gathers on the host")
    if blockers:
        warnings.warn(
            f"wire_format = packed is unsupported on this path "
            f"({'; '.join(blockers)}); running padded-wide instead")
        return WireSpec()
    return spec


@dataclasses.dataclass
class WireBatch:
    """One encoded batch: the arrays that cross the wall (CPU tensors)
    and the accounting."""
    args: Dict[str, torch.Tensor]
    packed: bool
    L: int                   # rectangle width (the unpack's target)
    wire_bytes: int          # bytes of ``args``: what is shipped
    logical_bytes: int       # bytes of the padded layout
    # Offload score path, packed: the uniq ids, kept on the host for the
    # backend's gather and never shipped.
    host_uniq: Optional[np.ndarray] = None
    # vocab_mode = admit: the batch's distinct hashed ids (never
    # shipped), for the step loop's note_trained.
    vocab_obs: Optional[np.ndarray] = None


class WireEncoder:
    """The one device-bound batch encoder.

    ``pad_id`` is the model's pad id (``cfg.pad_id == vocabulary_size``):
    raw-ids batches mark padding cells with it; host-dedup batches mark
    padding through the uniq table's pad_id slots. An admit-mode batch
    is encoded after its remap (``vocab_mode = admit``: the train step's
    ``ensure_current``, the pipeline's and the serving flush's remap),
    so it carries physical rows and the physical pad_id, and its
    ``vocab_obs`` rides on the ``WireBatch``. ``host_uniq`` (the
    offload score path): a packed batch's uniq ids stay out of the
    shipped arguments, on ``WireBatch.host_uniq``. ``rect_fraction``
    (the serving process) buckets flat arrays to the coarse
    ``rect_fraction_rungs`` ladder instead of ``flat_bucket``."""

    def __init__(self, wire: WireSpec, pad_id: int, host_uniq: bool = False,
                 rect_fraction: bool = False):
        self.wire = wire
        self.pad_id = int(pad_id)
        self.host_uniq = bool(host_uniq)
        self.rect_fraction = bool(rect_fraction)
        self._stream: Optional["torch.cuda.Stream"] = None

    def encode_train(self, batch: DeviceBatch) -> WireBatch:
        return self._encode(batch, train=True)

    def encode_score(self, batch: DeviceBatch) -> WireBatch:
        return self._encode(batch, train=False)

    def _encode(self, batch: DeviceBatch, train: bool) -> WireBatch:
        li = batch.local_idx
        B, L = li.shape
        # The padded layout's size: labels and weights ride on the train
        # wire only, as in the score path's arguments.
        logical = (li.nbytes + batch.vals.nbytes
                   + (batch.uniq_ids.nbytes
                      if batch.uniq_ids is not None else 0)
                   + (batch.fields.nbytes
                      if batch.fields is not None else 0)
                   + ((batch.labels.nbytes + batch.weights.nbytes)
                      if train else 0))
        if not self.wire.packed:
            from fast_tffm_tpu_torch.models.fm import batch_args
            args = batch_args(batch, torch.device("cpu"))
            if not train:
                del args["labels"], args["weights"]
            return WireBatch(args=args, packed=False, L=L,
                             wire_bytes=logical, logical_bytes=logical,
                             vocab_obs=batch.vocab_obs)
        # A cell is padding iff its target row is the dead pad row; a
        # host-deduped batch is tested through its uniq table, since the
        # C++ builder parks padding at slot 0 and make_device_batch at
        # slot U-1 (the unpack puts it at U-1: the same row either way).
        if batch.uniq_ids is None:
            mask = li != self.pad_id
            pad = self.pad_id
        else:
            mask = batch.uniq_ids[li] != self.pad_id
            pad = len(batch.uniq_ids) - 1
        # Features are front-packed per row, so the row-major selection
        # is the per-example CSR order the unpack rebuilds.
        lengths = mask.sum(axis=1).astype(np.int32)
        nnz = int(lengths.sum())
        P = (next(r for r in rect_fraction_rungs(B, L) if r >= nnz)
             if self.rect_fraction else flat_bucket(nnz))
        vdt = NARROW_VALUE_DTYPE if self.wire.narrow else np.float32
        flat_idx = np.full(P, pad, dtype=np.int32)
        flat_vals = np.zeros(P, dtype=vdt)
        flat_idx[:nnz] = li[mask]
        flat_vals[:nnz] = batch.vals[mask]
        arrays = {"lengths": lengths, "flat_idx": flat_idx,
                  "flat_vals": flat_vals}
        if batch.fields is not None:
            ff = np.zeros(P, dtype=np.int32)
            ff[:nnz] = batch.fields[mask]
            arrays["flat_fields"] = ff
        host_uniq = None
        if self.host_uniq:
            host_uniq = batch.uniq_ids
        elif batch.uniq_ids is not None:
            arrays["uniq_ids"] = batch.uniq_ids
        if train:
            arrays["labels"] = batch.labels
            arrays["weights"] = (batch.weights.astype(vdt)
                                 if self.wire.narrow else batch.weights)
        args = {k: torch.from_numpy(v) for k, v in arrays.items()}
        return WireBatch(args=args, packed=True, L=L,
                         wire_bytes=batch_payload_bytes(arrays),
                         logical_bytes=logical, host_uniq=host_uniq,
                         vocab_obs=batch.vocab_obs)

    def device_put(self, wb: WireBatch, device) -> Dict[str, torch.Tensor]:
        """The encoded arrays on ``device``, ready for the step or score
        body on the current stream. On the CPU they are the encoder's
        tensors. On the card each array is staged in pinned host memory
        (torch's caching host allocator keeps a block until the copy
        that reads it has finished, so the host never writes a buffer
        in flight) and copied with ``non_blocking`` on the encoder's
        copy stream; the current stream waits for the copy's event, and
        each tensor is marked as used there so that its memory is not
        handed to the next copy while a step still reads it."""
        device = torch.device(device)
        LEDGER.register("wire_buffers", 2 * wb.wire_bytes)
        if device.type != "cuda":
            return {k: v.to(device) for k, v in wb.args.items()}
        compute = torch.cuda.current_stream(device)
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in wb.args.items()}
        compute.wait_stream(stream)
        for t in out.values():
            t.record_stream(compute)
        return out


def unpack_rectangles(L: int, pad: int, lengths: torch.Tensor,
                      flat_idx: torch.Tensor, flat_vals: torch.Tensor,
                      flat_fields: Optional[torch.Tensor] = None):
    """The device-side inverse of the packed encoding: ``(local_idx [B,
    L] i32, vals [B, L] f32, fields [B, L] i32 or None)`` rebuilt from
    the flat CSR on the tensors' device, equal to the host-built padded
    arrays (padding cells restored to ``pad`` / 0.0 / 0). Torch ops:
    each flat cell's row comes from ``searchsorted`` over the cumulative
    lengths; cells past the batch's total (the flat ladder's padding)
    write to an extra row B that is dropped, as ``mode="drop"`` does in
    the JAX package."""
    device = flat_idx.device
    B = lengths.shape[0]
    P = flat_idx.shape[0]
    ends = torch.cumsum(lengths.long(), dim=0)
    starts = ends - lengths.long()
    pos = torch.arange(P, device=device, dtype=torch.int64)
    # Row of each flat cell: the count of example ends at or before it.
    row = torch.searchsorted(ends, pos, right=True)
    valid = pos < ends[-1]
    rowc = row.clamp(0, B - 1)
    col = (pos - starts[rowc]).clamp(0, L - 1)
    r = torch.where(valid, rowc, torch.full_like(rowc, B))
    li = torch.full((B + 1, L), pad, dtype=torch.int32, device=device)
    li[r, col] = flat_idx.to(torch.int32)
    vv = torch.zeros((B + 1, L), dtype=torch.float32, device=device)
    vv[r, col] = flat_vals.to(torch.float32)
    ff = None
    if flat_fields is not None:
        ff = torch.zeros((B + 1, L), dtype=torch.int32, device=device)
        ff[r, col] = flat_fields.to(torch.int32)
        ff = ff[:B]
    return li[:B], vv[:B], ff
