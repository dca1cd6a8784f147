"""The fused FM score kernels' wrappers — the port's counterpart of
``fast_tffm_tpu/ops/pallas_fm.py`` (``fm_batch_scores_pallas`` and the
``custom_vjp`` that joins its forward and backward kernels).

``fm_batch_scores(params, local_idx, vals)`` takes the signature of the
JAX function, but the kernel (``csrc/fm_score.cu``) gathers the rows
itself: ``params`` is the table (or any row block ``local_idx``
addresses), and no ``[B, L, K+1]`` block of gathered rows is stored.
When an input requires grad it goes through ``FmScores``, whose backward
runs ``fm_batch_scores_bwd`` (``csrc/fm_score_bwd.cu``): the gradient
with respect to ``params`` lands in a ``[N, K+1]`` block directly, the
transpose of the fused gather.

- CUDA tensors: checked for device, dtype, shape and contiguity, then
  the kernel launches on the current stream (built with nvcc at first
  use, ops/build.py). A failed build or launch raises; nothing falls
  back.
- CPU tensors: the plain versions in ops/interaction.py.

``launches`` and ``bwd_launches`` count kernel launches (never
plain-version calls), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from fast_tffm_tpu_torch.ops import build, interaction

MAX_ROW_DIM = 128   # K + 1 columns the kernels take: 4 warp-wide chunks

launches = 0
bwd_launches = 0
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _forward_library() -> ctypes.CDLL:
    return build.load_fm_score()


@functools.lru_cache(maxsize=None)
def _backward_library() -> ctypes.CDLL:
    return build.load_fm_score_bwd()


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (the plain version runs);
    True when all lie on one CUDA device; raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name} needs params, local_idx and vals on one device, got "
            + ", ".join(str(t.device) for t in tensors))
    return True


def check_kernel_shape(B: int, L: int, D: int) -> None:
    """Raise ValueError for a [B, L] batch of D-column rows that the
    kernels cannot take (the C entry points refuse the same)."""
    if not 2 <= D <= MAX_ROW_DIM:
        raise ValueError(f"the kernels take 2 <= K+1 <= {MAX_ROW_DIM} "
                         f"columns, got {D}")
    if B < 1 or L < 1:
        raise ValueError(f"the kernels take B >= 1 and L >= 1, got "
                         f"B={B}, L={L}")
    if B * L >= 1 << 31:
        raise ValueError(f"B*L = {B * L} slots: the kernels index fewer "
                         "than 2^31")


def _check_kernel_inputs(params: torch.Tensor, local_idx: torch.Tensor,
                         vals: torch.Tensor) -> None:
    if params.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"params and vals must be float32, got "
                        f"{params.dtype} and {vals.dtype}")
    if local_idx.dtype != torch.int32:
        raise TypeError(f"local_idx must be int32, got {local_idx.dtype}")
    if params.dim() != 2 or local_idx.dim() != 2 or \
            vals.shape != local_idx.shape:
        raise ValueError(
            f"want params [N, K+1], local_idx [B, L], vals [B, L]; got "
            f"{tuple(params.shape)}, {tuple(local_idx.shape)}, "
            f"{tuple(vals.shape)}")
    if not (params.is_contiguous() and local_idx.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("params, local_idx and vals must be contiguous")


def _scores(params: torch.Tensor, local_idx: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """Forward: the kernel on the card, the plain version on the CPU."""
    if not _on_card("fm_batch_scores", params, local_idx, vals):
        return interaction.fm_batch_scores(params, local_idx, vals)
    _check_kernel_inputs(params, local_idx, vals)
    N, D = params.shape
    B, L = local_idx.shape
    out = torch.empty(B, dtype=torch.float32, device=params.device)
    if B == 0 or L == 0:
        return out.zero_()
    check_kernel_shape(B, L, D)
    lib = _forward_library()
    dev = params.device.index
    rc = lib.fm_score_forward(
        params.data_ptr(), local_idx.data_ptr(), vals.data_ptr(),
        out.data_ptr(), N, D, B, L, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fm_score kernel launch failed (B={B}, L={L}, K+1={D}): "
            f"{lib.fm_score_error_string(rc).decode()}")
    global launches
    with _count_lock:
        launches += 1
    return out


def fm_batch_scores_bwd(params: torch.Tensor, local_idx: torch.Tensor,
                        vals: torch.Tensor, g: torch.Tensor,
                        need_dx: bool
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(dparams [N, K+1], dvals [B, L] or None)`` for ``g = dL/dscore
    [B]``: the kernel on the card, the plain version on the CPU."""
    if not _on_card("fm_batch_scores_bwd", params, local_idx, vals, g):
        return interaction.fm_batch_scores_bwd(params, local_idx, vals, g,
                                               need_dx)
    _check_kernel_inputs(params, local_idx, vals)
    N, D = params.shape
    B, L = local_idx.shape
    if g.dtype != torch.float32 or g.shape != (B,) or \
            not g.is_contiguous():
        raise ValueError(f"g must be a contiguous float32 [{B}], got "
                         f"{g.dtype} {tuple(g.shape)}")
    dvals = (torch.empty((B, L), dtype=torch.float32, device=vals.device)
             if need_dx else None)
    if B == 0 or L == 0:
        return torch.zeros_like(params), dvals
    check_kernel_shape(B, L, D)
    lib = _backward_library()
    dev = params.device.index
    dparams = torch.empty_like(params)
    # The kernel's scratch: each row's gradient in 64-bit fixed point and
    # its largest contribution (csrc/fm_score_bwd.cu zeroes both).
    acc = torch.empty((N, D), dtype=torch.int64, device=params.device)
    row_max = torch.empty(N, dtype=torch.int32, device=params.device)
    rc = lib.fm_score_bwd(
        params.data_ptr(), local_idx.data_ptr(), vals.data_ptr(),
        g.data_ptr(), dparams.data_ptr(),
        dvals.data_ptr() if need_dx else None, acc.data_ptr(),
        row_max.data_ptr(), N, D, B, L, int(need_dx), dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fm_score_bwd kernel launch failed (B={B}, L={L}, K+1={D}): "
            f"{lib.fm_score_bwd_error_string(rc).decode()}")
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dparams, dvals


class FmScores(torch.autograd.Function):
    """Scores with the hand-written backward — the counterpart of the
    ``custom_vjp`` ``fm_scores_pallas``. Saves its inputs, recomputes
    everything else in the backward, and computes ``dvals`` only when
    ``vals`` requires grad (training differentiates the rows alone)."""

    @staticmethod
    def forward(ctx, params, local_idx, vals):
        ctx.save_for_backward(params, local_idx, vals)
        return _scores(params, local_idx, vals)

    @staticmethod
    def backward(ctx, g):
        params, local_idx, vals = ctx.saved_tensors
        dparams, dvals = fm_batch_scores_bwd(
            params, local_idx, vals, g.contiguous(),
            need_dx=ctx.needs_input_grad[2])
        return (dparams if ctx.needs_input_grad[0] else None, None, dvals)


def fm_batch_scores(params: torch.Tensor, local_idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Per-example 2nd-order FM scores [B], f32; differentiable in
    ``params`` and ``vals`` through ``FmScores``."""
    if torch.is_grad_enabled() and (params.requires_grad
                                    or vals.requires_grad):
        return FmScores.apply(params, local_idx, vals)
    return _scores(params, local_idx, vals)
