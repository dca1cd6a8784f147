"""The fused FM score kernel's wrapper — the port's counterpart of
``fast_tffm_tpu/ops/pallas_fm.py:fm_batch_scores_pallas`` (forward).

``fm_batch_scores(params, local_idx, vals)`` takes the signature of the
JAX function, but the kernel (``csrc/fm_score.cu``) gathers the rows
itself: ``params`` is the table (or any row block ``local_idx``
addresses), and no ``[B, L, K+1]`` block of gathered rows is stored.

- CUDA tensors: checked for device, dtype, shape and contiguity, then
  the kernel launches on the current stream (built with nvcc at first
  use, ops/build.py). A failed build or launch raises; nothing falls
  back.
- CPU tensors: the plain version, ops/interaction.fm_batch_scores, which
  sums in the kernel's order.

``launches`` counts kernel launches (never plain-version calls), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import threading

import torch

from fast_tffm_tpu_torch.ops import interaction

MAX_ROW_DIM = 128  # K + 1 columns the kernel takes (4 warp-wide chunks)

launches = 0
_count_lock = threading.Lock()


def fm_batch_scores(params: torch.Tensor, local_idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Per-example 2nd-order FM scores [B], f32."""
    devices = {params.device.type, local_idx.device.type, vals.device.type}
    if devices == {"cpu"}:
        return interaction.fm_batch_scores(params, local_idx, vals)
    if devices != {"cuda"} or len({params.device, local_idx.device,
                                   vals.device}) != 1:
        raise ValueError(
            f"fm_batch_scores needs params, local_idx and vals on one "
            f"device, got {params.device}, {local_idx.device}, "
            f"{vals.device}")
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
    N, D = params.shape
    B, L = local_idx.shape
    if not 2 <= D <= MAX_ROW_DIM:
        raise ValueError(f"the kernel takes 2 <= K+1 <= {MAX_ROW_DIM} "
                         f"columns, got {D}")
    if not (params.is_contiguous() and local_idx.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("params, local_idx and vals must be contiguous")
    out = torch.empty(B, dtype=torch.float32, device=params.device)
    if B == 0 or L == 0:
        return out.zero_()
    from fast_tffm_tpu_torch.ops.build import load_fm_score
    lib = load_fm_score()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        rc = lib.fm_score_forward(params.data_ptr(), local_idx.data_ptr(),
                                  vals.data_ptr(), out.data_ptr(), N, D, B,
                                  L, stream)
    if rc != 0:
        raise RuntimeError(
            f"fm_score kernel launch failed (B={B}, L={L}, K+1={D}): "
            f"{lib.fm_score_error_string(rc).decode()}")
    global launches
    with _count_lock:
        launches += 1
    return out
