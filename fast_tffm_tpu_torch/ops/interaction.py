"""FM interaction math as plain PyTorch ops — the port's counterpart of
``fast_tffm_tpu/ops/interaction.py`` (order 2).

``fm_batch_scores`` is the plain version of the CUDA kernel in
``csrc/fm_score.cu`` and ``fm_batch_scores_bwd`` that of
``csrc/fm_score_bwd.cu``: the wrappers (ops/fm_kernel.py) run them for
tensors on the CPU, and ``chip_smoke.py`` holds each kernel against its
plain version on the card. The forward walks the feature slots in
ascending order and adds the factor terms in ascending order, the
kernel's own sum order, so a score does not depend on the batch size or
on how much padding follows the example: pad slots (``vals == 0`` on the
zero pad row) add exactly zero.

Shapes: ``params [N, K+1]`` (factor columns, then the linear weight);
``local_idx [B, L]`` int32 rows of ``params``; ``vals [B, L]`` f32. All
math is f32.
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the table. Padding ids hold ``pad_id ==
    vocabulary_size``, the dead all-zero row, so no clipping is needed."""
    return table.index_select(0, ids)


def fm_batch_scores(params: torch.Tensor, local_idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Per-example 2nd-order FM scores [B]:
    ``Σ_l w·x + ½ Σ_f [(Σ_l v·x)² − Σ_l (v·x)²]``."""
    B, L = local_idx.shape
    K = params.shape[1] - 1
    s = params.new_zeros((B, K))
    q = params.new_zeros((B, K))
    linear = params.new_zeros(B)
    for l in range(L):
        rows = gather_rows(params, local_idx[:, l])     # [B, K+1]
        x = vals[:, l]
        z = rows[:, :K] * x[:, None]
        s = s + z
        q = q + z * z
        linear = linear + rows[:, K] * x
    pair = params.new_zeros(B)
    for f in range(K):
        pair = pair + (s[:, f] * s[:, f] - q[:, f])
    return linear + 0.5 * pair


def fm_batch_scores_bwd(params: torch.Tensor, local_idx: torch.Tensor,
                        vals: torch.Tensor, g: torch.Tensor,
                        need_dx: bool, magnitudes: bool = False):
    """The vector-Jacobian product of ``fm_batch_scores`` for ``g =
    dL/dscore [B]``, written out (not autograd of the forward, so that
    it is a second witness). With ``z = v·x`` and ``s_f = Σ_l z_f``,
    slot (b, l) on row ``r = local_idx[b, l]`` adds ``g·x·(s_f − z_f)``
    to ``dparams[r, f]`` (f < K) and ``g·x`` to ``dparams[r, K]``, and
    has ``dvals[b, l] = g·(w + Σ_f v_f·(s_f − z_f))``.

    Returns ``(dparams [N, K+1], dvals [B, L] or None)``. With
    ``magnitudes``, also ``(dparams_abs, dvals_abs)``: each element's
    sum of absolute contributions, the scale that bounds how far a
    different summation order (the kernel's atomics) can move it.
    Dtype-generic, so a float64 gradcheck runs on it."""
    B, L = local_idx.shape
    K = params.shape[1] - 1
    s = params.new_zeros((B, K))
    for l in range(L):
        s = s + gather_rows(params, local_idx[:, l])[:, :K] * \
            vals[:, l][:, None]
    dparams = torch.zeros_like(params)
    dparams_abs = torch.zeros_like(params) if magnitudes else None
    dvals = vals.new_empty((B, L)) if need_dx else None
    dvals_abs = vals.new_empty((B, L)) if need_dx and magnitudes else None
    for l in range(L):
        r = local_idx[:, l].long()
        rows = gather_rows(params, r)
        v, w = rows[:, :K], rows[:, K]
        x = vals[:, l]
        sv = s - v * x[:, None]
        gx = g * x
        grow = torch.cat([gx[:, None] * sv, gx[:, None]], dim=1)
        dparams.index_add_(0, r, grow)
        if magnitudes:
            dparams_abs.index_add_(0, r, grow.abs())
        if need_dx:
            vsv = v * sv
            dvals[:, l] = g * (w + vsv.sum(dim=1))
            if magnitudes:
                dvals_abs[:, l] = g.abs() * (w.abs() + vsv.abs().sum(dim=1))
    if magnitudes:
        return dparams, dvals, dparams_abs, dvals_abs
    return dparams, dvals


def batch_reg(params: torch.Tensor, uniq_ids: torch.Tensor,
              vocabulary_size: int, factor_lambda: float,
              bias_lambda: float) -> torch.Tensor:
    """L2 over the batch's unique touched rows: a masked sum, padding
    rows (id == vocabulary_size) excluded."""
    mask = (uniq_ids < vocabulary_size).to(params.dtype)[:, None]
    v, w = params[:, :-1], params[:, -1:]
    return (factor_lambda * torch.sum(torch.square(v) * mask)
            + bias_lambda * torch.sum(torch.square(w) * mask))
