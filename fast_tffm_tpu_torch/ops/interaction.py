"""FM interaction math as plain PyTorch ops — the port's counterpart of
``fast_tffm_tpu/ops/interaction.py``.

``fm_batch_scores`` is the plain version of the CUDA kernel in
``csrc/fm_score.cu`` and ``fm_batch_scores_bwd`` that of
``csrc/fm_score_bwd.cu``: the wrappers (ops/fm_kernel.py) run them for
tensors on the CPU, and ``chip_smoke.py`` holds each kernel against its
plain version on the card. The forward walks the feature slots in
ascending order and adds the factor terms in ascending order, the
kernel's own sum order, so a score does not depend on the batch size or
on how much padding follows the example: pad slots (``vals == 0`` on the
zero pad row) add exactly zero.

``anova_batch_scores`` (order > 2) and ``ffm_batch_scores`` (field-aware
FM) are the JAX package's XLA scorers, which no Pallas kernel replaced:
they run as these torch ops on the CPU and on the card alike.

Shapes: ``params [N, D]`` (factor columns, then the linear weight; D =
K+1, or F·K+1 for FFM); ``local_idx [B, L]`` int32 rows of ``params``;
``vals [B, L]`` f32; ``fields [B, L]`` int32 (FFM). All math is full
f32: the JAX package asks for ``Precision.HIGHEST`` in every einsum, and
FFM's bucketing matmul refuses to run with TF32 on.
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


def _gathered(params: torch.Tensor, local_idx: torch.Tensor) -> torch.Tensor:
    """``params[local_idx]``: the ``[B, L, D]`` rows of a batch."""
    B, L = local_idx.shape
    return gather_rows(params, local_idx.reshape(-1)).reshape(B, L, -1)


def anova_batch_scores(params: torch.Tensor, local_idx: torch.Tensor,
                       vals: torch.Tensor, order: int) -> torch.Tensor:
    """Per-example scores of a higher-order FM [B]: the linear term plus
    the ANOVA kernels of degree 2..``order`` over all latent dims (the
    JAX package's ``fm_batch_scores`` for order > 2)."""
    rows = _gathered(params, local_idx)                 # [B, L, K+1]
    v, w = rows[..., :-1], rows[..., -1]
    linear = (w * vals).sum(dim=1)
    return linear + _anova_terms(v * vals[..., None], order)


def _anova_terms(z: torch.Tensor, order: int) -> torch.Tensor:
    """Sum of the ANOVA kernels of degree 2..order of ``z [B, L, K]``.

    The JAX package's ``lax.scan`` recurrence, slot by slot in ascending
    order: ``a[t] += a[t-1] * z_l`` for t = 1..order, every degree from
    the previous slot's state. Padded slots have z = 0 and leave the
    state as it is. O(L · order · K); no closed form through Newton's
    identities, whose power sums cancel badly in f32."""
    B, _, k = z.shape
    a = torch.cat([z.new_ones((B, 1, k)), z.new_zeros((B, order, k))], 1)
    for l in range(z.shape[1]):
        a = torch.cat([a[:, :1], a[:, 1:] + a[:, :-1] * z[:, l, None, :]],
                      dim=1)
    return a[:, 2:].sum(dim=(1, 2))


def _require_ieee_f32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are on (torch.backends.cuda.matmul.allow_tf32); "
            "the FFM scorer needs full f32, as the JAX package's "
            "Precision.HIGHEST: turn TF32 off")


def ffm_batch_scores(params: torch.Tensor, field_num: int,
                     local_idx: torch.Tensor, fields: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Field-aware FM scores [B]; row layout ``[N, F·K+1]``, where
    ``v[i, f]`` is the latent vector row i uses against field f:

        score = Σ_j w_j x_j + Σ_{i<j} <v[i, f_j], v[j, f_i]> x_i x_j

    Bucketed by field as the JAX package does, never forming the
    ``[B, L, L, K]`` pair tensor: ``S[b, f, g, :] = Σ_{l: fields[b,l]=g}
    x_l · v[b, l, f, :]`` (one batched matmul over the L slots against
    the one-hot fields), the pair sum is ``Σ_{f,g} <S[f,g], S[g,f]>``,
    minus the i = j diagonal ``Σ_l x_l² ||v_l[f_l]||²``, halved. Padded
    slots (x = 0, field 0) add zero everywhere."""
    _require_ieee_f32(params)
    rows = _gathered(params, local_idx)                 # [B, L, F*K+1]
    B, L = local_idx.shape
    F = field_num
    k = (rows.shape[-1] - 1) // F
    w = rows[..., -1]
    v = rows[..., :-1].reshape(B, L, F, k)
    linear = (w * vals).sum(dim=1)
    onehot = torch.nn.functional.one_hot(fields.long(), F).to(v.dtype)
    vx = (v * vals[..., None, None]).reshape(B, L, F * k)
    s = torch.bmm(vx.transpose(1, 2), onehot)          # [B, F*K, G]
    s = s.reshape(B, F, k, F).permute(0, 1, 3, 2)      # [B, F, G, K]
    cross = (s * s.transpose(1, 2)).sum(dim=(1, 2, 3))
    v_self = torch.gather(
        v, 2, fields.long()[:, :, None, None].expand(B, L, 1, k))[:, :, 0]
    diag = (v_self * v_self).sum(dim=2) * (vals * vals)
    return linear + 0.5 * (cross - diag.sum(dim=1))


def batch_reg(params: torch.Tensor, uniq_ids: torch.Tensor,
              vocabulary_size: int, factor_lambda: float,
              bias_lambda: float) -> torch.Tensor:
    """L2 over the batch's unique touched rows: a masked sum, padding
    rows (id == vocabulary_size) excluded."""
    mask = (uniq_ids < vocabulary_size).to(params.dtype)[:, None]
    v, w = params[:, :-1], params[:, -1:]
    return (factor_lambda * torch.sum(torch.square(v) * mask)
            + bias_lambda * torch.sum(torch.square(w) * mask))
