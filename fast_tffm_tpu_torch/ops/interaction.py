"""FM interaction math as plain PyTorch ops — the port's counterpart of
``fast_tffm_tpu/ops/interaction.py`` (order 2).

``fm_batch_scores`` is the plain version of the CUDA kernel in
``csrc/fm_score.cu``: the wrapper (ops/fm_kernel.py) runs it for tensors
on the CPU, and ``chip_smoke.py`` holds the kernel against it on the
card. It walks the feature slots in ascending order and adds the factor
terms in ascending order, the kernel's own sum order, so a score does not
depend on the batch size or on how much padding follows the example:
pad slots (``vals == 0`` on the zero pad row) add exactly zero.

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
