"""Model assembly for the port: spec, table init and the score path.

The serving slice of ``fast_tffm_tpu/models/fm.py``: ``ModelSpec``,
``init_table``, ``resolved_kernel``, ``_scores``, ``rows_score_body``
and the raw-gather branch of ``score_body``. Training (loss, the sparse
Adagrad step, the on-device unique) comes with the training slice
(ROADMAP.md A2).

A 2nd-order FM scores through ``ops/fm_kernel.fm_batch_scores``: the
CUDA kernel for tensors on the card, its plain version for tensors on
the CPU. The ``kernel`` and ``dedup`` config keys are accepted and
ignored: on the card an order-2 FM always runs the kernel, on the raw
gather path, as serving does in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.ops.fm_kernel import fm_batch_scores


def check_supported(cfg: FmConfig) -> None:
    """Refuse config values this slice does not serve, naming the
    ROADMAP.md item that brings each."""
    refusals = (
        (cfg.model_type == "ffm", "model_type = ffm", "A6"),
        (cfg.order > 2, f"order = {cfg.order}", "A6"),
        (cfg.vocab_mode == "admit", "vocab_mode = admit", "A8"),
        (cfg.lookup == "host", "lookup = host", "A7"),
        (cfg.wire_format == "packed", "wire_format = packed", "A5"),
        (cfg.serve_replicas > 1,
         f"serve_replicas = {cfg.serve_replicas}", "A9"),
    )
    for refused, what, item in refusals:
        if refused:
            raise NotImplementedError(
                f"{what} is not ported to fast_tffm_tpu_torch yet "
                f"(ROADMAP.md, queue A, item {item})")


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

    @classmethod
    def from_config(cls, cfg: FmConfig) -> "ModelSpec":
        check_supported(cfg)
        return cls(model_type=cfg.model_type, order=cfg.order,
                   factor_num=cfg.factor_num, field_num=cfg.field_num,
                   vocabulary_size=cfg.vocabulary_size,
                   loss_type=cfg.loss_type, factor_lambda=cfg.factor_lambda,
                   bias_lambda=cfg.bias_lambda,
                   learning_rate=cfg.learning_rate)

    @property
    def row_dim(self) -> int:
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


def resolved_kernel(device: torch.device) -> str:
    """What scores an order-2 FM batch on ``device``: the CUDA kernel on
    the card, its plain PyTorch version on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _scores(spec: ModelSpec, params: torch.Tensor, local_idx: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    return fm_batch_scores(params, local_idx, vals)


def rows_score_body(spec: ModelSpec, gathered: torch.Tensor,
                    local_idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Inference forward from a row block ``local_idx`` addresses."""
    return _scores(spec, gathered, local_idx, vals)


def score_body(spec: ModelSpec, table: torch.Tensor, local_idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Raw-gather inference forward: ``local_idx`` holds raw table rows
    (pad cells = pad_id). The JAX package gathers ``table[local_idx]``
    and scores the gathered block; here the kernel reads the table rows
    itself, the same rows summed in the same slot order."""
    return rows_score_body(spec, table, local_idx, vals)
