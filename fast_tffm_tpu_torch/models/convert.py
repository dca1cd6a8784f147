"""Weight carry-across between the JAX package and the port.

The port keeps its weights in its own checkpoints (checkpoint.py,
torch's format): the JAX package's checkpoints are orbax, which the
port cannot read (the card's machine has no jax, orbax or tensorstore),
and the two packages' step directories are not interchangeable.
``save_checkpoint_from_numpy`` writes a committed, manifest-verified
port step from the JAX package's arrays — its ``init_table`` /
``init_accumulator`` output, a restored orbax checkpoint's
``[ckpt_rows, D]`` arrays, or the ``table`` of its dense ``.npz``
export (``fast_tffm_tpu/checkpoint.py:export_npz``: ``[vocabulary_size,
D]`` f32, the dead pad row dropped) — so that the port's predict and
serve can load a JAX-trained model. The port's train writes the same
``.npz`` export (``save_npz``), which ``load_npz`` reads back;
``state_from_numpy`` starts a port train from the JAX package's
``(table, acc)`` arrays.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import CheckpointState, list_step_dirs
from fast_tffm_tpu_torch.config import FmConfig


def _rows_from_numpy(arr: np.ndarray, cfg: FmConfig,
                    device: torch.device, what: str) -> torch.Tensor:
    """``[num_rows, D]`` f32 on ``device`` from ``[vocabulary_size, D]``
    (the .npz layout), ``[num_rows, D]`` or ``[ckpt_rows, D]`` (the
    checkpoint layout); the pad row is left for the caller to set."""
    arr = np.asarray(arr)
    D = cfg.row_dim
    if arr.ndim != 2 or arr.shape[1] != D or arr.shape[0] not in (
            cfg.vocabulary_size, cfg.num_rows, cfg.ckpt_rows):
        raise ValueError(
            f"{what} of shape {arr.shape} does not fit the config: want "
            f"[{cfg.vocabulary_size}, {D}] (.npz export), "
            f"[{cfg.num_rows}, {D}] or [{cfg.ckpt_rows}, {D}] "
            "(vocabulary_size, factor_num and, for FFM, field_num must "
            "match the model)")
    rows = torch.zeros((cfg.num_rows, D), dtype=torch.float32,
                       device=device)
    n = min(arr.shape[0], cfg.num_rows)
    rows[:n] = torch.from_numpy(
        np.ascontiguousarray(arr[:n], dtype=np.float32)).to(device)
    return rows


def table_from_numpy(arr: np.ndarray, cfg: FmConfig,
                     device: torch.device) -> torch.Tensor:
    """The port's ``[num_rows, D]`` f32 table on ``device``, with a zero
    pad row, from ``[vocabulary_size, D]`` (the .npz layout),
    ``[num_rows, D]`` or ``[ckpt_rows, D]`` (the checkpoint layout)."""
    table = _rows_from_numpy(arr, cfg, device, "table")
    table[cfg.vocabulary_size] = 0.0
    return table


def state_from_numpy(table: np.ndarray, acc: np.ndarray, cfg: FmConfig,
                     device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table, acc)`` for training, both ``[num_rows, D]`` f32 on
    ``device``, from the JAX package's arrays in any layout
    ``table_from_numpy`` takes (``init_table``/``init_accumulator`` give
    ``[num_rows, D]``). The table's pad row is zeroed; the
    accumulator's keeps its value, or ``adagrad_init`` when the layout
    has none (a zero there would make the pad row's update 0·∞)."""
    t = table_from_numpy(table, cfg, device)
    a = _rows_from_numpy(acc, cfg, device, "accumulator")
    if np.asarray(acc).shape[0] == cfg.vocabulary_size:
        a[cfg.vocabulary_size] = cfg.adagrad_init
    return t, a


def load_npz(path: str, cfg: FmConfig, device: torch.device) -> torch.Tensor:
    """Load a dense ``.npz`` export (key ``table``) onto ``device``."""
    with np.load(path) as npz:
        if "table" not in npz.files:
            raise KeyError(f"{path} holds no 'table' array "
                           f"(keys: {npz.files})")
        arr = npz["table"]
    return table_from_numpy(arr, cfg, device)


def save_npz(table: torch.Tensor, path: str, cfg: FmConfig) -> None:
    """Write ``export_npz``'s layout: key ``table``, ``[vocab, D]`` f32,
    compressed. Like ``np.savez_compressed``, a path without the
    ``.npz`` suffix gets it appended."""
    arr = table[:cfg.vocabulary_size].detach().to("cpu", torch.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    np.savez_compressed(path, table=arr.numpy())


def save_checkpoint_from_numpy(cfg: FmConfig, table: np.ndarray,
                               acc: Optional[np.ndarray], step: int,
                               epoch: int = 0) -> str:
    """Write ``(table, acc)`` — in any layout ``state_from_numpy``
    takes — as a committed, manifest-verified port checkpoint step of
    ``cfg.model_file`` with ``epoch`` completed epochs; returns the step
    directory. ``acc=None`` (an ``.npz`` export's table, or a model
    that will only be served) writes an ``adagrad_init`` accumulator.
    Refuses a step that exists already: a save there would keep the
    old arrays."""
    cpu = torch.device("cpu")
    if acc is None:
        t = table_from_numpy(table, cfg, cpu)
        a = torch.full_like(t, cfg.adagrad_init)
    else:
        t, a = state_from_numpy(table, acc, cfg, cpu)
    ckpt = CheckpointState(cfg.model_file, verify=cfg.ckpt_verify,
                           adagrad_init=cfg.adagrad_init)
    try:
        if int(step) in list_step_dirs(ckpt.directory):
            raise FileExistsError(
                f"checkpoint step {step} exists at {ckpt.directory}; "
                "pick another step (or model_file)")
        ckpt.save(step, t, a, vocabulary_size=cfg.vocabulary_size,
                  force=True, wait=True, epoch=epoch)
        reason = ckpt.verify_step(step, "full")
    finally:
        ckpt.close()
    if reason is not None:
        raise OSError(f"checkpoint step {step} at {ckpt.directory} "
                      f"failed verification after the save: {reason}")
    return os.path.join(ckpt.directory, str(int(step)))
