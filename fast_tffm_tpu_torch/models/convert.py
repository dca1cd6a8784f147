"""Weight carry-across between the JAX package and the port.

The JAX package's checkpoints are orbax, which the port cannot read (the
card's machine has no jax, orbax or tensorstore). Every single-process
JAX train also writes a dense export, ``<model_file>.npz``
(``fast_tffm_tpu/checkpoint.py:export_npz``): one key ``table``,
``[vocabulary_size, D]`` f32, the dead pad row dropped. That file is the
port's weight format; ``save_npz`` writes the same layout, so a table
moves both ways. ``state_from_numpy`` starts a port train from the JAX
package's ``(table, acc)`` arrays.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

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
            "(vocabulary_size and factor_num must match the model)")
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
