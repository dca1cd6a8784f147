"""Weight carry-across between the JAX package and the port.

The JAX package's checkpoints are orbax, which the port cannot read (the
card's machine has no jax, orbax or tensorstore). Every single-process
JAX train also writes a dense export, ``<model_file>.npz``
(``fast_tffm_tpu/checkpoint.py:export_npz``): one key ``table``,
``[vocabulary_size, D]`` f32, the dead pad row dropped. That file is the
port's weight format; ``save_npz`` writes the same layout, so a table
moves both ways.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig


def table_from_numpy(arr: np.ndarray, cfg: FmConfig,
                     device: torch.device) -> torch.Tensor:
    """The port's ``[num_rows, D]`` f32 table on ``device``, with a zero
    pad row, from ``[vocabulary_size, D]`` (the .npz layout),
    ``[num_rows, D]`` or ``[ckpt_rows, D]`` (the checkpoint layout)."""
    arr = np.asarray(arr)
    D = cfg.row_dim
    if arr.ndim != 2 or arr.shape[1] != D or arr.shape[0] not in (
            cfg.vocabulary_size, cfg.num_rows, cfg.ckpt_rows):
        raise ValueError(
            f"table of shape {arr.shape} does not fit the config: want "
            f"[{cfg.vocabulary_size}, {D}] (.npz export), "
            f"[{cfg.num_rows}, {D}] or [{cfg.ckpt_rows}, {D}] "
            "(vocabulary_size and factor_num must match the model)")
    table = torch.zeros((cfg.num_rows, D), dtype=torch.float32,
                        device=device)
    n = cfg.vocabulary_size
    table[:n] = torch.from_numpy(
        np.ascontiguousarray(arr[:n], dtype=np.float32)).to(device)
    return table


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
