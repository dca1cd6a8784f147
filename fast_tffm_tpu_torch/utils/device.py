"""Device choice for the port's entry points.

Entry points run on the card by default. The CPU is used only when the
caller asks for it (``--device cpu``, or ``device="cpu"`` in the Python
API); without a card and without that request they raise, never quietly
carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "device='cpu' in the Python API) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev
