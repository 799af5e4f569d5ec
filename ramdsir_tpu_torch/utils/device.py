"""Device selection: the port runs where it is told, or raises."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device(device), refusing a CUDA device when CUDA is missing
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
