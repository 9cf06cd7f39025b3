"""The port's device rule: run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA card, which must then be present (under a
    process group the rank's card, `cuda:<LOCAL_RANK>`); pass `device="cpu"`
    to run the plain versions on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if torch.distributed.is_initialized():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
