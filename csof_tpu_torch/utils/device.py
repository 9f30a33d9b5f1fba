"""The device a library entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where the machine has
    none raises, naming ``device="cpu"`` as the way to run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device={str(device)!r}: there is no CUDA device; "
                         "pass device='cpu' to run on the CPU")
    return device
