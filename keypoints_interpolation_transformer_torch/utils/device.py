"""The device rule of the port's entry points: the card unless the caller
asks for the CPU, and no quiet fall-back to the CPU when there is no
card."""

from __future__ import annotations

import torch


def resolve_device(device, where: str) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names the card and
    this machine has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{where}: no CUDA device; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return dev
