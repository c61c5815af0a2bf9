"""Input preparation shared by serving and training (port of
``add_sos`` and ``zero_missing_frames`` of the JAX
``transforms/corruption.py``). The corruption samplers come with the
training slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def zero_missing_frames(video: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Replace masked frames of a (..., T, K, 2) video with zeros."""
    return torch.where(mask[..., None, None] > 0,
                       torch.zeros((), dtype=video.dtype,
                                   device=video.device), video)


def add_sos(video: torch.Tensor, mask: torch.Tensor = None,
            sos_value: float = 1.0):
    """Prepend an all-``sos_value`` start frame to a (..., T, K, 2) video
    and a 0 to its (..., T) mask."""
    out = F.pad(video, (0, 0, 0, 0, 1, 0), value=sos_value)
    if mask is None:
        return out
    return out, F.pad(mask, (1, 0), value=0.0)
