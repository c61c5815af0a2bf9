"""Composite of prediction and ground truth (port of the JAX
``ops/losses.composite_prediction``). The training criteria come with the
training slice."""

from __future__ import annotations

import torch


def composite_prediction(pred: torch.Tensor, target: torch.Tensor,
                         missing_mask: torch.Tensor) -> torch.Tensor:
    """``pred * m + target * (1 - m)`` with the (..., T) mask broadcast over
    keypoints and coordinates: the model's output only on missing frames."""
    m = missing_mask[..., None, None]
    return pred * m + target * (1.0 - m)
