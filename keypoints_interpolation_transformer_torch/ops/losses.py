"""Mask-aware losses over (..., T, K, 2) keypoint tensors and the composite
(port of the JAX ``ops/losses.py``).

``frame_weight`` is an optional (..., T) weight, 1 for real frames and 0
for padding; without it every frame counts.  On unpadded inputs:

  euclidean_loss           mean over points of the squared distance
  euclidean_distance_loss  sum over points of the distance
  mse_loss                 mean over coordinates (torch ``MSELoss``, the A1
                           train criterion) == euclidean_loss / 2
"""

from __future__ import annotations

import torch


def _sq_dist(pred, target):
    d = pred - target
    return (d * d).sum(-1)  # (..., T, K)


def euclidean_loss(pred, target, frame_weight=None):
    """Mean over keypoints of the squared euclidean distance."""
    sq = _sq_dist(pred, target)
    if frame_weight is None:
        return sq.mean((-1, -2))
    w = frame_weight[..., None]
    num = (sq * w).sum((-1, -2))
    den = w.sum((-1, -2)) * sq.shape[-1]
    return num / den.clamp_min(1.0)


def euclidean_distance_loss(pred, target, frame_weight=None, eps=0.0):
    """Sum over keypoints of the euclidean distance."""
    d = torch.sqrt(_sq_dist(pred, target).clamp_min(eps))
    if frame_weight is None:
        return d.sum((-1, -2))
    return (d * frame_weight[..., None]).sum((-1, -2))


def mse_loss(pred, target, frame_weight=None):
    """Mean over all coordinates: torch ``MSELoss`` semantics."""
    sq = (pred - target) ** 2
    if frame_weight is None:
        return sq.mean((-1, -2, -3))
    w = frame_weight[..., None, None]
    num = (sq * w).sum((-1, -2, -3))
    den = w.sum((-1, -2, -3)) * sq.shape[-1] * sq.shape[-2]
    return num / den.clamp_min(1.0)


def composite_prediction(pred: torch.Tensor, target: torch.Tensor,
                         missing_mask: torch.Tensor) -> torch.Tensor:
    """``pred * m + target * (1 - m)`` with the (..., T) mask broadcast over
    keypoints and coordinates: the model's output only on missing frames."""
    m = missing_mask[..., None, None]
    return pred * m + target * (1.0 - m)
