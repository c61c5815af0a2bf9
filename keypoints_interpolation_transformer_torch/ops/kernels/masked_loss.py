"""Fused masked euclidean loss: the per-video frame-weighted mean squared
keypoint distance, the criterion behind ``train.fused_loss``.

Kernel (``csrc/masked_loss.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/masked_loss.py``:

  * ``fused_masked_loss`` <- ``_loss_kernel``: pred, target (B, T, K, 2),
    frame weight (B, T) -> (B,),

        loss[b] = sum_t w[b, t] sum_k ||pred - target||^2
                  / max(K * sum_t w[b, t], 1)

Bound on an H100 by bytes (pred and target read once); one block per
video.  ``FusedEuclideanLoss`` gives it the closed-form gradient in plain
PyTorch, as the JAX package computes it in XLA (``masked_loss.py:80-86``);
no gradient reaches the weight.  The wrapper takes its plain version for
CPU tensors and launches its kernel for CUDA tensors (or raises);
``launches`` counts the calls that launched.
"""

from __future__ import annotations

import torch

from . import _build

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_masked_loss": "ppp" + "iiii" + "pp"}


def masked_loss_plain(pred, target, frame_weight):
    """Plain PyTorch version of ``fused_masked_loss``."""
    B, T, K = pred.shape[:3]
    d = (pred - target).reshape(B, T, -1)
    num = ((d * d).sum(-1) * frame_weight).sum(-1)
    return num / (frame_weight.sum(-1) * K).clamp_min(1.0)


def fused_masked_loss(pred, target, frame_weight):
    """(B, T, K, 2) x 2 and (B, T) -> (B,) per-video losses."""
    if pred.device.type == "cpu":
        return masked_loss_plain(pred, target, frame_weight)
    where = "fused_masked_loss"
    if pred.dim() != 4:
        raise ValueError(f"{where}: pred must be (B, T, K, 2), got "
                         f"{tuple(pred.shape)}")
    B, T, K, C = pred.shape
    _build.check_tensors(where, pred.device, pred=pred, target=target,
                         frame_weight=frame_weight)
    _build.check_shape(where, "target", target, pred.shape)
    _build.check_shape(where, "frame_weight", frame_weight, (B, T))
    _build.check_aligned(where, pred=pred, target=target)
    if (K * C) % 4:
        raise ValueError(f"{where}: K * 2 = {K * C} is not a multiple of 4")
    loss = torch.empty(B, device=pred.device)
    lib = _build.bind("masked_loss", _SIGS)
    _build.call(lib, "kit_masked_loss", pred.device, pred, target,
                frame_weight, B, T, K * C, K, loss)
    fused_masked_loss.launches += 1
    return loss


fused_masked_loss.launches = 0


class FusedEuclideanLoss(torch.autograd.Function):
    """``fused_masked_loss`` with the closed-form gradient
    2 (pred - target) w / max(K sum_t w, 1)."""

    @staticmethod
    def forward(ctx, pred, target, frame_weight):
        ctx.save_for_backward(pred, target, frame_weight)
        return fused_masked_loss(pred, target, frame_weight)

    @staticmethod
    def backward(ctx, g):
        pred, target, w = ctx.saved_tensors
        den = (w.sum(-1) * pred.shape[2]).clamp_min(1.0)
        dp = 2.0 * (pred - target) * w[..., None, None] \
            * (g / den)[:, None, None, None]
        return dp, -dp, None


def fused_euclidean_loss(pred, target, frame_weight):
    """The JAX ``fused_euclidean_loss``: differentiable per-video losses."""
    return FusedEuclideanLoss.apply(pred.contiguous(), target.contiguous(),
                                    frame_weight.contiguous())
