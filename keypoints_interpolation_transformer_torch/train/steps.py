"""Train and eval steps for the four regimes (port of the JAX
``train/steps.py``), and the model builder and regime forwards that serving
shares with them.

  a1  plain supervised: src = SOS + frames[:-1], tgt = frames shifted by
      one, "repeat-inc" attention masks, the MSE train criterion
      (``torch.nn.MSELoss`` semantics, frame-weighted), EuclideanLoss on
      the masked composite at eval.
  a2  cycle: a frozen first model fills the stream the Cycle model then
      reads with "all" masks and all-ones pad masks (``cycle_forward``).
  a3  embedding autoencoder: missing frames zeroed with p = 0.95 per video,
      identity reconstruction, EuclideanLoss both ways.
  a4  fine-tune: masked input frames zeroed, EuclideanLoss train /
      EuclideanDistanceLoss eval, optional embedding graft and freeze.

Corruption and augmentation run on the model's device inside the step,
batched, from an explicit ``torch.Generator`` there.  The forward and the
backward go through the training route of ``KeypointCompleter`` (the
sublayer kernels and their backwards, or the per-op attention kernels);
``plain=True`` differentiates the plain versions instead (the oracle path).
Torch-semantics Adam at a per-step learning rate closes each step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.completer import (Embedding, KeypointCompleter,
                                keypoint_completer_cycle)
from ..ops import losses
from ..ops.kernels import fused_euclidean_loss, masked_loss_plain
from ..transforms.augment import random_augment
from ..transforms.corruption import (DatasetMissingStats, add_sos,
                                     put_missing_frames, zero_missing_frames)
from ..utils.device import resolve_device
from .state import TrainState, apply_gradients

REGIMES = ("a1", "a2", "a3", "a4")
FUSION = ("auto", "on", "off")


def build_model(model_cfg, variant: Optional[str] = None, *,
                for_training: bool = False, merge_layers: bool = True,
                device="cuda", generator: Optional[torch.Generator] = None):
    """The configured model ("plain", "cycle" or "embedding") on
    ``device`` (the card unless the caller asks for the CPU), in
    ``train()`` mode when ``for_training``.  ``generator`` (a CPU
    generator) initializes the parameters deterministically.

    ``merge_layers`` selects the merged whole-layer serving kernels (the
    JAX package's default); ``for_training`` sets it off, as the JAX
    package builds the loop's model (``steps.py:82``), so the loop's eval
    forwards run per sublayer.  ``attn_sublayer_fusion``: "off" sends
    attention per op (``fused_attention``); "on" and "auto" take the
    attention-sublayer kernel wherever it applies, for serving and for
    training.  The JAX package resolves "auto" off for training at
    "highest" (``steps.py:63-82``) only to keep XLA's gradient numerics on
    the TPU; the port computes in float32 throughout, and its sublayer
    kernels and their backwards match the plain versions there, so it
    keeps its sublayer route.  ``model_cfg.matmul_precision`` becomes the
    model's ``precision``: its FF and attention sublayers run in that mode
    on every route (at "high" and "default" the JAX package's FF kernel and
    attention-sublayer kernel with their native backwards, as its training
    route resolves ``attn_sublayer_fusion`` on and ``ff_impl`` to Pallas
    there)."""
    if model_cfg.compute_dtype != "float32":
        raise ValueError("the PyTorch port computes in float32 only")
    if model_cfg.attn_sublayer_fusion not in FUSION:
        raise ValueError(f"attn_sublayer_fusion must be one of {FUSION}, "
                         f"got {model_cfg.attn_sublayer_fusion!r}")
    dev = resolve_device(device, "build_model")
    v = variant or model_cfg.variant
    if v == "embedding":
        return Embedding(model_cfg.hidden_dim, model_cfg.input_size,
                         device=dev, generator=generator,
                         precision=model_cfg.matmul_precision
                         ).train(for_training)
    kw = dict(input_size=model_cfg.input_size, ff_dim=model_cfg.ff_dim,
              merge_layers=merge_layers and not for_training,
              attn_sublayer_fusion=model_cfg.attn_sublayer_fusion != "off",
              device=dev, generator=generator,
              precision=model_cfg.matmul_precision)
    if v == "plain":
        model = KeypointCompleter(model_cfg.hidden_dim, model_cfg.num_layers,
                                  model_cfg.num_heads, **kw)
    elif v == "cycle":
        model = keypoint_completer_cycle(model_cfg.hidden_dim,
                                         model_cfg.num_layers,
                                         model_cfg.num_heads, **kw)
    else:
        raise ValueError(f"unknown model variant {v!r}")
    return model.train(for_training)


def corrupt_batch(g: torch.Generator, clean, length, *, augment: bool,
                  aug_prob: float, is_random_missing: bool,
                  dataset_name: str,
                  stats: Optional[DatasetMissingStats],
                  double_hand_rotation: bool = True):
    """augment -> put_missing_frames -> add_sos over the batch.  Returns
    (y, inputs, mask): y is the (possibly augmented) clean target, as the
    reference augments the stored video in place."""
    y = clean
    if augment:
        y = random_augment(g, clean, aug_prob,
                           double_hand_rotation=double_hand_rotation)
    corrupted, miss = put_missing_frames(
        g, y, is_random_missing=is_random_missing,
        dataset_name=dataset_name, stats=stats, t_actual=length)
    inputs, mask = add_sos(corrupted, miss)
    return y, inputs, mask


def shift_streams(inputs, mask, length):
    """The reference's src / tgt shift on padded batches: x = SOS +
    frames, x_no = frames; valid[p] = p < length."""
    T = inputs.shape[1] - 1
    x, x_no = inputs[:, :-1], inputs[:, 1:]
    x_mask, y_mask = mask[:, :-1], mask[:, 1:]
    valid = (torch.arange(T, device=length.device)[None, :]
             < length[:, None]).float()
    return x, x_no, x_mask, y_mask, valid


def _weighted_mean(per_video, weight):
    return (per_video * weight).sum() / weight.sum().clamp_min(1.0)


def make_train_criterion(regime: str, fused: bool, plain: bool = False):
    """Per-video train criterion (pred, target, valid) -> (B,): MSE for
    a1 / a2, EuclideanLoss for a3 / a4.  ``fused`` takes the masked-loss
    kernel (its plain version under ``plain``): half of it for a1 / a2,
    as MSE is euclidean / 2."""
    if fused:
        loss = masked_loss_plain if plain else fused_euclidean_loss
        if regime in ("a1", "a2"):
            return lambda p, y, v: 0.5 * loss(p, y, v)
        return loss
    if regime in ("a1", "a2"):
        return lambda p, y, v: losses.mse_loss(p, y, frame_weight=v)
    return lambda p, y, v: losses.euclidean_loss(p, y, frame_weight=v)


def completer_forward(model, x, x_no, x_mask, y_mask, valid,
                      plain: bool = False, mask_kind: str = "repeat-inc"):
    return model(x, x_no, src_frame_mask=x_mask, tgt_frame_mask=y_mask,
                 valid_mask=valid, plain=plain, src_mask_kind=mask_kind,
                 tgt_mask_kind=mask_kind)


def cycle_forward(first_model, model, x, x_no, x_mask, y_mask, valid,
                  plain: bool = False):
    """A2's forward: the frozen first model fills the stream (repeat-inc
    masks) and its prediction, with no gradient, is the filled stream of
    the Cycle model, which reads the frames ``x_no`` with all-ones masks
    of kind "all" (a uniform +1 on the logits, kept for fidelity)."""
    with torch.no_grad():
        pred1 = completer_forward(first_model, x, x_no, x_mask, y_mask,
                                  valid, plain)
    ones = torch.ones_like(x_mask)
    return model(x_no, pred1, src_frame_mask=ones, tgt_frame_mask=ones,
                 valid_mask=valid, plain=plain, src_mask_kind="all",
                 tgt_mask_kind="all")


def _global_norm(tensors):
    """sqrt of the sum of squares of all entries, in two launches."""
    return torch.cat([t.detach().reshape(-1) for t in tensors]).norm()


def regime_loss(regime: str, model, first_model, y, inputs, mask, length,
                weight, criterion, plain: bool = False, zero_gate=None):
    """(weighted mean loss, per-video losses) of ``regime``'s forward on an
    already corrupted batch (JAX ``steps.py:257-318``).  ``zero_gate``
    (B,) bool: A3's per-video choice to zero the missing frames."""
    x, x_no, x_mask, y_mask, valid = shift_streams(inputs, mask, length)
    if regime == "a2":
        pred = cycle_forward(first_model, model, x, x_no, x_mask, y_mask,
                             valid, plain)
    elif regime == "a3":
        zeroed = zero_missing_frames(x, x_mask)
        x = torch.where(zero_gate[:, None, None, None], zeroed, x)
        y = x
        pred = model(x, plain=plain)
    else:
        if regime == "a4":
            x = zero_missing_frames(x, x_mask)
        pred = completer_forward(model, x, x_no, x_mask, y_mask, valid,
                                 plain)
    per_video = criterion(pred, y, valid)
    return _weighted_mean(per_video, weight), per_video


def a1_loss(model, y, inputs, mask, length, weight, criterion,
            plain: bool = False):
    """(weighted mean loss, per-video losses) of the A1 forward on an
    already corrupted batch."""
    return regime_loss("a1", model, None, y, inputs, mask, length, weight,
                       criterion, plain)


def make_train_step(model, cfg, stats: Optional[DatasetMissingStats],
                    first_model=None, freeze=None,
                    plain: bool = False) -> Callable:
    """The per-batch train step of ``cfg.train.regime``:

        step(state, clean, length, weight, generator, lr) -> (state, metrics)

    ``clean`` (B, T, 54, 2), ``length`` (B,) and ``weight`` (B,) on the
    model's device, ``generator`` a ``torch.Generator`` there.  metrics
    holds the loss, the per-video losses and, under ``watch_norms``, the
    global gradient norm (before the freeze, as in JAX) and parameter
    norm, all on the device.  ``state`` holds ``model`` and its optimizer
    (``TrainState.create(model)``).  a2 needs ``first_model`` (the frozen
    plain model); ``freeze`` names the parameters a4 keeps (the graft).
    ``step.on_corrupted(state, y, inputs, mask, length, weight, lr,
    zero_gate=None)`` takes the step from an already corrupted batch (and,
    for a3, the per-video zero gate).  ``plain=True`` differentiates the
    plain versions."""
    regime = cfg.train.regime
    if regime not in REGIMES:
        raise ValueError(f"unknown regime {regime!r}")
    if regime == "a2" and first_model is None:
        raise ValueError("a2 needs first_model, the frozen plain model")
    d = cfg.data
    criterion = make_train_criterion(regime, cfg.train.fused_loss, plain)
    watch = cfg.train.watch_norms

    def on_corrupted(state: TrainState, y, inputs, mask, length, weight, lr,
                     zero_gate=None):
        if regime == "a3" and zero_gate is None:
            raise ValueError("a3 needs the per-video zero gate")
        model.train()
        loss, per_video = regime_loss(regime, model, first_model, y, inputs,
                                      mask, length, weight, criterion, plain,
                                      zero_gate)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = {"loss": loss.detach(), "per_video": per_video.detach()}
        params = list(model.parameters())
        if watch:
            metrics["grad_norm"] = _global_norm(
                p.grad for p in params if p.grad is not None)
        state = apply_gradients(state, lr, freeze)
        if watch:
            metrics["param_norm"] = _global_norm(params)
        return state, metrics

    def step(state: TrainState, clean, length, weight, generator, lr):
        with torch.no_grad():
            y, inputs, mask = corrupt_batch(
                generator, clean, length, augment=d.have_augmentation,
                aug_prob=d.augmentations_prob,
                is_random_missing=d.is_random_missing,
                dataset_name=d.dataset_name if stats is not None else "all",
                stats=stats, double_hand_rotation=d.double_hand_rotation)
            gate = None
            if regime == "a3":  # zero the missing frames with p = 0.95
                gate = torch.rand(clean.shape[0], generator=generator,
                                  device=clean.device) >= 0.05
        return on_corrupted(state, y, inputs, mask, length, weight, lr, gate)

    step.on_corrupted = on_corrupted
    return step


def make_eval_step(model, cfg, first_model=None,
                   plain: bool = False) -> Callable:
    """Eval on precorrupted batches (the validation corruption is computed
    once, as in the reference):

        eval_step(inputs, mask, clean, length) -> (per_video, baseline)

    per-video losses of the model and of the freeze-frame baseline (the
    corrupted frames themselves), both (B,).  A4 scores with the
    euclidean distance, the rest with the euclidean loss; every regime but
    A3 scores the composite (the model's output on missing frames only).
    Runs without autograd, so the model takes its serving route, per
    sublayer (``build_model(for_training=True)`` sets ``merge_layers``
    off, as the JAX loop's model has it)."""
    regime = cfg.train.regime

    def criterion(pred, y, valid):
        if regime == "a4":
            return losses.euclidean_distance_loss(pred, y, frame_weight=valid)
        return losses.euclidean_loss(pred, y, frame_weight=valid)

    @torch.no_grad()
    def eval_step(inputs, mask, clean, length):
        x, x_no, x_mask, y_mask, valid = shift_streams(inputs, mask, length)
        if regime == "a3":
            x = zero_missing_frames(x, x_mask)  # always zeroed at eval
            pred = model(x, plain=plain)
            return (losses.euclidean_loss(pred, x, frame_weight=valid),
                    losses.euclidean_loss(x, x, frame_weight=valid))
        y = clean
        if regime == "a2":
            pred = cycle_forward(first_model, model, x, x_no, x_mask, y_mask,
                                 valid, plain)
        else:
            if regime == "a4":
                x = zero_missing_frames(x, x_mask)
            pred = completer_forward(model, x, x_no, x_mask, y_mask, valid,
                                     plain)
        pred = losses.composite_prediction(pred, y, y_mask)
        return criterion(pred, y, valid), criterion(x_no, y, valid)

    return eval_step
