"""The train step (port of the JAX ``train/steps.py``), regime A1, and
the model builder and regime forwards that serving shares with it.

  a1  plain supervised: src = SOS + frames[:-1], tgt = frames shifted by
      one, "repeat-inc" attention masks, the MSE train criterion
      (``torch.nn.MSELoss`` semantics, frame-weighted), torch-semantics
      Adam at a per-step learning rate.
  a2  (its forward, ``cycle_forward``, serves the Cycle variant): a frozen
      first model fills the stream the Cycle model then reads with "all"
      masks and all-ones pad masks.

Corruption and augmentation run on the model's device inside the step,
batched, from an explicit ``torch.Generator`` there.  The forward and the
backward go through the training route of ``KeypointCompleter`` (the
sublayer kernels and their backwards); ``plain=True`` differentiates the
plain versions instead (the oracle path).  The train steps of regimes
A2-A4 and the fused masked-loss kernel are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.completer import (Embedding, KeypointCompleter,
                                keypoint_completer_cycle)
from ..ops import losses
from ..transforms.augment import random_augment
from ..transforms.corruption import (DatasetMissingStats, add_sos,
                                     put_missing_frames)
from .state import TrainState, apply_gradients


def build_model(model_cfg, variant: Optional[str] = None, *,
                for_training: bool = False, merge_layers: bool = True,
                device="cuda", generator: Optional[torch.Generator] = None):
    """The configured model ("plain", "cycle" or "embedding") on
    ``device`` (the card unless the caller asks for the CPU), in
    ``train()`` mode when ``for_training``.  ``merge_layers`` selects the
    merged whole-layer serving kernels (the JAX package's default; the
    training route does not read it).  ``generator`` (a CPU generator)
    initializes the parameters deterministically."""
    if model_cfg.compute_dtype != "float32":
        raise ValueError("the PyTorch port computes in float32 only")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' "
                           "to run the plain versions on the CPU")
    v = variant or model_cfg.variant
    if v == "embedding":
        return Embedding(model_cfg.hidden_dim, model_cfg.input_size,
                         device=dev, generator=generator).train(for_training)
    kw = dict(input_size=model_cfg.input_size, ff_dim=model_cfg.ff_dim,
              merge_layers=merge_layers, device=dev, generator=generator)
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


def make_train_criterion(regime: str, fused: bool):
    """Per-video train criterion (pred, target, valid) -> (B,): MSE for
    a1 / a2, EuclideanLoss for a3 / a4."""
    if fused:
        raise NotImplementedError(
            "the fused masked-loss kernel is not ported yet")
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
    masks) and its prediction, detached, is the filled stream of the Cycle
    model, which reads the frames ``x_no`` with all-ones masks of kind
    "all" (a uniform +1 on the logits, kept for fidelity)."""
    pred1 = completer_forward(first_model, x, x_no, x_mask, y_mask, valid,
                              plain).detach()
    ones = torch.ones_like(x_mask)
    return model(x_no, pred1, src_frame_mask=ones, tgt_frame_mask=ones,
                 valid_mask=valid, plain=plain, src_mask_kind="all",
                 tgt_mask_kind="all")


def _global_norm(tensors):
    """sqrt of the sum of squares of all entries, in two launches."""
    return torch.cat([t.detach().reshape(-1) for t in tensors]).norm()


def a1_loss(model, y, inputs, mask, length, weight, criterion,
            plain: bool = False):
    """(weighted mean loss, per-video losses) of the A1 forward on an
    already corrupted batch."""
    x, x_no, x_mask, y_mask, valid = shift_streams(inputs, mask, length)
    pred = completer_forward(model, x, x_no, x_mask, y_mask, valid, plain)
    per_video = criterion(pred, y, valid)
    return _weighted_mean(per_video, weight), per_video


def make_train_step(model, cfg, stats: Optional[DatasetMissingStats],
                    plain: bool = False) -> Callable:
    """The per-batch train step of ``cfg.train.regime`` (a1):

        step(state, clean, length, weight, generator, lr) -> (state, metrics)

    ``clean`` (B, T, 54, 2), ``length`` (B,) and ``weight`` (B,) on the
    model's device, ``generator`` a ``torch.Generator`` there.  metrics
    holds the loss, the per-video losses and, under ``watch_norms``, the
    global gradient and parameter norms.  ``state`` holds ``model`` and its
    optimizer (``TrainState.create(model)``).  ``step.on_corrupted(state, y,
    inputs, mask, length, weight, lr)`` takes the step from an already
    corrupted batch.  ``plain=True`` differentiates the plain versions."""
    regime = cfg.train.regime
    if regime != "a1":
        raise NotImplementedError(
            f"regime {regime!r} is not ported yet (only 'a1')")
    d = cfg.data
    criterion = make_train_criterion(regime, cfg.train.fused_loss)
    watch = cfg.train.watch_norms

    def on_corrupted(state: TrainState, y, inputs, mask, length, weight, lr):
        model.train()
        loss, per_video = a1_loss(model, y, inputs, mask, length, weight,
                                  criterion, plain)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = {"loss": loss.detach(), "per_video": per_video.detach()}
        params = list(model.parameters())
        if watch:
            metrics["grad_norm"] = _global_norm(
                p.grad for p in params if p.grad is not None)
        state = apply_gradients(state, lr)
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
        return on_corrupted(state, y, inputs, mask, length, weight, lr)

    step.on_corrupted = on_corrupted
    return step
