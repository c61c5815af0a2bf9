"""The unified training loop (port of the JAX ``train/loop.py``) for one
device: the card unless the caller asks for the CPU.

One loop covers the reference's four trainers:

  * the regime picks the model (a1 / a4 plain, a2 Cycle over a frozen
    plain model from ``upload_model``, a3 the Embedding autoencoder); a4
    may warm-start from ``upload_general_model`` and graft an Embedding's
    layers from ``upload_embedding_model`` (input_embedding -> both
    embeddings, output_embedding -> fc_final), frozen with
    ``freeze_grafted``;
  * the per-epoch learning rate: linear decay lr -> lr / 5 for a1 / a2 /
    a4, a constant with a / 10 drop after ``a3_lr_drop_epoch`` for a3;
  * the validation corruption computed once; per-video losses kept on the
    device and reduced once per epoch (no host sync per step);
  * the epoch-0 freeze-frame and cubic-spline baselines;
  * save-on-best (``train/checkpoint.py``), patience and early stop (a3
    never stops early by default), ``max_epochs_this_run``, exact resume
    from ``full_state.pt``.

Spans for ``torch.profiler`` mark each train step, eval step, cubic
baseline and checkpoint write (``chip_smoke.py --profile`` reads them).

Corruption and augmentation draw from a ``torch.Generator`` on the model's
device, seeded from ``cfg.train.seed``; the parameters are drawn from a
CPU generator with the same seed.  The RNG streams differ from the JAX
package's, so a run matches it in distribution, not draw for draw.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..data.pipeline import KeypointDataset, to_device
from ..data.synthetic import synthetic_dataset
from ..models.convert import load_reference_pth
from ..ops import losses
from ..ops.cubic_spline import cubic_interpolation_batch
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.metrics import MetricsLogger, snapshot_run_config
from ..utils.registry import missing_stats
from . import checkpoint as ckpt
from .state import (TrainState, freeze_for_graft, linear_decay_lrs,
                    step_drop_lrs)
from .steps import build_model, make_eval_step, make_train_step

REGIME_VARIANT = {"a1": "plain", "a2": "cycle", "a3": "embedding",
                  "a4": "plain"}
# the largest dataset the loop keeps on the card (the JAX package's cap)
_RESIDENT_BYTES = 2 << 30


@dataclasses.dataclass
class TrainResult:
    best_val_loss: float
    best_epoch: int
    epochs_run: int
    train_losses: List[float]
    val_losses: List[float]
    checkpoint_path: Optional[str]
    baseline_losses: Optional[List[float]] = None


def build_datasets(cfg: Config):
    """(train, val) from ``cfg.data``: synthetic videos, 80 / 20."""
    d = cfg.data
    if d.synthetic_num_videos <= 0:
        raise ValueError("no training data: set data.synthetic_num_videos or "
                         "pass train_ds and val_ds (reading HDF5 splits "
                         "waits for h5py on the card's machine)")
    vids = synthetic_dataset(d.synthetic_num_videos, d.synthetic_min_len,
                             d.synthetic_max_len, seed=d.seed,
                             motion=d.synthetic_motion,
                             vocab=d.synthetic_vocab)
    n_train = max(1, int(0.8 * len(vids)))
    kw = dict(dataset_name=d.dataset_name, max_seq_len=d.max_seq_len,
              bucket_multiple=d.bucket_multiple)
    return (KeypointDataset(videos=vids[:n_train], **kw),
            KeypointDataset(videos=vids[n_train:] or vids[:1], **kw))


def _load(model, path: str, dev) -> None:
    sd, _ = load_reference_pth(path)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})


def _graft(model, path: str) -> None:
    """The A4 graft: an Embedding's input_embedding into both embeddings,
    its output_embedding into fc_final."""
    sd, _ = load_reference_pth(path)
    with torch.no_grad():
        for dst, src in (("input_embedding", "input_embedding"),
                         ("filled_embedding", "input_embedding"),
                         ("fc_final", "output_embedding")):
            layer = getattr(model, dst)
            layer.weight.copy_(sd[f"{src}.weight"])
            layer.bias.copy_(sd[f"{src}.bias"])


def _cubic_baseline(regime, inputs, mask, clean, length):
    """Per-video losses of the cubic spline through the corrupted frames,
    scored with the eval criterion."""
    T = clean.shape[1]
    cub = cubic_interpolation_batch(inputs[:, 1:T + 1], mask[:, 1:T + 1])
    valid = (torch.arange(T, device=clean.device)[None, :]
             < length[:, None]).float()
    if regime == "a4":
        return losses.euclidean_distance_loss(cub, clean, frame_weight=valid)
    return losses.euclidean_loss(cub, clean, frame_weight=valid)


def train(cfg: Config, train_ds: Optional[KeypointDataset] = None,
          val_ds: Optional[KeypointDataset] = None, device="cuda",
          plain: bool = False) -> TrainResult:
    """Train ``cfg.train.regime`` on ``device`` (the card unless the caller
    asks for the CPU); ``plain=True`` differentiates the kernels' plain
    versions (the oracle path).  Without datasets, ``cfg.data`` makes
    synthetic ones.  Writes metrics and the run's config under
    ``results_dir`` and checkpoints under ``checkpoint_dir /
    experiment_name``."""
    cfg.check_supported()
    dev = resolve_device(device, "train")
    regime = cfg.train.regime
    if regime not in REGIME_VARIANT:
        raise ValueError(f"unknown regime {regime!r}")
    if regime == "a2" and not cfg.train.upload_model:
        raise ValueError("a2 needs train.upload_model (the frozen first "
                         "model's .pth)")
    if train_ds is None or val_ds is None:
        train_ds, val_ds = build_datasets(cfg)
    if len(train_ds) == 0 or len(val_ds) == 0:
        raise ValueError(
            f"empty dataset (train={len(train_ds)}, val={len(val_ds)}): "
            "videos under 10 frames are dropped")

    d, t = cfg.data, cfg.train
    stats = None
    if not d.is_random_missing and d.dataset_name != "all":
        try:
            stats = missing_stats(d.dataset_name, d.registry_path)
        except KeyError:
            print(f"dataset {d.dataset_name!r} has no missingness stats in "
                  "the registry; using the generic 'all' block-corruption "
                  "mode")

    model = build_model(cfg.model, REGIME_VARIANT[regime], for_training=True,
                        device=dev,
                        generator=torch.Generator().manual_seed(t.seed))
    first_model, freeze = None, None
    if regime == "a2":
        first_model = build_model(cfg.model, "plain", for_training=True,
                                  device=dev)
        _load(first_model, t.upload_model, dev)
    if regime == "a4":
        if t.upload_general_model:
            _load(model, t.upload_general_model, dev)
        if t.upload_embedding_model:
            _graft(model, t.upload_embedding_model)
            if t.freeze_grafted:
                freeze = freeze_for_graft(model)

    state = TrainState.create(model, t.lr)
    gen = torch.Generator(device=dev).manual_seed(t.seed)
    epoch_start, min_loss = 0, float("inf")
    if t.resume_from:
        last, min_loss = ckpt.restore(t.resume_from, state, gen)
        epoch_start = last + 1

    train_step = make_train_step(model, cfg, stats, first_model, freeze,
                                 plain)
    eval_step = make_eval_step(model, cfg, first_model, plain)
    if regime == "a3":
        lrs = step_drop_lrs(t.lr, t.epochs, t.a3_lr_drop_epoch)
    else:
        lrs = linear_decay_lrs(t.lr, t.epochs)

    corrupted_val = val_ds.precompute_corruption(
        seed=t.seed, is_random_missing=d.is_random_missing,
        registry_path=d.registry_path, device=dev)
    data_bytes = sum(v.nbytes for v in train_ds.videos) + \
        sum(v.nbytes for v in val_ds.videos)
    resident = d.device_resident_data and data_bytes < _RESIDENT_BYTES
    if resident:
        train_buckets = train_ds.device_buckets(device=dev)
        val_buckets = val_ds.device_buckets(corrupted=corrupted_val,
                                            device=dev)

    logger = MetricsLogger(log_dir=t.results_dir, run_name=t.experiment_name)
    snapshot_run_config(cfg, logger)
    ckpt_dir = os.path.join(t.checkpoint_dir, logger.run_name)
    hyper = {"input_size": cfg.model.input_size,
             "hidden_dim": cfg.model.hidden_dim,
             "num_layers": cfg.model.num_layers,
             "num_heads": cfg.model.num_heads}

    best_epoch, patience = -1, 0
    saves_since_full = 10 ** 9  # write on the first best
    best = None
    ckpt_path = None
    train_curve: List[float] = []
    val_curve: List[float] = []
    baseline_acc: Optional[List[float]] = None

    for epoch in range(epoch_start, t.epochs):
        lr = float(lrs[epoch])
        t0 = time.perf_counter()

        # ---- train ----
        if resident:
            stream = ((p["clean"], p["length"], w)
                      for _, p, w in train_ds.device_batches(
                          train_buckets, d.batch_size, shuffle=True,
                          seed=t.seed + epoch))
        else:
            stream = (to_device([b.clean, b.length.astype(np.int64)], dev)
                      + (b.weight,)
                      for b in train_ds.batches(d.batch_size, shuffle=True,
                                                seed=t.seed + epoch))
        pvs, wts, grad_norms, param_norm, frames = [], [], [], None, 0
        for clean, length, w in stream:
            weight = to_device([w], dev)[0]
            with record_function("train_step"):
                state, m = train_step(state, clean, length, weight, gen, lr)
            pvs.append(m["per_video"])
            wts.append(weight)
            frames += clean.shape[0] * clean.shape[1]  # padding included
            if "grad_norm" in m:
                grad_norms.append(m["grad_norm"])
                param_norm = m["param_norm"]
        pv, w = torch.cat(pvs), torch.cat(wts)
        train_loss = float((pv * w).sum() / w.sum().clamp_min(1.0))
        train_s = time.perf_counter() - t0

        # ---- eval ----
        if resident:
            eval_stream = (((p["inputs"], p["mask"], p["clean"],
                             p["length"]), w)
                           for _, p, w in val_ds.device_batches(
                               val_buckets, d.batch_size))
        else:
            eval_stream = ((to_device([b.inputs, b.mask, b.clean,
                                       b.length.astype(np.int64)], dev),
                            b.weight)
                           for b in val_ds.batches(d.batch_size,
                                                   corrupted=corrupted_val))
        cubic = epoch == 0 and t.epoch0_cubic_baseline and regime != "a3"
        ev_pv, ev_base, ev_cubic, ev_keep = [], [], [], []
        for args, bweight in eval_stream:
            with record_function("eval_step"):
                per_video, base = eval_step(*args)
            ev_pv.append(per_video)
            ev_base.append(base)
            ev_keep.append(bweight > 0)
            if cubic:
                with record_function("cubic_baseline"):
                    ev_cubic.append(_cubic_baseline(regime, *args))
        if not ev_keep:
            raise ValueError("the validation stream produced no batch: the "
                             "validation set is empty")
        keep = torch.from_numpy(np.concatenate(ev_keep)).to(dev)
        val_pv = torch.cat(ev_pv)[keep].tolist()
        base_pv = torch.cat(ev_base)[keep].tolist()
        val_loss = float(np.mean(val_pv))
        if baseline_acc is None:
            baseline_acc = base_pv  # the first epoch's freeze-frame baseline

        train_curve.append(train_loss)
        val_curve.append(val_loss)
        patience += 1
        if val_loss < min_loss:
            min_loss, best_epoch, patience = val_loss, epoch, 0
            if t.save_checkpoints:
                best = ckpt.snapshot(state, epoch, min_loss, gen)
                saves_since_full += 1
                if saves_since_full >= max(t.full_state_every, 1) \
                        or epoch == 0:
                    saves_since_full = 0
                    with record_function("checkpoint"):
                        ckpt_path = ckpt.write(ckpt_dir, best, hyper)
                    logger.log_artifact(ckpt_path)

        record = dict(train_loss=train_loss, val_loss=val_loss,
                      minimun_loss=min_loss, lr=lr, epoch=epoch,
                      train_seconds=train_s, train_frames=frames)
        if ev_cubic:
            record["cubic_val_loss"] = float(
                torch.cat(ev_cubic)[keep].mean())
        if grad_norms:
            record["grad_norm"] = float(torch.stack(grad_norms).mean())
            record["param_norm"] = float(param_norm)
        logger.log(epoch, **record)
        if t.log_every and epoch % t.log_every == 0:
            print(f"epoch {epoch}: lr={lr:.3g} train={train_loss:.6f} "
                  f"val={val_loss:.6f} best={min_loss:.6f}", flush=True)

        if t.effective_early_stop() and patience >= t.patience:
            break
        if t.max_epochs_this_run is not None and \
                epoch - epoch_start + 1 >= t.max_epochs_this_run:
            break

    if best is not None:
        ckpt_path = ckpt.write(ckpt_dir, best, hyper)  # the final flush
    logger.close()
    return TrainResult(best_val_loss=min_loss, best_epoch=best_epoch,
                       epochs_run=len(val_curve), train_losses=train_curve,
                       val_losses=val_curve, checkpoint_path=ckpt_path,
                       baseline_losses=baseline_acc)
