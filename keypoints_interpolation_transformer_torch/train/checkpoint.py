"""Checkpoints of the training loop (the port's counterpart of the JAX
``train/checkpoint.py`` and of the loop's orbax writes).

Two files in the run's checkpoint directory:

  best.pth         the best parameters in the reference ``.pth`` schema
                   (``models/convert.save_reference_pth``, with the
                   reference's hyperparameter dict), which the JAX
                   ``load_reference_checkpoint``, the port's ``Inpainter``
                   and the A2 / A4 uploads read;
  full_state.pt    what an exact resume needs (``torch.save``): the model's
                   and the optimizer's state dicts, the step, the epoch,
                   the best validation loss and the state of the train
                   generator after that epoch.

The loop snapshots the best state on the device (a copy there is cheap)
and writes both files on the JAX cadence: every ``full_state_every``-th
improving epoch, always at epoch 0, and once more when the run ends.  The
JAX package's orbax directories are out of scope.
"""

from __future__ import annotations

import copy
import os
from typing import NamedTuple

import torch

from ..models.convert import save_reference_pth
from .state import TrainState

BEST = "best.pth"
FULL_STATE = "full_state.pt"


class Snapshot(NamedTuple):
    model: dict
    optimizer: dict
    step: int
    epoch: int
    min_loss: float
    rng_state: torch.Tensor


def snapshot(state: TrainState, epoch: int, min_loss: float,
             generator: torch.Generator) -> Snapshot:
    """Copies, on the device, of everything ``write`` saves."""
    return Snapshot({k: v.detach().clone()
                     for k, v in state.model.state_dict().items()},
                    copy.deepcopy(state.optimizer.state_dict()), state.step,
                    epoch, min_loss, generator.get_state())


def write(ckpt_dir: str, snap: Snapshot, hyper: dict) -> str:
    """Write ``best.pth`` and ``full_state.pt`` from ``snap`` into
    ``ckpt_dir``; returns the path of ``best.pth``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    best = os.path.abspath(os.path.join(ckpt_dir, BEST))
    save_reference_pth(best, snap.model, hyper, loss=snap.min_loss)
    torch.save({"model": snap.model, "optimizer": snap.optimizer,
                "step": snap.step, "epoch": snap.epoch,
                "min_loss": snap.min_loss, "rng_state": snap.rng_state},
               os.path.join(ckpt_dir, FULL_STATE))
    return best


def restore(path: str, state: TrainState, generator: torch.Generator):
    """Load a ``full_state.pt`` (written on any device) into ``state`` and
    ``generator``; returns (the epoch it was written after, the best
    validation loss then)."""
    full = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(full["model"])
    state.optimizer.load_state_dict(full["optimizer"])
    state.step = int(full["step"])
    generator.set_state(full["rng_state"])
    return int(full["epoch"]), float(full["min_loss"])

