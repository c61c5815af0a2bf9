"""Train state and optimizer (port of the JAX ``train/state.py``).

Adam with torch's defaults (betas 0.9 / 0.999, eps 1e-8: the reference's
``Adam(model.parameters(), lr)``), with the learning rate written into
the parameter groups at every step, as the reference rewrites it per
epoch.  Freezing (the A4 embedding graft) zeroes the frozen parameters'
gradients, so their moments stay zero and they never move.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

BETAS = (0.9, 0.999)
EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, lr: float = 5e-6) -> "TrainState":
        return cls(model, torch.optim.Adam(model.parameters(), lr=lr,
                                           betas=BETAS, eps=EPS))


def apply_gradients(state: TrainState, lr: float,
                    freeze: Optional[Iterable[str]] = None) -> TrainState:
    """One Adam step at learning rate ``lr`` from the gradients on the
    parameters; ``freeze`` names parameters whose gradients are zeroed
    first."""
    if freeze:
        frozen = set(freeze)
        for name, p in state.model.named_parameters():
            if name in frozen and p.grad is not None:
                p.grad.zero_()
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return state


def linear_decay_lrs(lr: float, epochs: int):
    """The A1 / A4 per-epoch schedule: linspace(lr, lr / 5, epochs)."""
    return np.linspace(lr, lr / 5.0, num=epochs)


def step_drop_lrs(lr: float, epochs: int, drop_epoch: int = 80,
                  factor: float = 10.0):
    """The A3 schedule: constant, divided by ``factor`` from epoch
    ``drop_epoch + 1`` on."""
    out = np.full(epochs, lr, dtype=np.float64)
    if drop_epoch + 1 < epochs:
        out[drop_epoch + 1:] = lr / factor
    return out


GRAFTED = ("input_embedding", "filled_embedding", "fc_final")


def freeze_for_graft(model: nn.Module) -> list:
    """Names of the parameters the A4 embedding graft freezes: those of
    input_embedding, filled_embedding and fc_final (JAX
    ``freeze_mask_for_graft``)."""
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in GRAFTED]
