"""Additive attention-bias builders (port of the JAX ``ops/masks.py``).

Mask kinds (additive, float32; ``NEG`` instead of ``-inf`` so a fully
blocked row averages uniformly instead of producing NaN):

  "triangle"   causal lower-triangular
  "repeat"     every row equals the frame mask (raw 0/1 values added)
  "repeat-inc" bias[i, j] = NEG iff j > i and frame_mask[j] == 1
  "all"        zeros
"""

from __future__ import annotations

import torch

NEG = -1e9


def attention_bias(kind: str, frame_mask, size: int,
                   dtype=torch.float32) -> torch.Tensor:
    """A (..., size, size) additive bias; ``frame_mask`` (..., size) has 1
    on missing frames and is ignored by "triangle" and "all"."""
    device = frame_mask.device if torch.is_tensor(frame_mask) else None
    if kind == "triangle":
        tri = torch.ones(size, size, dtype=torch.bool, device=device).tril()
        return torch.where(tri, 0.0, NEG).to(dtype)
    if kind == "all":
        return torch.zeros(size, size, dtype=dtype, device=device)
    m = torch.as_tensor(frame_mask, dtype=dtype)
    if kind == "repeat":
        return m[..., None, :].expand(m.shape[:-1] + (size, size))
    if kind == "repeat-inc":
        idx = torch.arange(size, device=m.device)
        future = idx[None, :] > idx[:, None]
        blocked = future & (m[..., None, :] > 0)
        return torch.where(blocked, NEG, 0.0).to(dtype)
    raise ValueError(f"unknown attention mask kind: {kind!r}")


def padding_bias(valid_mask, dtype=torch.float32) -> torch.Tensor:
    """(..., 1, T) bias putting NEG on padded (invalid) key positions."""
    v = torch.as_tensor(valid_mask) > 0
    return torch.where(v[..., None, :], 0.0, NEG).to(dtype)


def key_padding_additive(frame_mask, dtype=torch.float32) -> torch.Tensor:
    """(..., 1, T): the raw mask values, added to the logits as torch does
    with a float ``key_padding_mask`` (missing keys get +1)."""
    return torch.as_tensor(frame_mask, dtype=dtype)[..., None, :]
