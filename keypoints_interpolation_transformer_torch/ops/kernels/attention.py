"""Per-op attention core over (B, T, H, dh): forward and backward.

Kernels (``csrc/attention.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/attention.py``:

  * ``fused_attention`` <- ``_attn_kernel``:

        out = softmax(q k^T / sqrt(dh) + bias) v        (per head)

  * ``attention_bwd`` <- ``_attn_bwd_kernel``: dq, dk, dv from q, k, v,
    g = dL/dout and the masks, the probabilities rebuilt (three launches:
    the forward again for out and the softmax statistics, a query-major dq
    pass and a key-major dk / dv pass).

The bias is built in-kernel from the 1-D (B, T) masks, as the sublayer
kernels build it (``attn_sublayer.bias_from_masks``); Tq = Tk.  Bound on
an H100 by float32 FFMA work (T / 4 FLOP per byte forward); see the source
note in ``csrc/attention.cu``.

The model takes this route where the JAX package takes ``fused_attention``:
with ``attn_sublayer_fusion`` off, and at lengths the sublayer kernel does
not take (``layer_fused.sublayer_supported``: T > 512 or T % 8 != 0).  A
wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); ``launches`` counts the calls that launched.
``AttentionFunction`` ties the two together for autograd, saving what the
JAX vjp saves (q, k, v and the masks).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .attn_sublayer import KINDS, bias_from_masks
from .widths import MAX_HEAD

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_attention": "p" * 5 + "i" * 6 + "pp",
         "kit_attention_bwd": "p" * 6 + "i" * 6 + "p" * 5}


def _probabilities(q, k, mask, valid, kind, add_keypad):
    B, T, H, dh = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        logits = logits + bias[:, None]
    return torch.softmax(logits, dim=-1)


def attention_plain(q, k, v, mask, valid, kind: str = "repeat-inc",
                    add_keypad: bool = False):
    """Plain PyTorch version of ``fused_attention`` (the JAX
    ``_xla_attention``)."""
    w = _probabilities(q, k, mask, valid, kind, add_keypad)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_bwd_plain(q, k, v, g, mask, valid, kind: str = "repeat-inc",
                        add_keypad: bool = False):
    """Plain PyTorch version of ``attention_bwd``, written out as the JAX
    package's XLA backward (``attention.py:524-534``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    w = _probabilities(q, k, mask, valid, kind, add_keypad)
    dv = torch.einsum("bhqk,bqhd->bkhd", w, g)
    gw = torch.einsum("bqhd,bkhd->bhqk", g, v)
    dl = w * (gw - (gw * w).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q)
    return dq, dk, dv


def _check(where, q, tensors, mask, valid, kind, add_keypad):
    """Checks of the kernels' operands; returns the mask the kernel reads
    (None where the kind does not read it)."""
    if kind not in KINDS:
        raise ValueError(f"{where}: unsupported mask kind {kind!r}")
    if q.dim() != 4:
        raise ValueError(f"{where}: q must be (B, T, H, dh), got "
                         f"{tuple(q.shape)}")
    B, T, H, dh = q.shape
    if not 1 <= dh <= MAX_HEAD:
        raise ValueError(f"{where}: needs a head width of 1 to {MAX_HEAD}, "
                         f"got {dh}")
    uses_mask = kind == "repeat-inc" or add_keypad
    if uses_mask and mask is None:
        raise ValueError(f"{where}: kind {kind!r} / add_keypad needs mask")
    mask = mask if uses_mask else None
    _build.check_tensors(where, q.device, q=q, mask=mask, valid=valid,
                         **tensors)
    for name, t in tensors.items():
        # k, v (and g) have the queries' shape: the kernels take Tq = Tk
        _build.check_shape(where, name, t, q.shape)
    _build.check_shape(where, "mask", mask, (B, T))
    _build.check_shape(where, "valid", valid, (B, T))
    return mask


def fused_attention(q, k, v, mask, valid, kind: str = "repeat-inc",
                    add_keypad: bool = False):
    """q, k, v (B, T, H, dh) -> out (B, T, H, dh).  ``mask`` (B, T) is read
    only for "repeat-inc" or ``add_keypad``; ``valid`` None means every key
    is real."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, valid, kind, add_keypad)
    mask = _check("fused_attention", q, {"k": k, "v": v}, mask, valid, kind,
                  add_keypad)
    B, T, H, dh = q.shape
    out = torch.empty_like(q)
    lib = _build.bind("attention", _SIGS)
    _build.call(lib, "kit_attention", q.device, q, k, v, mask, valid, B, T,
                H, dh, int(kind == "repeat-inc"), int(add_keypad), out)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def attention_bwd(q, k, v, g, mask, valid, kind: str = "repeat-inc",
                  add_keypad: bool = False):
    """Gradients of ``fused_attention``'s out: g (B, T, H, dh) is dL/dout;
    the rest as the forward took them.  Returns (dq, dk, dv)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g, mask, valid, kind, add_keypad)
    mask = _check("attention_bwd", q, {"k": k, "v": v, "g": g}, mask, valid,
                  kind, add_keypad)
    B, T, H, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # the rebuilt out, the softmax (max, sum) and delta
    scratch = torch.empty(B * T * H * dh + 3 * B * H * T, device=q.device)
    lib = _build.bind("attention", _SIGS)
    _build.call(lib, "kit_attention_bwd", q.device, q, k, v, g, mask, valid,
                B, T, H, dh, int(kind == "repeat-inc"), int(add_keypad), dq,
                dk, dv, scratch)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class AttentionFunction(torch.autograd.Function):
    """``fused_attention`` with ``attention_bwd`` as its backward; no
    gradient reaches the masks."""

    @staticmethod
    def forward(ctx, q, k, v, mask, valid, kind, add_keypad):
        ctx.cfg = (kind, add_keypad)
        ctx.save_for_backward(q, k, v, mask, valid)
        return fused_attention(q, k, v, mask, valid, kind, add_keypad)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, valid = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g.contiguous(), mask, valid,
                                   *ctx.cfg)
        return dq, dk, dv, None, None, None, None
