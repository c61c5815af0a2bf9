"""Attention sublayer of the transformer: projections, attention,
out-projection, residual and optional LayerNorm.

Kernel (``csrc/attn_sublayer.cu``, three launches), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/attn_sublayer.py::
_sublayer_kernel``:

    q = x Wq + bq;  k = m Wk + bk;  v = m Wv + bv        (m = x or memory)
    a = softmax(q k^T / sqrt(dh) + bias) v               (per head)
    y = [LN](x + a Wo + bo)

with the bias built in-kernel from the 1-D (B, T) masks (the contract of
``ops/pallas/attention.py::_bias_terms``): ``NEG`` where ``kind`` is
"repeat-inc", key > query and ``mask[key] == 1``; plus the raw mask when
``add_keypad``; plus ``NEG`` on invalid (padded) keys.  "all" has no
causal term.

Bound on an H100 by float32 FFMA work in the projections (0.52 MFLOP
per token at D = 256); the attention core streams keys with an online softmax
so the (T, T) scores never reach device memory.  See the source note in
``csrc/attn_sublayer.cu`` for what passes between the three launches.

Weights are in the Flax layout, q/k/v packed: ``wqkv = [Wq | Wk | Wv]``
(D, 3D), ``bqkv`` (3D,).  The wrapper takes ``attn_sublayer_plain`` for
CPU tensors and launches the kernels for CUDA tensors; ``launches``
counts the calls that launched them, one per call of the TPU kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..masks import NEG
from . import _build
from .ffn import LN_EPS

_SIGS = {"kit_attn_sublayer": "ppiiiippppppppiipppp"}
_WIDTHS = (128, 256)
_HEAD_DIMS = (16, 32, 64)
KINDS = ("repeat-inc", "all")


def bias_from_masks(mask, valid, T: int, kind: str, add_keypad: bool):
    """Additive bias, broadcastable to (B, T_query, T_key) (key-only terms
    stay (B, 1, T_key)), from the 1-D masks, summed in the
    order of the JAX ``_bias_terms``, or None when no term applies.
    ``mask`` is read only for "repeat-inc" or ``add_keypad``."""
    if kind not in KINDS:
        raise ValueError(f"unsupported mask kind {kind!r}")
    bias = None
    if kind == "repeat-inc":
        idx = torch.arange(T, device=mask.device)
        future = idx[None, :] > idx[:, None]
        blocked = future[None] & (mask[:, None, :] > 0)
        bias = torch.where(blocked, NEG, 0.0)
    if add_keypad:
        kp = mask[:, None, :]
        bias = kp if bias is None else bias + kp
    if valid is not None:
        vb = torch.where(valid[:, None, :] > 0, 0.0, NEG)
        bias = vb if bias is None else bias + vb
    return bias


def attn_sublayer_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                        valid, kind: str, add_keypad: bool, heads: int):
    """Plain PyTorch version of ``fused_attn_sublayer``."""
    B, T, D = x.shape
    dh = D // heads
    mem = x if memory is None else memory
    wq, wk, wv = wqkv.split(D, dim=1)
    bq, bk, bv = bqkv.split(D)

    def split(t):
        return t.reshape(B, T, heads, dh).transpose(1, 2)

    q, k, v = split(x @ wq + bq), split(mem @ wk + bk), split(mem @ wv + bv)
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        logits = logits + bias[:, None]
    a = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(B, T, D)
    r = x + (a @ wo + bo)
    if ln_w is not None:
        r = F.layer_norm(r, (D,), ln_w, ln_b, LN_EPS)
    return r


def fused_attn_sublayer(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                        valid, kind: str = "repeat-inc",
                        add_keypad: bool = False, heads: int = 8):
    """x (B, T, D) -> y (B, T, D).  ``memory`` None selects
    self-attention; ``ln_w``/``ln_b`` None means no LayerNorm; ``mask`` is
    read only for "repeat-inc" or ``add_keypad``; ``valid`` None means every
    key is real."""
    if x.device.type == "cpu":
        return attn_sublayer_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                                   mask, valid, kind, add_keypad, heads)
    where = "fused_attn_sublayer"
    if kind not in KINDS:
        raise ValueError(f"{where}: unsupported mask kind {kind!r}")
    B, T, D = x.shape
    if D not in _WIDTHS or D % heads or D // heads not in _HEAD_DIMS:
        raise ValueError(f"{where}: needs D in {_WIDTHS} and D / heads in "
                         f"{_HEAD_DIMS}, got D={D}, heads={heads}")
    uses_mask = kind == "repeat-inc" or add_keypad
    if uses_mask and mask is None:
        raise ValueError(f"{where}: kind {kind!r} / add_keypad needs mask")
    mask = mask if uses_mask else None
    _build.check_tensors(where, x.device, x=x, memory=memory, wqkv=wqkv,
                         bqkv=bqkv, wo=wo, bo=bo, ln_w=ln_w, ln_b=ln_b,
                         mask=mask, valid=valid)
    for name, t, shape in (("memory", memory, (B, T, D)),
                           ("wqkv", wqkv, (D, 3 * D)), ("bqkv", bqkv, (3 * D,)),
                           ("wo", wo, (D, D)), ("bo", bo, (D,)),
                           ("ln_w", ln_w, (D,)), ("ln_b", ln_b, (D,)),
                           ("mask", mask, (B, T)), ("valid", valid, (B, T))):
        _build.check_shape(where, name, t, shape)
    if (ln_w is None) != (ln_b is None):
        raise ValueError(f"{where}: give both ln_w and ln_b or neither")
    _build.check_aligned(where, wqkv=wqkv, wo=wo)
    qkv = torch.empty(B, T, 3 * D, device=x.device)
    a = torch.empty(B, T, D, device=x.device)
    y = torch.empty_like(x)
    lib = _build.bind("attn_sublayer", _SIGS)
    _build.call(lib, "kit_attn_sublayer", x.device, x,
                x if memory is None else memory, B, T, D, heads, wqkv, bqkv,
                wo, bo, ln_w, ln_b, mask, valid, int(kind == "repeat-inc"),
                int(add_keypad), qkv, a, y)
    fused_attn_sublayer.launches += 1
    return y


fused_attn_sublayer.launches = 0
