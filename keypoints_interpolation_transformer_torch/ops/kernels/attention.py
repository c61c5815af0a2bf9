"""Per-op attention core over (B, T, H, dh): forward and backward.

Kernels (``csrc/attention.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/attention.py``:

  * ``fused_attention`` <- ``_attn_kernel``:

        out = softmax(q k^T / sqrt(dh) + bias) v        (per head)

    and, with ``stats=True``, each (video, head, query)'s softmax row max
    and row sum, stats (B, H, T, 2) = (m, l): the log-sum-exp in two parts,
    since m + log l rounds log l away at a fully blocked row (m = NEG).
    4 B H T^2 dh FLOP.  At head widths 16, 32 and 64 one block takes 64
    queries of one (video, head), 8 rows a warp, with q k^T and p v as
    register-tiled products and keys streamed through a ``cp.async`` ring
    (``csrc/attention_fwd.cuh``); other head widths keep one query a thread
    (``csrc/attention.cuh``).

  * ``attention_bwd`` <- ``_attn_bwd_kernel``: dq, dk, dv from q, k, v,
    g = dL/dout, the masks and, where the caller kept them, the forward's
    out and stats; p is rebuilt as exp(s - m) / l from the forward's own
    score.  10 B H T^2 dh FLOP: at head widths 16, 32 and 64 one pass per
    (128 keys, head, video) (``csrc/attention_grad.cuh``, the core of
    ``attn_sublayer_bwd``; at T > 128 each key tile's dq part is added in
    order by a second launch), elsewhere two passes (``attention.cuh``).
    Without out and stats it runs the forward into scratch first.  No sum
    uses atomics: the gradients have the same bits from run to run.

The bias is built in-kernel from the 1-D (B, T) masks, as the sublayer
kernels build it (``attn_sublayer.bias_from_masks``); Tq = Tk.  Bound on
an H100 by float32 FFMA work (T / 4 FLOP per byte forward); see the source
note in ``csrc/attention.cu``.

The model takes this route where the JAX package takes ``fused_attention``:
with ``attn_sublayer_fusion`` off, and at lengths the sublayer kernel does
not take (``layer_fused.sublayer_supported``: T > 512 or T % 8 != 0).  A
wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); ``launches`` counts the calls that launched.
``AttentionFunction`` ties the two together for autograd, saving q, k, v,
the masks and the forward's out and stats (the JAX vjp saves only the
first four), so its backward is the one-pass form.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .attn_sublayer import KEY_TILE, KINDS, TILED_HEADS, bias_from_masks
from .widths import MAX_HEAD

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_attention": "p" * 5 + "i" * 6 + "ppp",
         "kit_attention_bwd": "p" * 6 + "i" * 6 + "p" * 7}


def _scores(q, k, mask, valid, kind, add_keypad):
    """(B, H, Tq, Tk): q k^T / sqrt(dh) plus the bias."""
    T, dh = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        logits = logits + bias[:, None]
    return logits


def attention_plain(q, k, v, mask, valid, kind: str = "repeat-inc",
                    add_keypad: bool = False, stats: bool = False):
    """Plain PyTorch version of ``fused_attention`` (the JAX
    ``_xla_attention``); with ``stats`` also (B, H, T, 2) = (row max, row
    sum) of each head's softmax, and the output as exp(s - m) / l v."""
    s = _scores(q, k, mask, valid, kind, add_keypad)
    if not stats:
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    return (torch.einsum("bhqk,bkhd->bqhd", e / l, v),
            torch.cat([m, l], -1))


def attention_bwd_plain(q, k, v, g, mask, valid, kind: str = "repeat-inc",
                        add_keypad: bool = False, out=None, stats=None):
    """Plain PyTorch version of ``attention_bwd``.  Without ``out`` and
    ``stats``, written out as the JAX package's XLA backward
    (``attention.py:524-534``); with them, as the kernel computes it: p =
    exp(s - m) / l from the saved (row max, row sum), delta = g . out per
    row, ds = p (g v^T - delta)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if out is None:
        w = torch.softmax(_scores(q, k, mask, valid, kind, add_keypad), -1)
        dv = torch.einsum("bhqk,bqhd->bkhd", w, g)
        gw = torch.einsum("bqhd,bkhd->bhqk", g, v)
        dl = w * (gw - (gw * w).sum(-1, keepdim=True)) * scale
        dq = torch.einsum("bhqk,bkhd->bqhd", dl, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", dl, q)
        return dq, dk, dv
    s = _scores(q, k, mask, valid, kind, add_keypad)
    p = torch.exp(s - stats[..., :1]) / stats[..., 1:]     # (B, H, Tq, Tk)
    delta = torch.einsum("bqhd,bqhd->bhq", g, out)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g, v) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def bwd_scratch_floats(B: int, T: int, H: int, dh: int,
                       residuals: bool) -> int:
    """The scratch ``kit_attention_bwd`` lays out (``csrc/attention.cu``),
    each part rounded up to 4 floats: without the forward's out and stats
    (``residuals`` False) room for them (B T H dh + 2 B H T); delta (B H
    T) where the head width takes the two passes; where it takes the
    one-pass core (``TILED_HEADS``) and T spans more than one key tile,
    each key tile's dq part (B T H dh), as ``attn_sublayer.
    bwd_scratch_floats`` sizes them for the sublayer backward."""
    def r4(n):
        return -(-n // 4) * 4
    n = 0 if residuals else B * T * H * dh + r4(2 * B * H * T)
    if dh not in TILED_HEADS:
        return n + r4(B * H * T)
    tiles = -(-T // KEY_TILE)
    return n + (tiles * B * T * H * dh if tiles > 1 else 0)


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
        # k, v (and g, out) have the queries' shape: the kernels take Tq = Tk
        _build.check_shape(where, name, t, q.shape)
    _build.check_shape(where, "mask", mask, (B, T))
    _build.check_shape(where, "valid", valid, (B, T))
    if dh in TILED_HEADS:  # the tiled cores read their rows as float4
        _build.check_aligned(where, q=q, **{n: t for n, t in tensors.items()
                                            if t is not None})
    return mask


def fused_attention(q, k, v, mask, valid, kind: str = "repeat-inc",
                    add_keypad: bool = False, stats: bool = False):
    """q, k, v (B, T, H, dh) -> out (B, T, H, dh), or (out, stats (B, H,
    T, 2)) with ``stats``.  ``mask`` (B, T) is read only for "repeat-inc"
    or ``add_keypad``; ``valid`` None means every key is real."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, valid, kind, add_keypad, stats)
    mask = _check("fused_attention", q, {"k": k, "v": v}, mask, valid, kind,
                  add_keypad)
    res = _launch_forward(q, k, v, mask, valid, kind, add_keypad, stats)
    fused_attention.launches += 1
    return res


fused_attention.launches = 0


def _launch_forward(q, k, v, mask, valid, kind, add_keypad, stats):
    """``fused_attention``'s out (and stats) from its checked operands."""
    B, T, H, dh = q.shape
    out = torch.empty_like(q)
    st = torch.empty(B, H, T, 2, device=q.device) if stats else None
    lib = _build.bind("attention", _SIGS)
    _build.call(lib, "kit_attention", q.device, q, k, v, mask, valid, B, T,
                H, dh, int(kind == "repeat-inc"), int(add_keypad), out, st)
    return (out, st) if stats else out


def attention_bwd(q, k, v, g, mask, valid, kind: str = "repeat-inc",
                  add_keypad: bool = False, out=None, stats=None):
    """Gradients of ``fused_attention``'s out: g (B, T, H, dh) is dL/dout;
    the rest as the forward took them, and optionally its out and stats
    (both or neither; without them the forward runs again).  Returns (dq,
    dk, dv)."""
    if (out is None) != (stats is None):
        raise ValueError("attention_bwd: out and stats are given together")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g, mask, valid, kind, add_keypad,
                                   out, stats)
    where = "attention_bwd"
    mask = _check(where, q, {"k": k, "v": v, "g": g, "out": out}, mask,
                  valid, kind, add_keypad)
    B, T, H, dh = q.shape
    _build.check_tensors(where, q.device, stats=stats)
    _build.check_shape(where, "stats", stats, (B, H, T, 2))
    grads = _launch_backward(q, k, v, g, mask, valid, kind, add_keypad, out,
                             stats)
    attention_bwd.launches += 1
    return grads


attention_bwd.launches = 0


def _launch_backward(q, k, v, g, mask, valid, kind, add_keypad, out, stats):
    """``attention_bwd``'s (dq, dk, dv) from its checked operands."""
    B, T, H, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty(bwd_scratch_floats(B, T, H, dh, out is not None),
                          device=q.device)
    lib = _build.bind("attention", _SIGS)
    _build.call(lib, "kit_attention_bwd", q.device, q, k, v, g, mask, valid,
                B, T, H, dh, int(kind == "repeat-inc"), int(add_keypad), out,
                stats, dq, dk, dv, scratch)
    return dq, dk, dv


class AttentionFunction(torch.autograd.Function):
    """``fused_attention`` with ``attention_bwd`` as its backward, given the
    forward's out and stats; no gradient reaches the masks."""

    @staticmethod
    def forward(ctx, q, k, v, mask, valid, kind, add_keypad):
        ctx.cfg = (kind, add_keypad)
        out, stats = fused_attention(q, k, v, mask, valid, kind, add_keypad,
                                     stats=True)
        ctx.save_for_backward(q, k, v, mask, valid, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, valid, out, stats = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g.contiguous(), mask, valid,
                                   *ctx.cfg, out=out, stats=stats)
        return dq, dk, dv, None, None, None, None
