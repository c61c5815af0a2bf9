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

In the precision modes "bf16x3" ("high") and "bf16" ("default") both
run ``csrc/attention_modes.cu``, in the TPU kernels' mode arithmetic
(``attention_plain`` / ``attention_bwd_plain`` with ``mode`` say it step
by step): the forward rounds q / sqrt(dh) log2(e) and k, v to their bf16
parts, takes the log2-domain softmax, and rounds each normalized
probability to one bf16 that multiplies v's parts (``attn_modes.cuh``'s
core, one launch); the backward keeps nothing of the forward, as the JAX
vjp keeps only q, k, v and the masks: it rebuilds the natural-exp softmax
from q's and k's parts, splits the float32 probabilities for dv, sums
delta over them, and rounds dl to its parts for dq and dk (two launches,
no atomics).  The JAX package takes XLA's backward above 512 frames, whose
dots XLA on the TPU rounds the same way in these modes; here the kernel
runs at every length.

The model takes this route where the JAX package takes ``fused_attention``:
with ``attn_sublayer_fusion`` off, and at lengths the sublayer kernel does
not take (``layer_fused.sublayer_supported``: T > 512 or T % 8 != 0).  A
wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); ``launches[mode]`` counts the calls that
launched.  ``AttentionFunction`` ties the two together for autograd: in
"f32" it saves q, k, v, the masks and the forward's out and stats (the JAX
vjp saves only the first four), so its backward is the one-pass form; in a
mode it saves what the JAX vjp saves.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .attn_sublayer import (KEY_TILE, KINDS, TILED_HEADS, _mode_scores,
                            bias_from_masks, mode_q_scale)
from .ffn import _PASSES
from .precision import (MODES, check_mode, part_products, parts,
                        prob_products)
from .widths import MAX_HEAD

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_attention": "p" * 5 + "i" * 6 + "ppp",
         "kit_attention_bwd": "p" * 6 + "i" * 6 + "p" * 7}
_MODE_SIGS = {"kit_attention_tc": "i" + "p" * 5 + "i" * 6 + "ppp",
              "kit_attention_tc_bwd": "i" + "p" * 6 + "i" * 6 + "p" * 5}


def _scores(q, k, mask, valid, kind, add_keypad):
    """(B, H, Tq, Tk): q k^T / sqrt(dh) plus the bias."""
    T, dh = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        logits = logits + bias[:, None]
    return logits


def attention_plain(q, k, v, mask, valid, kind: str = "repeat-inc",
                    add_keypad: bool = False, stats: bool = False,
                    mode: str = "f32"):
    """Plain PyTorch version of ``fused_attention`` (the JAX
    ``_xla_attention``); with ``stats`` also (B, H, T, 2) = (row max, row
    sum) of each head's softmax, and the output as exp(s - m) / l v.  In
    a mode, ``_attn_kernel``'s arithmetic (``_mode_attention``)."""
    if check_mode(mode) != "f32":
        return _mode_attention(q, k, v, mask, valid, kind, add_keypad, stats,
                               mode)
    s = _scores(q, k, mask, valid, kind, add_keypad)
    if not stats:
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    return (torch.einsum("bhqk,bkhd->bqhd", e / l, v),
            torch.cat([m, l], -1))


def _mode_attention(q, k, v, mask, valid, kind, add_keypad, stats, mode):
    """``_attn_kernel`` in a mode: q times 1 / sqrt(dh) log2(e) in float32
    (``mode_q_scale``, the kernel's ``scale * LOG2E`` at every head width
    once rounded to float32), then the scores of the parts (k_hi q_hi +
    k_hi q_lo + k_lo q_hi, one term in "bf16") + the bias with its keypad
    term times log2(e); the
    log2-domain softmax (max, exp2, times 1 / sum); the probabilities
    rounded to one bf16 against v's parts.  ``stats``: (m, l) in the log2
    domain."""
    c = torch.tensor(mode_q_scale(q.shape[-1]), dtype=torch.float32)
    qh, kh = (t.transpose(1, 2) for t in (q * c, k))    # (B, H, T, dh)
    logits = _mode_scores(qh, kh, mask, valid, kind, add_keypad, mode)
    m = logits.amax(-1, keepdim=True)
    e = torch.exp2(logits - m)
    l = e.sum(-1, keepdim=True)
    out = prob_products(e * (1.0 / l), parts(v.transpose(1, 2), mode))
    out = out.transpose(1, 2)
    return (out, torch.cat([m, l], -1)) if stats else out


def _mode_attention_bwd(q, k, v, g, mask, valid, kind, add_keypad, mode):
    """``_attn_bwd_kernel`` in a mode, per head in its key-major steps: s =
    (k q^T from the parts) / sqrt(dh) + the bias (natural domain, q
    unscaled); wt = exp(s - max) * (1 / sum) in float32; dv = wt g and gw
    = v g^T from the parts (wt split); delta = sum over the keys of gw wt;
    dl = the parts of wt (gw - delta) / sqrt(dh); dq = dl^T k, dk = dl q."""
    B, T, H, dh = q.shape
    sc = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    qp, kp, vp, gp = (parts(t.transpose(1, 2), mode) for t in (q, k, v, g))

    def tr(ps):
        return tuple(t.transpose(-1, -2) for t in ps)

    st = part_products(kp, tr(qp)) * sc                  # (B, H, Tk, Tq)
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        st = st + bias.transpose(-1, -2)[:, None]
    st = st - st.amax(-2, keepdim=True)
    e = torch.exp(st)
    wt = e * (1.0 / e.sum(-2, keepdim=True))
    dv = part_products(parts(wt, mode), gp)              # (B, H, Tk, dh)
    gw = part_products(vp, tr(gp))                       # (B, H, Tk, Tq)
    tmp = gw - (gw * wt).sum(-2, keepdim=True)
    dlp = parts((wt * tmp) * sc, mode)
    dq = part_products(tr(dlp), kp)
    dk = part_products(dlp, qp)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def attention_bwd_plain(q, k, v, g, mask, valid, kind: str = "repeat-inc",
                        add_keypad: bool = False, out=None, stats=None,
                        mode: str = "f32"):
    """Plain PyTorch version of ``attention_bwd``.  Without ``out`` and
    ``stats``, written out as the JAX package's XLA backward
    (``attention.py:524-534``); with them, as the kernel computes it: p =
    exp(s - m) / l from the saved (row max, row sum), delta = g . out per
    row, ds = p (g v^T - delta).  In a mode (no ``out`` or ``stats``),
    ``_attn_bwd_kernel``'s arithmetic (``_mode_attention_bwd``)."""
    if check_mode(mode) != "f32":
        if out is not None or stats is not None:
            raise ValueError("attention_bwd_plain: a mode's backward takes "
                             "no out or stats")
        return _mode_attention_bwd(q, k, v, g, mask, valid, kind, add_keypad,
                                   mode)
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


def _check(where, q, tensors, mask, valid, kind, add_keypad, mode="f32"):
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
    # the tiled cores and, at head widths a multiple of 8, the mode cores
    # read their rows as float4
    if dh in TILED_HEADS if mode == "f32" else dh % 8 == 0:
        _build.check_aligned(where, q=q, **{n: t for n, t in tensors.items()
                                            if t is not None})
    return mask


def fused_attention(q, k, v, mask, valid, kind: str = "repeat-inc",
                    add_keypad: bool = False, stats: bool = False,
                    mode: str = "f32"):
    """q, k, v (B, T, H, dh) -> out (B, T, H, dh), or (out, stats (B, H,
    T, 2)) with ``stats`` (in a mode (m, l) in the log2 domain).  ``mask``
    (B, T) is read only for "repeat-inc" or ``add_keypad``; ``valid`` None
    means every key is real."""
    check_mode(mode)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, valid, kind, add_keypad, stats,
                               mode)
    mask = _check("fused_attention", q, {"k": k, "v": v}, mask, valid, kind,
                  add_keypad, mode)
    res = _launch_forward(q, k, v, mask, valid, kind, add_keypad, stats,
                          mode)
    fused_attention.launches[mode] += 1
    return res


fused_attention.launches = dict.fromkeys(MODES, 0)


def _launch_forward(q, k, v, mask, valid, kind, add_keypad, stats,
                    mode="f32"):
    """``fused_attention``'s out (and stats) from its checked operands."""
    B, T, H, dh = q.shape
    out = torch.empty_like(q)
    st = torch.empty(B, H, T, 2, device=q.device) if stats else None
    flags = (int(kind == "repeat-inc"), int(add_keypad))
    if mode == "f32":
        lib = _build.bind("attention", _SIGS)
        _build.call(lib, "kit_attention", q.device, q, k, v, mask, valid, B,
                    T, H, dh, *flags, out, st)
    else:
        lib = _build.bind("attention_modes", _MODE_SIGS)
        _build.call(lib, "kit_attention_tc", q.device, _PASSES[mode], q, k, v,
                    mask, valid, B, T, H, dh, *flags, out, st)
    return (out, st) if stats else out


def attention_bwd(q, k, v, g, mask, valid, kind: str = "repeat-inc",
                  add_keypad: bool = False, out=None, stats=None,
                  mode: str = "f32"):
    """Gradients of ``fused_attention``'s out: g (B, T, H, dh) is dL/dout;
    the rest as the forward took them, and in "f32" optionally its out and
    stats (both or neither; without them the forward runs again; a mode's
    backward takes neither and rebuilds its own softmax).  Returns (dq,
    dk, dv)."""
    check_mode(mode)
    if (out is None) != (stats is None):
        raise ValueError("attention_bwd: out and stats are given together")
    if mode != "f32" and out is not None:
        raise ValueError("attention_bwd: a mode's backward takes no out or "
                         "stats")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g, mask, valid, kind, add_keypad,
                                   out, stats, mode)
    where = "attention_bwd"
    mask = _check(where, q, {"k": k, "v": v, "g": g, "out": out}, mask,
                  valid, kind, add_keypad, mode)
    B, T, H, dh = q.shape
    _build.check_tensors(where, q.device, stats=stats)
    _build.check_shape(where, "stats", stats, (B, H, T, 2))
    grads = _launch_backward(q, k, v, g, mask, valid, kind, add_keypad, out,
                             stats, mode)
    attention_bwd.launches[mode] += 1
    return grads


attention_bwd.launches = dict.fromkeys(MODES, 0)


def mode_bwd_scratch_floats(B: int, T: int, H: int) -> int:
    """The scratch of ``kit_attention_tc_bwd``: each query's (m, 1 / l,
    delta) and a pad float, per head and video."""
    return 4 * B * H * T


def _launch_backward(q, k, v, g, mask, valid, kind, add_keypad, out, stats,
                     mode="f32"):
    """``attention_bwd``'s (dq, dk, dv) from its checked operands."""
    B, T, H, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    flags = (int(kind == "repeat-inc"), int(add_keypad))
    if mode == "f32":
        scratch = torch.empty(bwd_scratch_floats(B, T, H, dh,
                                                 out is not None),
                              device=q.device)
        lib = _build.bind("attention", _SIGS)
        _build.call(lib, "kit_attention_bwd", q.device, q, k, v, g, mask,
                    valid, B, T, H, dh, *flags, out, stats, dq, dk, dv,
                    scratch)
    else:
        rows = torch.empty(mode_bwd_scratch_floats(B, T, H), device=q.device)
        lib = _build.bind("attention_modes", _MODE_SIGS)
        _build.call(lib, "kit_attention_tc_bwd", q.device, _PASSES[mode], q,
                    k, v, g, mask, valid, B, T, H, dh, *flags, dq, dk, dv,
                    rows)
    return dq, dk, dv


class AttentionFunction(torch.autograd.Function):
    """``fused_attention`` with ``attention_bwd`` as its backward, in
    ``mode``; no gradient reaches the masks.  In "f32" it keeps the
    forward's out and stats for the one-pass backward; in a mode only q,
    k, v and the masks, as the JAX vjp does.  With ``plain`` the two plain
    versions in their place (the plain training route in a mode, where
    autograd through the bf16 roundings would not be the JAX vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, valid, kind, add_keypad, mode="f32",
                plain=False):
        ctx.cfg = (kind, add_keypad)
        ctx.mode, ctx.plain = mode, plain
        fwd = attention_plain if plain else fused_attention
        if mode != "f32":
            ctx.save_for_backward(q, k, v, mask, valid)
            return fwd(q, k, v, mask, valid, kind, add_keypad, mode=mode)
        out, stats = fwd(q, k, v, mask, valid, kind, add_keypad, stats=True)
        ctx.save_for_backward(q, k, v, mask, valid, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, valid, *res = ctx.saved_tensors
        bwd = attention_bwd_plain if ctx.plain else attention_bwd
        dq, dk, dv = bwd(q, k, v, g.contiguous(), mask, valid, *ctx.cfg,
                         mode=ctx.mode, **dict(zip(("out", "stats"), res)))
        return dq, dk, dv, None, None, None, None, None, None
