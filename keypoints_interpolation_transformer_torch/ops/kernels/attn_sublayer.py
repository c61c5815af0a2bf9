"""Attention sublayer of the transformer: projections, attention,
out-projection, residual and optional LayerNorm; forward, training forward
and backward.

Kernels (``csrc/attn_sublayer.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/attn_sublayer.py``:

  * ``fused_attn_sublayer`` <- ``_sublayer_kernel`` (three launches):

        q = x Wq + bq;  k = m Wk + bk;  v = m Wv + bv        (m = x or memory)
        a = softmax(q k^T / sqrt(dh) + bias) v               (per head)
        y = [LN](x + a Wo + bo)

  * ``fused_attn_sublayer_train`` <- ``_sublayer_train_kernel``: the same
    launches, keeping what the backward reads: qkv (the unscaled q, k, v
    projections), the attention output a, the per-(row, head) softmax
    statistics (row max and row sum: the log-sum-exp in its two parts) and
    the pre-LN sum r when there is a LayerNorm;
  * ``attn_sublayer_bwd`` <- ``_sublayer_bwd_kernel``: LN backward, dWo /
    dbo / da, the per-head softmax backward with each probability rebuilt
    from q, k, the in-kernel bias and the saved statistics (no (T, T)
    tensor is stored), dq / dk / dv, dWq / dWk / dWv and their biases, dx,
    and dmem for cross-attention.  Its products stream through
    ``csrc/sgemm.cuh``'s 8 x 8 FFMA core; its attention core is one
    deterministic pass over each (video, head, ``KEY_TILE`` keys) at the
    head widths ``TILED_HEADS`` (``csrc/attention_grad.cuh``), two passes
    at the others.

The bias is built in-kernel from the 1-D (B, T) masks (the contract of
``ops/pallas/attention.py::_bias_terms``): ``NEG`` where ``kind`` is
"repeat-inc", key > query and ``mask[key] == 1``; plus the raw mask when
``add_keypad``; plus ``NEG`` on invalid (padded) keys.  "all" has no
causal term.

Bound on an H100 by float32 FFMA work in the projections (0.52 MFLOP per
token forward at D = 256, twice that backward); the attention cores stream
keys (or queries) through shared memory, so no (T, T) tensor reaches
device memory.  See the source notes in ``csrc/attn_sublayer.cu`` and
``csrc/attention_grad.cuh``.

Weights: the forward kernels take the Flax layout, q/k/v packed, wqkv =
[Wq | Wk | Wv] (D, 3D) with bqkv (3D,), wo (D, D); the backward takes
torch's layout, w_in = ``in_proj_weight`` (3D, D) and w_out =
``out_proj.weight`` (D, D), and returns the weight gradients in it.  A
wrapper takes its plain version for CPU tensors and launches its kernels
for CUDA tensors (or raises); ``launches`` counts the calls that launched,
one per call of the TPU kernel.  ``AttnSublayerFunction`` ties the
training forward and the backward together.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..masks import NEG
from . import _build
from .ffn import LN_EPS, _ln_bwd_plain, wave_splits
from .widths import check_heads, cut, cut_blocks, kernel_width, pad, \
    pad_blocks, row_tile

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_attn_sublayer": "pp" + "i" * 5 + "p" * 8 + "ii" + "p" * 6,
         "kit_attn_sublayer_bwd": "p" * 12 + "i" * 8 + "p" * 9}
KINDS = ("repeat-inc", "all")
# the backward's one-pass attention core (``csrc/attention_grad.cuh``):
# the keys a block owns (``AB_KT``) and the head widths it is built for
# (``tiled_head``)
KEY_TILE = 128
TILED_HEADS = (16, 32, 64)


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


def _check_config(where, x, mask, kind, add_keypad, heads):
    """The mask kind and widths the kernels take; returns ``mask`` (None
    where the kind does not read it)."""
    if kind not in KINDS:
        raise ValueError(f"{where}: unsupported mask kind {kind!r}")
    kernel_width(where, x.shape[-1])
    check_heads(where, x.shape[-1], heads)
    uses_mask = kind == "repeat-inc" or add_keypad
    if uses_mask and mask is None:
        raise ValueError(f"{where}: kind {kind!r} / add_keypad needs mask")
    return mask if uses_mask else None


def _check_forward(where, x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                   valid, kind, add_keypad, heads):
    """Checks of the forward kernels' operands; returns ``mask`` as
    ``_check_config`` does."""
    mask = _check_config(where, x, mask, kind, add_keypad, heads)
    B, T, D = x.shape
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
    _build.check_aligned(where, x=x, wqkv=wqkv, wo=wo)
    return mask


def _launch_forward(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask, valid,
                    kind, add_keypad, heads, train=False):
    """(y, qkv, a, stats, r) at the model's width n; stats and r only
    with ``train`` (r only with a LayerNorm).  Runs at the kernel width D,
    the operands zero-padded from n (``widths``)."""
    B, T, n = x.shape
    D = kernel_width("fused_attn_sublayer", n)
    x, memory, wo, bo, ln_w, ln_b = (
        pad(t, D) for t in (x, memory, wo, bo, ln_w, ln_b))
    wo = pad(wo, D, D)
    wqkv = pad(pad_blocks(wqkv, n, D, 1), D, 3 * D)
    bqkv = pad_blocks(bqkv, n, D, 0)
    dev = x.device
    qkv = torch.empty(B, T, 3 * D, device=dev)
    # the columns from H * dh on are not written, and the padded wo reads
    # them as 0 * a: they must hold zeros, not NaNs
    a = (torch.empty if n == D else torch.zeros)(B, T, D, device=dev)
    y = torch.empty_like(x)
    stats = torch.empty(B, heads, T, 2, device=dev) if train else None
    r = torch.empty_like(x) if train and ln_w is not None else None
    lib = _build.bind("attn_sublayer", _SIGS)
    _build.call(lib, "kit_attn_sublayer", dev, x,
                x if memory is None else memory, B, T, D, n, heads, wqkv,
                bqkv, wo, bo, ln_w, ln_b, mask, valid,
                int(kind == "repeat-inc"), int(add_keypad), qkv, a, y, stats,
                r)
    return (cut(y, n), cut_blocks(qkv, n, D, -1), cut(a, n), stats,
            cut(r, n))


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
    mask = _check_forward("fused_attn_sublayer", x, memory, wqkv, bqkv, wo,
                          bo, ln_w, ln_b, mask, valid, kind, add_keypad,
                          heads)
    y = _launch_forward(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                        valid, kind, add_keypad, heads)[0]
    fused_attn_sublayer.launches += 1
    return y


fused_attn_sublayer.launches = 0


def attn_sublayer_train_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                              mask, valid, kind: str, add_keypad: bool,
                              heads: int):
    """Plain PyTorch version of ``fused_attn_sublayer_train``: (y, qkv
    (B, T, 3D), a (B, T, D), stats (B, H, T, 2) = (row max, row sum) of
    each head's softmax, r (B, T, D) or None without a LayerNorm)."""
    B, T, D = x.shape
    dh = D // heads
    mem = x if memory is None else memory
    qkv = torch.cat([x @ wqkv[:, :D] + bqkv[:D],
                     mem @ wqkv[:, D:] + bqkv[D:]], -1)
    q, k, v = (t.reshape(B, T, heads, dh).transpose(1, 2)
               for t in qkv.split(D, -1))
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        logits = logits + bias[:, None]
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(-1, keepdim=True)
    a = ((e / l) @ v).transpose(1, 2).reshape(B, T, D)
    r = x + (a @ wo + bo)
    stats = torch.cat([m, l], -1)
    if ln_w is None:
        return r, qkv, a, stats, None
    return F.layer_norm(r, (D,), ln_w, ln_b, LN_EPS), qkv, a, stats, r


def fused_attn_sublayer_train(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                              mask, valid, kind: str = "repeat-inc",
                              add_keypad: bool = False, heads: int = 8):
    """``fused_attn_sublayer`` that also returns what its backward reads:
    (y, qkv, a, stats, r), as ``attn_sublayer_train_plain`` says."""
    if x.device.type == "cpu":
        return attn_sublayer_train_plain(x, memory, wqkv, bqkv, wo, bo, ln_w,
                                         ln_b, mask, valid, kind, add_keypad,
                                         heads)
    mask = _check_forward("fused_attn_sublayer_train", x, memory, wqkv,
                          bqkv, wo, bo, ln_w, ln_b, mask, valid, kind,
                          add_keypad, heads)
    y, qkv, a, stats, r = _launch_forward(x, memory, wqkv, bqkv, wo, bo,
                                          ln_w, ln_b, mask, valid, kind,
                                          add_keypad, heads, train=True)
    fused_attn_sublayer_train.launches += 1
    return y, qkv, a, stats, r


fused_attn_sublayer_train.launches = 0


def attn_core_bwd_plain(da, qkv, a, stats, mask, valid, kind: str,
                        add_keypad: bool, heads: int):
    """The attention core's part of ``attn_sublayer_bwd_plain``: (dq, dk,
    dv), each (B, T, D), from dA = dL/da (B, T, D), the training forward's
    qkv, a and stats, each probability rebuilt from q, k, the bias and the
    saved (row max, row sum)."""
    B, T, D = a.shape
    dh = D // heads
    scale = 1.0 / math.sqrt(dh)

    def heads_of(t):
        return t.reshape(B, T, heads, dh).transpose(1, 2)

    q, k, v = (heads_of(t) for t in qkv.split(D, -1))
    s = (q @ k.transpose(-1, -2)) * scale
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        s = s + bias[:, None]
    p = torch.exp(s - stats[..., :1]) / stats[..., 1:]   # (B, H, Tq, Tk)
    gh = heads_of(da)
    delta = (gh * heads_of(a)).sum(-1, keepdim=True)     # rowsum(dO * O)
    dv = p.transpose(-1, -2) @ gh
    ds = p * (gh @ v.transpose(-1, -2) - delta)
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale

    def rows(t):
        return t.transpose(1, 2).reshape(B, T, D)

    return rows(dq), rows(dk), rows(dv)


def attn_sublayer_bwd_plain(dy, x, memory, qkv, a, stats, r, w_in, w_out,
                            ln_w, mask, valid, kind: str, add_keypad: bool,
                            heads: int):
    """Plain PyTorch version of ``attn_sublayer_bwd``, written out step by
    step: each probability rebuilt from q, k, the bias and the saved
    (row max, row sum) (``attn_core_bwd_plain``)."""
    B, T, D = x.shape
    g = dy.reshape(-1, D)
    dg = dbe = None
    if ln_w is not None:
        g, dg, dbe = _ln_bwd_plain(g, r.reshape(-1, D), ln_w)
    dr = g                                               # (M, D)
    dw_out = dr.t() @ a.reshape(-1, D)                   # [o, i]
    db_out = dr.sum(0)
    da = dr @ w_out                                      # (M, D)
    dq, dk, dv = attn_core_bwd_plain(da.reshape(B, T, D), qkv, a, stats,
                                     mask, valid, kind, add_keypad, heads)
    dqkv = torch.cat([dq, dk, dv], -1).reshape(-1, 3 * D)  # (M, 3D)
    db_in = dqkv.sum(0)
    xf = x.reshape(-1, D)
    mf = xf if memory is None else memory.reshape(-1, D)
    dw_in = torch.cat([dqkv[:, :D].t() @ xf, dqkv[:, D:].t() @ mf], 0)
    dx = dr + dqkv[:, :D] @ w_in[:D]
    dkv_in = dqkv[:, D:] @ w_in[D:]
    dmem = None
    if memory is None:
        dx = dx + dkv_in
    else:
        dmem = dkv_in.reshape(x.shape)
    return (dx.reshape(x.shape), dmem, dw_in, db_in, dw_out, db_out, dg,
            dbe)


def bwd_splits(M: int, D: int) -> int:
    """The row ranges of ``attn_sublayer_bwd``'s weight-gradient launch at
    M = B T rows and kernel width D: with the row tiles of [dW_in^T |
    dW_out^T], 4 D / ``row_tile(D)``, they fill one wave of the card."""
    return wave_splits(M, 4 * D // row_tile(D))


def bwd_scratch_floats(B: int, T: int, D: int, heads: int, dh: int) -> int:
    """The scratch ``kit_attn_sublayer_bwd`` lays out (``csrc/
    attn_sublayer.cu``) at kernel width D and head width dh: dr, da and
    dqkv (5 M D), delta (B H T, rounded up to 4), the LayerNorm's sums per
    32-row block, the weight and bias gradients' per row range and, where
    the head width takes the one-pass core and there is more than one key
    tile, each key tile's dq part (M D)."""
    M = B * T
    tiles = -(-T // KEY_TILE)
    parts = tiles * M * D if dh in TILED_HEADS and tiles > 1 else 0
    return (5 * M * D + -(-B * heads * T // 4) * 4 + -(-M // 32) * 2 * D
            + bwd_splits(M, D) * (4 * D * D + 4 * D) + parts)


def attn_sublayer_bwd(dy, x, memory, qkv, a, stats, r, w_in, w_out, ln_w,
                      mask, valid, kind: str = "repeat-inc",
                      add_keypad: bool = False, heads: int = 8):
    """Gradients of ``fused_attn_sublayer_train``'s y: dy (B, T, D) is
    dL/dy; x, memory, masks as the forward saw them; qkv, a, stats, r as
    it wrote them; w_in (3D, D) and w_out (D, D) in torch's layout.
    Returns (dx, dmem, dw_in, db_in, dw_out, db_out, dln_w, dln_b); dmem
    is None for self-attention, dln_* None without a LayerNorm."""
    if dy.device.type == "cpu":
        return attn_sublayer_bwd_plain(dy, x, memory, qkv, a, stats, r, w_in,
                                       w_out, ln_w, mask, valid, kind,
                                       add_keypad, heads)
    where = "attn_sublayer_bwd"
    B, T, D = x.shape
    mask = _check_config(where, x, mask, kind, add_keypad, heads)
    if (ln_w is None) != (r is None):
        raise ValueError(f"{where}: r is given exactly when ln_w is")
    _build.check_tensors(where, dy.device, dy=dy, x=x, memory=memory,
                         qkv=qkv, a=a, stats=stats, r=r, w_in=w_in,
                         w_out=w_out, ln_w=ln_w, mask=mask, valid=valid)
    for name, t, shape in (("dy", dy, (B, T, D)), ("memory", memory,
                                                    (B, T, D)),
                           ("qkv", qkv, (B, T, 3 * D)), ("a", a, (B, T, D)),
                           ("stats", stats, (B, heads, T, 2)),
                           ("r", r, (B, T, D)), ("w_in", w_in, (3 * D, D)),
                           ("w_out", w_out, (D, D)), ("ln_w", ln_w, (D,)),
                           ("mask", mask, (B, T)), ("valid", valid, (B, T))):
        _build.check_shape(where, name, t, shape)
    _build.check_aligned(where, **{k: t for k, t in (
        ("dy", dy), ("x", x), ("memory", memory), ("qkv", qkv), ("a", a),
        ("r", r), ("w_in", w_in), ("w_out", w_out)) if t is not None})
    grads = _launch_backward(dy, x, memory, qkv, a, stats, r, w_in, w_out,
                             ln_w, mask, valid, kind, add_keypad, heads)
    attn_sublayer_bwd.launches += 1
    return grads


def _launch_backward(dy, x, memory, qkv, a, stats, r, w_in, w_out, ln_w,
                     mask, valid, kind, add_keypad, heads):
    """``attn_sublayer_bwd``'s gradients from its checked operands, at the
    model's width n.  Runs at the kernel width D, the operands zero-padded
    from n (``widths``)."""
    B, T, n = x.shape
    D = kernel_width("attn_sublayer_bwd", n)
    dy, x, memory, a, r, ln_w = (pad(t, D) for t in (dy, x, memory, a, r,
                                                     ln_w))
    qkv = pad_blocks(qkv, n, D, -1)
    w_in = pad(pad_blocks(w_in, n, D, 0), 3 * D, D)
    w_out = pad(w_out, D, D)
    dev = dy.device
    empty = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    s_w = bwd_splits(B * T, D)
    dx = empty(B, T, D)
    dmem = None if memory is None else empty(B, T, D)
    dw_in, db_in = empty(3 * D, D), empty(3 * D)
    dw_out, db_out = empty(D, D), empty(D)
    ln_out = empty(2, D)
    scratch = empty(bwd_scratch_floats(B, T, D, heads, n // heads))
    lib = _build.bind("attn_sublayer", _SIGS)
    _build.call(lib, "kit_attn_sublayer_bwd", dev, dy, x, memory, qkv, a,
                stats, r, w_in, w_out, ln_w, mask, valid, B, T, D, n, heads,
                int(kind == "repeat-inc"), int(add_keypad), s_w, dx,
                dmem, dw_in, db_in, dw_out, db_out, ln_out, scratch)
    dg, dbe = (None, None) if ln_w is None else (cut(ln_out[0], n),
                                                 cut(ln_out[1], n))
    return (cut(dx, n), cut(dmem, n), cut(cut_blocks(dw_in, n, D, 0), n),
            cut_blocks(db_in, n, D, 0), cut(dw_out, n, n), cut(db_out, n),
            dg, dbe)


attn_sublayer_bwd.launches = 0


class AttnSublayerFunction(torch.autograd.Function):
    """[LN](x + MHA(x, memory or x)) through ``fused_attn_sublayer_train``
    and ``attn_sublayer_bwd``.  Takes the parameters in torch's layout
    (w_in = in_proj_weight, w_out = out_proj.weight) and returns their
    gradients in it; ``memory`` None selects self-attention."""

    @staticmethod
    def forward(ctx, x, memory, w_in, b_in, w_out, b_out, ln_w, ln_b, mask,
                valid, kind, add_keypad, heads):
        y, qkv, a, stats, r = fused_attn_sublayer_train(
            x, memory, w_in.t().contiguous(), b_in, w_out.t().contiguous(),
            b_out, ln_w, ln_b, mask, valid, kind, add_keypad, heads)
        ctx.cfg = (kind, add_keypad, heads)
        ctx.save_for_backward(x, memory, qkv, a, stats, r, w_in, w_out,
                              ln_w, mask, valid)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, memory, qkv, a, stats, r, w_in, w_out, ln_w, mask, valid = \
            ctx.saved_tensors
        dx, dmem, dw_in, db_in, dw_out, db_out, dg, dbe = attn_sublayer_bwd(
            dy.contiguous(), x, memory, qkv, a, stats, r, w_in, w_out, ln_w,
            mask, valid, *ctx.cfg)
        return (dx, dmem, dw_in, db_in, dw_out, db_out, dg, dbe, None, None,
                None, None, None)
