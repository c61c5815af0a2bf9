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
device memory.  The forward's projections run on ``csrc/sgemm.cuh``'s 8 x
8 core (narrower tiles where the rows alone leave the card idle), its
attention core is the per-op forward's (``csrc/attention_fwd.cuh``), so
its statistics are the ones the backward's core rebuilds p from.  See the
source notes in ``csrc/attn_sublayer.cu`` and
``csrc/attention_grad.cuh``.

The precision modes "high" (bf16x3) and "default" (one bf16 pass;
``precision.py``), ``csrc/attn_sublayer_modes.cu`` on the bf16 tensor cores
(``csrc/tc_gemm.cuh``'s products, ``csrc/attn_modes.cuh``'s ``mma.sync``
attention cores), as the JAX kernels compute them under those modes:

  * ``fused_attn_sublayer(..., mode)``: log2(e) / sqrt(dh) folded into Wq
    and bq before the split (``attn_weight_planes``, the planes the merged
    mode layers read too), every product of bf16 parts, the softmax on exp2
    with p rounded to one bf16 (``attn_sublayer_plain``'s mode arithmetic);
  * ``fused_attn_sublayer_train(..., mode)``: Wq not folded: q = x Wq + bq
    in the mode is the kept residual, and the core reads the planes of q
    times the scale (applied after the bias); its y therefore differs from
    the serving form's by rounding.  It keeps q, k, v and a in float32 and
    each row's statistics in the log2 domain, (max, sum) of exp2;
  * ``attn_sublayer_bwd(..., mode)``: every product of the JAX
    ``_sublayer_bwd_kernel`` in the mode, each probability rebuilt from q
    times the scale, the bias and the statistics (the forward's very bf16
    p), no (T, T) tensor in memory.  The TPU kernel sums its softmax
    correction as sum over keys of gw p; the kernel sums delta = (dA_hi +
    dA_lo) . a over the forward's float32 a instead (the same sum at
    "default", the lo lo term more at "high"); the plain version follows
    the TPU kernel.  The saved a is float32.

Weights: the forward kernels take the Flax layout, q/k/v packed, wqkv =
[Wq | Wk | Wv] (D, 3D) with bqkv (3D,), wo (D, D); the backward takes
torch's layout, w_in = ``in_proj_weight`` (3D, D) and w_out =
``out_proj.weight`` (D, D), and returns the weight gradients in it.  In the
modes the kernels read bf16 planes: the serving forward the folded Flax
ones (``attn_weight_planes``), the training forward and the backward the
planes of w_in and w_out in torch's layout (``attn_train_planes``), which
``AttnSublayerFunction`` splits once a forward and hands to the backward.
A wrapper takes its plain version for CPU tensors and launches its kernels
for CUDA tensors (or raises); ``launches[mode]`` counts the calls that
launched, one per call of the TPU kernel.  ``AttnSublayerFunction`` ties
the training forward and the backward together.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..masks import NEG
from . import _build
from .ffn import _PASSES, LN_EPS, _ln_bwd_plain, wave_splits
from .precision import (MODES, check_mode, part_products, parts,
                        prob_products, split_bf16, weight_planes)
from .widths import check_heads, cut, cut_blocks, kernel_width, pad, \
    pad_blocks, row_tile

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_attn_sublayer": "pp" + "i" * 5 + "p" * 8 + "ii" + "p" * 6,
         "kit_attn_sublayer_bwd": "p" * 12 + "i" * 8 + "p" * 9}
_MODE_SIGS = {"kit_attn_sublayer_tc": "iipp" + "i" * 5 + "p" * 10 + "ii"
                                      + "p" * 9,
              "kit_attn_sublayer_tc_bwd": "i" + "p" * 12 + "i" * 8 + "p" * 9,
              "kit_attn_bwd_fused": "iii"}
# the backward's bias gradients: rows a partial sum (``csrc/
# attn_sublayer_modes.cu`` BIAS_ROWS)
BIAS_ROWS = 128
KINDS = ("repeat-inc", "all")
# log2(e): in the precision modes the scores are in the log2 domain (the
# JAX ``LOG2E``, folded into Wq / bq and the keypad term)
LOG2E = 1.4426950408889634
# the backward's one-pass attention core (``csrc/attention_grad.cuh``):
# the keys a block owns (``AB_KT``) and the head widths it is built for
# (``tiled_head``)
KEY_TILE = 128
TILED_HEADS = (16, 32, 64)


def bias_from_masks(mask, valid, T: int, kind: str, add_keypad: bool,
                    mul: float = 1.0):
    """Additive bias, broadcastable to (B, T_query, T_key) (key-only terms
    stay (B, 1, T_key)), from the 1-D masks, summed in the
    order of the JAX ``_bias_terms``, or None when no term applies.
    ``mask`` is read only for "repeat-inc" or ``add_keypad``; ``mul``
    scales the keypad term only, as ``_bias_terms_T`` scales it for its
    log2-domain scores (the NEG blockers stay as they are)."""
    if kind not in KINDS:
        raise ValueError(f"unsupported mask kind {kind!r}")
    bias = None
    if kind == "repeat-inc":
        idx = torch.arange(T, device=mask.device)
        future = idx[None, :] > idx[:, None]
        blocked = future[None] & (mask[:, None, :] > 0)
        bias = torch.where(blocked, NEG, 0.0)
    if add_keypad:
        kp = mask[:, None, :] if mul == 1.0 else mask[:, None, :] * mul
        bias = kp if bias is None else bias + kp
    if valid is not None:
        vb = torch.where(valid[:, None, :] > 0, 0.0, NEG)
        bias = vb if bias is None else bias + vb
    return bias


def attn_sublayer_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                        valid, kind: str, add_keypad: bool, heads: int,
                        mode: str = "f32"):
    """Plain PyTorch version of ``fused_attn_sublayer``; in the modes
    "bf16x3" and "bf16" the products round as the JAX ``_sublayer_kernel``
    rounds them there (``_sublayer_mode_plain``)."""
    if check_mode(mode) != "f32":
        return _sublayer_mode_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                                    mask, valid, kind, add_keypad, heads,
                                    mode)
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


def mode_q_scale(dh: int) -> float:
    """The factor the modes fold into Wq and bq before they are split: the
    JAX ``_enc_fwd_pallas`` / ``_dec_fwd_pallas`` ``qscale``; the training
    forward multiplies its float32 q by it after the bias
    (``_sublayer_train_kernel``'s ``qs``)."""
    return LOG2E / math.sqrt(dh)


def attn_weight_planes(wqkv, bqkv, wo, heads: int, mode: str):
    """(wh, wl, b, oh, ol): one attention sublayer's weights as the serving
    mode kernels read them (this sublayer's and the merged layers'): [Wq s
    | Wk | Wv] (D, 3D) with s = log2(e) / sqrt(D / heads) folded into Wq in
    float32 before the split, as bf16 hi / lo planes; b = [bq s | bk | bv]
    in float32; Wo's planes (the lo planes None in "bf16")."""
    D = wo.shape[0]
    s = mode_q_scale(D // heads)
    w = torch.cat([wqkv[:, :D] * s, wqkv[:, D:]], 1)
    b = torch.cat([bqkv[:D] * s, bqkv[D:]])
    return (*weight_planes(w, mode), b.contiguous(), *weight_planes(wo, mode))


def attn_train_planes(w_in, w_out, mode: str):
    """(wih, wil, woh, wol): the training forward's and the backward's
    weights, in_proj_weight (3D, D) and out_proj.weight (D, D) in torch's
    layout, unscaled, as bf16 hi / lo planes (the lo planes None in
    "bf16"); the forward reads them K-major, the backward MN-major."""
    return (*weight_planes(w_in, mode), *weight_planes(w_out, mode))


def _sublayer_mode_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                         valid, kind, add_keypad, heads, mode, train=False):
    """The attention sublayer in a mode, as the JAX TPU kernels compute it:
    every projection a product of the bf16 parts (``precision.
    part_products``, each activation split once) + bias; per head the
    scores k_hi q_hi^T + k_hi q_lo^T + k_lo q_hi^T (one term in "bf16") of
    q times log2(e) / sqrt(dh) + the bias with its keypad term times
    log2(e) (``_mode_scores``); the softmax in the log2 domain (max, exp2,
    times 1 / sum) before the probabilities are rounded to one bf16 that
    multiplies v's parts (``precision.prob_products``); biases, the
    residual and the LayerNorm in float32.  Serving (``_sublayer_kernel``)
    folds the scale into Wq and bq in float32 before the split and returns
    y; with ``train`` (``_sublayer_train_kernel``) q = x Wq + bq is kept
    unscaled and scaled after its bias, and the result is (y, qkv, a,
    stats, r) as ``attn_sublayer_train_plain`` returns it."""
    B, T, D = x.shape
    dh = D // heads
    mem = x if memory is None else memory
    wq, wk, wv = wqkv.split(D, dim=1)
    bq, bk, bv = bqkv.split(D)
    s = mode_q_scale(dh)
    if not train:
        wq, bq = wq * s, bq * s
    xp = parts(x.reshape(-1, D), mode)
    mp = xp if memory is None else parts(mem.reshape(-1, D), mode)

    def proj(a_parts, w, b):
        return (part_products(a_parts, parts(w, mode)) + b).reshape(B, T, D)

    q, k, v = proj(xp, wq, bq), proj(mp, wk, bk), proj(mp, wv, bv)
    qh = _heads(q, heads)
    logits = _mode_scores(qh * s if train else qh, _heads(k, heads), mask,
                          valid, kind, add_keypad, mode)
    m = logits.amax(-1, keepdim=True)
    e = torch.exp2(logits - m)
    l = e.sum(-1, keepdim=True)
    a = _rows(prob_products(e * (1.0 / l), parts(_heads(v, heads), mode)))
    r = x + proj(parts(a.reshape(-1, D), mode), wo, bo)
    y = r if ln_w is None else F.layer_norm(r, (D,), ln_w, ln_b, LN_EPS)
    if not train:
        return y
    return (y, torch.cat([q, k, v], -1), a, torch.cat([m, l], -1),
            None if ln_w is None else r)


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
                   valid, kind, add_keypad, heads, dense=True):
    """Checks of the forward kernels' operands (the float32 weights, which
    the mode kernels read only to split when no planes are given, with
    ``dense``); returns ``mask`` as ``_check_config`` does."""
    mask = _check_config(where, x, mask, kind, add_keypad, heads)
    B, T, D = x.shape
    weights = {"wqkv": wqkv, "wo": wo} if dense else {}
    _build.check_tensors(where, x.device, x=x, memory=memory, bqkv=bqkv,
                         bo=bo, ln_w=ln_w, ln_b=ln_b, mask=mask, valid=valid,
                         **weights)
    for name, t, shape in (("memory", memory, (B, T, D)),
                           ("wqkv", wqkv, (D, 3 * D)), ("bqkv", bqkv, (3 * D,)),
                           ("wo", wo, (D, D)), ("bo", bo, (D,)),
                           ("ln_w", ln_w, (D,)), ("ln_b", ln_b, (D,)),
                           ("mask", mask, (B, T)), ("valid", valid, (B, T))):
        _build.check_shape(where, name, t, shape)
    if (ln_w is None) != (ln_b is None):
        raise ValueError(f"{where}: give both ln_w and ln_b or neither")
    _build.check_aligned(where, x=x, **weights)
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
                        add_keypad: bool = False, heads: int = 8,
                        mode: str = "f32", planes=None):
    """x (B, T, D) -> y (B, T, D).  ``memory`` None selects
    self-attention; ``ln_w``/``ln_b`` None means no LayerNorm; ``mask`` is
    read only for "repeat-inc" or ``add_keypad``; ``valid`` None means every
    key is real.  In the modes "bf16x3" and "bf16" the kernel reads the
    weights as bf16 planes: ``planes`` (``attn_weight_planes``, as a packed
    model keeps them), or split here from wqkv, bqkv, wo."""
    check_mode(mode)
    if x.device.type == "cpu":
        return attn_sublayer_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                                   mask, valid, kind, add_keypad, heads, mode)
    where = "fused_attn_sublayer"
    if mode == "f32":
        mask = _check_forward(where, x, memory, wqkv, bqkv, wo, bo, ln_w,
                              ln_b, mask, valid, kind, add_keypad, heads)
        y = _launch_forward(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b, mask,
                            valid, kind, add_keypad, heads)[0]
    else:
        mask = _check_forward(where, x, memory, wqkv, bqkv, wo, bo, ln_w,
                              ln_b, mask, valid, kind, add_keypad, heads,
                              dense=False)
        D = kernel_width(where, x.shape[-1])
        weights = _mode_attn(where, x, (wqkv, bqkv, wo, bo), planes, heads,
                             mode, D)
        y = _launch_forward_mode(x, memory, weights, ln_w, ln_b, mask, valid,
                                 kind, add_keypad, heads, mode, False)[0]
    fused_attn_sublayer.launches[mode] += 1
    return y


fused_attn_sublayer.launches = dict.fromkeys(MODES, 0)


def attn_sublayer_train_plain(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                              mask, valid, kind: str, add_keypad: bool,
                              heads: int, mode: str = "f32"):
    """Plain PyTorch version of ``fused_attn_sublayer_train``: (y, qkv
    (B, T, 3D), a (B, T, D), stats (B, H, T, 2) = (row max, row sum) of
    each head's softmax, r (B, T, D) or None without a LayerNorm).  In the
    modes "bf16x3" and "bf16" as the JAX ``_sublayer_train_kernel`` rounds
    them (``_sublayer_mode_plain``); the statistics are then those of the
    log2-domain scores, (max, sum of exp2)."""
    if check_mode(mode) != "f32":
        return _sublayer_mode_plain(x, memory, wqkv, bqkv, wo, bo, ln_w,
                                    ln_b, mask, valid, kind, add_keypad,
                                    heads, mode, train=True)
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


def _heads(t, heads):
    """(B, T, D) -> (B, H, T, dh)."""
    B, T, D = t.shape
    return t.reshape(B, T, heads, D // heads).transpose(1, 2)


def _rows(t):
    """(B, H, T, dh) -> (B, T, D)."""
    B, H, T, dh = t.shape
    return t.transpose(1, 2).reshape(B, T, H * dh)


def _mode_scores(q, k, mask, valid, kind, add_keypad, mode):
    """The log2-domain scores (B, H, Tq, Tk) of the modes' cores: the parts
    of q s (q (B, H, T, dh) already scaled) against k's, as the JAX
    ``_score_dot`` takes k q^T, then the bias with its keypad term times
    log2(e)."""
    qp, kp = parts(q, mode), parts(k, mode)
    st = part_products(kp, tuple(t.transpose(-1, -2) for t in qp))
    logits = st.transpose(-1, -2)
    bias = bias_from_masks(mask, valid, q.shape[2], kind, add_keypad,
                           mul=LOG2E)
    return logits if bias is None else logits + bias[:, None]


def fused_attn_sublayer_train(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                              mask, valid, kind: str = "repeat-inc",
                              add_keypad: bool = False, heads: int = 8,
                              mode: str = "f32", planes=None):
    """``fused_attn_sublayer`` that also returns what its backward reads:
    (y, qkv, a, stats, r, acts), the first five as
    ``attn_sublayer_train_plain`` says.  In the modes the kernel reads w_in
    = wqkv^T and w_out = wo^T as bf16 planes in torch's layout: ``planes``
    (``attn_train_planes``), which a call on the card must give; acts are
    the planes of x, the memory and a the kernel split, which the backward
    reads (``attn_sublayer_bwd``'s ``acts``; None on the CPU and at
    "f32")."""
    check_mode(mode)
    if x.device.type == "cpu":
        return (*attn_sublayer_train_plain(x, memory, wqkv, bqkv, wo, bo,
                                           ln_w, ln_b, mask, valid, kind,
                                           add_keypad, heads, mode), None)
    where = "fused_attn_sublayer_train"
    if mode == "f32":
        mask = _check_forward(where, x, memory, wqkv, bqkv, wo, bo, ln_w,
                              ln_b, mask, valid, kind, add_keypad, heads)
        out = (*_launch_forward(x, memory, wqkv, bqkv, wo, bo, ln_w, ln_b,
                                mask, valid, kind, add_keypad, heads,
                                train=True), None)
    else:
        mask = _check_forward(where, x, memory, wqkv, bqkv, wo, bo, ln_w,
                              ln_b, mask, valid, kind, add_keypad, heads,
                              dense=False)
        n = x.shape[-1]
        D = kernel_width(where, n)
        wih, wil, woh, wol = _train_planes(where, x.device, planes, mode, n,
                                           D)
        weights = (wih, wil, pad_blocks(bqkv, n, D, 0), woh, wol, pad(bo, D))
        out = _launch_forward_mode(x, memory, weights, ln_w, ln_b, mask,
                                   valid, kind, add_keypad, heads, mode, True)
    fused_attn_sublayer_train.launches[mode] += 1
    return out


fused_attn_sublayer_train.launches = dict.fromkeys(MODES, 0)


def _check_planes(where, device, mode, named, prefix=""):
    """Bf16 weight planes in ``mode``: ``named`` holds (name, plane, shape)
    as (hi, lo) pairs, the lo planes None exactly in "bf16", each a
    contiguous bfloat16 tensor on ``device``."""
    if any((t is None) != (mode == "bf16") for _, t, _ in named[1::2]):
        raise ValueError(f"{where}: mode {mode!r} takes "
                         f"{'no' if mode == 'bf16' else 'both'} attention lo "
                         "planes")
    for k, t, shape in named:
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.device != device or \
                not t.is_contiguous():
            raise ValueError(f"{where}: {prefix}{k} must be a contiguous "
                             f"bfloat16 tensor on {device}")
        _build.check_shape(where, prefix + k, t, shape)
        _build.check_aligned(where, **{prefix + k: t})


def _pad_planes(w_planes, o_planes, n, D, axis):
    """Weight planes zero-padded from the model's width n to the kernel
    width D: those of the q / k / v weights with each block on its own
    along ``axis`` (``pad_blocks``; 1 for the serving form's (n, 3n), 0 for
    torch's (3n, n)), then the out-projection's (n, n)."""
    size = (D, 3 * D) if axis else (3 * D, D)
    return (*(None if t is None else pad(pad_blocks(t, n, D, axis), *size)
              for t in w_planes),
            *(None if t is None else pad(t, D, D) for t in o_planes))


def _mode_attn(where, x, attn, planes, heads, mode, D, prefix=""):
    """One attention sublayer's operands in a mode at the kernel width D:
    (wh, wl, b, oh, ol, bo), its planes (``attn_weight_planes``) built from
    the float32 weights when ``planes`` is None."""
    n = x.shape[-1]
    wqkv, bqkv, wo, bo = attn
    _build.check_tensors(where, x.device, **{prefix + "bqkv": bqkv,
                                             prefix + "bo": bo})
    for name, t, shape in (("wqkv", wqkv, (n, 3 * n)),
                           ("bqkv", bqkv, (3 * n,)), ("wo", wo, (n, n)),
                           ("bo", bo, (n,))):
        _build.check_shape(where, prefix + name, t, shape)
    if planes is None:
        planes = attn_weight_planes(wqkv, bqkv, wo, heads, mode)
    wh, wl, b, oh, ol = planes
    _check_planes(where, x.device, mode, (
        ("wh", wh, (n, 3 * n)), ("wl", wl, (n, 3 * n)), ("oh", oh, (n, n)),
        ("ol", ol, (n, n))), prefix)
    _build.check_tensors(where, x.device, **{prefix + "b": b})
    _build.check_shape(where, prefix + "b", b, (3 * n,))
    wh, wl, oh, ol = _pad_planes((wh, wl), (oh, ol), n, D, 1)
    return wh, wl, pad_blocks(b, n, D, 0), oh, ol, pad(bo, D)


def _train_planes(where, device, planes, mode, n, D):
    """``attn_train_planes`` in ``mode``, which the training form takes on
    the card (``AttnSublayerFunction`` splits them once a step): checked,
    then padded to the kernel width D."""
    if planes is None:
        raise ValueError(f"{where}: mode {mode!r} takes the weights' planes "
                         "(attn_train_planes)")
    wih, wil, woh, wol = planes
    _check_planes(where, device, mode, (
        ("wih", wih, (3 * n, n)), ("wil", wil, (3 * n, n)),
        ("woh", woh, (n, n)), ("wol", wol, (n, n))))
    return _pad_planes((wih, wil), (woh, wol), n, D, 0)


def mode_act_elems(B: int, T: int, D: int, cross: bool, mode: str) -> int:
    """The bf16 elements of the training forward's kept planes (``acts``):
    those of x, the memory (cross-attention) and the attention output a, B
    T D each, two planes in "bf16x3"."""
    return (3 if cross else 2) * (2 if mode == "bf16x3" else 1) * B * T * D


def mode_forward_scratch(B: int, T: int, D: int, cross: bool, mode: str,
                         ln: bool, train: bool):
    """``kit_attn_sublayer_tc``'s scratch (``csrc/attn_sublayer_modes.cu``):
    (bf16 elements, floats): the planes of q / k / v (3 B T D) and, when
    serving (training keeps them apart: ``acts``, ``mode_act_elems``), of
    x, the memory (cross-attention) and the attention output (B T D each),
    two planes in "bf16x3"; the pre-LN sum when serving with a LayerNorm."""
    MD = B * T * D
    planes = 3 * (2 if mode == "bf16x3" else 1) * MD
    if not train:
        planes += mode_act_elems(B, T, D, cross, mode)
    return planes, (MD if ln and not train else 0)


def attn_act_planes(x, memory, a, mode: str):
    """The planes of x, the memory (None: self-attention) and a, each
    zero-padded to the kernel width and split (hi, then lo in "bf16x3"), as
    the training forward keeps them for ``attn_sublayer_bwd`` (``acts``): for
    a backward called on the card without its forward's call."""
    D = kernel_width("attn_sublayer_bwd", x.shape[-1])
    out = []
    for t in (x, memory, a):
        if t is not None:
            t = pad(t, D).reshape(-1)
            out.extend(split_bf16(t) if mode == "bf16x3"
                       else (t.to(torch.bfloat16),))
    return torch.cat(out)


def mode_bwd_splits(M: int, D: int) -> int:
    """The row ranges of the backward's weight gradients in a mode: with the
    4 (D / 128)^2 output tiles of [dW_in | dW_out] they fill one wave of the
    card."""
    return wave_splits(M, 4 * (D // 128) ** 2)


def mode_bwd_scratch_floats(B: int, T: int, D: int, heads: int, mode: str,
                            s_w: int, fused: bool) -> int:
    """``kit_attn_sublayer_tc_bwd``'s scratch in floats, ``fused`` as
    ``kit_attn_bwd_fused`` answers for (T, dh): without the fused core dqkv
    (3 M D) and delta (B H T, rounded up to 4); the LayerNorm's and dr's
    sums per 32-row block (3 D each), the weight gradients' per row range
    (4 D^2 each), [dq | dk | dv]'s sums per video (fused) or per
    ``BIAS_ROWS`` rows (3 D each), dr (M D), then the bf16 planes of dr, dA
    and [dq | dk | dv] (5 M D a plane, two planes in "bf16x3"; two bf16 a
    float)."""
    M = B * T
    MD = M * D
    two = 0 if fused else 3 * MD + -(-B * heads * T // 4) * 4
    vec = B if fused else -(-M // BIAS_ROWS)
    planes = 5 * (2 if mode == "bf16x3" else 1) * MD
    return (two + -(-M // 32) * 3 * D + s_w * 4 * D * D + vec * 3 * D + MD
            + -(-planes // 2))


def _launch_forward_mode(x, memory, weights, ln_w, ln_b, mask, valid, kind,
                         add_keypad, heads, mode, train):
    """(y, qkv, a, stats, r, acts) of the forward in ``mode`` at the model's
    width n (qkv, a, stats, r and acts, the planes of x, the memory and a,
    None unless ``train``; r only with a LayerNorm):
    ``weights`` (wh, wl, b, oh, ol, bo) padded to the kernel width D, the
    serving form's (``_mode_attn``) or the training form's
    (``_train_weights``)."""
    where = "fused_attn_sublayer"
    B, T, n = x.shape
    D = kernel_width(where, n)
    x, memory, ln_w, ln_b = (pad(t, D) for t in (x, memory, ln_w, ln_b))
    dev = x.device
    y = torch.empty_like(x)
    qkv = a = stats = r = acts = None
    if train:
        qkv = torch.empty(B, T, 3 * D, device=dev)
        # the columns from H * dh on are not written
        a = (torch.empty if n == D else torch.zeros)(B, T, D, device=dev)
        stats = torch.empty(B, heads, T, 2, device=dev)
        r = torch.empty_like(x) if ln_w is not None else None
        acts = torch.empty(mode_act_elems(B, T, D, memory is not None, mode),
                           dtype=torch.bfloat16, device=dev)
    nb, nf = mode_forward_scratch(B, T, D, memory is not None, mode,
                                  ln_w is not None, train)
    buf = torch.empty(nb, dtype=torch.bfloat16, device=dev)
    fs = torch.empty(nf, device=dev) if nf else None
    lib = _build.bind("attn_sublayer_modes", _MODE_SIGS)
    _build.call(lib, "kit_attn_sublayer_tc", dev, _PASSES[mode], int(train),
                x, memory, B, T, D, n, heads, *weights, ln_w, ln_b, mask,
                valid, int(kind == "repeat-inc"), int(add_keypad), y, qkv, a,
                stats, r, buf, acts, fs)
    if not train:
        return cut(y, n), None, None, None, None, None
    return (cut(y, n), cut_blocks(qkv, n, D, -1), cut(a, n), stats,
            cut(r, n), acts)


def attn_core_bwd_plain(da, qkv, a, stats, mask, valid, kind: str,
                        add_keypad: bool, heads: int, mode: str = "f32"):
    """The attention core's part of ``attn_sublayer_bwd_plain``: (dq, dk,
    dv), each (B, T, D), from dA = dL/da (B, T, D), the training forward's
    qkv, a and stats, each probability rebuilt from q, k, the bias and the
    saved (row max, row sum).  In the modes the stats are the log2-domain
    ones and the steps those of ``_core_bwd_mode_plain``."""
    if check_mode(mode) != "f32":
        return _core_bwd_mode_plain(da, qkv, stats, mask, valid, kind,
                                    add_keypad, heads, mode)
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


def mode_probs(qkv, stats, mask, valid, kind: str, add_keypad: bool,
               heads: int, mode: str):
    """The probabilities (B, H, Tq, Tk) of a mode's training forward, rebuilt
    as its backward rebuilds them: the scores of q times log2(e) / sqrt(dh)
    (from the forward's qkv) against k, the bias, exp2 of their difference
    from the row max times 1 / the row sum (the log2-domain ``stats``),
    rounded to one bf16 (returned as float32): the p its p v consumed."""
    D = qkv.shape[-1] // 3
    q, k = (_heads(t, heads) for t in qkv.split(D, -1)[:2])
    logits = _mode_scores(q * mode_q_scale(D // heads), k, mask, valid, kind,
                          add_keypad, mode)
    p = torch.exp2(logits - stats[..., :1]) * (1.0 / stats[..., 1:])
    return p.to(torch.bfloat16).float()


def _core_bwd_mode_plain(da, qkv, stats, mask, valid, kind, add_keypad,
                         heads, mode):
    """The core's gradients in a mode, the steps of the JAX
    ``_sublayer_bwd_kernel`` per head: p rebuilt from q times log2(e) /
    sqrt(dh) (the forward's operands), the bias and the statistics, rounded
    to one bf16 (the probabilities the forward's p v consumed); dv = p^T dA
    against dA's parts; gw = v dA^T from the parts; tmp = gw - sum over the
    keys of gw p; dl = the parts of p tmp / sqrt(dh); dq = dl k and dk =
    dl^T q (q unscaled), each a product of the parts."""
    D = qkv.shape[-1] // 3
    dh = D // heads
    q, k, v = (_heads(t, heads) for t in qkv.split(D, -1))
    pb = mode_probs(qkv, stats, mask, valid, kind, add_keypad, heads, mode)
    dap, vp = parts(_heads(da, heads), mode), parts(v, mode)
    dv = prob_products(pb.transpose(-1, -2), dap)
    # key-major as the TPU kernel holds them: (B, H, Tk, Tq)
    wt = pb.transpose(-1, -2)
    gw = part_products(vp, tuple(t.transpose(-1, -2) for t in dap))
    tmp = gw - (gw * wt).sum(-2, keepdim=True)
    dlp = parts((wt * tmp) * (1.0 / math.sqrt(dh)), mode)
    dq = part_products(tuple(t.transpose(-1, -2) for t in dlp),
                       parts(k, mode))
    dk = part_products(dlp, parts(q, mode))
    return _rows(dq), _rows(dk), _rows(dv)


def _bwd_mode_plain(dy, x, memory, qkv, a, stats, r, w_in, w_out, ln_w,
                    mask, valid, kind, add_keypad, heads, mode):
    """The JAX ``_sublayer_bwd_kernel`` in a mode, step by step: the LN
    backward in float32; dbo = sum dr; dWo = a^T dr and dA = dr Wo^T from
    the parts; the core (``_core_bwd_mode_plain``); then per q, k, v the
    bias gradient, dW = [x | m]^T d and the input gradient d W^T, each
    product's three terms in the TPU kernel's order (in its Flax layout,
    then transposed to torch's)."""
    B, T, D = x.shape
    g = dy.reshape(-1, D)
    dg = dbe = None
    if ln_w is not None:
        g, dg, dbe = _ln_bwd_plain(g, r.reshape(-1, D), ln_w)
    dr = g                                               # (M, D)
    drp = parts(dr, mode)

    def wgrad(inp, d):  # sum_r inp[r, i] d[r, o] -> torch's [o, i]
        return part_products(tuple(t.t() for t in inp), d).t()

    dw_out = wgrad(parts(a.reshape(-1, D), mode), drp)
    db_out = dr.sum(0)
    da = part_products(drp, parts(w_out, mode))          # dr Wo^T
    dq, dk, dv = _core_bwd_mode_plain(da.reshape(B, T, D), qkv, stats, mask,
                                      valid, kind, add_keypad, heads, mode)
    xp = parts(x.reshape(-1, D), mode)
    mp = xp if memory is None else parts(memory.reshape(-1, D), mode)
    dws, dbs, dins = [], [], []
    for d, inp, w in ((dq, xp, w_in[:D]), (dk, mp, w_in[D:2 * D]),
                      (dv, mp, w_in[2 * D:])):
        d = d.reshape(-1, D)
        dbs.append(d.sum(0))
        dp = parts(d, mode)
        dws.append(wgrad(inp, dp))
        dins.append(part_products(dp, parts(w, mode)))   # d W^T
    dx = dr + dins[0]
    dmem = None
    if memory is None:
        dx = (dx + dins[1]) + dins[2]
    else:
        dmem = (dins[1] + dins[2]).reshape(x.shape)
    return (dx.reshape(x.shape), dmem, torch.cat(dws, 0), torch.cat(dbs),
            dw_out, db_out, dg, dbe)


def attn_sublayer_bwd_plain(dy, x, memory, qkv, a, stats, r, w_in, w_out,
                            ln_w, mask, valid, kind: str, add_keypad: bool,
                            heads: int, mode: str = "f32"):
    """Plain PyTorch version of ``attn_sublayer_bwd``, written out step by
    step: each probability rebuilt from q, k, the bias and the saved
    (row max, row sum) (``attn_core_bwd_plain``).  In the modes "bf16x3"
    and "bf16" every product in the mode, as the JAX
    ``_sublayer_bwd_kernel`` takes them (not autograd through the casts,
    which would round the float32 gradients)."""
    if check_mode(mode) != "f32":
        return _bwd_mode_plain(dy, x, memory, qkv, a, stats, r, w_in, w_out,
                               ln_w, mask, valid, kind, add_keypad, heads,
                               mode)
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
                      add_keypad: bool = False, heads: int = 8,
                      mode: str = "f32", planes=None, acts=None):
    """Gradients of ``fused_attn_sublayer_train``'s y: dy (B, T, D) is
    dL/dy; x, memory, masks as the forward saw them; qkv, a, stats, r as
    it wrote them (in the same ``mode``: a mode's statistics are in the
    log2 domain); w_in (3D, D) and w_out (D, D) in torch's layout.
    Returns (dx, dmem, dw_in, db_in, dw_out, db_out, dln_w, dln_b); dmem
    is None for self-attention, dln_* None without a LayerNorm.  In the
    modes the kernels read the forward's planes of w_in and w_out
    (``planes``, ``attn_train_planes``, as ``AttnSublayerFunction`` hands
    them on) and those of x, the memory and a (``acts``: the forward's sixth
    value, or ``attn_act_planes``), which a call on the card must give."""
    check_mode(mode)
    if dy.device.type == "cpu":
        return attn_sublayer_bwd_plain(dy, x, memory, qkv, a, stats, r, w_in,
                                       w_out, ln_w, mask, valid, kind,
                                       add_keypad, heads, mode)
    where = "attn_sublayer_bwd"
    B, T, D = x.shape
    mask = _check_config(where, x, mask, kind, add_keypad, heads)
    if (ln_w is None) != (r is None):
        raise ValueError(f"{where}: r is given exactly when ln_w is")
    dense = {"w_in": w_in, "w_out": w_out} if mode == "f32" else {}
    _build.check_tensors(where, dy.device, dy=dy, x=x, memory=memory,
                         qkv=qkv, a=a, stats=stats, r=r, ln_w=ln_w,
                         mask=mask, valid=valid, **dense)
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
        ("r", r), *dense.items()) if t is not None})
    if mode == "f32":
        grads = _launch_backward(dy, x, memory, qkv, a, stats, r, w_in,
                                 w_out, ln_w, mask, valid, kind, add_keypad,
                                 heads)
    else:
        kw = kernel_width(where, D)
        planes = _train_planes(where, dy.device, planes, mode, D, kw)
        n_acts = mode_act_elems(B, T, kw, memory is not None, mode)
        if acts is None or acts.dtype != torch.bfloat16 or \
                acts.device != dy.device or not acts.is_contiguous() or \
                acts.numel() != n_acts:
            raise ValueError(f"{where}: mode {mode!r} takes the forward's "
                             f"planes of x, the memory and a (acts: {n_acts} "
                             f"contiguous bfloat16 values on {dy.device})")
        _build.check_aligned(where, acts=acts)
        grads = _launch_backward_mode(dy, x, memory, qkv, a, stats, r,
                                      planes, acts, ln_w, mask, valid, kind,
                                      add_keypad, heads, mode)
    attn_sublayer_bwd.launches[mode] += 1
    return grads


def _launch_backward_mode(dy, x, memory, qkv, a, stats, r, planes, acts,
                          ln_w, mask, valid, kind, add_keypad, heads, mode):
    """``attn_sublayer_bwd``'s gradients in a mode from its checked
    operands, at the model's width n.  Runs at the kernel width D, the
    operands zero-padded from n (``widths``), ``planes`` and ``acts``
    already (``_train_planes``, the forward's keep)."""
    B, T, n = x.shape
    D = kernel_width("attn_sublayer_bwd", n)
    dy, a, r, ln_w = (pad(t, D) for t in (dy, a, r, ln_w))
    qkv = pad_blocks(qkv, n, D, -1)
    wih, wil, woh, wol = planes
    dev = dy.device
    empty = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    s_w = mode_bwd_splits(B * T, D)
    dx = empty(B, T, D)
    dmem = None if memory is None else empty(B, T, D)
    dw_in, dw_out = empty(3 * D, D), empty(D, D)
    db = empty(4 * D)  # [db_in | db_out]
    ln_out = empty(2, D)
    lib = _build.bind("attn_sublayer_modes", _MODE_SIGS)
    fused = bool(lib.kit_attn_bwd_fused(_PASSES[mode], T, n // heads))
    scratch = empty(mode_bwd_scratch_floats(B, T, D, heads, mode, s_w,
                                            fused))
    _build.call(lib, "kit_attn_sublayer_tc_bwd", dev, _PASSES[mode], dy,
                qkv, a, stats, r, wih, wil, woh, wol, ln_w, mask,
                valid, B, T, D, n, heads, int(kind == "repeat-inc"),
                int(add_keypad), s_w, acts, dx, dmem, dw_in, dw_out, db,
                ln_out, scratch)
    db_in, db_out = db[:3 * D], db[3 * D:]
    dg, dbe = (None, None) if ln_w is None else (cut(ln_out[0], n),
                                                 cut(ln_out[1], n))
    return (cut(dx, n), cut(dmem, n), cut(cut_blocks(dw_in, n, D, 0), n),
            cut_blocks(db_in, n, D, 0), cut(dw_out, n, n), cut(db_out, n),
            dg, dbe)


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


attn_sublayer_bwd.launches = dict.fromkeys(MODES, 0)


class AttnSublayerFunction(torch.autograd.Function):
    """[LN](x + MHA(x, memory or x)) through ``fused_attn_sublayer_train``
    and ``attn_sublayer_bwd`` in ``mode``; with ``plain`` through their
    plain versions (the plain training route in a mode: the backward step
    by step in the mode, as the kernel route computes it).  Takes the
    parameters in torch's layout (w_in = in_proj_weight, w_out =
    out_proj.weight) and returns their gradients in it; ``memory`` None
    selects self-attention.  In the modes the weights are split into bf16
    planes once a forward (``attn_train_planes``), and the backward reads
    the same planes, and those of x, the memory and a the forward's kernel
    split (its ``acts``)."""

    @staticmethod
    def forward(ctx, x, memory, w_in, b_in, w_out, b_out, ln_w, ln_b, mask,
                valid, kind, add_keypad, heads, mode="f32", plain=False):
        planes = acts = None
        if plain:
            y, qkv, a, stats, r = attn_sublayer_train_plain(
                x, memory, w_in.t(), b_in, w_out.t(), b_out, ln_w, ln_b,
                mask, valid, kind, add_keypad, heads, mode)
        elif mode == "f32":
            y, qkv, a, stats, r, _ = fused_attn_sublayer_train(
                x, memory, w_in.t().contiguous(), b_in,
                w_out.t().contiguous(), b_out, ln_w, ln_b, mask, valid, kind,
                add_keypad, heads)
        else:  # the weights split once per step, in torch's layout
            if x.device.type != "cpu":
                planes = attn_train_planes(w_in, w_out, mode)
            y, qkv, a, stats, r, acts = fused_attn_sublayer_train(
                x, memory, w_in.t(), b_in, w_out.t(), b_out, ln_w, ln_b,
                mask, valid, kind, add_keypad, heads, mode, planes)
        ctx.planes = planes  # the backward reads the same planes
        ctx.acts = acts
        ctx.cfg = (kind, add_keypad, heads, mode)
        ctx.plain = plain
        ctx.save_for_backward(x, memory, qkv, a, stats, r, w_in, w_out,
                              ln_w, mask, valid)
        return y

    @staticmethod
    def backward(ctx, dy):
        args = (dy.contiguous(), *ctx.saved_tensors, *ctx.cfg)
        if ctx.plain:
            grads = attn_sublayer_bwd_plain(*args)
        else:
            grads = attn_sublayer_bwd(*args, ctx.planes, ctx.acts)
        return (*grads, None, None, None, None, None, None, None)
