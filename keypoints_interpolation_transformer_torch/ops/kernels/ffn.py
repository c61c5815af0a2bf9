"""Feed-forward sublayer of the transformer: forward, training forward and
backward.

Kernels (``csrc/ffn.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/ffn.py`` (the float32
mode):

  * ``fused_ffn`` <- ``_kernel_single``:
        x1 = LN1(r) if pre_ln else r
        y  = LN2(x1 + gelu(x1 W1 + b1) W2 + b2)        (exact-erf GELU)
  * ``fused_ffn_train`` <- ``_kernel_single`` with ``want_residuals``: the
    same launch, also writing u = x1 W1 + b1 (N, FF) and z = x1 + gelu(u)
    W2 + b2 (N, D), the pre-LN2 sum;
  * ``ffn_bwd`` <- ``_ffn_bwd_kernel`` (``has_uz``): from (r, g, u, z) and
    the weights, LN2 backward, dW2 / db2, the GELU backward, dW1 / db1,
    dx1 + dz, LN1 backward, dr and the LayerNorm gradients.

Bound on an H100 by float32 FFMA work: 2.1 MFLOP per token forward and
4.2 backward at D = 256, FF = 2048.  The forward keeps each FF chunk's
GELU output on chip; the backward keeps the (rows, FF) dh and du on chip
too (see the source note in ``csrc/ffn.cu`` for how it splits into
launches).

Weights: the forward kernels take the Flax layout, w1 (D, FF) and w2
(FF, D); the backward takes torch's ``Linear`` layout, w1t = W1^T (FF, D)
and w2t = W2^T (D, FF), and returns the weight gradients in that layout.
A wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); ``launches`` counts the calls that launched.
``FFNFunction`` ties the training forward and the backward together.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-5
# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_ffn": "p" + "i" * 3 + "p" * 12,
         "kit_ffn_bwd": "p" * 8 + "i" * 6 + "p" * 11}
_WIDTHS = (128, 256)


def ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln: bool = False):
    """Plain PyTorch version of ``fused_ffn``."""
    return ffn_train_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln)[0]


def ffn_train_plain(r, w1, b1, w2, b2, g1, be1, g2, be2,
                    pre_ln: bool = False):
    """Plain PyTorch version of ``fused_ffn_train``: (y, u, z), u and z
    flattened to (N, FF) and (N, D)."""
    D = r.shape[-1]
    x1 = F.layer_norm(r, (D,), g1, be1, LN_EPS) if pre_ln else r
    x1 = x1.reshape(-1, D)
    u = x1 @ w1 + b1
    z = x1 + (F.gelu(u) @ w2 + b2)  # exact erf
    return F.layer_norm(z, (D,), g2, be2, LN_EPS).reshape(r.shape), u, z


def _check_forward(where, r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln):
    D = r.shape[-1]
    FF = w1.shape[1]
    if D not in _WIDTHS or FF % 4:
        raise ValueError(f"{where}: needs D in {_WIDTHS} and FF a multiple "
                         f"of 4, got D={D}, FF={FF}")
    if not pre_ln:
        g1 = be1 = None
    _build.check_tensors(where, r.device, r=r, w1=w1, b1=b1, w2=w2, b2=b2,
                         g1=g1, be1=be1, g2=g2, be2=be2)
    for name, t, shape in (("w1", w1, (D, FF)), ("b1", b1, (FF,)),
                           ("w2", w2, (FF, D)), ("b2", b2, (D,)),
                           ("g1", g1, (D,)), ("be1", be1, (D,)),
                           ("g2", g2, (D,)), ("be2", be2, (D,))):
        _build.check_shape(where, name, t, shape)
    _build.check_aligned(where, r=r, w1=w1, w2=w2)
    return D, FF, g1, be1


def _launch_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, u, z):
    D = r.shape[-1]
    y = torch.empty_like(r)
    lib = _build.bind("ffn", _SIGS)
    _build.call(lib, "kit_ffn", r.device, r, r.numel() // D, D, w1.shape[1],
                w1, b1, w2, b2, g1, be1, g2, be2, y, u, z)
    return y


def fused_ffn(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln: bool = False):
    """r (..., D) -> y (..., D); g1/be1 are read only when ``pre_ln``."""
    if r.device.type == "cpu":
        return ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln)
    _, _, g1, be1 = _check_forward("fused_ffn", r, w1, b1, w2, b2, g1, be1,
                                   g2, be2, pre_ln)
    y = _launch_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, None, None)
    fused_ffn.launches += 1
    return y


fused_ffn.launches = 0


def fused_ffn_train(r, w1, b1, w2, b2, g1, be1, g2, be2,
                    pre_ln: bool = False):
    """r (..., D) -> (y (..., D), u (N, FF), z (N, D)), N = r.numel() / D:
    the forward plus the residuals its backward reads."""
    if r.device.type == "cpu":
        return ffn_train_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln)
    D, FF, g1, be1 = _check_forward("fused_ffn_train", r, w1, b1, w2, b2, g1,
                                    be1, g2, be2, pre_ln)
    N = r.numel() // D
    u = torch.empty(N, FF, device=r.device)
    z = torch.empty(N, D, device=r.device)
    y = _launch_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, u, z)
    fused_ffn_train.launches += 1
    return y, u, z


fused_ffn_train.launches = 0


def _ln_bwd_plain(dy, x, gamma):
    """Backward of y = norm(x) * gamma + beta over the last axis: (dx,
    dgamma, dbeta), the parameter gradients summed over rows."""
    m = x.mean(-1, keepdim=True)
    xc = x - m
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    n = xc * inv
    dn = dy * gamma
    dx = (dn - dn.mean(-1, keepdim=True)
          - n * (dn * n).mean(-1, keepdim=True)) * inv
    return dx, (dy * n).sum(0), dy.sum(0)


def _gelu_grad(u):
    """d/du [u Phi(u)] = Phi(u) + u phi(u), exact erf."""
    cdf = 0.5 * (1.0 + torch.erf(u * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + u * pdf


def ffn_bwd_plain(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln: bool = False):
    """Plain PyTorch version of ``ffn_bwd``, written out step by step."""
    D = r.shape[-1]
    gg = g.reshape(-1, D)
    x = r.reshape(-1, D)
    dz, dg2, dbe2 = _ln_bwd_plain(gg, z, g2)                # LN2
    h = F.gelu(u)
    dw2t = dz.t() @ h                                       # (D, FF)
    db2 = dz.sum(0)
    du = (dz @ w2t) * _gelu_grad(u)                         # (N, FF)
    db1 = du.sum(0)
    x1 = F.layer_norm(x, (D,), g1, be1, LN_EPS) if pre_ln else x
    dw1t = du.t() @ x1                                      # (FF, D)
    dx1 = du @ w1t + dz
    if pre_ln:
        dr, dg1, dbe1 = _ln_bwd_plain(dx1, x, g1)           # LN1
    else:
        dr, dg1, dbe1 = dx1, None, None
    return (dr.reshape(r.shape), dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2)


def row_splits(rows: int, tiles: int) -> int:
    """How many row ranges a reduction over ``rows`` is cut into so that
    ``tiles`` output tiles times the splits fill the card twice over
    (132 SMs); each range keeps at least 256 rows."""
    want = -(-2 * 132 // max(tiles, 1))
    return max(1, min(want, rows // 256))


def ffn_bwd(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln: bool = False):
    """Gradients of ``fused_ffn_train``'s y: g (..., D) is dL/dy; r, u, z
    as the training forward saw and wrote them; w1t (FF, D), w2t (D, FF)
    in torch's Linear layout.  Returns (dr, dw1t, db1, dw2t, db2, dg1,
    dbe1, dg2, dbe2), dg1/dbe1 None without ``pre_ln``."""
    if g.device.type == "cpu":
        return ffn_bwd_plain(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln)
    where = "ffn_bwd"
    D = r.shape[-1]
    FF = w1t.shape[0]
    N = r.numel() // D
    if D not in _WIDTHS or FF % 128:
        raise ValueError(f"{where}: needs D in {_WIDTHS} and FF a multiple "
                         f"of 128, got D={D}, FF={FF}")
    if not pre_ln:
        g1 = be1 = None
    _build.check_tensors(where, g.device, g=g, r=r, u=u, z=z, w1t=w1t,
                         w2t=w2t, g1=g1, be1=be1, g2=g2)
    for name, t, shape in (("g", g, r.shape), ("u", u, (N, FF)),
                           ("z", z, (N, D)), ("w1t", w1t, (FF, D)),
                           ("w2t", w2t, (D, FF)), ("g1", g1, (D,)),
                           ("be1", be1, (D,)), ("g2", g2, (D,))):
        _build.check_shape(where, name, t, shape)
    _build.check_aligned(where, g=g, r=r, u=u, z=z, w1t=w1t, w2t=w2t)
    dev = g.device
    empty = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    blocks = -(-N // 32)
    s_dw1 = row_splits(N, FF // 128)
    s_dw2 = row_splits(N, (D // 32) * -(-FF // 256))
    s_vec = row_splits(N, -(-D // 128))
    dr, dz = empty(r.shape), empty(N, D)
    x1 = empty(N, D) if pre_ln else None
    dw1t, dw2t = empty(FF, D), empty(D, FF)
    db1, db2 = empty(FF), empty(D)
    ln_out = empty(4, D)  # dg2, dbe2, dg1, dbe1
    # scratch: per-block / per-split partial sums, reduced in fixed order
    scratch = empty(blocks * (2 * D + FF + 2 * D) + s_dw1 * FF * D
                    + s_dw2 * D * FF + s_vec * D)
    lib = _build.bind("ffn", _SIGS)
    _build.call(lib, "kit_ffn_bwd", dev, g, r, u, z, w1t, w2t, g1, be1,
                N, D, FF, s_dw1, s_dw2, s_vec, g2, x1, dz, dr, dw1t, db1,
                dw2t, db2, ln_out, scratch)
    ffn_bwd.launches += 1
    dg1, dbe1 = (ln_out[2], ln_out[3]) if pre_ln else (None, None)
    return dr, dw1t, db1, dw2t, db2, dg1, dbe1, ln_out[0], ln_out[1]


ffn_bwd.launches = 0


class FFNFunction(torch.autograd.Function):
    """norm_out(x1 + FF(x1)), x1 = norm_in(r) when ``pre_ln``, through
    ``fused_ffn_train`` and ``ffn_bwd``.  Takes the Linear parameters in
    torch's layout (w1t = linear1.weight, w2t = linear2.weight) and
    returns their gradients in it."""

    @staticmethod
    def forward(ctx, r, w1t, b1, w2t, b2, g1, be1, g2, be2, pre_ln):
        y, u, z = fused_ffn_train(r, w1t.t().contiguous(), b1,
                                  w2t.t().contiguous(), b2, g1, be1, g2, be2,
                                  pre_ln)
        ctx.pre_ln = pre_ln
        ctx.save_for_backward(r, u, z, w1t, w2t, g1, be1, g2)
        return y

    @staticmethod
    def backward(ctx, g):
        r, u, z, w1t, w2t, g1, be1, g2 = ctx.saved_tensors
        dr, dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2 = ffn_bwd(
            g.contiguous(), r, u, z, w1t, w2t, g1, be1, g2, ctx.pre_ln)
        return dr, dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2, None
