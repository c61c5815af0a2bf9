"""Feed-forward sublayer of the transformer: forward, training forward and
backward, in the precision modes (``precision.py``: "f32", "bf16x3",
"bf16") and, for serving, int8.

Kernels (``csrc/ffn.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/ffn.py``:

  * ``fused_ffn`` <- ``_kernel_single`` (float32, and its one-pass bf16
    mode "bf16") and ``_kernel_split`` (bf16x3, "bf16x3"):
        x1 = LN1(r) if pre_ln else r
        y  = LN2(x1 + gelu(x1 W1 + b1) W2 + b2)        (exact-erf GELU)
  * ``fused_ffn_train`` <- ``_kernel_single`` with ``want_residuals``: the
    same launch, also writing u = x1 W1 + b1 (N, FF) and z = x1 + gelu(u)
    W2 + b2 (N, D), the pre-LN2 sum;
  * ``ffn_bwd`` <- ``_ffn_bwd_kernel`` (``has_uz``): from (r, g, u, z) and
    the weights, LN2 backward, dW2 / db2, the GELU backward, dW1 / db1,
    dx1 + dz, LN1 backward, dr and the LayerNorm gradients (float32: the
    "highest" route), in two phases with du (N, FF) written once, its
    products streamed through ``csrc/sgemm.cuh``'s 8 x 8 FFMA core;
  * ``ffn_bwd_split`` <- ``_ffn_bwd_kernel_a`` and ``_ffn_bwd_kernel_b``:
    the same two phases with the products on the bf16 tensor cores, the
    "high" and "default" routes; in "f32" it is ``ffn_bwd``.

Bound on an H100: 2.1 MFLOP per token forward and 4.2 backward at D = 256,
FF = 2048, float32 FFMA work at "highest", bf16 tensor-core work (three
passes at "bf16x3") otherwise.  The float32 forward runs on
``csrc/sgemm.cuh``'s 8 x 8 FFMA core and keeps each FF chunk's GELU output
on chip; where its row tiles leave the card idle (one 128-frame video,
the 600-frame request) the FF chunks of a tile are split over blocks
(``ff_parts``) and a second pass adds their sums in order.  The backward
writes du once (see the source note in ``csrc/ffn.cu``).

In the tensor-core modes both kernels run on Hopper's warpgroup products
(``wgmma``) fed through a ring of shared-memory stages by the Tensor
Memory Accelerator, a producer warpgroup ahead of two consumer warpgroups
(``csrc/mma_bf16.cuh``): the forward takes 128-row tiles (``tc_rows``),
keeps u and z in registers and feeds gelu(u) to the second product as a
register operand, splitting the FF chunks of a tile over ``tc_parts``
blocks where the tiles fill less than half the card; the backward's four
products run on one core of 128 x 128 tiles, its operands bf16 planes in
device memory written once, the weight gradients over ``tc_bwd_splits``
row ranges added in a fixed order.  The weights are split into bf16 hi /
lo planes in torch's layout (``ff_weight_planes``) once per packed model
for serving and once per training step, where ``FFNFunction`` hands the
forward's planes to the backward.

Weights: the forward kernels take the Flax layout, w1 (D, FF) and w2
(FF, D); the backward takes torch's ``Linear`` layout, w1t = W1^T (FF, D)
and w2t = W2^T (D, FF), and returns the weight gradients in that layout.
A wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); ``launches`` counts the calls that launched,
per mode for the wrappers that take one.  ``FFNFunction`` ties the training
forward and the backward together.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .int8_matmul import int8_dense_plain
from .precision import MODES, check_mode, mode_matmul, weight_planes
from .widths import cut, kernel_width, pad, row_tile

LN_EPS = 1e-5
# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_ffn": "p" + "i" * 5 + "p" * 13,
         "kit_ffn_bwd": "p" * 8 + "i" * 5 + "p" * 12,
         "kit_ffn_int8": "p" + "i" * 4 + "p" * 13,
         "kit_ffn_tc": "ip" + "i" * 5 + "p" * 15,
         "kit_ffn_bwd_split": "i" + "p" * 10 + "i" * 7 + "p" * 12}
# the FF widths the kernels take, zero-padded to them: the float32 kernels
# in steps of 4, the tensor-core ones in steps of 16 (the k of m64nNk16)
_FF_STEP = 4
_FF_STEP_TC = 16
_PASSES = {"bf16x3": 3, "bf16": 1}  # bf16 products per product
# the float32 forward's FF split (``csrc/ffn.cu`` FF_SPLIT_ROWS,
# FF_SPLIT_COLS): its row tile and FF chunk
SPLIT_ROWS = 32
SPLIT_COLS = 128
SMS = 132  # an H100 SXM's SMs (``csrc/sgemm.cuh`` SMS)
# the tensor-core kernels (``csrc/ffn.cu``, ``csrc/mma_bf16.cuh``): the
# forward's FF chunk (FC_TC) and the backward's output tile
TC_FC = 64
TC_TILE = 128


def ff_kernel_width(FF: int, step: int = _FF_STEP) -> int:
    """The FF width a kernel runs at: FF rounded up to ``step``, the
    weights zero-padded there (``widths``)."""
    return -(-FF // step) * step


def rows_fill(M: int, D: int) -> bool:
    """Whether M rows in ``row_tile(D)`` tiles, one block an SM each, fill
    half the card or more (``csrc/sgemm.cuh`` ``rows_fill``): the float32
    forwards then take those tiles, else narrower ones."""
    return 2 * -(-M // row_tile(D)) >= SMS


def ff_parts(M: int, D: int, FF: int) -> int:
    """The blocks that share one row tile's FF chunks in the float32
    forward (``csrc/ffn.cu``, the FF split) at M rows, kernel width D and
    FF: 1 (the row-tile build, no split) where ``rows_fill``; else as many
    as put about two blocks of ``SPLIT_ROWS`` rows on each SM (one above D
    = 256, where the build's shared memory allows one), at most one per
    ``SPLIT_COLS``-wide chunk."""
    if rows_fill(M, D):
        return 1
    slots = SMS * (2 if D <= 256 else 1)
    chunks = -(-FF // SPLIT_COLS)
    return max(1, min(chunks, slots // -(-M // SPLIT_ROWS)))


def ff_scratch_floats(M: int, D: int, parts: int) -> int:
    """The float32 forward's scratch: one M x D partial sum per part with
    the FF split, none without."""
    return parts * M * D if parts > 1 else 0


def tc_rows(D: int) -> int:
    """The token rows of a tensor-core forward block (``csrc/ffn.cu``
    ``TcFwd::ROWS``): 128, two warpgroups of 64, up to D = 256; 64 above,
    where the groups split z's columns."""
    return 128 if D <= 256 else 64


def tc_parts(M: int, D: int, FF: int) -> int:
    """The blocks that share one row tile's FF chunks in the tensor-core
    forward at M rows, kernel width D and FF: 1 where its ``tc_rows(D)``
    tiles, one block an SM, fill half the card or more; else as many as
    put about one block on each SM, at most one per ``TC_FC``-wide
    chunk."""
    tiles = -(-M // tc_rows(D))
    if 2 * tiles >= SMS:
        return 1
    return max(1, min(-(-FF // TC_FC), SMS // tiles))


def tc_bwd_splits(N: int, D: int, FF: int) -> int:
    """The row ranges of the tensor-core backward's weight-gradient
    products at N rows: with their (D / 128) x ceil(FF / 128) output tiles
    they fill one wave of the card, one block an SM (``wave_splits``)."""
    return wave_splits(N, (D // TC_TILE) * -(-FF // TC_TILE))


def tc_bwd_scratch_floats(N: int, D: int, FF: int, s_w: int,
                          s_vec: int) -> int:
    """``kit_ffn_bwd_split``'s scratch: the LayerNorms' partial sums per
    32-row block, the weight gradients' per row range (``s_w`` each), db2's
    per ``s_vec`` range, db1's per 128-row tile of the du product, then the
    bf16 planes of dz, x1, du and gelu(u), a hi and a lo plane each (two
    bf16 a float)."""
    return (-(-N // 32) * 4 * D + 2 * s_w * FF * D + s_vec * D
            + -(-N // TC_TILE) * FF + N * (2 * D + 2 * FF))


def ffn_supported(D: int, FF: int, int8: bool = False,
                  mode: str = "f32") -> bool:
    """The JAX ``_ffn_fwd_pallas`` rule: the FF kernel while its weights
    (bytes per D x FF element: 8 in float32, 12 in bf16x3, 4 in bf16, 2.5
    in int8, double-buffered on the TPU) stay within 8 MB; the plain chain
    above it."""
    per = 2.5 if int8 else {"f32": 8, "bf16x3": 12, "bf16": 4}[
        check_mode(mode)]
    return per * D * FF <= (8 << 20)


def ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln: bool = False,
              mode: str = "f32"):
    """Plain PyTorch version of ``fused_ffn``."""
    return ffn_train_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln,
                           mode)[0]


def ffn_train_plain(r, w1, b1, w2, b2, g1, be1, g2, be2,
                    pre_ln: bool = False, mode: str = "f32"):
    """Plain PyTorch version of ``fused_ffn_train``: (y, u, z), u and z
    flattened to (N, FF) and (N, D); the two products in ``mode``."""
    D = r.shape[-1]
    x1 = F.layer_norm(r, (D,), g1, be1, LN_EPS) if pre_ln else r
    x1 = x1.reshape(-1, D)
    u = mode_matmul(x1, w1, mode) + b1
    z = x1 + (mode_matmul(F.gelu(u), w2, mode) + b2)  # exact erf
    return F.layer_norm(z, (D,), g2, be2, LN_EPS).reshape(r.shape), u, z


def ff_weight_planes(w1t, w2t, mode: str):
    """(w1h, w1l, w2h, w2l): the tensor-core kernels' weights, W1^T (FF,
    D) and W2^T (D, FF) (torch's Linear layout), as bf16 hi / lo planes
    (the lo planes None in "bf16"); the forward reads them K-major, the
    backward MN-major."""
    return (*weight_planes(w1t, mode), *weight_planes(w2t, mode))


def _check_planes(where, device, mode, planes, n, FF):
    """The weight planes the tensor-core kernels read in ``mode``: lo
    planes in "bf16x3" only; each contiguous bfloat16 on ``device``,
    16-byte aligned, W1^T (FF, n) and W2^T (n, FF)."""
    if (planes[1] is None or planes[3] is None) != (mode == "bf16"):
        raise ValueError(f"{where}: mode {mode!r} takes "
                         f"{'no' if mode == 'bf16' else 'both'} lo planes")
    shapes = {"w1": (FF, n), "w2": (n, FF)}
    for k, t in zip(("w1h", "w1l", "w2h", "w2l"), planes):
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.device != device or \
                not t.is_contiguous():
            raise ValueError(f"{where}: {k} must be a contiguous bfloat16 "
                             f"tensor on {device}")
        _build.check_shape(where, k, t, shapes[k[:2]])
        _build.check_aligned(where, **{k: t})


def _check_forward(where, r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln,
                   mode, planes):
    D = r.shape[-1]
    FF = w1.shape[1]
    kernel_width(where, D)
    if not pre_ln:
        g1 = be1 = None
    dense = {"w1": w1, "w2": w2} if mode == "f32" else {}
    _build.check_tensors(where, r.device, r=r, b1=b1, b2=b2, g1=g1,
                         be1=be1, g2=g2, be2=be2, **dense)
    for name, t, shape in (("w1", w1, (D, FF)), ("b1", b1, (FF,)),
                           ("w2", w2, (FF, D)), ("b2", b2, (D,)),
                           ("g1", g1, (D,)), ("be1", be1, (D,)),
                           ("g2", g2, (D,)), ("be2", be2, (D,))):
        _build.check_shape(where, name, t, shape)
    _build.check_aligned(where, r=r, **dense)
    if mode != "f32":
        if planes is None:
            planes = ff_weight_planes(w1.t(), w2.t(), mode)
        _check_planes(where, r.device, mode, planes, D, FF)
    return g1, be1, planes


def _launch_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, train, mode,
                    planes):
    """(y, u, z) at the model's widths n and FF, u and z only with
    ``train``.  Runs at the kernel width D and FF rounded up to the
    kernel's FF step (4 in float32, 16 on the tensor cores), the operands
    zero-padded (``widths``)."""
    n, FF = w1.shape
    N = r.numel() // n
    D = kernel_width("fused_ffn", n)
    F4 = ff_kernel_width(FF, _FF_STEP if mode == "f32" else _FF_STEP_TC)
    r = pad(r, D)
    b1 = pad(b1, F4)
    b2, g1, be1, g2, be2 = (pad(t, D) for t in (b2, g1, be1, g2, be2))
    dev = r.device
    y = torch.empty_like(r)
    u = torch.empty(N, F4, device=dev) if train else None
    z = torch.empty(N, D, device=dev) if train else None
    lib = _build.bind("ffn", _SIGS)
    if mode == "f32":
        w1, w2 = pad(w1, D, F4), pad(w2, F4, D)
        parts = ff_parts(N, D, F4)
        scratch = (torch.empty(ff_scratch_floats(N, D, parts), device=dev)
                   if parts > 1 else None)
        _build.call(lib, "kit_ffn", dev, r, N, D, n, F4, parts, w1, b1, w2,
                    b2, g1, be1, g2, be2, y, u, z, scratch)
    else:
        w1h, w1l, w2h, w2l = planes
        w1h, w1l = pad(w1h, F4, D), pad(w1l, F4, D)
        w2h, w2l = pad(w2h, D, F4), pad(w2l, D, F4)
        parts = tc_parts(N, D, F4)
        scratch = (torch.empty(ff_scratch_floats(N, D, parts), device=dev)
                   if parts > 1 else None)
        _build.call(lib, "kit_ffn_tc", dev, _PASSES[mode], r, N, D, n, F4,
                    parts, w1h, w1l, b1, w2h, w2l, b2, g1, be1, g2, be2, y, u,
                    z, scratch)
    return cut(y, n), cut(u, FF), cut(z, n)


def fused_ffn(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln: bool = False,
              mode: str = "f32", planes=None):
    """r (..., D) -> y (..., D); g1/be1 are read only when ``pre_ln``.  In
    the modes "bf16x3" and "bf16" the kernel reads the weights as bf16
    planes: ``planes`` (``ff_weight_planes``), or split here from w1, w2."""
    check_mode(mode)
    if r.device.type == "cpu":
        return ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln, mode)
    g1, be1, planes = _check_forward("fused_ffn", r, w1, b1, w2, b2, g1,
                                     be1, g2, be2, pre_ln, mode, planes)
    y = _launch_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, False, mode,
                        planes)[0]
    fused_ffn.launches[mode] += 1
    return y


fused_ffn.launches = dict.fromkeys(MODES, 0)


def fused_ffn_train(r, w1, b1, w2, b2, g1, be1, g2, be2,
                    pre_ln: bool = False, mode: str = "f32", planes=None):
    """r (..., D) -> (y (..., D), u (N, FF), z (N, D)), N = r.numel() / D:
    the forward plus the residuals its backward reads; ``mode`` and
    ``planes`` as ``fused_ffn`` takes them."""
    check_mode(mode)
    if r.device.type == "cpu":
        return ffn_train_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln,
                               mode)
    g1, be1, planes = _check_forward("fused_ffn_train", r, w1, b1, w2, b2,
                                     g1, be1, g2, be2, pre_ln, mode, planes)
    y, u, z = _launch_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, True,
                              mode, planes)
    fused_ffn_train.launches[mode] += 1
    return y, u, z


fused_ffn_train.launches = dict.fromkeys(MODES, 0)


def ffn_int8_plain(r, w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2, be2,
                   pre_ln: bool = True, xla: bool = False):
    """Plain PyTorch version of ``fused_ffn_int8``; with ``xla`` the JAX
    package's int8 chain for weights over the kernel's budget
    (``ffn_supported``): ``_int8_dense_xla`` with the bias inside, on
    weights quantized in the "dense" form."""
    D = r.shape[-1]
    x1 = F.layer_norm(r, (D,), g1, be1, LN_EPS) if pre_ln else r
    h = F.gelu(int8_dense_plain(x1, w1q, w1s, b1, xla))  # exact erf
    if xla:
        z = x1 + int8_dense_plain(h, w2q, w2s, b2, xla)
    else:
        z = (x1 + int8_dense_plain(h, w2q, w2s)) + b2
    return F.layer_norm(z, (D,), g2, be2, LN_EPS)


def check_int8_ff(where, D, w1q, w1s, b1, w2q, w2s, b2):
    """The int8 FF weights in torch's layout, w1q (FF, D) and w2q (D, FF)
    int8 with their scales (FF,) and (D,); returns FF."""
    FF = w1q.shape[0]
    for name, t, shape in (("w1q", w1q, (FF, D)), ("w2q", w2q, (D, FF))):
        if t.dtype != torch.int8 or t.device != w1s.device or \
                not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be a contiguous int8 "
                             f"tensor on {w1s.device}")
        _build.check_shape(where, name, t, shape)
    for name, t, shape in (("w1s", w1s, (FF,)), ("b1", b1, (FF,)),
                           ("w2s", w2s, (D,)), ("b2", b2, (D,))):
        _build.check_shape(where, name, t, shape)
    _build.check_aligned(where, w1q=w1q, w2q=w2q)
    return FF


def pad_int8_ff(w1q, w1s, b1, w2q, w2s, b2, D: int, F4: int):
    """The int8 FF weights zero-padded to the kernel width D and FF width
    F4 (``widths``)."""
    return (pad(w1q, F4, D), pad(w1s, F4), pad(b1, F4), pad(w2q, D, F4),
            pad(w2s, D), pad(b2, D))


def fused_ffn_int8(r, w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2, be2,
                   pre_ln: bool = True):
    """r (..., D) -> y (..., D): the FF sublayer with both products int8
    (``_kernel_int8``), g1/be1 read only when ``pre_ln``; the weights
    quantized in the "ff" form (``int8_matmul.quantize_weight``)."""
    if r.device.type == "cpu":
        return ffn_int8_plain(r, w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2,
                              be2, pre_ln)
    where = "fused_ffn_int8"
    n = r.shape[-1]
    D = kernel_width(where, n)
    if not pre_ln:
        g1 = be1 = None
    _build.check_tensors(where, r.device, r=r, w1s=w1s, b1=b1, w2s=w2s,
                         b2=b2, g1=g1, be1=be1, g2=g2, be2=be2)
    FF = check_int8_ff(where, n, w1q, w1s, b1, w2q, w2s, b2)
    for name, t in (("g1", g1), ("be1", be1), ("g2", g2), ("be2", be2)):
        _build.check_shape(where, name, t, (n,))
    F4 = ff_kernel_width(FF)
    w = pad_int8_ff(w1q, w1s, b1, w2q, w2s, b2, D, F4)
    g1, be1, g2, be2 = (pad(t, D) for t in (g1, be1, g2, be2))
    x = pad(r, D)
    N = x.numel() // D
    y = torch.empty_like(x)
    h = torch.empty(N, F4, device=r.device)  # each row's GELU output
    lib = _build.bind("ffn", _SIGS)
    _build.call(lib, "kit_ffn_int8", r.device, x, N, D, n, F4, *w, g1, be1,
                g2, be2, y, h)
    fused_ffn_int8.launches += 1
    return cut(y, n)


fused_ffn_int8.launches = 0


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
    """Plain PyTorch version of ``ffn_bwd`` (float32)."""
    return ffn_bwd_split_plain(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln)


def ffn_bwd_split_plain(g, r, u, z, w1t, w2t, g1, be1, g2,
                        pre_ln: bool = False, mode: str = "f32"):
    """Plain PyTorch version of ``ffn_bwd_split``, written out step by step
    (and of ``ffn_bwd`` in "f32"): the four products in ``mode``, their
    operands rounded where the TPU kernels round them (h, dz, x1, du and
    the weights: ``_prep_act``)."""
    D = r.shape[-1]
    gg = g.reshape(-1, D)
    x = r.reshape(-1, D)
    dz, dg2, dbe2 = _ln_bwd_plain(gg, z, g2)                # LN2
    h = F.gelu(u)
    dw2t = mode_matmul(dz.t(), h, mode)                     # (D, FF)
    db2 = dz.sum(0)
    du = mode_matmul(dz, w2t, mode) * _gelu_grad(u)         # (N, FF)
    db1 = du.sum(0)
    x1 = F.layer_norm(x, (D,), g1, be1, LN_EPS) if pre_ln else x
    dw1t = mode_matmul(du.t(), x1, mode)                    # (FF, D)
    dx1 = mode_matmul(du, w1t, mode) + dz
    if pre_ln:
        dr, dg1, dbe1 = _ln_bwd_plain(dx1, x, g1)           # LN1
    else:
        dr, dg1, dbe1 = dx1, None, None
    return (dr.reshape(r.shape), dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2)


def row_splits(rows: int, tiles: int) -> int:
    """How many row ranges a reduction over ``rows`` is cut into so that
    ``tiles`` output tiles times the splits fill the card twice over
    (132 SMs); each range keeps at least 256 rows."""
    want = -(-2 * SMS // max(tiles, 1))
    return max(1, min(want, rows // 256))


def wave_splits(rows: int, tiles: int) -> int:
    """How many row ranges a weight-gradient launch over ``rows`` is cut
    into so that ``tiles`` output tiles times the ranges fill one wave of
    the card's 132 SMs, a block each (``csrc/sgemm_grad.cuh``); each range
    keeps at least 256 rows."""
    return max(1, min(SMS // max(tiles, 1), rows // 256))


def bwd_splits(N: int, D: int, FF: int) -> int:
    """The row ranges of ``ffn_bwd``'s weight-gradient launch at N rows,
    kernel width D and FF: with its row tiles, [dW1^T | dW2^T] over 2 FF /
    ``row_tile(D)``, they fill one wave of the card."""
    return wave_splits(N, 2 * -(-FF // row_tile(D)))


def du_rows(D: int) -> int:
    """The row tile of ``ffn_bwd``'s du product at kernel width D
    (``csrc/sgemm_grad.cuh`` ``resident_rows``): 64, 32 at D = 512."""
    return 64 if D <= 384 else 32


def bwd_scratch_floats(N: int, D: int, FF: int) -> int:
    """The partial sums ``kit_ffn_bwd`` keeps (``csrc/ffn.cu``): the two
    LayerNorms' per 32-row block, [dW1^T | dW2^T | db1] per row range,
    db2 per row tile of the du product."""
    return (-(-N // 32) * 4 * D + bwd_splits(N, D, FF) * (2 * FF * D + FF)
            + -(-N // du_rows(D)) * D)


def _check_backward(where, g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln):
    D = r.shape[-1]
    FF = w1t.shape[0]
    N = r.numel() // D
    kernel_width(where, D)
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
    return g1, be1


def ffn_bwd(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln: bool = False):
    """Gradients of ``fused_ffn_train``'s y: g (..., D) is dL/dy; r, u, z
    as the training forward saw and wrote them; w1t (FF, D), w2t (D, FF)
    in torch's Linear layout.  Returns (dr, dw1t, db1, dw2t, db2, dg1,
    dbe1, dg2, dbe2), dg1/dbe1 None without ``pre_ln``."""
    if g.device.type == "cpu":
        return ffn_bwd_plain(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln)
    where = "ffn_bwd"
    g1, be1 = _check_backward(where, g, r, u, z, w1t, w2t, g1, be1, g2,
                              pre_ln)
    grads = _launch_backward(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln)
    ffn_bwd.launches += 1
    return grads


def _launch_backward(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln):
    """``ffn_bwd``'s gradients from its checked operands, at the model's
    widths n and FF.  Runs at the kernel width D and FF rounded up to 4,
    the operands zero-padded (``widths``)."""
    n, nf = r.shape[-1], w1t.shape[0]
    N = r.numel() // n
    D = kernel_width("ffn_bwd", n)
    FF = ff_kernel_width(nf)
    g, r, z, g1, be1, g2 = (pad(t, D) for t in (g, r, z, g1, be1, g2))
    u, w1t, w2t = pad(u, FF), pad(w1t, FF, D), pad(w2t, D, FF)
    dev = g.device
    empty = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    splits = bwd_splits(N, D, FF)
    dr, dz, du = empty(r.shape), empty(N, D), empty(N, FF)
    x1 = empty(N, D) if pre_ln else None
    dw1t, dw2t = empty(FF, D), empty(D, FF)
    db1, db2 = empty(FF), empty(D)
    ln_out = empty(4, D)  # dg2, dbe2, dg1, dbe1
    scratch = empty(bwd_scratch_floats(N, D, FF))
    lib = _build.bind("ffn", _SIGS)
    _build.call(lib, "kit_ffn_bwd", dev, g, r, u, z, w1t, w2t, g1, be1,
                N, D, n, FF, splits, g2, x1, dz, du, dr, dw1t, db1,
                dw2t, db2, ln_out, scratch)
    ln_out = cut(ln_out, n)
    dg1, dbe1 = (ln_out[2], ln_out[3]) if pre_ln else (None, None)
    return (cut(dr, n), cut(dw1t, nf, n), cut(db1, nf), cut(dw2t, n, nf),
            cut(db2, n), dg1, dbe1, ln_out[0], ln_out[1])


ffn_bwd.launches = 0


def ffn_bwd_split(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln: bool = False,
                  mode: str = "f32", planes=None):
    """``ffn_bwd``'s gradients in two phases (A: LN2 backward, du, dW2^T,
    db2; B: dW1^T, db1, dx1, LN1 backward), the products in ``mode``; the
    arguments and results as ``ffn_bwd`` takes and returns them.  In
    "bf16x3" and "bf16" the kernel reads the weights as the forward's bf16
    planes in torch's layout: ``planes`` (``ff_weight_planes(w1t, w2t,
    mode)``, as ``FFNFunction`` saves them from its forward), or split here
    from w1t, w2t; in "f32" this is ``ffn_bwd`` (and counts as its
    launch)."""
    check_mode(mode)
    if g.device.type == "cpu":
        return ffn_bwd_split_plain(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln,
                                   mode)
    if mode == "f32":
        return ffn_bwd(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln)
    where = "ffn_bwd_split"
    g1, be1 = _check_backward(where, g, r, u, z, w1t, w2t, g1, be1, g2,
                              pre_ln)
    if planes is None:
        planes = ff_weight_planes(w1t, w2t, mode)
    _check_planes(where, g.device, mode, planes, r.shape[-1], w1t.shape[0])
    grads = _launch_bwd_split(g, r, u, z, planes, g1, be1, g2, pre_ln, mode)
    ffn_bwd_split.launches[mode] += 1
    return grads


def _launch_bwd_split(g, r, u, z, planes, g1, be1, g2, pre_ln, mode):
    """``ffn_bwd_split``'s gradients in a tensor-core mode from its checked
    operands and the weight planes, at the model's widths n and FF.  Runs
    at the kernel width D and FF rounded up to 16, the operands
    zero-padded (``widths``)."""
    n, nf = r.shape[-1], planes[0].shape[0]
    N = r.numel() // n
    D = kernel_width("ffn_bwd_split", n)
    FF = ff_kernel_width(nf, _FF_STEP_TC)
    g, r, z, g1, be1, g2 = (pad(t, D) for t in (g, r, z, g1, be1, g2))
    u = pad(u, FF)
    w1h, w1l, w2h, w2l = planes
    w1h, w1l = pad(w1h, FF, D), pad(w1l, FF, D)
    w2h, w2l = pad(w2h, D, FF), pad(w2l, D, FF)
    s_w = tc_bwd_splits(N, D, FF)
    s_vec = row_splits(N, -(-D // 128))
    dev = g.device
    empty = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    dr, dz, du = empty(r.shape), empty(N, D), empty(N, FF)
    x1 = empty(N, D) if pre_ln else None
    dw1t, dw2t = empty(FF, D), empty(D, FF)
    db1, db2 = empty(FF), empty(D)
    ln_out = empty(4, D)  # dg2, dbe2, dg1, dbe1
    # scratch: per-block / per-split partial sums, reduced in fixed order,
    # then the operand planes
    scratch = empty(tc_bwd_scratch_floats(N, D, FF, s_w, s_vec))
    lib = _build.bind("ffn", _SIGS)
    _build.call(lib, "kit_ffn_bwd_split", dev, _PASSES[mode], g, r, u, z,
                w1h, w1l, w2h, w2l, g1, be1, N, D, n, FF, s_w, s_w, s_vec,
                g2, x1, dz, du, dr, dw1t, db1, dw2t, db2, ln_out, scratch)
    ln_out = cut(ln_out, n)
    dg1, dbe1 = (ln_out[2], ln_out[3]) if pre_ln else (None, None)
    return (cut(dr, n), cut(dw1t, nf, n), cut(db1, nf), cut(dw2t, n, nf),
            cut(db2, n), dg1, dbe1, ln_out[0], ln_out[1])


ffn_bwd_split.launches = dict.fromkeys(_PASSES, 0)


class FFNFunction(torch.autograd.Function):
    """norm_out(x1 + FF(x1)), x1 = norm_in(r) when ``pre_ln``, through
    ``fused_ffn_train`` and, as the JAX package's mode -> backward table
    has it (``_fused_ffn_vjp_bwd``), ``ffn_bwd`` in "f32" or
    ``ffn_bwd_split`` in "bf16x3" and "bf16".  Takes the Linear parameters
    in torch's layout (w1t = linear1.weight, w2t = linear2.weight) and
    returns their gradients in it."""

    @staticmethod
    def forward(ctx, r, w1t, b1, w2t, b2, g1, be1, g2, be2, pre_ln,
                mode="f32"):
        if mode == "f32":
            y, u, z = fused_ffn_train(r, w1t.t().contiguous(), b1,
                                      w2t.t().contiguous(), b2, g1, be1, g2,
                                      be2, pre_ln)
        else:  # the weights split once per step, in torch's layout
            planes = None if r.device.type == "cpu" else \
                ff_weight_planes(w1t, w2t, mode)
            y, u, z = fused_ffn_train(r, w1t.t(), b1, w2t.t(), b2, g1, be1,
                                      g2, be2, pre_ln, mode, planes)
            ctx.planes = planes  # the backward reads the same planes
        ctx.pre_ln, ctx.mode = pre_ln, mode
        ctx.save_for_backward(r, u, z, w1t, w2t, g1, be1, g2)
        return y

    @staticmethod
    def backward(ctx, g):
        r, u, z, w1t, w2t, g1, be1, g2 = ctx.saved_tensors
        args = (g.contiguous(), r, u, z, w1t, w2t, g1, be1, g2, ctx.pre_ln)
        if ctx.mode == "f32":
            grads = ffn_bwd(*args)
        else:
            grads = ffn_bwd_split(*args, ctx.mode, ctx.planes)
        return (*grads, None, None)
