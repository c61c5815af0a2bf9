"""Feed-forward sublayer of the transformer.

Kernel (``csrc/ffn.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/ffn.py::_kernel_single``
(the float32 mode; ``_kernel_split`` is its bf16x3 mode):

    x1 = LN1(r) if pre_ln else r
    y  = LN2(x1 + gelu(x1 W1 + b1) W2 + b2)        (exact-erf GELU)

Bound on an H100 by float32 FFMA work (2.1 MFLOP per token at D = 256,
FF = 2048); one block keeps a 32-row tile's x1, each FF chunk's GELU
output and the z accumulator on chip, so only r and y touch device
memory.  See the source note in ``csrc/ffn.cu``.

Weights are in the Flax layout: w1 (D, FF), w2 (FF, D).  The wrapper takes
``ffn_plain`` for CPU tensors and launches the kernel for CUDA tensors;
``launches`` counts the calls that launched it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-5
_SIGS = {"kit_ffn": "piiipppppppppp"}
_WIDTHS = (128, 256)


def ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln: bool = False):
    """Plain PyTorch version of ``fused_ffn``."""
    D = r.shape[-1]
    x1 = F.layer_norm(r, (D,), g1, be1, LN_EPS) if pre_ln else r
    h = F.gelu(x1 @ w1 + b1)  # exact erf
    return F.layer_norm(x1 + (h @ w2 + b2), (D,), g2, be2, LN_EPS)


def fused_ffn(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln: bool = False):
    """r (..., D) -> y (..., D); g1/be1 are read only when ``pre_ln``."""
    if r.device.type == "cpu":
        return ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln)
    where = "fused_ffn"
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
    _build.check_aligned(where, w1=w1, w2=w2)
    y = torch.empty_like(r)
    lib = _build.bind("ffn", _SIGS)
    _build.call(lib, "kit_ffn", r.device, r, r.numel() // D, D, FF, w1, b1,
                w2, b2, g1, be1, g2, be2, y)
    fused_ffn.launches += 1
    return y


fused_ffn.launches = 0
