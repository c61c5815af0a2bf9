"""The int8 dense layer of int8 serving, and the weight quantization that
int8 serving packs its models with.

Kernel (``csrc/int8_matmul.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/int8_matmul.py``:

  * ``fused_int8_dense`` <- ``_kernel``: a dynamic per-row int8 quantize of
    x, an int8 x int8 -> int32 product with weights quantized per output
    column, the dequantization and the bias, in one launch:

        s  = max(max_k |x[r, k]|, 1e-12) * (1 / 127)          (per row)
        xq = clip(rint(x * (1 / s)), -127, 127)
        y  = float(xq Wq^T) * s * w_scale + b

Bound on an H100 by its bytes at the shapes serving gives it (K and N of
108 to 768: x in and y out in float32 against 2 K N int8 operations per
row); see the source note in ``csrc/int8_matmul.cu``.

Weights are quantized once, when a model packs them (``quantize_weight``),
in torch's Linear layout: wq (N, K) int8, one row per output column, and
its scale (N,).  The JAX package has two forms of the scale, and each
route uses its own: "dense", ``max(max|w| / 127, 1e-12)``, for the
``nn.Dense`` table (JAX ``eval/quantize._quantize_kernel``), and "ff",
``max(max|w|, 1e-12) / 127``, for the FF and merged-layer kernels (JAX
``ops/pallas/ffn.py`` and ``layer_fused._quant_w``).  Both round w / scale
half to even.

The int32 sums are exact (|acc| <= K 127^2 < 2^31); the plain versions
take them in float64, exact below 2^53 (a float32 product is not exact
above 2^24, and on the card ``torch.matmul`` takes no integer tensors),
and cast them to float32 as the kernel does.  A wrapper takes its plain
version for CPU tensors and launches its kernel for CUDA tensors (or
raises); ``launches`` counts the calls that launched.
"""

from __future__ import annotations

import torch

from . import _build

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_int8_dense": "p" + "ii" + "ppp" + "i" + "pp"}
FORMS = ("dense", "ff")


def quantize_weight(w, form: str = "dense"):
    """Symmetric per-output-channel int8 of a Linear weight w (N, K):
    (wq (N, K) int8, scale (N,) float32), the scale in ``form``."""
    if form not in FORMS:
        raise ValueError(f"unknown scale form {form!r}, expected one of "
                         f"{FORMS}")
    w = w.detach().to(torch.float32)
    amax = w.abs().amax(1)
    if form == "dense":
        scale = torch.clamp(amax / 127.0, min=1e-12)
    else:
        scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def quantize_rows(x, xla: bool = False):
    """Dynamic symmetric per-row int8 of x (M, K): (xq (M, K) float32
    holding integers, s (M, 1)).  As the TPU kernels compute it, s =
    max(amax, 1e-12) * (1 / 127) and xq = rint(x * (1 / s)); with ``xla``
    as the JAX ``_int8_dense_xla`` does, s = max(amax / 127, 1e-12) and
    xq = rint(x / s), which can round one value the other way."""
    amax = x.abs().amax(-1, keepdim=True)
    if xla:
        s = torch.clamp(amax / 127.0, min=1e-12)
        return torch.clamp(torch.round(x / s), -127, 127), s
    s = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    return torch.clamp(torch.round(x * (1.0 / s)), -127, 127), s


def int8_product(xq, wq):
    """The exact sums xq wq^T (float64, cast to float32)."""
    return (xq.to(torch.float64) @ wq.to(torch.float64).t()).to(
        torch.float32)


def int8_dense_plain(x, wq, w_scale, bias=None, xla: bool = False):
    """Plain PyTorch version of ``fused_int8_dense``; with ``xla`` the JAX
    ``_int8_dense_xla`` (see ``quantize_rows``)."""
    shape = x.shape
    xq, s = quantize_rows(x.reshape(-1, shape[-1]).to(torch.float32), xla)
    y = int8_product(xq, wq) * s * w_scale
    if bias is not None:
        y = y + bias
    return y.reshape(*shape[:-1], wq.shape[0])


def fused_int8_dense(x, wq, w_scale, bias=None):
    """x (..., K) -> y (..., N): wq (N, K) int8, w_scale (N,), bias (N,)
    or None."""
    if x.device.type == "cpu":
        return int8_dense_plain(x, wq, w_scale, bias)
    where = "fused_int8_dense"
    shape = x.shape
    K = shape[-1]
    N = wq.shape[0]
    x2 = x.reshape(-1, K)
    _build.check_tensors(where, x.device, x=x2, w_scale=w_scale, bias=bias)
    if wq.dtype != torch.int8 or wq.device != x.device or \
            not wq.is_contiguous():
        raise ValueError(f"{where}: wq must be a contiguous int8 tensor on "
                         f"{x.device}")
    _build.check_shape(where, "wq", wq, (N, K))
    _build.check_shape(where, "w_scale", w_scale, (N,))
    _build.check_shape(where, "bias", bias, (N,))
    if K % 4 == 0:
        _build.check_aligned(where, wq=wq)
    y = torch.empty(x2.shape[0], N, device=x.device)
    if not y.numel():
        return y.reshape(*shape[:-1], N)
    lib = _build.bind("int8_matmul", _SIGS)
    _build.call(lib, "kit_int8_dense", x.device, x2, x2.shape[0], K, wq,
                w_scale, bias, N, y)
    fused_int8_dense.launches += 1
    return y.reshape(*shape[:-1], N)


fused_int8_dense.launches = 0
