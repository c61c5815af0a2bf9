"""The matmul precision modes, and their plain arithmetic.

The JAX package reads its mode from the ambient
``jax.default_matmul_precision`` (``ops/pallas/ffn.py`` ``_precision_mode``,
``ops/pallas/attention.py`` ``_mxu_mode``); the port takes it from the
model's ``precision`` attribute, set from ``ModelConfig.matmul_precision``
(``utils/config.py`` ``resolve_precision``):

  "highest", "float32"                     -> "f32": float32 products;
  "high", "tensorfloat32", "bfloat16_3x"   -> "bf16x3": each float32 operand
      x split into hi = bf16(x) and lo = bf16(x - hi), both rounded to
      nearest even, and a product taken as A_hi B_hi + A_hi B_lo + A_lo B_hi
      with every term summed in float32 (XLA's "high" on the TPU);
  "default", "bfloat16", "fastest"         -> "bf16": one bf16 pass,
      A_hi B_hi.

Only the operands of the products are rounded; LayerNorm, GELU, biases and
residuals stay float32 in every mode.  A product of two bf16 values is exact
in float32, so ``mode_matmul`` emulates the kernels' operand rounding
exactly, with float32 sums in another order.  On the card it needs TF32
off, or its float32 products would round once more.
"""

from __future__ import annotations

import torch

MODES = ("f32", "bf16x3", "bf16")


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown precision mode {mode!r}, expected one of "
                         f"{MODES}")
    return mode


def split_bf16(x: torch.Tensor):
    """(hi, lo) bf16 tensors: hi = bf16(x), lo = bf16(x - hi), both rounded
    to nearest even; x - hi is exact in float32."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def weight_planes(w: torch.Tensor, mode: str):
    """(hi, lo) contiguous bf16 planes of a float32 weight for the
    tensor-core kernels; lo is None in mode "bf16"."""
    if mode == "bf16":
        return w.contiguous().to(torch.bfloat16), None
    hi, lo = split_bf16(w.contiguous())
    return hi, lo


def _check_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("mode_matmul needs torch.backends.cuda.matmul."
                           "allow_tf32 off: TF32 would round its float32 "
                           "products again")


def _rounded_product(a: torch.Tensor, b: torch.Tensor, mode: str):
    if mode == "bf16":
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    ah, al = (p.float() for p in split_bf16(a))
    bh, bl = (p.float() for p in split_bf16(b))
    return (ah @ bh + ah @ bl) + al @ bh


class _ModeMatmul(torch.autograd.Function):
    """a (N, K) @ b (K, M) in a bf16 mode, whose gradients are products in
    the same mode, g b^T and a^T g, as the JAX package takes a dot's
    transposed products at the dot's precision.  Autograd through the
    casts instead would round the float32 gradients to bf16."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return _rounded_product(a, b, mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _rounded_product(g, b.t(), ctx.mode)
        if ctx.needs_input_grad[1]:
            db = _rounded_product(a.t(), g, ctx.mode)
        return da, db, None


def mode_matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a (N, K) @ b (K, M) in ``mode``: float32, or the one or three
    products of the bf16 parts, each exact, summed in float32; under
    autograd its gradients are products in the mode too."""
    if check_mode(mode) == "f32":
        return a @ b
    _check_tf32(a)
    return _ModeMatmul.apply(a, b, mode)
