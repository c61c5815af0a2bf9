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
residuals stay float32 in every mode.  The attention core rounds as the
JAX ``_attn_core`` does: the scores are products of q's and k's parts
(``part_products``), and the softmax probabilities, normalized first, are
rounded to one bf16 that multiplies v's parts (``prob_products``).  A product of two bf16 values is exact
in float32, so ``mode_matmul`` emulates the kernels' operand rounding
exactly, with float32 sums in another order.  On the card it needs TF32
off, or its float32 products would round once more.

The JAX package runs its whole train step and its serving calls under the
ambient precision, so the products it leaves to XLA (its ``nn.Dense``
layers: the training route's pointwise chains, the per-op q / k / v and
out-projections, the Embedding) are in the mode too, and so are their
transposed products in the backward.  ``mode_linear_plain`` is one such
Dense layer: x W + b with the product in the mode, its gradients g W^T
and x^T g in the mode as well (``_ModeMatmul``), the bias's a float32
column sum.
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


def parts(x: torch.Tensor, mode: str):
    """The float32 values of x's bf16 parts in ``mode``: (hi, lo) in
    "bf16x3", (hi,) in "bf16" (the JAX ``_prep``)."""
    if mode == "bf16":
        return (x.to(torch.bfloat16).float(),)
    return tuple(p.float() for p in split_bf16(x))


def part_products(a_parts, b_parts) -> torch.Tensor:
    """a @ b from pre-split parts (``parts``; batched as ``@`` is): a_hi b_hi,
    or (a_hi b_hi + a_hi b_lo) + a_lo b_hi, the three products summed in
    float32 in the order of the JAX ``_dot``."""
    if len(a_parts) == 1:
        return a_parts[0] @ b_parts[0]
    (ah, al), (bh, bl) = a_parts, b_parts
    return (ah @ bh + ah @ bl) + al @ bh


def prob_products(p: torch.Tensor, v_parts) -> torch.Tensor:
    """p @ v with the probabilities p rounded to one bf16 and v in its parts
    (``parts``): p v_hi (+ p v_lo), as the JAX ``_prob_parts`` /
    ``_prob_dot`` take them."""
    pb = p.to(torch.bfloat16).float()
    out = pb @ v_parts[0]
    return out if len(v_parts) == 1 else out + pb @ v_parts[1]


def _check_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("mode_matmul needs torch.backends.cuda.matmul."
                           "allow_tf32 off: TF32 would round its float32 "
                           "products again")


def _rounded_product(a: torch.Tensor, b: torch.Tensor, mode: str):
    return part_products(parts(a, mode), parts(b, mode))


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


def mode_linear_plain(x: torch.Tensor, w: torch.Tensor, b, mode: str):
    """x (..., K) W (K, N) + b (N,) (b may be None) with the product in
    ``mode`` (``mode_matmul`` on the rows of x); at "f32" exactly ``x @ w +
    b``.  Under autograd the gradients of x and W are products in the mode
    too, the bias's the float32 sum of g over the rows."""
    if check_mode(mode) == "f32":
        y = x @ w
    else:
        y = mode_matmul(x.reshape(-1, x.shape[-1]), w, mode).reshape(
            *x.shape[:-1], w.shape[1])
    return y if b is None else y + b


def mode_linear_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          mode: str, need_dx: bool = True):
    """The gradients of ``mode_linear_plain`` given g = dL/dy (..., N):
    (dx = g W^T or None without ``need_dx``, dW = x^T g, db = the column
    sums of g), the two products in ``mode`` over the rows of x and g."""
    check_mode(mode)
    g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
    if mode == "f32":
        dx = (g2 @ w.t()).reshape(x.shape) if need_dx else None
        return dx, x2.t() @ g2, g2.sum(0)
    dx = _rounded_product(g2, w.t(), mode).reshape(x.shape) if need_dx \
        else None
    return dx, _rounded_product(x2.t(), g2, mode), g2.sum(0)
