"""The JAX package's ``nn.Dense`` products rounded as the TPU rounds them in
a precision mode, for the port's tests on the CPU.

The JAX package runs its train step and its serving calls under the
ambient ``jax.default_matmul_precision``, and leaves its ``nn.Dense``
layers to XLA, which on the TPU takes a dot at "high" as bf16_3x (x_hi W_hi
+ x_hi W_lo + x_lo W_hi, hi = bf16(v), lo = bf16(v - hi)) and at "default"
as one bf16 pass (x_hi W_hi), the transposed dots of the backward at the
same precision.  XLA on the CPU ignores the ambient precision.
``dense_in_mode(mode)`` intercepts every ``nn.Dense.__call__`` (the hook
the JAX package's int8 route uses, ``eval/quantize.py``) and computes it
that way: each product of exact bf16 parts summed in float32, its
``jax.custom_vjp`` taking g W^T and x^T g in the same mode.  Nothing in the
JAX package changes.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
from flax import linen as nn

# the ambient precision names of the port's modes
PRECISION = {"bf16x3": "high", "bf16": "default"}


def _parts(x, mode):
    hi = x.astype(jnp.bfloat16).astype(jnp.float32)
    if mode == "bf16":
        return (hi,)
    return hi, (x - hi).astype(jnp.bfloat16).astype(jnp.float32)


def _dot(a, b, mode):
    """a (M, K) @ b (K, N) from the bf16 parts of both, each product exact
    in float32 and summed in float32."""
    def dot(x, y):
        return jnp.dot(x, y, precision=jax.lax.Precision.HIGHEST)
    ap, bp = _parts(a, mode), _parts(b, mode)
    if len(ap) == 1:
        return dot(ap[0], bp[0])
    return (dot(ap[0], bp[0]) + dot(ap[0], bp[1])) + dot(ap[1], bp[0])


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def mode_dot(x, w, mode):
    """x (..., K) @ w (K, N) in ``mode``; its gradients in the mode too."""
    return _dot(x.reshape(-1, x.shape[-1]), w, mode).reshape(
        *x.shape[:-1], w.shape[1])


def _fwd(x, w, mode):
    return mode_dot(x, w, mode), (x, w)


def _bwd(mode, res, g):
    x, w = res
    g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
    return (_dot(g2, w.T, mode).reshape(x.shape), _dot(x2.T, g2, mode))


mode_dot.defvjp(_fwd, _bwd)


def _interceptor(mode):
    def interceptor(next_fn, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dense) and context.method_name == "__call__" \
                and "params" in mod.variables:
            params = mod.variables["params"]
            y = mode_dot(jnp.asarray(args[0], jnp.float32),
                         params["kernel"].astype(jnp.float32), mode)
            if mod.use_bias:
                y = y + params["bias"].astype(jnp.float32)
            return y.astype(mod.dtype or args[0].dtype)
        return next_fn(*args, **kwargs)
    return interceptor


@contextlib.contextmanager
def dense_in_mode(mode):
    """Within it, every ``nn.Dense`` the JAX models apply computes in
    ``mode`` ("bf16x3" or "bf16"), forward and backward."""
    with nn.intercept_methods(_interceptor(mode)):
        yield
