"""Pre-stream chains and post head of the KeypointCompleter.

Kernels (``csrc/pointwise.cu``), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/pointwise.py``:

  * ``fused_pre_stream_embed`` <- ``_pre_embed_kernel``: Linear(F -> D),
    token_norm [doubled for Cycle], + (pe + learned), SwiGLU; optionally
    also returns the embedding.
  * ``fused_pre_stream`` <- ``_pre_kernel``: the same chain from an
    embedding that is already computed.  The JAX package reaches its kernel
    only with its embedding kernel switched off (``KIT_PW_EMBED=0``,
    ``completer.py:170,192``), and no route of the port's model takes it.
  * ``fused_post_head`` <- ``_post_kernel``: SwiGLU, token_norm(+ filled
    embedding), swish, Linear(D -> F).

Bound on an H100 by float32 FFMA work (about 0.4 MFLOP per token against
2 KB of activations in and out); one block keeps a 32-row tile's whole
chain in shared memory and registers, so no intermediate reaches device
memory.  See the source note in ``csrc/pointwise.cu``.

Weights are in the Flax layout (in, out); fc1 and fc2 arrive packed as
``w12 = [W1 | W2]`` (D, 2D) with ``b12 = [b1 | b2]``.  A wrapper takes its
``*_plain`` version for CPU tensors and launches the kernel for CUDA
tensors; ``launches`` counts the calls that launched it.
"""

from __future__ import annotations

import torch

from . import _build
from .ffn import LN_EPS
from .widths import KERNEL_WIDTHS

_SIGS = {"kit_pre_embed": "piiiipppppppppip",
         "kit_pre_stream": "piii" + "p" * 6 + "ip",
         "kit_post_head": "ppiippppppipp"}


def pointwise_supported(D: int, T: int) -> bool:
    """The JAX ``KeypointCompleter``'s rule for its pointwise kernels: D a
    multiple of 128 up to 512 and T a multiple of 8; its XLA chains (here
    the plain ones) elsewhere."""
    return D % 128 == 0 and T % 8 == 0 and D <= 512


def token_norm(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """Per-token normalization over the last axis, no affine parameters."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) * (x - m)).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def swiglu_plain(n, w12, b12, w3, b3):
    """fc3(fc1(n) * sigmoid(fc2(n))) from the packed fc1/fc2 weight."""
    x1, x2 = (n @ w12 + b12).chunk(2, dim=-1)
    return (x1 * torch.sigmoid(x2)) @ w3 + b3


def pre_stream_embed_plain(x, wemb, bemb, pe_learned, w12, b12, w3, b3,
                           pe_residual: bool, want_emb: bool):
    """Plain PyTorch version of ``fused_pre_stream_embed``."""
    e = x @ wemb + bemb
    n = token_norm(e)
    n = (n + n + pe_learned) if pe_residual else (n + pe_learned)
    s = swiglu_plain(n, w12, b12, w3, b3)
    return (s, e) if want_emb else s


def pre_stream_plain(e, pe_learned, w12, b12, w3, b3,
                     pe_residual: bool = False):
    """Plain PyTorch version of ``fused_pre_stream``."""
    n = token_norm(e)
    n = (n + n + pe_learned) if pe_residual else (n + pe_learned)
    return swiglu_plain(n, w12, b12, w3, b3)


def post_head_plain(decoded, filled_emb, w12, b12, w3, b3, wh, bh):
    """Plain PyTorch version of ``fused_post_head``."""
    z = token_norm(swiglu_plain(decoded, w12, b12, w3, b3) + filled_emb)
    return (z * torch.sigmoid(z)) @ wh + bh


def _check_swiglu(where, D, w12, b12, w3, b3):
    _build.check_shape(where, "w12", w12, (D, 2 * D))
    _build.check_shape(where, "b12", b12, (2 * D,))
    _build.check_shape(where, "w3", w3, (D, D))
    _build.check_shape(where, "b3", b3, (D,))


def fused_pre_stream_embed(x, wemb, bemb, pe_learned, w12, b12, w3, b3,
                           pe_residual: bool = False,
                           want_emb: bool = False):
    """x (B, T, F) -> s (B, T, D) [, e (B, T, D) when ``want_emb``];
    ``pe_learned`` (T, D) is the sinusoidal table plus the learned vector."""
    if x.device.type == "cpu":
        return pre_stream_embed_plain(x, wemb, bemb, pe_learned, w12, b12,
                                      w3, b3, pe_residual, want_emb)
    where = "fused_pre_stream_embed"
    B, T, F = x.shape
    D = wemb.shape[1]
    if D not in KERNEL_WIDTHS or F > D or F % 4:
        raise ValueError(f"{where}: needs D in {KERNEL_WIDTHS} and F <= D a "
                         f"multiple of 4, got D={D}, F={F}")
    _build.check_tensors(where, x.device, x=x, wemb=wemb, bemb=bemb,
                         pe_learned=pe_learned, w12=w12, b12=b12, w3=w3,
                         b3=b3)
    _build.check_shape(where, "wemb", wemb, (F, D))
    _build.check_shape(where, "bemb", bemb, (D,))
    _build.check_shape(where, "pe_learned", pe_learned, (T, D))
    _check_swiglu(where, D, w12, b12, w3, b3)
    _build.check_aligned(where, wemb=wemb, w12=w12, w3=w3)
    out = torch.empty(B, T, D, device=x.device)
    emb = torch.empty(B, T, D, device=x.device) if want_emb else None
    lib = _build.bind("pointwise", _SIGS)
    _build.call(lib, "kit_pre_embed", x.device, x, B * T, T, F, D, wemb,
                bemb, pe_learned, w12, b12, w3, b3, out, emb,
                int(pe_residual))
    fused_pre_stream_embed.launches += 1
    return (out, emb) if want_emb else out


fused_pre_stream_embed.launches = 0


def fused_pre_stream(e, pe_learned, w12, b12, w3, b3,
                     pe_residual: bool = False):
    """e (B, T, D) -> s (B, T, D): token_norm(e) [+ token_norm(e)] +
    ``pe_learned`` (T, D), then SwiGLU."""
    if e.device.type == "cpu":
        return pre_stream_plain(e, pe_learned, w12, b12, w3, b3, pe_residual)
    where = "fused_pre_stream"
    B, T, D = e.shape
    if D not in KERNEL_WIDTHS:
        raise ValueError(f"{where}: needs D in {KERNEL_WIDTHS}, got D={D}")
    _build.check_tensors(where, e.device, e=e, pe_learned=pe_learned,
                         w12=w12, b12=b12, w3=w3, b3=b3)
    _build.check_shape(where, "pe_learned", pe_learned, (T, D))
    _check_swiglu(where, D, w12, b12, w3, b3)
    _build.check_aligned(where, w12=w12, w3=w3)
    out = torch.empty(B, T, D, device=e.device)
    lib = _build.bind("pointwise", _SIGS)
    _build.call(lib, "kit_pre_stream", e.device, e, B * T, T, D, pe_learned,
                w12, b12, w3, b3, out, int(pe_residual))
    fused_pre_stream.launches += 1
    return out


fused_pre_stream.launches = 0


def fused_post_head(decoded, filled_emb, w12, b12, w3, b3, wh, bh):
    """decoded, filled_emb (B, T, D) -> (B, T, F)."""
    if decoded.device.type == "cpu":
        return post_head_plain(decoded, filled_emb, w12, b12, w3, b3, wh, bh)
    where = "fused_post_head"
    B, T, D = decoded.shape
    F = wh.shape[1]
    if D not in KERNEL_WIDTHS or F > D or F % 4:
        raise ValueError(f"{where}: needs D in {KERNEL_WIDTHS} and F <= D a "
                         f"multiple of 4, got D={D}, F={F}")
    _build.check_tensors(where, decoded.device, decoded=decoded,
                         filled_emb=filled_emb, w12=w12, b12=b12, w3=w3,
                         b3=b3, wh=wh, bh=bh)
    _build.check_shape(where, "filled_emb", filled_emb, (B, T, D))
    _check_swiglu(where, D, w12, b12, w3, b3)
    _build.check_shape(where, "wh", wh, (D, F))
    _build.check_shape(where, "bh", bh, (F,))
    _build.check_aligned(where, w12=w12, w3=w3, wh=wh)
    out = torch.empty(B, T, F, device=decoded.device)
    lib = _build.bind("pointwise", _SIGS)
    _build.call(lib, "kit_post_head", decoded.device, decoded, filled_emb,
                B * T, D, w12, b12, w3, b3, wh, bh, F, out)
    fused_post_head.launches += 1
    return out


fused_post_head.launches = 0
