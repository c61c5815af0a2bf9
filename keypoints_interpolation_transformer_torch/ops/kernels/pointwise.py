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

In the precision modes "bf16x3" ("high") and "bf16" ("default"),
``fused_pre_stream_embed`` and ``fused_post_head`` run
``csrc/pointwise_modes.cu`` in the TPU kernels' mode arithmetic (the
``*_plain`` versions with ``mode`` say it step by step): every product's
operands rounded to their bf16 parts, the activation split again before
each product that reads it; token_norm, sigmoid, biases and the positional
sum in float32.  Each chain is five launches (a split, the products on the
bf16 tensor cores with the bias, residual or SwiGLU gate in their
epilogues, a row step for the norm), its weights as bf16 planes
(``chain_planes``) that a packed model splits once.  ``fused_pre_stream``
stays float32 (its mode: ROADMAP B 3).

Weights are in the Flax layout (in, out); fc1 and fc2 arrive packed as
``w12 = [W1 | W2]`` (D, 2D) with ``b12 = [b1 | b2]``.  A wrapper takes its
``*_plain`` version for CPU tensors and launches the kernel for CUDA
tensors; ``launches`` (``launches[mode]`` for the two chains that take a
mode) counts the calls that launched it.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .ffn import _PASSES, LN_EPS
from .precision import MODES, check_mode, mode_linear_plain, weight_planes
from .widths import KERNEL_WIDTHS

_SIGS = {"kit_pre_embed": "piiiipppppppppip",
         "kit_pre_stream": "piii" + "p" * 6 + "ip",
         "kit_post_head": "ppiippppppipp"}
_MODE_SIGS = {"kit_pre_embed_tc": "ipiiii" + "p" * 12 + "ipp",
              "kit_post_head_tc": "ippii" + "p" * 9 + "ipppp"}
# the chains' products walk the weight's columns 64 at a time (the gate's
# tile pairs x1 and x2 of the same 64 columns)
GATE_COLS = 64


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


def _dense(mode, linear):
    """The chain's Dense layer in ``mode``: ``linear`` (x, w, b) if given
    (the training route's ``mode_linear``, kernel and backward in the
    mode), else ``mode_linear_plain``."""
    return linear or functools.partial(mode_linear_plain, mode=mode)


def swiglu_mode_plain(n, w12, b12, w3, b3, mode, linear=None):
    """``swiglu_plain`` as the JAX ``_swiglu`` takes it in a mode: n's
    parts against [W1 | W2]'s, + b12, the gate in float32, its parts
    against W3's, + b3 (each product ``linear``, see ``_dense``)."""
    dense = _dense(mode, linear)
    x1, x2 = dense(n, w12, b12).chunk(2, dim=-1)
    return dense(x1 * torch.sigmoid(x2), w3, b3)


def pre_stream_embed_plain(x, wemb, bemb, pe_learned, w12, b12, w3, b3,
                           pe_residual: bool, want_emb: bool,
                           mode: str = "f32", linear=None):
    """Plain PyTorch version of ``fused_pre_stream_embed``; in a mode the
    JAX ``_pre_embed_kernel``'s arithmetic, which is also its XLA chain's
    (``nn.Dense`` under the ambient precision): e from x's and Wemb's
    parts, the SwiGLU from the parts of n and of the gate.  ``linear``
    (x, w, b) takes each product in the mode where given (``_dense``)."""
    if check_mode(mode) != "f32":
        dense = _dense(mode, linear)
        e = dense(x, wemb, bemb)
        n = token_norm(e)
        n = (n + n + pe_learned) if pe_residual else (n + pe_learned)
        s = swiglu_mode_plain(n, w12, b12, w3, b3, mode, dense)
        return (s, e) if want_emb else s
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


def post_head_plain(decoded, filled_emb, w12, b12, w3, b3, wh, bh,
                    mode: str = "f32", linear=None):
    """Plain PyTorch version of ``fused_post_head``; in a mode the JAX
    ``_post_kernel``'s arithmetic (the SwiGLU as above, the head from the
    parts of swish(z) and Wh), ``linear`` as ``pre_stream_embed_plain``
    takes it."""
    if check_mode(mode) != "f32":
        dense = _dense(mode, linear)
        z = token_norm(swiglu_mode_plain(decoded, w12, b12, w3, b3, mode,
                                         dense) + filled_emb)
        return dense(z * torch.sigmoid(z), wh, bh)
    z = token_norm(swiglu_plain(decoded, w12, b12, w3, b3) + filled_emb)
    return (z * torch.sigmoid(z)) @ wh + bh


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def chain_planes(w12, w3, mode: str, wemb=None, wh=None):
    """A chain's weights as ``csrc/pointwise_modes.cu`` reads them in
    ``mode``: (w12h, w12l, w3h, w3l, wxh, wxl), each a pair of contiguous
    bf16 planes (the lo planes None in "bf16"): [W1 | W2] (D, 2D) with its
    columns interleaved per GATE_COLS (W1's 64 j .. 64 j + 63, then W2's),
    W3 (D, D), and the embedding Wemb (F, D) with zero rows to FP = F
    rounded up to 16 (``wemb``), or the head Wh (D, F) with zero columns
    to FP (``wh``)."""
    D = w3.shape[0]
    w12i = w12.reshape(D, 2, D // GATE_COLS, GATE_COLS).transpose(1, 2)
    w12i = w12i.reshape(D, 2 * D)
    if wemb is not None:
        F = wemb.shape[0]
        wx = torch.nn.functional.pad(wemb, (0, 0, 0, _pad16(F) - F))
    else:
        F = wh.shape[1]
        wx = torch.nn.functional.pad(wh, (0, _pad16(F) - F))
    return (*weight_planes(w12i, mode), *weight_planes(w3, mode),
            *weight_planes(wx, mode))


def _check_swiglu(where, D, w12, b12, w3, b3):
    _build.check_shape(where, "w12", w12, (D, 2 * D))
    _build.check_shape(where, "b12", b12, (2 * D,))
    _build.check_shape(where, "w3", w3, (D, D))
    _build.check_shape(where, "b3", b3, (D,))


def _check_planes(where, planes, mode, device, shapes):
    """``chain_planes`` as the mode kernels read them: six entries, bf16
    pairs of the given shapes on ``device``, the lo planes None exactly in
    "bf16"."""
    if planes is None or len(planes) != 6:
        raise ValueError(f"{where}: needs the six chain_planes entries")
    for i, (name, shape) in enumerate(zip(("w12", "w3", "wx"), shapes)):
        for t, part in zip(planes[2 * i:2 * i + 2], ("hi", "lo")):
            if t is None and part == "lo" and mode == "bf16":
                continue
            if t is None or (part == "lo" and mode == "bf16"):
                raise ValueError(f"{where}: {name}'s {part} plane does not "
                                 f"fit mode {mode!r}")
            if t.dtype != torch.bfloat16 or t.device != device or \
                    not t.is_contiguous():
                raise ValueError(f"{where}: {name}'s {part} plane must be a "
                                 f"contiguous bf16 tensor on {device}")
            _build.check_shape(where, f"{name} {part}", t, shape)
    _build.check_aligned(where, **{f"plane {i}": t for i, t in
                                   enumerate(planes) if t is not None})


def fused_pre_stream_embed(x, wemb, bemb, pe_learned, w12, b12, w3, b3,
                           pe_residual: bool = False,
                           want_emb: bool = False, mode: str = "f32",
                           planes=None):
    """x (B, T, F) -> s (B, T, D) [, e (B, T, D) when ``want_emb``];
    ``pe_learned`` (T, D) is the sinusoidal table plus the learned vector.
    In the modes "bf16x3" and "bf16" the kernels read the weights as bf16
    planes, ``planes`` (``chain_planes(w12, w3, mode, wemb=wemb)``), which
    a card tensor in a mode must bring."""
    check_mode(mode)
    if x.device.type == "cpu":
        return pre_stream_embed_plain(x, wemb, bemb, pe_learned, w12, b12,
                                      w3, b3, pe_residual, want_emb, mode)
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
    emb = torch.empty(B, T, D, device=x.device) \
        if want_emb or mode != "f32" else None
    if mode == "f32":
        lib = _build.bind("pointwise", _SIGS)
        _build.call(lib, "kit_pre_embed", x.device, x, B * T, T, F, D, wemb,
                    bemb, pe_learned, w12, b12, w3, b3, out, emb,
                    int(pe_residual))
    else:
        if planes is None:
            raise ValueError(f"{where}: mode {mode!r} takes the weights' "
                             "planes (chain_planes)")
        FP = _pad16(F)
        _check_planes(where, planes, mode, x.device,
                      ((D, 2 * D), (D, D), (FP, D)))
        _build.check_aligned(where, x=x, bemb=bemb, b3=b3)
        w12h, w12l, w3h, w3l, weh, wel = planes
        planes_a = 2 if mode == "bf16x3" else 1  # bf16 planes an operand
        scratch = torch.empty(planes_a * B * T * (FP + 2 * D),
                              dtype=torch.bfloat16, device=x.device)
        lib = _build.bind("pointwise_modes", _MODE_SIGS)
        _build.call(lib, "kit_pre_embed_tc", x.device, _PASSES[mode], x,
                    B * T, T, F, D, weh, wel, bemb, pe_learned, w12h, w12l,
                    b12, w3h, w3l, b3, out, emb, int(pe_residual), scratch)
    fused_pre_stream_embed.launches[mode] += 1
    return (out, emb) if want_emb else out


fused_pre_stream_embed.launches = dict.fromkeys(MODES, 0)


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


def fused_post_head(decoded, filled_emb, w12, b12, w3, b3, wh, bh,
                    mode: str = "f32", planes=None):
    """decoded, filled_emb (B, T, D) -> (B, T, F); ``mode`` and ``planes``
    (``chain_planes(w12, w3, mode, wh=wh)``) as ``fused_pre_stream_embed``
    takes them."""
    check_mode(mode)
    if decoded.device.type == "cpu":
        return post_head_plain(decoded, filled_emb, w12, b12, w3, b3, wh, bh,
                               mode)
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
    if mode == "f32":
        lib = _build.bind("pointwise", _SIGS)
        _build.call(lib, "kit_post_head", decoded.device, decoded,
                    filled_emb, B * T, D, w12, b12, w3, b3, wh, bh, F, out)
    else:
        if planes is None:
            raise ValueError(f"{where}: mode {mode!r} takes the weights' "
                             "planes (chain_planes)")
        _check_planes(where, planes, mode, decoded.device,
                      ((D, 2 * D), (D, D), (D, _pad16(F))))
        _build.check_aligned(where, decoded=decoded, filled_emb=filled_emb,
                             b3=b3, bh=bh)
        w12h, w12l, w3h, w3l, whh, whl = planes
        planes_a = 2 if mode == "bf16x3" else 1  # bf16 planes an operand
        scratch = torch.empty(3 * planes_a * B * T * D,
                              dtype=torch.bfloat16, device=decoded.device)
        fs = torch.empty(B * T * D, device=decoded.device)
        lib = _build.bind("pointwise_modes", _MODE_SIGS)
        _build.call(lib, "kit_post_head_tc", decoded.device, _PASSES[mode],
                    decoded, filled_emb, B * T, D, w12h, w12l, b12, w3h, w3l,
                    b3, whh, whl, bh, F, out, scratch, fs)
    fused_post_head.launches[mode] += 1
    return out


fused_post_head.launches = dict.fromkeys(MODES, 0)
