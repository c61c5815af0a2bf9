"""Dense layers in the precision modes: the products the JAX package leaves
to XLA.

The JAX package runs its train step and its serving calls under the ambient
``jax.default_matmul_precision``, so every ``nn.Dense`` outside its Pallas
kernels (the training route's pointwise chains, the per-op q / k / v and
out-projections, the ``Embedding`` autoencoder, the serving chains where its
pointwise kernels do not run) is an XLA dot that the TPU takes as bf16_3x
at "high" and one bf16 pass at "default", and so are the transposed dots of
its backward.  Kernels (``csrc/mode_linear.cu``):

  * ``mode_linear(x, w, b, mode)``: y = x W + b over the last axis, the
    product on the bf16 tensor cores from the bf16 parts of x and W
    (``precision.mode_linear_plain`` says it step by step), one launch a
    call: the kernel reads x in float32 and splits it itself;
  * ``weight_planes(w, mode)``: W's planes and their tensor maps, made once
    per weight version (the tensor, its ``_version``, its storage and the
    mode: an optimizer's in-place step and ``load_state_dict``'s ``copy_``
    both bump the version) and kept while W lives; ``weight_planes.splits``
    counts the splits;
  * ``mode_linear_bwd``: dx = g W^T and dW = x^T g in the same mode, db the
    float32 column sums of g, in a fixed order (no atomics);
  * ``ModeLinearFunction`` ties them together under autograd: its forward
    has the kernel write x's planes beside y, and its backward reads them
    and W's, so a step splits each weight once.

``mode_linear`` takes the plain version for CPU tensors and launches the
kernels for CUDA tensors (through ``ModeLinearFunction`` when a gradient
is wanted), or raises; at "f32" it is ``x @ w + b``, as the port computed
these products before (the library's float32 product, counted nowhere).
``launches[mode]`` counts the calls that launched.  W is (in, out), the Flax
layout, as ``packed_linear`` and ``graph_linear`` hand it over (a view of
a Linear's weight keys the cache by that weight); K and N must be
multiples of 4.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch

from . import _build
from .ffn import _PASSES, wave_splits
from .precision import (MODES, check_mode, mode_linear_bwd_plain,
                        mode_linear_plain, split_bf16)

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_mode_linear": "ipiii" + "p" * 6,
         "kit_mode_linear_weight": "ipii" + "p" * 4,
         "kit_mode_linear_bwd": "ipiii" + "p" * 7 + "ii" + "p" * 4}
# two CUtensorMap of 128 bytes: the maps of W's planes
_MAPS_BYTES = 256
# the planes' row multiple (``csrc/mode_linear.cu`` pad16): TMA reads rows
# of 16-byte multiples, and 108 columns are 216 bytes
PLANE_COLS = 16
# the tensor-core product's output tile (``csrc/tc_gemm.cuh``)
TILE = 128
# rows of g a partial column sum of db covers, at least
COLSUM_ROWS = 256


def padded(n: int) -> int:
    return -(-n // PLANE_COLS) * PLANE_COLS


def _planes_of(t: torch.Tensor, mode: str):
    """(hi, lo) bf16 planes of a float32 matrix (rows, cols), its columns
    zero-padded to ``padded(cols)``; lo None in "bf16"."""
    cols = t.shape[1]
    t = torch.nn.functional.pad(t, (0, padded(cols) - cols))
    if mode == "bf16":
        return t.to(torch.bfloat16), None
    return split_bf16(t)


def linear_planes(w: torch.Tensor, mode: str):
    """W (K, N) as ``csrc/mode_linear.cu`` reads it in ``mode``: bf16
    planes (K, padded(N)), the columns past N zero, lo None in "bf16"."""
    return _planes_of(w.detach().float(), check_mode(mode))


def row_planes(x: torch.Tensor, mode: str):
    """x's rows (M, K) as the kernels read them: planes (M, padded(K))."""
    return _planes_of(x.detach().reshape(-1, x.shape[-1]).float(),
                      check_mode(mode))


def weight_splits(M: int, K: int, N: int) -> int:
    """The row ranges of dW = x^T g at M rows: with its ceil(K / 128) x
    ceil(N / 128) output tiles they fill one wave of the card."""
    return wave_splits(M, -(-K // TILE) * -(-N // TILE))


def colsum_splits(M: int) -> int:
    """The row ranges db's column sums add in order: one per
    ``COLSUM_ROWS`` rows, at most 132 (one wave of blocks)."""
    return max(1, min(132, M // COLSUM_ROWS))


def _operand(where, name, t, device):
    """t as the kernels read it: float32, contiguous, on ``device`` and on
    a 16-byte boundary (a view with an offset is copied)."""
    if t is None:
        return None
    t = t.contiguous()
    _build.check_tensors(where, device, **{name: t})
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_planes(where, planes, mode, device, shape):
    hi, lo = planes
    for t, part in ((hi, "hi"), (lo, "lo")):
        if t is None and part == "lo" and mode == "bf16":
            continue
        if t is None or (part == "lo" and mode == "bf16"):
            raise ValueError(f"{where}: the {part} plane does not fit mode "
                             f"{mode!r}")
        if t.dtype != torch.bfloat16 or t.device != device or \
                not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{where}: a plane must be a contiguous, "
                             f"16-byte aligned bf16 tensor on {device}")
        _build.check_shape(where, part, t, shape)


def _check_widths(where, K, N):
    if K % 4 or N % 4:
        raise ValueError(f"{where}: needs K and N multiples of 4, got K={K}, "
                         f"N={N}")


def _plane_pair(P, rows, cols, device):
    buf = torch.empty(P, rows, cols, dtype=torch.bfloat16, device=device)
    return buf[0], (buf[1] if P == 2 else None)


class WeightPlanes(NamedTuple):
    """W's planes (hi, lo; lo None in "bf16") and, on the card, the tensor
    maps of them that the kernel reads (a CPU byte tensor)."""
    planes: tuple
    maps: Optional[torch.Tensor]


class _Entry(NamedTuple):
    ref: weakref.ref
    version: int
    ptr: int
    value: WeightPlanes


_CACHE: dict = {}


def _cache_key(w: torch.Tensor, mode: str):
    """(the tensor W is a view of, or W, and the key of W's planes): the
    base's identity, W's place in it and the mode."""
    base = w if w._base is None else w._base
    return base, (id(base), tuple(w.shape), tuple(w.stride()),
                  w.storage_offset(), mode)


def weight_planes(w: torch.Tensor, mode: str) -> WeightPlanes:
    """W (K, N)'s planes in ``mode`` as ``csrc/mode_linear.cu`` reads them
    (``linear_planes``), split once per version of W: a hit needs the same
    tensor (a weak reference, so a new tensor at a freed one's address
    misses), the same ``_version`` and the same storage.  On the card the
    split is ``kit_mode_linear_weight``'s, which also encodes the planes'
    tensor maps; on the CPU ``linear_planes``."""
    check_mode(mode)
    base, key = _cache_key(w, mode)
    e = _CACHE.get(key)
    if e is not None and e.ref() is base and e.version == w._version \
            and e.ptr == w.data_ptr():
        return e.value
    if w.device.type == "cpu":
        value = WeightPlanes(linear_planes(w, mode), None)
    else:
        value = _split_weight(w, mode)
    weight_planes.splits[mode] += 1
    ref = weakref.ref(base, lambda _, k=key: _CACHE.pop(k, None))
    _CACHE[key] = _Entry(ref, w._version, w.data_ptr(), value)
    return value


weight_planes.splits = dict.fromkeys(MODES, 0)


def _split_weight(w, mode):
    where = "mode_linear"
    K, N = w.shape
    _check_widths(where, K, N)
    wc = _operand(where, "w", w.detach(), w.device)
    P = 2 if mode == "bf16x3" else 1
    wh, wl = _plane_pair(P, K, padded(N), w.device)
    maps = torch.empty(_MAPS_BYTES, dtype=torch.uint8)
    lib = _build.bind("mode_linear", _SIGS)
    _build.call(lib, "kit_mode_linear_weight", w.device, _PASSES[mode], wc,
                K, N, wh, wl, maps)
    return WeightPlanes((wh, wl), maps)


def _launch(x, w, b, mode, keep):
    """The forward on the card: (y (..., N), x's planes (M, padded(K)) or
    None, W's planes), one launch; x's planes written when ``keep``.  The
    checks raise on device, dtype and shape; a view that is not contiguous
    or not 16-byte aligned is copied."""
    where = "mode_linear"
    K, N = w.shape
    dev = x.device
    if x.shape[-1] != K:
        raise ValueError(f"{where}: x has {x.shape[-1]} features, W {K} rows")
    if w.device != dev:
        raise ValueError(f"{where}: w is on {w.device}, expected {dev}")
    wp = weight_planes(w, mode)
    x2 = x.reshape(-1, K)
    if x2.dtype != torch.float32 or not x2.is_contiguous() \
            or x2.data_ptr() % 16:
        x2 = _operand(where, "x", x2, dev)
    if b is not None:
        if b.dtype != torch.float32 or b.device != dev \
                or not b.is_contiguous() or b.data_ptr() % 16:
            b = _operand(where, "b", b, dev)
        if b.shape != (N,):
            _build.check_shape(where, "b", b, (N,))
    M = x2.shape[0]
    xh = xl = None
    if keep:
        xh, xl = _plane_pair(2 if mode == "bf16x3" else 1, M, padded(K), dev)
    y = torch.empty(M, N, device=dev)
    lib = _build.bind("mode_linear", _SIGS)
    _build.call(lib, "kit_mode_linear", dev, _PASSES[mode], x2, M, K, N,
                wp.maps, b, y, xh, xl)
    mode_linear.launches[mode] += 1
    return y.view(*x.shape[:-1], N), (xh, xl), wp.planes


def mode_linear(x: torch.Tensor, w: torch.Tensor, b, mode: str):
    """x (..., K) W (K, N) + b (N,) (b may be None) with the product in
    ``mode``: the plain version on the CPU; on the card the kernel, through
    ``ModeLinearFunction`` when autograd wants a gradient of x, W or b."""
    check_mode(mode)
    if mode == "f32" or x.device.type == "cpu":
        return mode_linear_plain(x, w, b, mode)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return ModeLinearFunction.apply(x, w, b, mode)
    return _launch(x, w, b, mode, False)[0]


mode_linear.launches = dict.fromkeys(MODES, 0)


def mode_linear_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    mode: str, planes=None, need_dx: bool = True,
                    need_dw: bool = True, need_db: bool = True):
    """The gradients of ``mode_linear`` given g = dL/dy (..., N): (dx (...,
    K), dW (K, N), db (N,)), each None where not needed, the products in
    ``mode``.  On the card the kernel reads the planes of x's rows and of W
    (``planes`` = (``row_planes(x)``, ``linear_planes(w)``), as the
    forward's call left them; split here when not given); x and W are read
    only on the CPU and for their shapes."""
    check_mode(mode)
    if mode == "f32":
        raise ValueError("mode_linear_bwd: takes a bf16 mode; at \"f32\" "
                         "autograd differentiates x @ w + b")
    if g.device.type == "cpu":
        dx, dw, db = mode_linear_bwd_plain(g, x, w, mode, need_dx)
        return dx, (dw if need_dw else None), (db if need_db else None)
    if planes is None:
        planes = (row_planes(x, mode), linear_planes(w, mode))
    return _launch_bwd(g, planes, w.shape[0], mode, need_dx, need_dw,
                       need_db)


def _launch_bwd(g, planes, K, mode, need_dx, need_dw, need_db):
    """The backward on the card from the planes of x's rows and of W (K,
    N)."""
    where = "mode_linear_bwd"
    N = g.shape[-1]
    _check_widths(where, K, N)
    g2 = _operand(where, "g", g.reshape(-1, N), g.device)
    M = g2.shape[0]
    xp, wp = planes
    _check_planes(where, xp, mode, g.device, (M, padded(K)))
    _check_planes(where, wp, mode, g.device, (K, padded(N)))
    P = 2 if mode == "bf16x3" else 1
    gh, gl = _plane_pair(P, M, padded(N), g.device)
    splits = weight_splits(M, K, N) if need_dw else 1
    vsplits = colsum_splits(M)
    part = torch.empty((splits * K * N if splits > 1 else 0) + vsplits * N,
                       device=g.device)
    dx = torch.empty(M, K, device=g.device) if need_dx else None
    dw = torch.empty(K, N, device=g.device) if need_dw else None
    db = torch.empty(N, device=g.device) if need_db else None
    lib = _build.bind("mode_linear", _SIGS)
    _build.call(lib, "kit_mode_linear_bwd", g.device, _PASSES[mode], g2, M,
                K, N, *xp, *wp, dx, dw, db, splits, vsplits, gh, gl, part)
    mode_linear_bwd.launches[mode] += 1
    if dx is not None:
        dx = dx.reshape(*g.shape[:-1], K)
    return dx, dw, db


mode_linear_bwd.launches = dict.fromkeys(MODES, 0)


class ModeLinearFunction(torch.autograd.Function):
    """y = x W + b in a bf16 mode through ``mode_linear``'s kernel and
    ``mode_linear_bwd``: the forward's kernel writes x's planes, W's come
    from ``weight_planes``, and the backward reads both (on the CPU, the
    plain versions of both)."""

    @staticmethod
    def forward(ctx, x, w, b, mode):
        ctx.mode, ctx.has_b = mode, b is not None
        if x.device.type == "cpu":
            ctx.planes = None
            ctx.save_for_backward(x, w)
            return mode_linear_plain(x, w, b, mode)
        y, xp, wp = _launch(x, w, b, mode, True)
        ctx.planes, ctx.K = (xp, wp), w.shape[0]
        return y

    @staticmethod
    def backward(ctx, g):
        need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
        need_db = need_db and ctx.has_b
        if ctx.planes is None:
            dx, dw, db = mode_linear_bwd(g, *ctx.saved_tensors, ctx.mode,
                                         None, need_dx, need_dw, need_db)
        else:
            dx, dw, db = _launch_bwd(g, ctx.planes, ctx.K, ctx.mode,
                                     need_dx, need_dw, need_db)
        return dx, dw, db, None
