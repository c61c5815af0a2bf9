"""The widths the CUDA kernels are built for, and the zero padding that
takes a narrower model to them.

The row kernels (``csrc/common.cuh``) hold a token row of D = 32 * TN
values in one warp and are built for D = 128, 256, 384 and 512.  A model
of width n <= 512 runs at the next of these, D = ``kernel_width(n)``: its
wrapper pads every activation, weight, bias and LayerNorm parameter with
zeros from n to D, passes n to the kernel, which keeps every LayerNorm's
statistics over the first n columns and writes 0 beyond them, and cuts the
results back to n.  The padded columns hold 0 through every product, so the
result is the unpadded model's.  The attention cores take any head width
dh = n / H up to ``MAX_HEAD`` = 512, the widest D (their head stride is
dh, not a padded one; ``csrc/attention.cuh`` ``by_head``).

Packed weights keep their blocks: [Wq | Wk | Wv] (n, 3n) becomes
[Wq' | Wk' | Wv'] (D, 3D), each block padded on its own (``pad_blocks``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_WIDTHS = (128, 256, 384, 512)
MAX_HEAD = 512


def kernel_width(where: str, n: int) -> int:
    """The kernel width a model of width ``n`` runs at; raises above 512."""
    for D in KERNEL_WIDTHS:
        if n <= D:
            return D
    raise ValueError(f"{where}: the kernels take widths up to "
                     f"{KERNEL_WIDTHS[-1]}, got {n}")


def row_tile(D: int) -> int:
    """Token rows per tile of the kernels' float32 block product at the
    kernel width D (``csrc/sgemm.cuh`` ``row_tile``): 64 up to D = 256, 32
    at 384 and 512, where two 64-row accumulator tiles and their shared
    tiles do not fit one SM."""
    return 64 if D <= 256 else 32


def check_heads(where: str, n: int, heads: int) -> int:
    """The head width n / heads; raises unless it is whole and at most
    ``MAX_HEAD``."""
    if heads <= 0 or n % heads or n // heads > MAX_HEAD:
        raise ValueError(f"{where}: needs a head width D / heads of at most "
                         f"{MAX_HEAD}, got D={n}, heads={heads}")
    return n // heads


def pad(t, *sizes):
    """``t`` zero-padded at the end of its last ``len(sizes)`` axes to
    ``sizes`` (None passes through; no copy where nothing grows)."""
    if t is None:
        return None
    grow = [s - n for s, n in zip(sizes, t.shape[-len(sizes):])]
    if not any(grow):
        return t
    spec = []
    for g in reversed(grow):
        spec += [0, g]
    return F.pad(t, spec).contiguous()


def pad_blocks(t, n: int, D: int, dim: int):
    """Each width-n block of ``t`` along ``dim`` zero-padded to D."""
    if n == D:
        return t
    parts = [F.pad(b.movedim(dim, -1), (0, D - n)).movedim(-1, dim)
             for b in t.split(n, dim)]
    return torch.cat(parts, dim).contiguous()


def cut_blocks(t, n: int, D: int, dim: int):
    """The inverse of ``pad_blocks``: the first n of each width-D block."""
    if n == D:
        return t
    parts = [b.narrow(dim, 0, n) for b in t.split(D, dim)]
    return torch.cat(parts, dim).contiguous()


def cut(t, *sizes):
    """``t`` cut at the end of its last ``len(sizes)`` axes to ``sizes``."""
    if t is None or tuple(t.shape[-len(sizes):]) == tuple(sizes):
        return t
    idx = (Ellipsis,) + tuple(slice(0, s) for s in sizes)
    return t[idx].contiguous()
