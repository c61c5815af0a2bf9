"""The merged layers' two-kernel attention halves in the precision modes
(``csrc/layer_modes.cu`` on ``csrc/sub_fwd.cuh``): which shapes take them
(``layer_fused.mode_layer_fused`` against the header's ``fused_fwd``),
the K-major weight planes they read (``attn_kmajor_planes``: the same bits
as the transposed ``attn_weight_planes``, whose q scale the JAX ``_prep_w``
operands fold the same way; made once per version of the planes) and the
scratch each path takes.  The kernels themselves run only on the card
(``chip_smoke.py`` and ``tests/test_torch_gpu.py``)."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    layer_fused as jlf)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    layer_fused as tlf)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

_CSRC = Path(kernels.__file__).resolve().parents[2] / "csrc"


@pytest.mark.parametrize("T,D,dh,fused", [
    (128, 256, 32, True), (136, 256, 32, False), (129, 256, 32, False),
    (1, 256, 32, True), (40, 256, 32, True), (0, 256, 32, False),
    (128, 256, 64, False), (128, 256, 16, False), (128, 128, 32, False),
    (128, 384, 32, False), (256, 256, 32, False)])
def test_route_predicate(T, D, dh, fused):
    """Kernel width 256, 32-wide heads and T <= 128 take the two-kernel
    halves (the flagship's serving shape); T = 136, 64-wide heads or
    another width keep the longer launch chain."""
    assert tlf.mode_layer_fused(T, D, dh) is fused


def test_route_predicate_is_the_headers():
    """The Python rule's constants and comparisons are ``fused_fwd``'s in
    ``csrc/sub_fwd.cuh``, which ``layer_modes.cu`` and
    ``attn_sublayer_modes.cu`` both include."""
    src = (_CSRC / "sub_fwd.cuh").read_text()
    got = re.search(r"constexpr int FWD_D = (\d+), FWD_DH = (\d+), "
                    r"FWD_T = (\d+);", src)
    assert tuple(map(int, got.groups())) == (tlf.FWD_D, tlf.FWD_DH,
                                             tlf.FWD_T)
    body = re.search(r"inline bool fused_fwd\(int T, int D, int dh\) \{\s*"
                     r"(.*?)\s*\}", src, re.S).group(1)
    assert body == ("return D == FWD_D && dh == FWD_DH && T >= 1 && "
                    "T <= FWD_T;")
    for name in ("layer_modes.cu", "attn_sublayer_modes.cu"):
        assert '#include "sub_fwd.cuh"' in (_CSRC / name).read_text()


def _weights(rng, n):
    wqkv = torch.from_numpy(rng.normal(size=(n, 3 * n)).astype(np.float32))
    bqkv = torch.from_numpy(rng.normal(size=(3 * n,)).astype(np.float32))
    wo = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    return wqkv * 0.1, bqkv * 0.05, wo * 0.1


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("n,heads", [(256, 8), (224, 7)])
def test_kmajor_planes_are_the_transposed_planes(mode, n, heads):
    """``attn_kmajor_planes``: the planes of ``attn_weight_planes``
    zero-padded to the kernel width 256 as ``_mode_attn`` pads them (each
    of q, k and v's blocks on its own), then transposed: the same bits."""
    rng = np.random.default_rng(0)
    wqkv, bqkv, wo = _weights(rng, n)
    planes = tlf.attn_weight_planes(wqkv, bqkv, wo, heads, mode)
    x = torch.zeros(1, 8, n)
    wh, wl, _, oh, ol, _ = tlf._mode_attn("t", x, (wqkv, bqkv, wo,
                                                   torch.zeros(n)),
                                          planes, heads, mode, 256)
    kh, kl, koh, kol = tlf.attn_kmajor_planes(planes, 256)
    assert kh.shape == (768, 256) and koh.shape == (256, 256)
    assert kh.is_contiguous() and koh.is_contiguous()
    np.testing.assert_array_equal(_bits(kh), _bits(wh.t().contiguous()))
    np.testing.assert_array_equal(_bits(koh), _bits(oh.t().contiguous()))
    if mode == "bf16":
        assert kl is None and kol is None
    else:
        np.testing.assert_array_equal(_bits(kl), _bits(wl.t().contiguous()))
        np.testing.assert_array_equal(_bits(kol),
                                      _bits(ol.t().contiguous()))
    # the route's operands: the ten of ``_mode_attn_k``, K-major last
    at = tlf._mode_attn_k("t", x, (wqkv, bqkv, wo, torch.zeros(n)), planes,
                          heads, mode, 256, True)
    assert len(at) == 10 and at[6] is kh and at[8] is koh
    assert tlf._mode_attn_k("t", x, (wqkv, bqkv, wo, torch.zeros(n)),
                            planes, heads, mode, 256, False)[6:] == \
        (None,) * 4


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_kmajor_planes_fold_the_scale_as_prep_w(mode):
    """The K-major planes against the JAX operands of ``_enc_fwd_pallas``:
    q's weight times log2(e) / sqrt(dh) in float32, then ``_prep_w`` (the
    stacked [hi; lo; hi] at "bf16x3", one bf16 at "bf16"); each block's
    rows of the K-major planes are those operands' transposes, bit for
    bit, and so are Wo's."""
    n, heads = 256, 8
    rng = np.random.default_rng(1)
    wqkv, bqkv, wo = _weights(rng, n)
    kh, kl, koh, kol = tlf.attn_kmajor_planes(
        tlf.attn_weight_planes(wqkv, bqkv, wo, heads, mode), 256)
    qscale = jlf._LOG2E / math.sqrt(n // heads)
    wq, wk, wv = (jnp.asarray(w.numpy()) for w in wqkv.split(n, 1))
    ops = jlf._prep_w([wq * qscale, wk, wv, jnp.asarray(wo.numpy())], mode)
    for i, op in enumerate(ops):
        op = np.asarray(op).view(np.int16)
        hi, lo = (kh, kl) if i < 3 else (koh, kol)
        rows = slice(i * n, (i + 1) * n) if i < 3 else slice(0, n)
        np.testing.assert_array_equal(_bits(hi[rows]).T, op[:n], str(i))
        if mode == "bf16x3":
            np.testing.assert_array_equal(_bits(lo[rows]).T, op[n:2 * n])
            np.testing.assert_array_equal(op[2 * n:], op[:n])
        else:
            assert op.shape == (n, n)


def test_kmajor_planes_are_made_once_per_version():
    """A second call on the same planes is a hit (no transpose made); a
    plane changed in place (its ``_version``), a new planes tuple or
    inference tensors (no version kept: transposed every call) miss."""
    rng = np.random.default_rng(2)
    wqkv, bqkv, wo = _weights(rng, 256)
    planes = tlf.attn_weight_planes(wqkv, bqkv, wo, 8, "bf16x3")
    first = tlf.attn_kmajor_planes(planes, 256)
    builds = tlf.attn_kmajor_planes.builds
    assert tlf.attn_kmajor_planes(planes, 256) is first
    assert tlf.attn_kmajor_planes.builds == builds
    planes[3].mul_(1.0)
    again = tlf.attn_kmajor_planes(planes, 256)
    assert again is not first and tlf.attn_kmajor_planes.builds == builds + 1
    assert tlf.attn_kmajor_planes(planes, 256) is again
    fresh = tlf.attn_weight_planes(wqkv, bqkv, wo, 8, "bf16x3")
    other = tlf.attn_kmajor_planes(fresh, 256)
    assert other is not again
    for a, b in zip(other, again):
        assert torch.equal(a, b)
    with torch.inference_mode():
        inf = tlf.attn_weight_planes(wqkv, bqkv, wo, 8, "bf16")
        n0 = tlf.attn_kmajor_planes.builds
        tlf.attn_kmajor_planes(inf, 256)
        tlf.attn_kmajor_planes(inf, 256)
        assert tlf.attn_kmajor_planes.builds == n0 + 2


@pytest.mark.parametrize("decoder", [False, True])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_scratch_of_the_two_kernel_halves(decoder, mode):
    """The two-kernel halves' scratch: the attention output's planes (M D
    a plane) and floats M D (the encoder's r) or 2 M D (the decoder's x1
    and r), the FF split's parts as on the chain; less than the longer
    launch chain's."""
    B, T, D = 3, 128, 256
    MD = B * T * D
    planes = 2 if mode == "bf16x3" else 1
    for parts in (1, 4):
        nb, nf, ns = tlf.mode_scratch(B, T, D, decoder, mode, parts, True)
        assert (nb, nf) == (planes * MD, (2 if decoder else 1) * MD)
        assert ns == (parts * MD if parts > 1 else 0)
        old = tlf.mode_scratch(B, T, D, decoder, mode, parts)
        assert nb < old[0] and ns == old[2]

