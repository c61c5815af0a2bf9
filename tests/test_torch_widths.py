"""The widths the port's kernels take, and the routes it picks, against the
JAX package's predicates on the CPU.

The CUDA kernels are built for D = 128, 256, 384 and 512 and any head
width up to 512; a narrower model runs zero-padded to the next of these
(``ops/kernels/widths.py``).  Where the JAX package routes a shape to XLA
(the pointwise chains off D % 128 == 0, T % 8 == 0, D <= 512; the FF
sublayer above its weight budget; attention per op above 512 frames or
off T % 8 == 0), the port takes its plain ops as that route.  The kernels
themselves run on the card only (``tests/test_torch_gpu.py``)."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attn_sublayer as jasl)
from keypoints_interpolation_transformer_tpu.ops.pallas import ffn as jffn
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    layer_fused as jlf)
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    pointwise as jpw)
from keypoints_interpolation_transformer_torch.eval import serving
from keypoints_interpolation_transformer_torch.models import (
    completer as tc)
from keypoints_interpolation_transformer_torch.ops.kernels import (
    layer_fused as tlf)
from keypoints_interpolation_transformer_torch.ops.kernels import (
    attention, widths)
from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
    ffn_supported)
from keypoints_interpolation_transformer_torch.ops.kernels.pointwise import (
    pointwise_supported)
from keypoints_interpolation_transformer_torch.utils.config import (
    ModelConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

WIDTHS = (32, 64, 100, 128, 200, 256, 384, 512, 640, 1024)
LENGTHS = (8, 12, 16, 128, 256, 264, 512, 520)


class _Route(Exception):
    """Raised by a patched JAX function to report the route taken."""


def _jax_pointwise_route(D, T):
    """True where the JAX ``KeypointCompleter`` on its TPU route sends the
    pre-stream chain to its Pallas kernel (``completer.py:165-168``), read
    by tracing it abstractly with both routes' first calls patched."""
    def kernel(*a, **k):
        raise _Route(True)

    def chain(*a, **k):
        raise _Route(False)

    model = jc.KeypointCompleter(hidden_dim=D, num_layers=1, num_heads=1,
                                 ff_dim=8)
    x = jnp.zeros((1, T, 54, 2))
    with mock.patch.object(jc, "_attention_platform", return_value="tpu"), \
            mock.patch.object(jpw, "fused_pre_stream_embed", kernel), \
            mock.patch.object(jc, "token_norm", chain):
        try:
            jax.eval_shape(lambda: model.init(jax.random.key(0), x, x))
        except _Route as r:
            return r.args[0]
    raise AssertionError("neither route was reached")


def _jax_ffn_kernel(D, FF, int8):
    """True where the JAX ``_ffn_fwd_pallas`` keeps the FF sublayer in its
    kernel (its weight budget, ``ffn.py:287-300``), read by tracing it with
    ``pallas_call`` patched."""
    def call(*a, **k):
        raise _Route(True)

    r = jax.ShapeDtypeStruct((8, D), jnp.float32)
    w1 = jax.ShapeDtypeStruct((D, FF), jnp.float32)
    w2 = jax.ShapeDtypeStruct((FF, D), jnp.float32)
    vec = jax.ShapeDtypeStruct((D,), jnp.float32)
    b1 = jax.ShapeDtypeStruct((FF,), jnp.float32)
    # at "highest", as the port serves: 8 bytes per float32 weight
    with mock.patch.object(jffn.pl, "pallas_call", call), \
            jax.default_matmul_precision("highest"):
        try:
            jax.eval_shape(lambda *a: jffn._ffn_fwd_pallas(*a, True, int8),
                           r, w1, b1, w2, vec, vec, vec, vec, vec)
        except _Route:
            return True
    return False


@pytest.mark.parametrize("D", WIDTHS)
def test_routing_predicates_match_jax(D):
    """The port's copies of the JAX predicates at every (D, T, FF) of a
    grid: the attention-sublayer kernel (``attn_sublayer.py:259-264``),
    the merged layers (``layer_fused.py:37-48``), the pointwise kernels
    (``completer.py:165-168``) and the FF kernel's budget
    (``ffn.py:287-300``), the last two read from the JAX code's own
    behaviour."""
    for T in LENGTHS:
        assert tlf.sublayer_supported(T, D) == \
            jasl.fused_attn_sublayer_supported(T, D)
        for fuse in (True, False):
            assert tlf.use_sublayer_kernel(fuse, T, D) == (
                fuse and jasl.fused_attn_sublayer_supported(T, D))
        for FF in (64, 2048, 4096):
            assert tlf.fused_layer_supported(T, D, FF) == \
                jlf.fused_layer_supported(T, D, FF)
            assert tlf.decoder_full_supported(T, D, FF) == \
                jlf.decoder_full_supported(T, D, FF)
    for T in (12, 16):
        assert pointwise_supported(D, T) == _jax_pointwise_route(D, T)
    for FF in (64, 2048, 4096, 8192):
        for int8 in (False, True):
            assert ffn_supported(D, FF, int8) == _jax_ffn_kernel(D, FF, int8)


@pytest.mark.parametrize("n,heads", [(384, 1), (384, 2), (512, 1),
                                     (512, 2), (200, 1)])
def test_check_heads_takes_head_widths_to_512(n, heads):
    """Head widths above 128 (the JAX attention kernels take any): the
    cores' wide build takes 128 < dh <= 512 (``csrc/attention.cuh``
    ``by_head``), so the wrappers let them through; wider heads than any
    kernel width are still refused, by every attention entry point."""
    assert widths.check_heads("f", n, heads) == n // heads
    assert widths.MAX_HEAD == 512
    for bad_n, bad_h in ((1024, 1), (1026, 2)):
        with pytest.raises(ValueError, match="head width"):
            widths.check_heads("f", bad_n, bad_h)
    q = torch.zeros(1, 8, 1, 513)
    with pytest.raises(ValueError, match="head width"):
        attention._check("fused_attention", q, {}, None, None, "all", False)


def test_kernel_widths_and_padding():
    """The widths a model runs at on the card, and the zero padding that
    takes it there: each block of a packed weight padded on its own, and
    cut back."""
    assert [widths.kernel_width("f", n) for n in (1, 32, 128, 129, 384,
                                                  500, 512)] == \
        [128, 128, 128, 256, 384, 512, 512]
    with pytest.raises(ValueError, match="up to 512"):
        widths.kernel_width("f", 513)
    assert widths.check_heads("f", 384, 3) == 128
    assert widths.check_heads("f", 32, 4) == 8
    for n, h in ((1026, 2), (30, 4), (32, 0)):
        with pytest.raises(ValueError, match="head width"):
            widths.check_heads("f", n, h)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(32, 96, generator=g)  # [Wq | Wk | Wv] at n = 32
    p = widths.pad(widths.pad_blocks(w, 32, 128, 1), 128, 384)
    assert p.shape == (128, 384)
    for i in range(3):
        torch.testing.assert_close(p[:32, 128 * i:128 * i + 32],
                                   w[:, 32 * i:32 * (i + 1)])
    assert float(p.abs().sum()) == pytest.approx(float(w.abs().sum()))
    back = widths.cut(widths.cut_blocks(p, 32, 128, 1), 32, 96)
    torch.testing.assert_close(back, w, rtol=0, atol=0)
    assert widths.pad(w, 32, 96) is w and widths.pad(None, 4) is None


@pytest.mark.parametrize("D,H", [(32, 4), (128, 2), (384, 3), (512, 8)])
def test_models_serve_and_train_at_the_widths(rng, D, H):
    """The entry points take every width the card now takes (D up to 512,
    head widths 8 to 128): one int8 and one float32 Inpainter request and
    one training forward and backward per width, on the CPU (the plain
    versions), agree in shape and stay finite; the float and int8 requests
    keep the non-missing frames."""
    from keypoints_interpolation_transformer_torch.train import steps
    cfg = ModelConfig(hidden_dim=D, num_heads=H, num_layers=1, ff_dim=2 * D)
    model = tc.KeypointCompleter(D, 1, H, ff_dim=2 * D,
                                 generator=torch.Generator().manual_seed(D))
    v = rng.uniform(0.2, 0.8, (20, 54, 2)).astype(np.float32)
    m = (rng.random(20) < 0.3).astype(np.float32)
    outs = []
    for q in (None, "int8"):
        inp = serving.Inpainter(model.state_dict(), cfg, bucket_multiple=16,
                                device="cpu", quantize=q)
        out = inp.inpaint([v], [m])[0]
        assert out.shape == v.shape and np.isfinite(out).all()
        np.testing.assert_array_equal(out[m == 0], v[m == 0])
        outs.append(out)
    assert not np.array_equal(outs[0], outs[1])
    net = steps.build_model(cfg, for_training=True, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.stack([v[:16]] * 2))
    mask = torch.from_numpy(np.stack([m[:16]] * 2))
    out = net(x, x, mask, mask)
    out.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in net.parameters() if p.requires_grad)
