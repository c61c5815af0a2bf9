"""The port's int8 serving (``Inpainter(quantize="int8")``, ``cli serve
--quantize int8``) against the JAX package's int8 Inpainter on the route
it takes on the TPU, on the CPU: the JAX platform is patched to "tpu" and
its Pallas kernels run in interpret mode (as ``test_pallas_kernels.py``
does), the weights go through the same reference ``.pth``.

On the CPU the JAX package would turn its int8 FF kernels into an XLA
chain and quantize every ``nn.Dense`` (the attention projections too); on
the TPU only its int8 kernels and the ``nn.Dense`` calls that still run
are int8.  The port follows the TPU route on both devices, so that is the
route held here."""

import contextlib
import unittest.mock as mock

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.eval import serving as jserving
from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.utils.config import (
    ModelConfig as JaxModelConfig)
from keypoints_interpolation_transformer_torch import cli
from keypoints_interpolation_transformer_torch.eval import serving
from keypoints_interpolation_transformer_torch.eval.quantize import (
    quantization_error)
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.models.convert import (
    save_reference_pth)
from keypoints_interpolation_transformer_torch.ops import kernels

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

LAYERS = 2
# port against JAX on the missing frames: float32 noise only (the same int8
# values on both sides), so well below any one quantization step's effect
TOL = 1e-4
# int8 against float32 must stand at least this far above that noise, or
# the comparison could not tell an int8 route from a float one
SEPARATION = 10.0


@contextlib.contextmanager
def _tpu_route():
    """The JAX package's TPU route on the CPU: its platform reads "tpu" and
    its Pallas kernels run in interpret mode."""
    with mock.patch.object(jc, "_attention_platform", return_value="tpu"), \
            pltpu.force_tpu_interpret_mode():
        yield


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _videos(rng, lengths):
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in lengths]
    masks = [(rng.random(t) < 0.3).astype(np.float32) for t in lengths]
    for m in masks:
        m[0] = 0.0
        m[-1] = 1.0
    return videos, masks


def _compare(tag, videos, masks, got, want, floats):
    """Non-missing frames bit for bit the input; missing ones within TOL of
    the JAX int8 Inpainter; int8 at least SEPARATION times that gap from
    the port's float32 Inpainter."""
    err = delta = 0.0
    for v, m, g, w, f in zip(videos, masks, got, want, floats):
        assert g.shape == v.shape and np.isfinite(g).all()
        np.testing.assert_array_equal(g[m == 0], v[m == 0])
        err = max(err, float(np.abs(g[m == 1] - w[m == 1]).max()))
        delta = max(delta, float(np.abs(g[m == 1] - f[m == 1]).max()))
    print(f"{tag}: port int8 vs JAX int8 {err:.3e} (tol {TOL:.0e}); int8 vs "
          f"float32 {delta:.3e}")
    assert err <= TOL
    assert delta >= SEPARATION * max(err, TOL / SEPARATION)


def _serve(path, jax_cfg, lengths, rng, first=None, **kw):
    """The three Inpainters on the same videos: (videos, masks, port int8,
    JAX int8, port float32)."""
    videos, masks = _videos(rng, lengths)
    with _tpu_route():
        want = jserving.Inpainter.from_checkpoint(
            path, jax_cfg, first_checkpoint=first, quantize="int8",
            **kw).inpaint(videos, masks)
    q8 = serving.Inpainter.from_checkpoint(path, first_checkpoint=first,
                                           quantize="int8", device="cpu", **kw)
    got = q8.inpaint(videos, masks)
    floats = serving.Inpainter.from_checkpoint(
        path, first_checkpoint=first, device="cpu", **kw).inpaint(videos,
                                                                  masks)
    return videos, masks, got, want, floats


def _hyper(D, H):
    return {"hidden_dim": D, "num_layers": LAYERS, "num_heads": H}


@pytest.mark.parametrize("D,H", [(32, 4), (128, 4)])
def test_int8_inpainter_matches_jax_tpu_route(rng, tmp_path, D, H):
    """Two layers, buckets of 16 and 32 frames.  D=32: the pre-stream and
    post-head chains off their kernels, their Linears int8 (the int8 dense
    layer); D=128: the float pointwise kernels.  Both: the merged encoder
    with its int8 FF, the merged decoder without its FF tail, then the
    int8 FF sublayer."""
    path = str(tmp_path / "m.pth")
    save_reference_pth(path, KeypointCompleter(D, LAYERS, H, ff_dim=2 * D,
                                               generator=_gen(D)),
                       _hyper(D, H))
    cfg = JaxModelConfig(hidden_dim=D, num_layers=LAYERS, num_heads=H,
                         ff_dim=2 * D)
    _compare(f"D={D}", *_serve(path, cfg, (10, 25, 32), rng,
                                bucket_multiple=16, max_seq_len=32))


def test_int8_routes_and_quantization_error(rng):
    """Which int8 route each shape takes, by the kernels' wrappers called
    (on the CPU they run their plain versions and launch nothing), and the
    masked-frame MPJPE delta ``quantization_error`` reports: the int8
    forward's, within the JAX serving test's 0.1, and the model left as
    it was."""
    model = KeypointCompleter(32, 1, 4, ff_dim=64, generator=_gen(3)).eval()
    calls = {}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    from keypoints_interpolation_transformer_torch.models import layers
    names = ("fused_int8_dense", "fused_ffn_int8", "fused_encoder_layer_int8",
             "fused_decoder_layer", "fused_encoder_layer", "fused_ffn")
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 16, 54, 2)).astype(
        np.float32))
    miss = torch.from_numpy((rng.random((2, 16)) < 0.3).astype(np.float32))
    model.pack_weights("int8")
    with contextlib.ExitStack() as st:
        for n in names:
            st.enter_context(mock.patch.object(
                layers, n, count(n, getattr(layers, n))))
        with torch.no_grad():
            model(x, x, miss, miss)
    # the Linears of the pre-stream chains (2 x 3) and the post head (3);
    # per layer the merged encoder (int8 FF inside), the merged decoder
    # without its FF tail, then the int8 FF sublayer
    assert calls == {"fused_int8_dense": 9, "fused_encoder_layer_int8": 1,
                     "fused_decoder_layer": 1, "fused_ffn_int8": 1}
    assert kernels.launch_counts()["int8_dense"] == 0
    model.pack_weights(None)
    err = quantization_error(model, (x, x, miss, miss), frame_mask=miss)
    assert 0.0 < err < 0.1
    assert not model.int8


def test_cli_serve_quantize_and_unknown_mode(tmp_path):
    args = cli.build_parser().parse_args(
        ["serve", "--checkpoint", "m.pth", "--quantize", "int8"])
    assert args.quantize == "int8"
    assert cli.build_parser().parse_args(
        ["serve", "--checkpoint", "m.pth"]).quantize is None
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(
            ["serve", "--checkpoint", "m.pth", "--quantize", "int4"])
    path = str(tmp_path / "m.pth")
    save_reference_pth(path, KeypointCompleter(32, 1, 4, ff_dim=64,
                                               generator=_gen(4)),
                       {"hidden_dim": 32, "num_layers": 1, "num_heads": 4})
    with pytest.raises(ValueError, match="unknown quantize mode"):
        serving.Inpainter.from_checkpoint(path, device="cpu",
                                          quantize="int4")
    # "none", as the JAX Inpainter takes it, is float32
    assert not serving.Inpainter.from_checkpoint(
        path, device="cpu", quantize="none").model.int8
