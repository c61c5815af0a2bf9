"""The int8 route's merged layers in the precision modes "high" (bf16x3) and
"default" (one bf16 pass): ``encoder_layer_int8_plain(..., mode)`` against
the JAX ``fused_encoder_layer(..., ff_int8=True)`` (``_enc_kernel`` with its
int8 FF tail) in interpret mode under the ambient precision; the int8
Inpainter at "high" against the JAX int8 Inpainter on its TPU route; the
model's routing of the mode on the int8 route, the table rows and the C
entry.  The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``).

The attention half rounds as the merged mode layers do
(``tests/test_torch_layer_modes.py``): the same exact bf16 products summed
in float32 in another order, and the softmax probabilities rounded to ONE
bf16, so a probability the two orders put on either side of a rounding
boundary moves its query's token by a bf16 step of its share of v.  The
int8 tail quantizes LN1's output per row: a value the two orders put on
either side of a quantization boundary moves one step (as
``tests/test_torch_int8.py`` allows)."""

import contextlib
import re
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.eval import serving as jserving
from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    layer_fused as jlf)
from keypoints_interpolation_transformer_tpu.utils.config import (
    ModelConfig as JaxModelConfig)
from keypoints_interpolation_transformer_torch.eval import serving
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.models.convert import (
    save_reference_pth)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import _build
from keypoints_interpolation_transformer_torch.ops.kernels import (
    layer_fused as tlf)
from keypoints_interpolation_transformer_torch.ops.kernels.int8_matmul \
    import quantize_weight

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

PREC = {"bf16x3": "high", "bf16": "default"}
WRONG = {"bf16x3": "bf16", "bf16": "f32"}
B, T, D, H, FF = 2, 16, 32, 4, 64
# each output against its own largest value: "high" float32 noise of the
# same arithmetic, "default" a bf16 step where a sum order flips a rounding
TOL = {"bf16x3": 2e-5, "bf16": 2e-3}
# the tokens a flipped probability or quantization step may move beyond
# TOL (within "default"'s, and within 1e-2: one int8 step of h)
FLIP_TOKENS = 0.1
FLIP_TOL = 1e-2
MODE_SEPARATION = 4.0


def _f32(a):
    return np.asarray(a, np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _q(w):
    """The port's "ff"-form quantization of a JAX-layout (in, out)
    weight."""
    return quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)), "ff")


def _layer(rng, kind):
    x = _f32(rng.normal(size=(B, T, D)))
    attn = [(_f32(rng.normal(size=(D, D)) * 0.2),
             _f32(rng.normal(size=(D,)) * 0.05)) for _ in range(4)]
    w1 = _f32(rng.normal(size=(D, FF)) * 0.1)
    b1 = _f32(rng.normal(size=(FF,)) * 0.01)
    w2 = _f32(rng.normal(size=(FF, D)) * 0.1)
    b2 = _f32(rng.normal(size=(D,)) * 0.01)
    norms = [_f32(s + 0.1 * rng.normal(size=(D,))) for s in (1, 0, 1, 0)]
    mask = np.ones((B, T), np.float32) if kind == "all" else \
        (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, T - 5:] = 0.0
    return x, attn, (w1, b1, w2, b2), norms, mask, valid


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kind", ["repeat-inc", "all"])
def test_encoder_layer_int8_plain_matches_jax_in_mode(rng, mode, kind):
    """``encoder_layer_int8_plain(..., mode)`` against the JAX kernel with
    ``ff_int8`` under ambient "high" / "default": each token within TOL of
    the output's largest value but for at most FLIP_TOKENS of them (within
    FLIP_TOL), the mean MODE_SEPARATION times nearer than one mode down;
    at "f32" it is the float32 int8 layer, bit for bit."""
    x, attn, (w1, b1, w2, b2), norms, mask, valid = _layer(rng, kind)
    jparams = tuple(jnp.asarray(a) for a in
                    (*[a for pair in attn for a in pair], w1, b1, w2, b2,
                     *norms))
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(PREC[mode]):
        want = np.asarray(jlf.fused_encoder_layer(
            jnp.asarray(x), jparams, (jnp.asarray(mask), jnp.asarray(valid)),
            kind, True, H, True, False))
    wqkv = np.concatenate([w for w, _ in attn[:3]], 1)
    bqkv = np.concatenate([b for _, b in attn[:3]])
    q1, s1 = _q(w1)
    q2, s2 = _q(w2)
    args = (*_t(x, wqkv, bqkv, *attn[3]), q1, s1, torch.from_numpy(b1), q2,
            s2, torch.from_numpy(b2), *_t(*norms, mask, valid), kind, True, H)
    got = kernels.encoder_layer_int8_plain(*args, mode).numpy()
    wrong = kernels.encoder_layer_int8_plain(*args, WRONG[mode]).numpy()
    s = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).reshape(-1, D) / s
    print(f"enc_layer_int8 {mode} {kind}: max {err.max():.3e} mean "
          f"{err.mean():.3e}")
    assert err.max() <= FLIP_TOL
    assert (err.max(-1) > TOL[mode]).mean() <= FLIP_TOKENS
    assert np.abs(got - want).mean() * MODE_SEPARATION < \
        np.abs(wrong - want).mean()
    kernels.reset_launches()
    np.testing.assert_array_equal(kernels.fused_encoder_layer_int8(
        *args, mode=mode).numpy(), got)
    assert set(kernels.launch_counts().values()) == {0}
    np.testing.assert_array_equal(
        kernels.encoder_layer_int8_plain(*args, "f32").numpy(),
        kernels.encoder_layer_int8_plain(*args).numpy())


@contextlib.contextmanager
def _tpu_route(prec):
    """The JAX package's TPU route on the CPU under ambient ``prec``: its
    platform reads "tpu", its Pallas kernels run in interpret mode."""
    with mock.patch.object(jc, "_attention_platform", return_value="tpu"), \
            pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


def test_int8_inpainter_at_high_matches_jax(rng, tmp_path):
    """``Inpainter(quantize="int8", precision="high")`` against the JAX int8
    Inpainter at "high" on its TPU route, from one ``.pth``: two layers at
    D=128 (the pointwise kernels in the mode, the merged encoder with its
    int8 FF, the merged decoder without its FF tail, then the int8 FF
    sublayer, all in the mode around the int8).  A flipped probability or
    quantization step cascades through the layers, so the missing frames
    are held within twice the JAX int8 Inpainter's own drift on inputs one
    ulp away (at least TOL), and nearer it than the port's int8 route at
    "highest" on average."""
    Dm, Hm, layers_ = 128, 4, 2
    path = str(tmp_path / "m.pth")
    save_reference_pth(path, KeypointCompleter(
        Dm, layers_, Hm, ff_dim=2 * Dm,
        generator=torch.Generator().manual_seed(9)),
        {"hidden_dim": Dm, "num_layers": layers_, "num_heads": Hm})
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in (12, 16)]
    masks = [(rng.random(t) < 0.3).astype(np.float32) for t in (12, 16)]
    for m in masks:
        m[-1] = 1.0
    jcfg = JaxModelConfig(hidden_dim=Dm, num_layers=layers_, num_heads=Hm,
                          ff_dim=2 * Dm, matmul_precision="high")
    with _tpu_route("high"):
        jinp = jserving.Inpainter.from_checkpoint(path, jcfg,
                                                  quantize="int8",
                                                  bucket_multiple=16)
        want = jinp.inpaint(videos, masks)
        moved = jinp.inpaint([np.nextafter(v, np.float32(2)) for v in
                              videos], masks)
    got = serving.Inpainter.from_checkpoint(
        path, quantize="int8", precision="high", device="cpu",
        bucket_multiple=16).inpaint(videos, masks)
    f32 = serving.Inpainter.from_checkpoint(
        path, quantize="int8", device="cpu", bucket_multiple=16).inpaint(
            videos, masks)
    drift = max(float(np.abs(a[m == 1] - b[m == 1]).max())
                for a, b, m in zip(moved, want, masks))
    err = max(float(np.abs(a[m == 1] - b[m == 1]).max())
              for a, b, m in zip(got, want, masks))
    print(f"int8 Inpainter at high: port vs JAX {err:.3e}, JAX one-ulp "
          f"drift {drift:.3e}")
    assert err <= max(2.0 * drift, TOL["bf16x3"])
    for v, m, g in zip(videos, masks, got):
        np.testing.assert_array_equal(g[m == 0], v[m == 0])
    mean = {k: np.mean([np.abs(a[m == 1] - b[m == 1]).mean()
                        for a, b, m in zip(o, want, masks)])
            for k, o in (("high", got), ("highest", f32))}
    assert mean["high"] < mean["highest"], mean


@pytest.mark.parametrize("prec,mode", [("high", "bf16x3"),
                                       ("default", "bf16"),
                                       ("highest", "f32")])
def test_int8_merged_route_takes_the_mode(monkeypatch, prec, mode):
    """One int8 forward at the flagship's depth on the merged route: the
    pointwise kernels 2 + 1, ``fused_encoder_layer_int8`` 6 and
    ``fused_decoder_layer`` 6 in the model's mode (with the planes of
    their attention sublayers), then the int8 FF sublayer 6: the flagship
    counts 2 / 6 / 6 / 6 / 1, under the mode's rows on the card."""
    seen = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append((name, kw.get("mode", "f32"),
                         kw.get("planes") is not None))
            return fn(*a, **kw)
        return wrapped

    for name in ("fused_encoder_layer_int8", "fused_decoder_layer",
                 "fused_ffn_int8"):
        monkeypatch.setattr(layers, name, spy(name, getattr(layers, name)))
    from keypoints_interpolation_transformer_torch.models import completer
    for name in ("fused_pre_stream_embed", "fused_post_head"):
        monkeypatch.setattr(completer, name,
                            spy(name, getattr(completer, name)))
    model = KeypointCompleter(128, 6, 4, ff_dim=256, precision=prec,
                              generator=torch.Generator().manual_seed(0))
    model.pack_weights("int8")
    x = torch.rand(2, 16, 54, 2)
    m = (torch.rand(2, 16) < 0.3).float()
    with torch.no_grad():
        model.eval()(x, x, m, m)
    planes = mode != "f32"
    counts = {}
    for name, got_mode, has_planes in seen:
        if name != "fused_ffn_int8":
            assert got_mode == mode and has_planes == planes, (name, seen)
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"fused_pre_stream_embed": 2,
                      "fused_encoder_layer_int8": 6,
                      "fused_decoder_layer": 6, "fused_ffn_int8": 6,
                      "fused_post_head": 1}


def _c_params(src, entry):
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return "".join("i" if p.strip().startswith("int ") else "p"
                   for p in m.group(1).split(","))


def test_rows_and_signature():
    """Two rows name the int8 merged encoder's mode kernels in
    ``csrc/layer_modes.cu`` beside its float32 row, all three replacing
    ``_enc_kernel``; the wrapper counts per mode; the C entry takes what
    ``_MODE_SIGS`` passes; the int8 FF tail is the int8 FF sublayer's own
    kernel (``csrc/int8.cuh``), which ``ffn.cu`` builds too."""
    table = {k.name: k for k in kernels.KERNELS}
    for name, mode, cu in (("enc_layer_int8", "f32", "layer_fused.cu"),
                           ("enc_layer_int8_high", "bf16x3",
                            "layer_modes.cu"),
                           ("enc_layer_int8_default", "bf16",
                            "layer_modes.cu")):
        k = table[name]
        assert (k.wrapper, k.mode) == (kernels.fused_encoder_layer_int8, mode)
        assert k.source.endswith(f"csrc/{cu}")
        assert k.replaces.endswith("ops/pallas/layer_fused.py:77")
    kernels.reset_launches()
    kernels.fused_encoder_layer_int8.launches["bf16x3"] += 6
    assert kernels.launch_counts()["enc_layer_int8_high"] == 6
    assert kernels.launch_counts()["enc_layer_int8"] == 0
    kernels.reset_launches()
    src = (_build.CSRC / "layer_modes.cu").read_text()
    assert _c_params(src, "kit_enc_layer_int8_tc") == \
        tlf._MODE_SIGS["kit_enc_layer_int8_tc"]
    assert "launch_int8<TN>" in src
    assert "int ffn_int8_kernel" not in (_build.CSRC / "ffn.cu").read_text()
    int8 = (_build.CSRC / "int8.cuh").read_text()
    assert "ffn_int8_kernel" in int8
    # internal linkage: the launcher's flag that its kernel's shared-memory
    # ceiling is set must be one per library (ffn.cu's and layer_modes.cu's
    # copies of the kernel), not one per process
    assert "static int launch_int8(" in int8
