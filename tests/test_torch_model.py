"""The PyTorch port's model, masks, transforms and converter against the
JAX package on the CPU (f32, small widths, numpy-seeded inputs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.models.layers import (
    sinusoidal_positional_encoding as jax_pe)
from keypoints_interpolation_transformer_tpu.ops import losses as jlosses
from keypoints_interpolation_transformer_tpu.ops import masks as jmasks
from keypoints_interpolation_transformer_tpu.train.checkpoint import (
    completer_params_to_torch)
from keypoints_interpolation_transformer_tpu.transforms import (
    corruption as jcorr)
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter, keypoint_completer_cycle)
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.models.layers import (
    sinusoidal_positional_encoding)
from keypoints_interpolation_transformer_torch.ops import losses, masks
from keypoints_interpolation_transformer_torch.transforms import corruption

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D, LAYERS, HEADS, FF = 3, 24, 32, 2, 4, 64


@pytest.mark.parametrize("kind", ["triangle", "repeat", "repeat-inc", "all"])
def test_attention_bias_matches_jax(rng, kind):
    m = (rng.random((2, 10)) < 0.4).astype(np.float32)
    want = np.asarray(jmasks.attention_bias(kind, jnp.asarray(m), 10))
    got = masks.attention_bias(kind, torch.from_numpy(m), 10).numpy()
    np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)
    with pytest.raises(ValueError):
        masks.attention_bias("nope", torch.from_numpy(m), 10)


def test_padding_and_key_padding_bias_match_jax(rng):
    v = (rng.random((2, 9)) < 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        masks.padding_bias(torch.from_numpy(v)).numpy(),
        np.asarray(jmasks.padding_bias(jnp.asarray(v))))
    np.testing.assert_array_equal(
        masks.key_padding_additive(torch.from_numpy(v)).numpy(),
        np.asarray(jmasks.key_padding_additive(jnp.asarray(v))))
    assert masks.NEG == jmasks.NEG


def test_transforms_and_composite_match_jax(rng):
    video = rng.uniform(size=(2, 7, 54, 2)).astype(np.float32)
    mask = (rng.random((2, 7)) < 0.5).astype(np.float32)
    got_v, got_m = corruption.add_sos(torch.from_numpy(video),
                                      torch.from_numpy(mask))
    want_v, want_m = jcorr.add_sos(jnp.asarray(video), jnp.asarray(mask))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(
        corruption.add_sos(torch.from_numpy(video[0])).numpy(),
        np.asarray(jcorr.add_sos(jnp.asarray(video[0]))))
    np.testing.assert_array_equal(
        corruption.zero_missing_frames(torch.from_numpy(video),
                                       torch.from_numpy(mask)).numpy(),
        np.asarray(jcorr.zero_missing_frames(jnp.asarray(video),
                                             jnp.asarray(mask))))
    pred = rng.uniform(size=video.shape).astype(np.float32)
    got = losses.composite_prediction(torch.from_numpy(pred),
                                      torch.from_numpy(video),
                                      torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jlosses.composite_prediction(jnp.asarray(pred), jnp.asarray(video),
                                     jnp.asarray(mask))))
    np.testing.assert_array_equal(got[mask == 0], video[mask == 0])


def test_positional_encoding_matches_jax():
    np.testing.assert_allclose(sinusoidal_positional_encoding(64, 32).numpy(),
                               np.asarray(jax_pe(64, 32)), atol=1e-6)


def _jax_model(cycle):
    kw = dict(hidden_dim=D, num_layers=LAYERS, num_heads=HEADS, ff_dim=FF,
              attention_impl="xla", ff_impl="xla", pointwise_impl="xla")
    if cycle:
        return jc.keypoint_completer_cycle(**kw)
    return jc.KeypointCompleter(**kw)


def _port_model(params, cycle):
    make = keypoint_completer_cycle if cycle else KeypointCompleter
    m = make(D, LAYERS, HEADS, ff_dim=FF)
    m.load_state_dict(state_dict_tensors(params_from_jax(params)))
    return m.eval()


def _inputs(rng):
    x = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    sm = (rng.random((B, T)) < 0.3).astype(np.float32)
    tm = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, 17:] = 0.0  # a padded row
    return x, f, sm, tm, valid


@pytest.mark.parametrize("cycle", [False, True])
def test_completer_matches_jax_xla_forward(rng, cycle):
    x, f, sm, tm, valid = _inputs(rng)
    jm = _jax_model(cycle)
    params = jm.init(jax.random.key(1), jnp.asarray(x[:1]),
                     jnp.asarray(f[:1]))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(
            params, jnp.asarray(x), jnp.asarray(f),
            src_frame_mask=jnp.asarray(sm), tgt_frame_mask=jnp.asarray(tm),
            src_bias=jmasks.attention_bias("repeat-inc", jnp.asarray(sm), T),
            tgt_bias=jmasks.attention_bias("repeat-inc", jnp.asarray(tm), T),
            valid_mask=jnp.asarray(valid)))
    model = _port_model(params, cycle)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, f, sm, tm, valid)))
    assert got.shape == (B, T, 54, 2)
    real = valid > 0
    np.testing.assert_allclose(got.numpy()[real], want[real], atol=2e-5)


def test_padded_batch_equals_unpadded(rng):
    x, f, sm, tm, valid = _inputs(rng)
    torch.manual_seed(0)
    model = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF,
                              generator=torch.Generator().manual_seed(3))
    n = 17  # row 1's real length
    with torch.no_grad():
        batched = model(*(torch.from_numpy(a)
                          for a in (x, f, sm, tm, valid)))[1, :n]
        alone = model(*(torch.from_numpy(a[1:2, :n])
                        for a in (x, f, sm, tm)))[0]
    np.testing.assert_allclose(batched.numpy(), alone.numpy(), atol=1e-5)


def test_params_from_jax_equals_completer_params_to_torch():
    jm = _jax_model(False)
    z = jnp.zeros((1, 8, 54, 2))
    params = jm.init(jax.random.key(0), z, z)
    got = params_from_jax(params)
    want = completer_params_to_torch(params["params"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    # the port's state dict is exactly the reference schema
    port = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF)
    assert set(port.state_dict()) == set(want)
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == want[k].shape, k


def test_generator_init_is_deterministic_and_packing_tracks_weights():
    make = lambda seed: KeypointCompleter(  # noqa: E731
        D, 1, HEADS, ff_dim=FF, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(5), make(5), make(6)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not all(torch.equal(va, vc) for va, vc in
                   zip(a.state_dict().values(), c.state_dict().values()))
    attn = a.transformer.encoder.layers[0].self_attn
    wqkv = attn.packed()[0]
    assert attn.packed()[0] is wqkv  # built once
    a.load_state_dict(c.state_dict())  # in-place copy: the pack rebuilds
    assert torch.equal(attn.packed()[0], attn.in_proj_weight.t())
    assert not torch.equal(attn.packed()[0], wqkv)
