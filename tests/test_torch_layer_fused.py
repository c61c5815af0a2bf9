"""The merged whole-layer kernels' module and the merged serving route of
the PyTorch port against the JAX package on the CPU.

The port's plain versions (the path its wrappers take for CPU tensors) are
held against the JAX pure-XLA oracles and the JAX Pallas kernels in
interpret mode, on the same numpy-seeded inputs, at the JAX kernel tests'
tolerance; the routing rules against the JAX predicates; the whole model on
the merged route against the JAX model on its Pallas path.  The CUDA
kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``).
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    layer_fused as jlf)
from keypoints_interpolation_transformer_tpu.ops.pallas.attn_sublayer import (
    fused_attn_sublayer_supported)
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter, keypoint_completer_cycle)
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    layer_fused as tlf)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D, H, FF = 2, 32, 64, 4, 128
TOL = 2e-5  # the JAX kernel tests' f32 forward tolerance


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _f32(a):
    return np.asarray(a, np.float32)


def _attn(rng):
    """(w, b) pairs of q, k, v, o."""
    return [(_f32(rng.normal(size=(D, D)) * 0.1),
             _f32(rng.normal(size=(D,)) * 0.05)) for _ in range(4)]


def _packed(attn):
    """The port's (wqkv, bqkv, wo, bo) of JAX-style (w, b) pairs."""
    return (np.concatenate([w for w, _ in attn[:3]], 1),
            np.concatenate([b for _, b in attn[:3]]), *attn[3])


def _ff(rng):
    """(w1, b1, w2, b2) and two LayerNorm pairs."""
    return (_f32(rng.normal(size=(D, FF)) * 0.05),
            _f32(rng.normal(size=(FF,)) * 0.01),
            _f32(rng.normal(size=(FF, D)) * 0.05),
            _f32(rng.normal(size=(D,)) * 0.01),
            *[_f32(s + 0.1 * rng.normal(size=(D,)))
              for s in (1.0, 0.0, 1.0, 0.0)])


def _masks(rng, cycle, with_valid=True):
    """(frame mask, valid): Cycle's all-ones mask or a random one; a padded
    row in valid."""
    mask = np.ones((B, T), np.float32) if cycle else \
        (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, T - 6:] = 0.0
    return mask, valid if with_valid else None


# (flags, kind, add_keypad, with_valid): the plain model's encoder, the
# Cycle model's, and the 1-D contract without a valid mask
_ENC_CASES = [("plain", "repeat-inc", True, True),
              ("cycle", "all", True, True),
              ("no valid", "repeat-inc", True, False)]


@pytest.mark.parametrize("flags,kind,add_keypad,with_valid", _ENC_CASES)
def test_encoder_layer_plain_matches_jax(rng, flags, kind, add_keypad,
                                         with_valid):
    x = _f32(rng.normal(size=(B, T, D)))
    attn, ff = _attn(rng), _ff(rng)
    mask, valid = _masks(rng, flags == "cycle", with_valid)
    jparams = (*_j(*[a for pair in attn for a in pair]), *_j(*ff))
    jx, jmask, jvalid = _j(x, mask, valid)
    with jax.default_matmul_precision("highest"):
        want_ref = jlf.encoder_layer_reference(jx, jparams, jmask, jvalid,
                                               kind, add_keypad, H)
    with _interpret():
        want_pallas = jlf.fused_encoder_layer(jx, jparams, (jmask, jvalid),
                                              kind, add_keypad, H)
    got = kernels.fused_encoder_layer(
        *_t(x, *_packed(attn), *ff, mask, valid), kind, add_keypad,
        H).numpy()
    assert got.shape == (B, T, D)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL)
    # the Pallas kernel's rational erf differs from erf by < 4e-7
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=TOL)


@pytest.mark.parametrize("flags", ["plain", "cycle"])
@pytest.mark.parametrize("with_ff", [True, False])
def test_decoder_layer_plain_matches_jax(rng, flags, with_ff):
    """Self-attention repeat-inc without key padding (plain) or "all" with
    the all-ones key padding (Cycle); cross-attention "all" plus the
    padding bias; with and without the FF tail."""
    x = _f32(rng.normal(size=(B, T, D)))
    mem = _f32(rng.normal(size=(B, T, D)))
    sattn, cattn, ff = _attn(rng), _attn(rng), _ff(rng)
    g1 = _f32(1 + 0.1 * rng.normal(size=(D,)))
    be1 = _f32(0.1 * rng.normal(size=(D,)))
    cycle = flags == "cycle"
    smask, valid = _masks(rng, cycle)
    cmask = np.zeros((B, T), np.float32)
    skind, skp = ("all", True) if cycle else ("repeat-inc", False)
    jparams = (*_j(*[a for pair in sattn + cattn for a in pair]),
               *_j(g1, be1))
    jff = tuple(_j(*ff)) if with_ff else None
    jargs = _j(x, mem)
    jm = _j(smask, valid, cmask, valid)
    with jax.default_matmul_precision("highest"):
        want_ref = jlf.decoder_selfcross_reference(
            *jargs, jparams, *jm, skind, skp, "all", False, H, jff)
    with _interpret():
        want_pallas = jlf.fused_decoder_selfcross(
            *jargs, jparams, tuple(jm), jff, skind, skp, "all", False, H)
    tff = tuple(_t(*ff)) if with_ff else None
    got = kernels.fused_decoder_layer(
        *_t(x, mem, *_packed(sattn), *_packed(cattn), g1, be1), tff,
        *_t(smask, valid, cmask, valid), skind, skp, "all", False,
        H).numpy()
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=TOL)


def test_routing_predicates_match_jax():
    """The port's copies of the JAX rules agree on a grid of (T, D, FF)
    around every threshold (T 256 and 512, the 8 / 10 MB weight budgets)."""
    for t in (8, 12, 16, 40, 128, 248, 256, 260, 264, 320, 512, 520):
        for d in (32, 64, 128, 256, 320, 512, 1024):
            assert tlf.sublayer_supported(t, d) == \
                fused_attn_sublayer_supported(t, d), (t, d)
            for f in (64, 1024, 2048, 2560, 3072, 4096):
                assert tlf.fused_layer_supported(t, d, f) == \
                    jlf.fused_layer_supported(t, d, f), (t, d, f)
                assert tlf.decoder_full_supported(t, d, f) == \
                    jlf.decoder_full_supported(t, d, f), (t, d, f)
    # the flagship: merged at its serving buckets up to 256
    assert tlf.fused_layer_supported(256, 256, 2048)
    assert tlf.decoder_full_supported(256, 256, 2048)
    assert not tlf.decoder_full_supported(256, 256, 4096)


def test_cluster_size_spreads_a_small_batch(monkeypatch):
    """About one block per SM over the batch, 1 to 8 blocks per video."""
    monkeypatch.setattr(tlf, "_sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    assert [tlf.cluster_size(B, dev) for B in (1, 16, 32, 64, 128, 256,
                                               1024)] == [8, 8, 4, 2, 1, 1, 1]


def test_cluster_override_is_checked(monkeypatch):
    """A forced cluster size is taken as given from 1 to 8 and refused
    outside; None takes ``cluster_size``."""
    monkeypatch.setattr(tlf, "_sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    assert tlf._cluster("w", 3, dev, None) == 8
    assert [tlf._cluster("w", 3, dev, c) for c in range(1, 9)] == \
        list(range(1, 9))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="cluster must be 1 to 8"):
            tlf._cluster("w", 3, dev, bad)


@pytest.mark.parametrize("flags", ["plain", "cycle"])
@pytest.mark.parametrize("name", ["enc_layer", "dec_layer"])
def test_library_layers_match_plain(rng, name, flags):
    """The one PyTorch call ``chip_smoke.py`` times beside each whole-layer
    kernel (``nn.TransformerEncoderLayer`` / ``TransformerDecoderLayer``
    with the same weights and the masks as a float attention mask)
    computes the same function as its plain version."""
    import chip_smoke
    x = torch.from_numpy(_f32(rng.normal(size=(B, T, D))))
    mem = torch.from_numpy(_f32(rng.normal(size=(B, T, D))))
    attn = _t(*_packed(_attn(rng)))
    cattn = _t(*_packed(_attn(rng)))
    ff = _t(*_ff(rng))
    cycle = flags == "cycle"
    mask, valid = _t(*_masks(rng, cycle))
    kind = "all" if cycle else "repeat-inc"
    if name == "enc_layer":
        args = (x, *attn, *ff, mask, valid, kind, True, H)
        want = kernels.encoder_layer_plain(*args)
    else:
        args = (x, mem, *attn, *cattn, *ff[4:6], tuple(ff),
                mask, valid, None, valid, kind, cycle, "all", False, H)
        want = kernels.decoder_layer_plain(*args)
    with torch.inference_mode():
        got = chip_smoke.LIBRARY[name](torch, *args)()
    assert torch.backends.mha.get_fastpath_enabled()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


def _model_inputs(rng, Tm, padded):
    x = _f32(rng.uniform(0.2, 0.8, (B, Tm, 54, 2)))
    f = _f32(rng.uniform(0.2, 0.8, (B, Tm, 54, 2)))
    sm = (rng.random((B, Tm)) < 0.3).astype(np.float32)
    tm = (rng.random((B, Tm)) < 0.3).astype(np.float32)
    valid = np.ones((B, Tm), np.float32)
    if padded:
        valid[1, Tm - 5:] = 0.0
    return x, f, sm, tm, valid


@pytest.mark.parametrize("cycle", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_merged_model_matches_jax_pallas_model(rng, cycle, padded):
    """One layer at T=16: the port on its merged route (plain versions on
    the CPU) against the JAX model on its Pallas path in interpret mode,
    which takes its merged kernels there.  Cycle: kinds "all" with all-ones
    masks, as its second pass runs."""
    Tm, dm, heads, ffm = 16, 32, 4, 64
    x, f, sm, tm, valid = _model_inputs(rng, Tm, padded)
    kinds = "repeat-inc"
    if cycle:
        sm = tm = np.ones((B, Tm), np.float32)
        kinds = "all"
    make = jc.keypoint_completer_cycle if cycle else jc.KeypointCompleter
    kw = dict(hidden_dim=dm, num_layers=1, num_heads=heads, ff_dim=ffm)
    params = make(attention_impl="xla", ff_impl="xla", **kw).init(
        jax.random.key(2), jnp.asarray(x[:1]), jnp.asarray(f[:1]))
    jm = make(attention_impl="pallas", ff_impl="pallas", **kw)
    with _interpret():
        want = np.asarray(jm.apply(
            params, *_j(x, f), src_frame_mask=jnp.asarray(sm),
            tgt_frame_mask=jnp.asarray(tm), valid_mask=jnp.asarray(valid),
            src_mask_kind=kinds, tgt_mask_kind=kinds))
    port = (keypoint_completer_cycle if cycle else KeypointCompleter)(
        dm, 1, heads, ff_dim=ffm)
    port.load_state_dict(state_dict_tensors(params_from_jax(params)))
    with torch.no_grad():
        got = port.eval()(*_t(x, f, sm, tm, valid), src_mask_kind=kinds,
                          tgt_mask_kind=kinds).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


class _Counter:
    """Counts the calls of a kernel wrapper the model layers make."""

    def __init__(self, monkeypatch, names):
        self.calls = {n: 0 for n in names}
        for n in names:
            fn = getattr(layers, n)

            def counted(*a, _n=n, _fn=fn, **k):
                self.calls[_n] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(layers, n, counted)


@pytest.mark.parametrize("Tm,merge,want", [
    (16, True, (1, 1, 0, 0)),     # whole layers
    (264, True, (0, 1, 1, 2)),    # encoder per sublayer; decoder merged
                                  # without its FF tail, then the FF kernel
    (16, False, (0, 0, 3, 2)),    # per sublayer throughout
])
def test_merged_route_is_taken_where_jax_takes_it(rng, monkeypatch, Tm,
                                                  merge, want):
    """The wrappers one forward calls per (encoder + decoder) layer:
    (fused_encoder_layer, fused_decoder_layer, fused_attn_sublayer,
    fused_ffn), the launches the card would count."""
    names = ("fused_encoder_layer", "fused_decoder_layer",
             "fused_attn_sublayer", "fused_ffn")
    counter = _Counter(monkeypatch, names)
    model = KeypointCompleter(32, 1, 4, ff_dim=64,
                              generator=torch.Generator().manual_seed(0))
    inputs = _t(*_model_inputs(rng, Tm, True))

    def run(merge_layers):
        counter.calls = dict.fromkeys(names, 0)
        model.merge_layers = merge_layers
        out = model(*inputs)
        return out, tuple(counter.calls[n] for n in names)

    with torch.no_grad():
        got, counts = run(merge)
        other, _ = run(not merge)
    assert counts == want
    # both routes compute the same function
    np.testing.assert_allclose(got.numpy(), other.numpy(), atol=1e-5)
    # the training route ignores merge_layers
    model.train()
    out, counts = run(True)
    out.sum().backward()
    assert counts == (0, 0, 0, 0)


def test_layer_kernels_in_the_table_and_counted_only_on_the_card(rng):
    table = {k.name: k for k in kernels.KERNELS}
    assert table["enc_layer"].wrapper is kernels.fused_encoder_layer
    assert table["dec_layer"].wrapper is kernels.fused_decoder_layer
    assert table["enc_layer"].replaces.endswith("layer_fused.py:77")
    assert table["dec_layer"].replaces.endswith("layer_fused.py:239")
    assert table["enc_layer"].source.endswith("csrc/layer_fused.cu")
    kernels.reset_launches()
    x = _f32(rng.normal(size=(B, T, D)))
    attn, ff = _attn(rng), _ff(rng)
    kernels.fused_encoder_layer(*_t(x, *_packed(attn), *ff), None, None,
                                "all", False, H)
    # a CPU tensor takes the plain version: no launch is counted
    assert set(kernels.launch_counts().values()) == {0}
