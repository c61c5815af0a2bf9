"""The merged whole-layer kernels in the precision modes "high" (bf16x3) and
"default" (one bf16 pass): the port's plain versions against the JAX
``_enc_fwd_pallas`` / ``_dec_fwd_pallas`` in interpret mode under the
ambient precision, the merged model at "high" against the JAX model with
its merged layers on Pallas, the folded q scale, the weight planes, the
routing and the wrappers' table and scratch rules.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``).

Both packages round the same operands to bf16 (nearest even) and sum exact
bf16 products in float32, so "high" holds near float32 tolerances: the
differences left are the order of the float32 sums, exp2 and the Pallas
kernels' rational erf.  In "default" those differences can move a value
across a bf16 rounding boundary: an activation or a probability then
differs by one bf16 step (2^-8 of its size), which the layer carries on.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    layer_fused as jlf)
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter, keypoint_completer_cycle)
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    attn_sublayer as tas)
from keypoints_interpolation_transformer_torch.ops.kernels import (
    layer_fused as tlf)
from keypoints_interpolation_transformer_torch.ops.kernels import precision

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D, H, FF = 2, 24, 32, 4, 64
MODE_OF = {"high": "bf16x3", "default": "bf16"}
# "high": the same exact bf16 products summed in float32 in another order,
# exp2 and the rational erf -- float32 noise through two sublayers
HIGH_TOL = 2e-5
# "default": as "high", plus the values the sum order moves across a bf16
# rounding boundary, each off by one bf16 step (2^-8) of its term; the same
# bound as the FF sublayer's in "default" (test_torch_precision.py)
DEFAULT_TOL = 2e-3
# "high" rounds the softmax probabilities to ONE bf16 too (the JAX
# ``_prob_parts``): where the float32 noise moves a probability across a
# bf16 rounding boundary, that probability differs by one bf16 step and its
# query's token by up to 2^-8 of its share of v -- the bound of "default".
# Elsewhere "high" holds HIGH_TOL.  Such flips touch few tokens: at most
# FLIP_TOKENS of them.
FLIP_TOKENS = 0.1

_CSRC = Path(kernels.__file__).resolve().parents[2] / "csrc"


@contextlib.contextmanager
def _interpret(prec):
    """The Pallas kernels as the JAX kernel tests run them on the CPU,
    under the ambient precision ``prec``."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _f32(a):
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    """Within ``tol`` of the larger of 1 and the reference's scale."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0,
                               err_msg=what)


def _close_mode(got, want, prec, what=""):
    """``_close`` at the mode's tolerance: "default" DEFAULT_TOL; "high"
    HIGH_TOL on every token but the few a flipped probability moves
    (FLIP_TOKENS), which stay within DEFAULT_TOL."""
    if prec == "default":
        return _close(got, want, DEFAULT_TOL, what)
    _close(got, want, DEFAULT_TOL, what)
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).reshape(-1, got.shape[-1]) / scale
    flipped = (err.max(-1) > HIGH_TOL).mean()
    assert flipped <= FLIP_TOKENS, (what, flipped, float(err.max()))


def _attn(rng):
    """(w, b) pairs of q, k, v, o."""
    return [(_f32(rng.normal(size=(D, D)) * 0.2),
             _f32(rng.normal(size=(D,)) * 0.05)) for _ in range(4)]


def _packed(attn):
    """The port's (wqkv, bqkv, wo, bo) of JAX-style (w, b) pairs."""
    return (np.concatenate([w for w, _ in attn[:3]], 1),
            np.concatenate([b for _, b in attn[:3]]), *attn[3])


def _ff(rng):
    """(w1, b1, w2, b2) and two LayerNorm pairs."""
    return (_f32(rng.normal(size=(D, FF)) * 0.1),
            _f32(rng.normal(size=(FF,)) * 0.01),
            _f32(rng.normal(size=(FF, D)) * 0.1),
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
              ("no valid", "repeat-inc", False, False)]


def _encoder_case(rng, flags, with_valid):
    x = _f32(rng.normal(size=(B, T, D)))
    attn, ff = _attn(rng), _ff(rng)
    mask, valid = _masks(rng, flags == "cycle", with_valid)
    return x, attn, ff, mask, valid


def _jax_encoder(prec, x, attn, ff, mask, valid, kind, add_keypad):
    jparams = (*_j(*[a for pair in attn for a in pair]), *_j(*ff))
    with _interpret(prec):
        return np.asarray(jlf._enc_fwd_pallas(
            *_j(x), jparams, *_j(mask, valid), kind, add_keypad, H))


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("flags,kind,add_keypad,with_valid", _ENC_CASES)
def test_encoder_layer_plain_matches_pallas_in_mode(rng, prec, flags, kind,
                                                    add_keypad, with_valid):
    """``encoder_layer_plain`` in the mode against ``_enc_fwd_pallas``
    (``_enc_kernel``) in interpret mode under the ambient precision; the
    wrapper takes the same plain version for CPU tensors."""
    x, attn, ff, mask, valid = _encoder_case(rng, flags, with_valid)
    want = _jax_encoder(prec, x, attn, ff, mask, valid, kind, add_keypad)
    mode = MODE_OF[prec]
    args = _t(x, *_packed(attn), *ff, mask, valid)
    got = kernels.encoder_layer_plain(*args, kind, add_keypad, H,
                                      mode).numpy()
    _close_mode(got, want, prec, f"{prec} {flags}")
    wrapped = kernels.fused_encoder_layer(*args, kind, add_keypad, H,
                                          mode=mode).numpy()
    np.testing.assert_array_equal(wrapped, got)
    # the mode is the one the JAX kernel took: float32 is further away, on
    # average over the elements (a flip moves a few tokens only)
    f32 = kernels.encoder_layer_plain(*args, kind, add_keypad, H).numpy()
    assert np.abs(f32 - want).mean() > 4 * np.abs(got - want).mean()


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("flags", ["plain", "cycle"])
@pytest.mark.parametrize("with_ff", [True, False])
def test_decoder_layer_plain_matches_pallas_in_mode(rng, prec, flags,
                                                    with_ff):
    """``decoder_layer_plain`` in the mode against ``_dec_fwd_pallas``
    (``_dec_kernel``) in interpret mode, with and without its FF tail:
    self-attention repeat-inc without key padding (plain) or "all" with
    the all-ones key padding (Cycle); cross-attention "all" plus the
    padding bias."""
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
    with _interpret(prec):
        want = np.asarray(jlf._dec_fwd_pallas(
            *_j(x, mem), jparams, *_j(smask, valid, cmask, valid), skind,
            skp, "all", False, H, ff_params=jff))
    mode = MODE_OF[prec]
    tff = tuple(_t(*ff)) if with_ff else None
    args = (*_t(x, mem, *_packed(sattn), *_packed(cattn), g1, be1), tff,
            *_t(smask, valid, cmask, valid), skind, skp, "all", False, H)
    got = kernels.decoder_layer_plain(*args, mode).numpy()
    _close_mode(got, want, prec, f"{prec} {flags} ff={with_ff}")
    wrapped = kernels.fused_decoder_layer(*args, mode=mode).numpy()
    np.testing.assert_array_equal(wrapped, got)


def _scaled_after(x, wqkv, bqkv, wo, bo, mask, valid, kind, add_keypad,
                  heads, mode):
    """The attention sublayer in ``mode`` with 1 / sqrt(dh) applied to the
    scores after the product (the float32 plain's order), everything else
    as ``_sublayer_mode_plain``: another function once q is rounded."""
    Bq, Tq, Dq = x.shape
    dh = Dq // heads
    wq, wk, wv = wqkv.split(Dq, dim=1)
    bq, bk, bv = bqkv.split(Dq)
    xp = precision.parts(x.reshape(-1, Dq), mode)

    def proj(w, b):
        return precision.part_products(xp, precision.parts(w, mode)) + b

    def split(t):
        return precision.parts(
            t.reshape(Bq, Tq, heads, dh).transpose(1, 2), mode)

    qp, kp, vp = split(proj(wq, bq)), split(proj(wk, bk)), split(proj(wv, bv))
    st = precision.part_products(kp, tuple(q.transpose(-1, -2) for q in qp))
    logits = st.transpose(-1, -2) * (tas.LOG2E / dh ** 0.5)
    bias = tas.bias_from_masks(mask, valid, Tq, kind, add_keypad,
                               mul=tas.LOG2E)
    if bias is not None:
        logits = logits + bias[:, None]
    e = torch.exp2(logits - logits.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    a = precision.prob_products(p, vp).transpose(1, 2).reshape(-1, Dq)
    return x + (precision.part_products(precision.parts(a, mode),
                                        precision.parts(wo, mode))
                + bo).reshape(x.shape)


def test_folded_scale_matters_in_default(rng):
    """The modes fold log2(e) / sqrt(dh) into Wq and bq before the split,
    as ``_enc_fwd_pallas`` does: at "default" scaling the scores after
    the product instead rounds another q, and lands measurably further
    from the JAX kernel than the folded plain version does."""
    x = _f32(rng.normal(size=(B, T, D)))
    attn = _attn(rng)
    mask, valid = _masks(rng, False)
    jparams = _j(*[a for pair in attn for a in pair])
    zero_ff = (np.zeros((D, FF), np.float32), np.zeros(FF, np.float32),
               np.zeros((FF, D), np.float32), np.zeros(D, np.float32))
    # with a zero FF tail and unit LayerNorms the layer is LN2(LN1(r)):
    # compare the attention sublayers through the JAX kernel's whole layer
    ones, zeros = np.ones(D, np.float32), np.zeros(D, np.float32)
    ff = (*zero_ff, ones, zeros, ones, zeros)
    want = _jax_encoder("default", x, attn, ff, mask, valid, "repeat-inc",
                        True)
    targs = _t(x, *_packed(attn))
    mvt = _t(mask, valid)

    def layer(r):
        ln = torch.nn.functional.layer_norm
        return ln(ln(r, (D,), eps=tas.LN_EPS), (D,), eps=tas.LN_EPS).numpy()

    folded = layer(kernels.attn_sublayer_plain(
        targs[0], None, *targs[1:], None, None, *mvt, "repeat-inc", True, H,
        "bf16"))
    after = layer(_scaled_after(*targs, *mvt, "repeat-inc", True, H, "bf16"))
    err_folded = np.abs(folded - want).max()
    err_after = np.abs(after - want).max()
    assert err_folded < DEFAULT_TOL
    assert err_after > 4 * err_folded, (err_folded, err_after)


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
def test_merged_model_at_high_matches_jax(rng, cycle):
    """One layer at T = 16: the port at "high" on its merged route (plain
    versions on the CPU) against the JAX model with its merged layers on
    Pallas (interpret mode, ambient "high") and ``pointwise_impl="pallas"``
    as on its TPU: at D = 32 its pointwise kernels do not take the width,
    so its chains run on XLA, which on the CPU run in float32 as the
    port's plain chains do.  The float32 port is further away."""
    Tm, dm, heads, ffm = 16, 32, 4, 64
    x, f, sm, tm, valid = _model_inputs(rng, Tm, True)
    kinds = "repeat-inc"
    if cycle:
        sm = tm = np.ones((B, Tm), np.float32)
        kinds = "all"
    make = jc.keypoint_completer_cycle if cycle else jc.KeypointCompleter
    kw = dict(hidden_dim=dm, num_layers=1, num_heads=heads, ff_dim=ffm)
    params = jax.jit(make(attention_impl="xla", ff_impl="xla", **kw).init)(
        jax.random.key(3), jnp.asarray(x[:1]), jnp.asarray(f[:1]))
    jm = make(attention_impl="pallas", ff_impl="pallas",
              pointwise_impl="pallas", **kw)
    with _interpret("high"):
        want = np.asarray(jax.jit(lambda p: jm.apply(
            p, *_j(x, f), src_frame_mask=jnp.asarray(sm),
            tgt_frame_mask=jnp.asarray(tm), valid_mask=jnp.asarray(valid),
            src_mask_kind=kinds, tgt_mask_kind=kinds))(params))
    outs = {}
    for prec in ("high", "highest"):
        port = (keypoint_completer_cycle if cycle else KeypointCompleter)(
            dm, 1, heads, ff_dim=ffm, precision=prec)
        port.load_state_dict(state_dict_tensors(params_from_jax(params)))
        with torch.no_grad():
            outs[prec] = port.eval()(
                *_t(x, f, sm, tm, valid), src_mask_kind=kinds,
                tgt_mask_kind=kinds).numpy()
    real = valid > 0
    _close_mode(outs["high"][real], want[real], "high")
    err = {k: np.abs(v[real] - want[real]).max() for k, v in outs.items()}
    assert err["high"] < err["highest"], err


class _Recorder:
    """Records the ``mode`` and ``planes`` the model layers hand the merged
    wrappers."""

    def __init__(self, monkeypatch):
        self.calls = []
        for n in ("fused_encoder_layer", "fused_decoder_layer"):
            fn = getattr(layers, n)

            def rec(*a, _n=n, _fn=fn, **k):
                self.calls.append((_n, k.get("mode"), k.get("planes")))
                return _fn(*a, **k)

            monkeypatch.setattr(layers, n, rec)


@pytest.mark.parametrize("prec,mode", [("high", "bf16x3"),
                                       ("default", "bf16"),
                                       ("highest", "f32")])
def test_merged_route_takes_the_mode_and_packed_planes(rng, monkeypatch,
                                                       prec, mode):
    """The merged wrappers get the model's mode and, outside "f32", the
    planes ``pack_weights`` built (the same tensors, so the first request
    splits nothing): the attention's with q's scale folded in and the FF
    tail's; the decoder at T 257-512 (no FF tail inside) gets no FF
    planes."""
    rec = _Recorder(monkeypatch)
    model = KeypointCompleter(32, 1, 4, ff_dim=64, precision=prec,
                              generator=torch.Generator().manual_seed(0))
    model.pack_weights()
    enc, dec = model.transformer.encoder.layers[0], model.transformer.decoder.layers[0]
    with torch.no_grad():
        model.eval()(*_t(*_model_inputs(rng, 16, True)))
    (ne, me, pe), (nd, md, pd) = rec.calls
    assert (ne, nd, me, md) == ("fused_encoder_layer", "fused_decoder_layer",
                                mode, mode)
    if mode == "f32":
        assert pe is None and pd is None
        return
    assert pe[0] is enc.self_attn.__dict__[f"_planes_{mode}"][1]
    assert pe[1] is enc.__dict__[f"_planes_{mode}"][1]
    assert pd[0] is dec.self_attn.__dict__[f"_planes_{mode}"][1]
    assert pd[1] is dec.multihead_attn.__dict__[f"_planes_{mode}"][1]
    assert pd[2] is dec.__dict__[f"_planes_{mode}"][1]
    wh, wl, b, oh, ol = pe[0]
    wqkv, bqkv, wo, _ = enc.self_attn.packed()
    s = tas.LOG2E / (32 // 4) ** 0.5
    hi, lo = precision.weight_planes(torch.cat([wqkv[:, :32] * s,
                                                wqkv[:, 32:]], 1), mode)
    torch.testing.assert_close(wh, hi, rtol=0, atol=0)
    assert (wl is None) == (mode == "bf16")
    if wl is not None:
        torch.testing.assert_close(wl, lo, rtol=0, atol=0)
    torch.testing.assert_close(b, torch.cat([bqkv[:32] * s, bqkv[32:]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(oh, precision.weight_planes(wo, mode)[0],
                               rtol=0, atol=0)
    rec.calls.clear()
    with torch.no_grad():
        model.eval()(*_t(*_model_inputs(rng, 264, True)))
    (nd, md, pd), = rec.calls  # the encoder runs per sublayer at T = 264
    assert nd == "fused_decoder_layer" and md == mode and pd[2] is None


def test_int8_route_keeps_its_layers_float32(rng, monkeypatch):
    """Int8 serving at "high" keeps the merged layers around its int8 FF
    in float32 (the int8 route at a mode is not ported): its decoder layers
    get mode "f32", as at "highest"."""
    rec = _Recorder(monkeypatch)
    model = KeypointCompleter(32, 1, 4, ff_dim=64, precision="high",
                              generator=torch.Generator().manual_seed(0))
    model.pack_weights("int8")
    with torch.no_grad():
        model.eval()(*_t(*_model_inputs(rng, 16, True)))
    assert [(n, m) for n, m, _ in rec.calls] == [("fused_decoder_layer",
                                                  "f32")]


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_attn_weight_planes_split_the_scaled_weights(rng, mode):
    """``attn_weight_planes``: q's block of wqkv and bqkv times log2(e) /
    sqrt(dh) in float32, then split bit for bit as ``split_bf16`` does."""
    wqkv, bqkv, wo, _ = _t(*_packed(_attn(rng)))
    wh, wl, b, oh, ol = tlf.attn_weight_planes(wqkv, bqkv, wo, H, mode)
    s = np.float32(np.log2(np.e) / np.sqrt(D // H))
    w = wqkv.numpy().copy()
    w[:, :D] *= s
    hi, lo = precision.split_bf16(torch.from_numpy(w))
    assert wh.dtype == torch.bfloat16 and wh.shape == (D, 3 * D)
    torch.testing.assert_close(wh, hi, rtol=0, atol=0)
    bs = bqkv.numpy().copy()
    bs[:D] *= s
    np.testing.assert_array_equal(b.numpy(), bs)
    if mode == "bf16":
        assert wl is None and ol is None
        torch.testing.assert_close(oh, wo.to(torch.bfloat16), rtol=0, atol=0)
    else:
        torch.testing.assert_close(wl, lo, rtol=0, atol=0)
        torch.testing.assert_close(ol, precision.split_bf16(wo)[1], rtol=0,
                                   atol=0)


def test_mode_kernels_in_the_table():
    """Four rows name the mode kernels of the two float wrappers, beside
    their "f32" rows; the table counts per mode (the attention sublayer's
    six mode rows: ``tests/test_torch_sublayer_modes.py``)."""
    table = {k.name: k for k in kernels.KERNELS}
    assert len(kernels.KERNELS) == 41
    for name, wrapper, line, mode in (
            ("enc_layer", kernels.fused_encoder_layer, 77, "f32"),
            ("enc_layer_high", kernels.fused_encoder_layer, 77, "bf16x3"),
            ("enc_layer_default", kernels.fused_encoder_layer, 77, "bf16"),
            ("dec_layer", kernels.fused_decoder_layer, 239, "f32"),
            ("dec_layer_high", kernels.fused_decoder_layer, 239, "bf16x3"),
            ("dec_layer_default", kernels.fused_decoder_layer, 239, "bf16")):
        k = table[name]
        assert (k.wrapper, k.mode) == (wrapper, mode)
        assert k.replaces.endswith(f"ops/pallas/layer_fused.py:{line}")
        src = "layer_fused.cu" if mode == "f32" else "layer_modes.cu"
        assert k.source.endswith(f"csrc/{src}")
    kernels.reset_launches()
    kernels.fused_encoder_layer.launches["bf16x3"] += 2
    assert kernels.launch_counts()["enc_layer_high"] == 2
    assert kernels.launch_counts()["enc_layer"] == 0
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}


def _c_params(entry):
    """The C parameter list of ``entry`` in ``csrc/layer_modes.cu``: one
    letter each, as ``_MODE_SIGS`` writes them (p pointer, i int)."""
    src = (_CSRC / "layer_modes.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return "".join("i" if p.strip().startswith("int ") else "p"
                   for p in m.group(1).split(","))


@pytest.mark.parametrize("entry", ["kit_enc_layer_tc", "kit_dec_layer_tc"])
def test_signatures_match_the_c_entries(entry):
    assert tlf._MODE_SIGS[entry] == _c_params(entry)


@pytest.mark.parametrize("decoder", [False, True])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_mode_scratch_is_what_the_kernels_carve(decoder, mode):
    """``mode_scratch`` against the regions ``csrc/layer_modes.cu`` carves:
    the carve calls of its layer (M D a unit) times the planes, and the
    float regions its comment names."""
    src = (_CSRC / "layer_modes.cu").read_text()
    body = src[src.index("int dec_layer(" if decoder else "int enc_layer("):]
    body = body[:body.index("\n}\n")]
    units = sum(int(u) if u else 1 for u in
                re.findall(r"carve<PASSES>\(cur, (\d*)\s*\*?\s*MD\)", body))
    planes = 2 if mode == "bf16x3" else 1
    Bq, Tq, Dq, parts = 3, 40, 128, 4
    nb, nf, ns = tlf.mode_scratch(Bq, Tq, Dq, decoder, mode, parts)
    MD = Bq * Tq * Dq
    assert nb == units * planes * MD
    assert units == (10 if decoder else 5)
    assert nf == (3 if decoder else 1) * MD
    assert ns == parts * MD
    assert tlf.mode_scratch(Bq, Tq, Dq, decoder, mode, 1)[2] == 0
