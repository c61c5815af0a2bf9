"""The PyTorch port's kernel modules against the JAX package on the CPU.

For each kernel module the port's plain version (the path its wrapper takes
for CPU tensors) is held against the JAX pure-XLA oracle and against the
JAX Pallas kernel in interpret mode, on the same numpy-seeded inputs, at
the tolerances of the JAX kernel tests.  The CUDA kernels themselves run
only on the card (``chip_smoke.py`` and ``tests/test_torch_gpu.py``).
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attn_sublayer as jasl, ffn as jffn, pointwise as jpw)
from keypoints_interpolation_transformer_tpu.ops.pallas.attention import (
    _bias_terms)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    _build, attn_sublayer as tasl, ffn as tffn, pointwise as tpw)
from keypoints_interpolation_transformer_torch.ops.masks import NEG

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _masks(rng, B, T, pad=6):
    mask = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[-1, T - pad:] = 0.0  # a padded row
    return mask, valid


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------------------
# the mask contract the sublayer kernel builds in-kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,add_keypad,with_valid", [
    ("repeat-inc", True, True), ("repeat-inc", False, True),
    ("repeat-inc", True, False), ("all", True, True), ("all", False, True)])
def test_bias_from_masks_matches_jax_bias_terms(rng, kind, add_keypad,
                                                with_valid):
    B, T = 3, 12
    mask, valid = _masks(rng, B, T)
    want = np.stack([np.asarray(_bias_terms(
        jnp.asarray(mask[b]), jnp.asarray(valid[b]) if with_valid else None,
        T, kind, add_keypad)) for b in range(B)])
    got = tasl.bias_from_masks(*_t(mask, valid if with_valid else None), T,
                               kind, add_keypad).numpy()
    np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)


def test_bias_contract_pinned(rng):
    """repeat-inc puts the finite NEG iff key > query and mask[key] == 1;
    the raw mask is added under add_keypad; invalid keys get NEG."""
    mask = np.array([[0, 1, 0, 1]], np.float32)
    valid = np.array([[1, 1, 1, 0]], np.float32)
    b = tasl.bias_from_masks(*_t(mask, None), 4, "repeat-inc", False)[0]
    for q in range(4):
        for k in range(4):
            blocked = k > q and mask[0, k] == 1
            assert float(b[q, k]) == (NEG if blocked else 0.0)
    assert NEG == -1e9 and np.isfinite(float(b.min()))
    kp = tasl.bias_from_masks(*_t(mask, None), 4, "all", True)[0]
    np.testing.assert_array_equal(kp.numpy(), mask)  # (1, T_key) row
    vb = tasl.bias_from_masks(*_t(mask, valid), 4, "all", False)[0]
    assert float(vb[0, 3]) == NEG and float(vb[0, :3].abs().max()) == 0.0
    assert tasl.bias_from_masks(None, None, 4, "all", False) is None


# ---------------------------------------------------------------------------
# attention sublayer
# ---------------------------------------------------------------------------

def _sublayer_operands(rng, B=2, T=24, D=64, post_ln=False):
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mem = rng.normal(size=(B, T, D)).astype(np.float32)
    ws = [(rng.normal(size=(D, D)) * 0.1).astype(np.float32)
          for _ in range(4)]
    bs = [(rng.normal(size=(D,)) * 0.05).astype(np.float32)
          for _ in range(4)]
    ln = ((1 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
          (0.1 * rng.normal(size=(D,))).astype(np.float32)) if post_ln \
        else (None, None)
    mask, valid = _masks(rng, B, T)
    return x, mem, ws, bs, ln, mask, valid


_SUBLAYER_CASES = [
    # (self_attn, kind, add_keypad, post_ln, with_valid)
    (True, "repeat-inc", True, False, True),    # encoder self-attention
    (True, "repeat-inc", False, True, True),    # decoder self-attention
    (True, "repeat-inc", True, True, True),     # Cycle decoder self
    (False, "all", False, False, True),         # cross-attention
    (True, "all", False, False, False),         # no mask, no padding
]


@pytest.mark.parametrize("self_attn,kind,add_keypad,post_ln,with_valid",
                         _SUBLAYER_CASES)
def test_attn_sublayer_plain_matches_jax(rng, self_attn, kind, add_keypad,
                                         post_ln, with_valid):
    x, mem, ws, bs, ln, mask, valid = _sublayer_operands(rng,
                                                         post_ln=post_ln)
    valid = valid if with_valid else None
    memory = None if self_attn else mem
    D = x.shape[-1]
    jparams = (*(_j(ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3])),
               *(_j(*ln) if post_ln else [jnp.zeros((0,))] * 2))
    jargs = (*_j(x, memory), jparams, *_j(mask, valid))
    with jax.default_matmul_precision("highest"):
        want_ref = jasl.attn_sublayer_reference(
            jargs[0], jargs[1], jargs[2], jargs[3], jargs[4], kind,
            add_keypad, post_ln, 4)
    with _interpret():
        want_pallas = jasl.fused_attn_sublayer(
            jargs[0], jargs[1], jargs[2], (jargs[3], jargs[4]), kind,
            add_keypad, post_ln, 4)
    wqkv = np.concatenate(ws[:3], axis=1)
    bqkv = np.concatenate(bs[:3])
    args = _t(x, memory, wqkv, bqkv, ws[3], bs[3], *ln, mask, valid)
    got = kernels.fused_attn_sublayer(*args, kind, add_keypad, 4).numpy()
    assert got.shape == (2, 24, D)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=2e-5)


def test_mha_module_with_full_bias_equals_sublayer(rng):
    """The additive-bias MultiHeadAttention module, fed the (B, T, T) bias
    of the mask builders, equals the sublayer's 1-D-mask plain path."""
    from keypoints_interpolation_transformer_torch.models.layers import (
        MultiHeadAttention)
    from keypoints_interpolation_transformer_torch.ops.masks import (
        attention_bias, key_padding_additive, padding_bias)

    B, T, D = 2, 16, 32
    torch.manual_seed(0)
    mha = MultiHeadAttention(D, 4)
    x = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32))
    mask, valid = _t(*_masks(rng, B, T))
    bias = (attention_bias("repeat-inc", mask, T)
            + key_padding_additive(mask) + padding_bias(valid))[:, None]
    with torch.no_grad():
        want = x + mha(x, x, bias)
        got = tasl.attn_sublayer_plain(x, None, *mha.packed(), None, None,
                                       mask, valid, "repeat-inc", True, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


# ---------------------------------------------------------------------------
# feed-forward sublayer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_ln", [True, False])
def test_ffn_plain_matches_jax(rng, pre_ln):
    N, D, FF = 24, 32, 64
    r = rng.normal(size=(2, N // 2, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, FF)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(FF,)) * 0.01).astype(np.float32)
    w2 = (rng.normal(size=(FF, D)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.01).astype(np.float32)
    g1, be1, g2, be2 = [(s + 0.1 * rng.normal(size=(D,))).astype(np.float32)
                        for s in (1.0, 0.0, 1.0, 0.0)]
    ops = (r, w1, b1, w2, b2, g1, be1, g2, be2)
    with jax.default_matmul_precision("highest"):
        want_ref = jffn.ffn_reference(*_j(*ops), pre_ln=pre_ln)
    with _interpret():
        want_pallas = jffn.fused_ffn(*_j(*ops), pre_ln)
    got = kernels.fused_ffn(*_t(*ops), pre_ln).numpy()
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=1e-5)
    # the Pallas kernel's rational erf differs from erf by < 4e-7
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=1e-5)


# ---------------------------------------------------------------------------
# pointwise: pre-stream embed and post head
# ---------------------------------------------------------------------------

def _swiglu_weights(rng, D):
    w = [(rng.normal(size=(D, D)) * 0.1).astype(np.float32) for _ in range(3)]
    b = [(rng.normal(size=(D,)) * 0.02).astype(np.float32) for _ in range(3)]
    flat = (w[0], b[0], w[1], b[1], w[2], b[2])
    packed = (np.concatenate(w[:2], 1), np.concatenate(b[:2]), w[2], b[2])
    return flat, packed


@pytest.mark.parametrize("pe_residual", [False, True])
def test_pre_stream_embed_plain_matches_jax(rng, pe_residual):
    B, T, F, D = 2, 16, 108, 128
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    wemb = (rng.normal(size=(F, D)) * 0.1).astype(np.float32)
    bemb = (rng.normal(size=(D,)) * 0.02).astype(np.float32)
    pe = rng.normal(size=(T, D)).astype(np.float32)
    flat, packed = _swiglu_weights(rng, D)
    jargs = _j(x, wemb, bemb, pe, *flat)
    with jax.default_matmul_precision("highest"):
        want_s, want_e = jpw.pre_stream_embed_reference(
            *jargs, pe_residual, True)
    with _interpret():
        pal_s, pal_e = jpw.fused_pre_stream_embed(*jargs, pe_residual, True)
    targs = _t(x, wemb, bemb, pe, *packed)
    got_s, got_e = kernels.fused_pre_stream_embed(*targs, pe_residual, True)
    got_only = kernels.fused_pre_stream_embed(*targs, pe_residual, False)
    for want in (want_s, pal_s):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want),
                                   atol=2e-5)
    for want in (want_e, pal_e):
        np.testing.assert_allclose(got_e.numpy(), np.asarray(want),
                                   atol=2e-5)
    np.testing.assert_array_equal(got_only.numpy(), got_s.numpy())


def test_post_head_plain_matches_jax(rng):
    B, T, F, D = 2, 16, 108, 128
    dec = rng.normal(size=(B, T, D)).astype(np.float32)
    emb = rng.normal(size=(B, T, D)).astype(np.float32)
    wh = (rng.normal(size=(D, F)) * 0.1).astype(np.float32)
    bh = (rng.normal(size=(F,)) * 0.02).astype(np.float32)
    flat, packed = _swiglu_weights(rng, D)
    jargs = _j(dec, emb, *flat, wh, bh)
    with jax.default_matmul_precision("highest"):
        want = jpw.post_head_reference(*jargs)
    with _interpret():
        pal = jpw.fused_post_head(*jargs)
    got = kernels.fused_post_head(*_t(dec, emb, *packed, wh, bh)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pal), atol=2e-5)


def test_token_norm_matches_jax(rng):
    from keypoints_interpolation_transformer_tpu.models.layers import (
        token_norm as jtn)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(tpw.token_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jtn(jnp.asarray(x))), atol=1e-6)


# ---------------------------------------------------------------------------
# wrappers, build helpers, and the card
# ---------------------------------------------------------------------------

def test_kernel_table_and_counters():
    names = [k.name for k in kernels.KERNELS]
    assert names == ["pre_stream_embed", "attn_sublayer", "ffn",
                     "post_head", "attn_sublayer_train", "attn_sublayer_bwd",
                     "ffn_train", "ffn_bwd", "enc_layer", "dec_layer",
                     "attention", "attention_bwd", "masked_loss",
                     "int8_dense", "ffn_int8", "enc_layer_int8",
                     "ffn_high", "ffn_default", "ffn_train_high",
                     "ffn_train_default",
                     "ffn_bwd_split_high", "ffn_bwd_split_default",
                     "pre_stream", "enc_layer_high", "enc_layer_default",
                     "dec_layer_high", "dec_layer_default",
                     "attn_sublayer_high", "attn_sublayer_default",
                     "attn_sublayer_train_high",
                     "attn_sublayer_train_default",
                     "attn_sublayer_bwd_high", "attn_sublayer_bwd_default",
                     "attention_high", "attention_default",
                     "attention_bwd_high", "attention_bwd_default",
                     "pre_stream_embed_high", "pre_stream_embed_default",
                     "post_head_high", "post_head_default",
                     "mode_linear_high", "mode_linear_default",
                     "mode_linear_bwd_high", "mode_linear_bwd_default",
                     "enc_layer_int8_high", "enc_layer_int8_default"]
    # the precision modes count apart, under their wrapper's mode
    modes = {k.name: k.mode for k in kernels.KERNELS if k.mode}
    assert modes["ffn"] == modes["ffn_train"] == "f32"
    assert modes["attn_sublayer"] == modes["attn_sublayer_bwd"] == "f32"
    assert modes["attn_sublayer_train_high"] == "bf16x3"
    assert modes["attn_sublayer_bwd_default"] == "bf16"
    assert modes["enc_layer"] == modes["dec_layer"] == "f32"
    assert modes["enc_layer_high"] == modes["dec_layer_high"] == "bf16x3"
    assert modes["dec_layer_default"] == "bf16"
    assert modes["ffn_high"] == modes["ffn_bwd_split_high"] == "bf16x3"
    assert modes["ffn_train_default"] == "bf16"
    for k in kernels.KERNELS:
        assert k.source.endswith(".cu") and ".py:" in k.replaces
    kernels.reset_launches()
    x = torch.zeros(1, 8, 32)
    w = torch.zeros(32, 64)
    kernels.fused_ffn(x, w, torch.zeros(64), w.t().contiguous(),
                      torch.zeros(32), None, None, torch.ones(32),
                      torch.zeros(32), False)
    # a CPU tensor takes the plain version: no launch is counted
    assert set(kernels.launch_counts().values()) == {0}


def test_build_checks_and_sources():
    cpu = torch.device("cpu")
    _build.check_tensors("f", cpu, a=torch.zeros(2), b=None)
    with pytest.raises(TypeError):
        _build.check_tensors("f", cpu, a=torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        _build.check_tensors("f", cpu, a=torch.zeros(4, 4).t())
    with pytest.raises(ValueError):
        _build.check_shape("f", "a", torch.zeros(2, 3), (3, 2))
    _build.check_aligned("f", a=torch.zeros(8), b=torch.zeros(8)[4:])
    with pytest.raises(ValueError, match="16-byte"):
        _build.check_aligned("f", a=torch.zeros(8)[1:])
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "common.cuh"' in src and 'extern "C"' in src
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

