"""The precision modes "high" (bf16x3) and "default" (one bf16 pass) of the
port against the JAX package on the CPU: the name table, the hi / lo split,
the FF sublayer's plain forwards and split backward against the Pallas
kernels in interpret mode under the ambient precision, and the FF kernel's
weight budget per mode (the model, the step and the entry points at
"high": ``test_torch_precision_model.py``).

Both packages round the same operands to bf16 (nearest even) and sum exact
bf16 products in float32, so "high" holds near float32 tolerances; the
differences left are the order of the float32 sums and the Pallas kernels'
rational erf (within 4e-7 of erf), which in "default" can move a value
across a bf16 rounding boundary."""

import contextlib
import types
import unittest.mock as mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attention as jatt)
from keypoints_interpolation_transformer_tpu.ops.pallas import ffn as jffn
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import precision
from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
    ffn_supported)
from keypoints_interpolation_transformer_torch.utils.config import (
    PRECISIONS, Config, ModelConfig, resolve_precision)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

D_, FF_ = 32, 64
MODE_OF = {"high": "bf16x3", "default": "bf16"}
# "high": the same exact bf16 products summed in float32 in another order
# (and the rational erf) -- float32 noise over contractions of 32-64 terms
HIGH_TOL = 2e-5
# "default": as "high", plus the values the sum order or the rational erf
# moves across a bf16 rounding boundary, each off by one bf16 step (2^-8)
# of its term; the JAX package's own bound between its bf16 kernel and its
# reference is 5e-3 (tests/test_pallas_kernels.py:646-676)
DEFAULT_TOL = 2e-3


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


def _close(got, want, tol, what=""):
    """Within ``tol`` of the larger of 1 and the reference's scale."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# the table and the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PRECISIONS))
def test_resolve_precision_matches_jax(name, monkeypatch):
    """Each precision name resolves to the JAX package's own mode, read
    from ``_precision_mode`` (FF) and ``_mxu_mode`` (attention) under that
    ambient value; names the JAX config refuses are fed to them through a
    stand-in config."""
    f32 = jnp.float32
    try:
        with jax.default_matmul_precision(name):
            want = {jffn._precision_mode(f32), jatt._mxu_mode(f32)}
    except ValueError:  # "bfloat16_3x", "fastest": only the modes know them
        monkeypatch.setattr(jax, "config", types.SimpleNamespace(
            jax_default_matmul_precision=name))
        want = {jffn._precision_mode(f32), jatt._mxu_mode(f32)}
        monkeypatch.undo()
    assert want == {resolve_precision(name)}
    assert resolve_precision(name) in precision.MODES


def test_unknown_precision_raises():
    for name in ("fp8", None, "HIGH"):
        with pytest.raises(ValueError, match="matmul_precision"):
            resolve_precision(name)
    with pytest.raises(ValueError, match="matmul_precision"):
        KeypointCompleter(32, 1, 4, ff_dim=64, precision="fp8")
    with pytest.raises(ValueError, match="matmul_precision"):
        Config(model=ModelConfig(matmul_precision="fp8")).check_supported()
    with pytest.raises(ValueError, match="mode"):
        precision.mode_matmul(torch.zeros(2, 2), torch.zeros(2, 2), "high")


def test_split_bf16_is_bit_exact_with_jax(rng):
    """hi = bf16(x) and lo = bf16(x - hi), both nearest-even, bit for bit as
    the JAX package's fold-proof ``_split_hi_lo`` (jitted, where XLA once
    folded the split away) and its in-kernel ``_split_hi_lo_kernel``; lo
    carries the next 8 bits (|x - hi - lo| <= 2^-17 |x|).  Normal float32
    values only: XLA on the CPU flushes subnormal results to zero."""
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(
        -6, 6, size=4096), [0.0, 1.0, -1.5, 1.0 + 2.0 ** -8,
                            1.0 + 3 * 2.0 ** -9]]).astype(np.float32)
    hi, lo = precision.split_bf16(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    for split in (jax.jit(jffn._split_hi_lo), jffn._split_hi_lo_kernel):
        jh, jl = split(jnp.asarray(x))
        np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                      np.asarray(jh).view(np.int16))
        np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                      np.asarray(jl).view(np.int16))
    rest = np.abs(x - hi.float().numpy() - lo.float().numpy())
    assert np.all(rest <= 2.0 ** -17 * np.abs(x))
    assert np.count_nonzero(lo.float().numpy()) > 4000  # not folded away
    # nearest even: 1 + 2^-8 sits half way between two bf16 values
    assert float(hi[-2]) == 1.0 and float(hi[-1]) == 1.0 + 2.0 ** -7


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_mode_matmul_is_the_rounded_product(rng, mode):
    """The one or three products of the bf16 parts, exact in float64."""
    a = rng.normal(size=(9, 40)).astype(np.float32)
    b = rng.normal(size=(40, 7)).astype(np.float32)
    ah, al = (p.double() for p in precision.split_bf16(torch.from_numpy(a)))
    bh, bl = (p.double() for p in precision.split_bf16(torch.from_numpy(b)))
    want = ah @ bh if mode == "bf16" else ah @ bh + ah @ bl + al @ bh
    got = precision.mode_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    assert torch.equal(precision.mode_matmul(torch.from_numpy(a),
                                             torch.from_numpy(b), "f32"),
                       torch.from_numpy(a) @ torch.from_numpy(b))


# ---------------------------------------------------------------------------
# the FF sublayer
# ---------------------------------------------------------------------------

def _ffn_operands(rng, N=24, D=D_, FF=FF_):
    r = rng.normal(size=(2, N // 2, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, FF)) * 0.2).astype(np.float32)
    b1 = (rng.normal(size=(FF,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(FF, D)) * 0.2).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.05).astype(np.float32)
    g1, be1, g2, be2 = [(s + 0.1 * rng.normal(size=(D,))).astype(np.float32)
                        for s in (1.0, 0.0, 1.0, 0.0)]
    return r, w1, b1, w2, b2, g1, be1, g2, be2


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_ffn_plain_matches_pallas_in_mode(rng, prec, pre_ln):
    """``ffn_plain`` / ``ffn_train_plain`` in the mode against
    ``_ffn_fwd_pallas`` in interpret mode under the ambient precision
    (``_kernel_split`` at "high", ``_kernel_single``'s bf16 mode at
    "default"), y and the residuals u, z."""
    ops = _ffn_operands(rng)
    mode = MODE_OF[prec]
    tol = HIGH_TOL if prec == "high" else DEFAULT_TOL
    with _interpret(prec):
        y, u, z = jffn._ffn_fwd_pallas(*map(jnp.asarray, ops), pre_ln,
                                       want_residuals=True)
    got = kernels.ffn_train_plain(*_t(*ops), pre_ln, mode)
    for name, g, w in zip("yuz", got, (y, u, z)):
        _close(g.numpy(), w, tol, f"{prec} {name}")
    _close(kernels.ffn_plain(*_t(*ops), pre_ln, mode).numpy(), y, tol)
    # the mode's rounding is what closes the gap: float32 is further away
    f32 = kernels.ffn_plain(*_t(*ops), pre_ln).numpy()
    y = np.asarray(y)
    assert np.abs(got[0].numpy() - y).max() < np.abs(f32 - y).max() / 2


@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16"])
def test_ffn_bwd_split_plain_matches_pallas(rng, mode):
    """``ffn_bwd_split_plain`` against the JAX package's native backward
    in interpret mode: the two-kernel split ``_ffn_bwd_pallas_split`` in
    "f32" and "bf16x3", and in "bf16" the monolith ``_ffn_bwd_pallas``
    (its bf16 route, the same arithmetic), from the same residuals u, z;
    every gradient against the largest of its kind."""
    ops = _ffn_operands(rng)
    r, w1, b1, w2, b2, g1, be1, g2, be2 = ops
    g = rng.normal(size=r.shape).astype(np.float32)
    _, u, z = kernels.ffn_train_plain(*_t(*ops), True)
    u, z = u.numpy(), z.numpy()
    prec = {"f32": "highest", "bf16x3": "high", "bf16": "default"}[mode]
    with _interpret(prec):
        fn = jffn._ffn_bwd_pallas if mode == "bf16" else \
            jffn._ffn_bwd_pallas_split
        want = fn(*map(jnp.asarray, (r, g, w1, b1, w2, b2, g1, be1, g2,
                                     be2)), True, mode, jnp.asarray(u),
                  jnp.asarray(z))
    got = kernels.ffn_bwd_split_plain(
        *_t(g, r, u, z, w1.T.copy(), w2.T.copy(), g1, be1, g2), True, mode)
    dr, dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2 = (t.numpy() for t in got)
    tol = {"f32": 1e-5, "bf16x3": HIGH_TOL, "bf16": DEFAULT_TOL}[mode]
    for name, a, b in (("dr", dr, want[0]), ("dw1", dw1t.T, want[1]),
                       ("db1", db1, want[2]), ("dw2", dw2t.T, want[3]),
                       ("db2", db2, want[4]), ("dg1", dg1, want[5]),
                       ("dbe1", dbe1, want[6]), ("dg2", dg2, want[7]),
                       ("dbe2", dbe2, want[8])):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a / scale, b / scale, atol=tol, rtol=0,
                                   err_msg=f"{mode} {name}")
    # the float32 split is the monolith's arithmetic
    mono = kernels.ffn_bwd_plain(*_t(g, r, u, z, w1.T.copy(), w2.T.copy(),
                                     g1, be1, g2), True)
    if mode == "f32":
        for a, b in zip(got, mono):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_plain_route_gradients_are_products_in_the_mode(rng, mode):
    """The plain training route differentiates ``ffn_train_plain`` by
    autograd; its gradients must be the split backward's, every product
    in the mode (as the JAX package's XLA route takes a dot's transposed
    products at the dot's precision), not products of float32 gradients
    rounded to bf16 where autograd passes back through the casts.  The
    same rounded products in another float32 order: HIGH_TOL / DEFAULT_TOL
    of each gradient's own largest value, as above; the gradients that
    rounding through the casts gives miss "high" by some 1e-3."""
    ops = _ffn_operands(rng)
    r, w1, b1, w2, b2, g1, be1, g2, be2 = _t(*ops)
    g = torch.from_numpy(rng.normal(size=r.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (r, w1, b1, w2, b2, g1,
                                                    be1, g2, be2)]
    y, u, z = kernels.ffn_train_plain(*leaves, True, mode)
    y.backward(g)
    want = kernels.ffn_bwd_split_plain(
        g, r, u.detach(), z.detach(), w1.t().contiguous(),
        w2.t().contiguous(), g1, be1, g2, True, mode)
    dr, dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2 = want
    tol = HIGH_TOL if mode == "bf16x3" else DEFAULT_TOL
    for name, leaf, w in (("dr", leaves[0], dr), ("dw1", leaves[1], dw1t.t()),
                          ("db1", leaves[2], db1), ("dw2", leaves[3], dw2t.t()),
                          ("db2", leaves[4], db2), ("dg1", leaves[5], dg1),
                          ("dbe1", leaves[6], dbe1), ("dg2", leaves[7], dg2),
                          ("dbe2", leaves[8], dbe2)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(leaf.grad.numpy() / scale,
                                   w.numpy() / scale, atol=tol, rtol=0,
                                   err_msg=f"{mode} {name}")


def _jax_ffn_kernel(D, FF, prec):
    """True where ``_ffn_fwd_pallas`` keeps the FF sublayer in its kernel
    under the ambient precision ``prec`` (its weight budget), read by
    tracing it with ``pallas_call`` patched."""
    class Route(Exception):
        pass

    def call(*a, **k):
        raise Route

    r = jax.ShapeDtypeStruct((8, D), jnp.float32)
    w1 = jax.ShapeDtypeStruct((D, FF), jnp.float32)
    w2 = jax.ShapeDtypeStruct((FF, D), jnp.float32)
    vec = jax.ShapeDtypeStruct((D,), jnp.float32)
    b1 = jax.ShapeDtypeStruct((FF,), jnp.float32)
    with mock.patch.object(jffn.pl, "pallas_call", call), \
            jax.default_matmul_precision(prec):
        try:
            jax.eval_shape(lambda *a: jffn._ffn_fwd_pallas(*a, True),
                           r, w1, b1, w2, vec, vec, vec, vec, vec)
        except Route:
            return True
    return False


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
def test_ffn_budget_per_mode_matches_jax(prec):
    """``ffn_supported`` per mode (12 bytes per weight element at bf16x3,
    4 at bf16) against the JAX rule read from its code."""
    mode = resolve_precision(prec)
    for D in (128, 256, 512, 1024):
        for FF in (512, 2048, 4096, 8192):
            assert ffn_supported(D, FF, mode=mode) == \
                _jax_ffn_kernel(D, FF, prec), (D, FF)
