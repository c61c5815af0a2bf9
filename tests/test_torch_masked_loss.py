"""The fused masked-loss module of the PyTorch port against the JAX package
on the CPU: the plain version and its closed-form gradient against the
Pallas ``fused_euclidean_loss`` in interpret mode and against
``losses.euclidean_loss``, with padded frames and videos of zero weight;
the train criteria that use it.  The CUDA kernel runs only on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops import losses as jlosses
from keypoints_interpolation_transformer_tpu.ops.pallas.masked_loss import (
    fused_euclidean_loss as jfused)
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_torch.ops import kernels, losses
from keypoints_interpolation_transformer_torch.train import steps

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

RTOL = 1e-5


def _inputs(seed, B=5, T=12):
    """pred, target (B, T, 54, 2); weights with padded frames, a video of
    zero weight and a fractional one."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(B, T, 54, 2)).astype(np.float32)
    tgt = rng.uniform(size=(B, T, 54, 2)).astype(np.float32)
    w = (np.arange(T)[None, :] < rng.integers(1, T + 1, (B, 1))).astype(
        np.float32)
    w[1] = 0.0
    w[3] *= 0.5
    return pred, tgt, w


def test_plain_matches_jax_kernel_and_euclidean_loss():
    pred, tgt, w = _inputs(0)
    got = kernels.masked_loss_plain(*map(torch.from_numpy, (pred, tgt, w)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused(*map(jnp.asarray, (pred, tgt, w))))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    ref = losses.euclidean_loss(*map(torch.from_numpy, (pred, tgt, w)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL)
    assert got[1] == 0.0  # a video of zero weight costs nothing
    kernels.reset_launches()
    same = kernels.fused_masked_loss(*map(torch.from_numpy, (pred, tgt, w)))
    torch.testing.assert_close(same, got, rtol=0, atol=0)
    assert kernels.launch_counts()["masked_loss"] == 0


def test_gradient_matches_jax():
    pred, tgt, w = _inputs(1)
    g = np.random.default_rng(2).normal(size=pred.shape[0]).astype(
        np.float32)
    p, t = (torch.from_numpy(a).requires_grad_() for a in (pred, tgt))
    out = kernels.fused_euclidean_loss(p, t, torch.from_numpy(w))
    out.backward(torch.from_numpy(g))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b: jfused(a, b, jnp.asarray(w)),
                         jnp.asarray(pred), jnp.asarray(tgt))
        dp, dt = vjp(jnp.asarray(g))
    scale = float(np.abs(dp).max())
    np.testing.assert_allclose(p.grad.numpy() / scale,
                               np.asarray(dp) / scale, atol=RTOL)
    np.testing.assert_allclose(t.grad.numpy() / scale,
                               np.asarray(dt) / scale, atol=RTOL)
    # autograd through the XLA euclidean loss gives the same gradient
    _, vjp = jax.vjp(lambda a: jlosses.euclidean_loss(
        a, jnp.asarray(tgt), frame_weight=jnp.asarray(w)), jnp.asarray(pred))
    np.testing.assert_allclose(p.grad.numpy() / scale,
                               np.asarray(vjp(jnp.asarray(g))[0]) / scale,
                               atol=RTOL)


def test_closed_form_gradient_gradcheck():
    pred, tgt, w = (torch.from_numpy(a.astype(np.float64))
                    for a in _inputs(3, B=4, T=4))
    pred.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda p: kernels.FusedEuclideanLoss.apply(p, tgt, w), (pred,),
        fast_mode=True)


@pytest.mark.parametrize("regime", ["a1", "a2", "a3", "a4"])
def test_fused_criteria_match_jax(regime):
    """make_train_criterion(fused=True): half the fused loss for a1 / a2
    (MSE is euclidean / 2), the fused loss for a3 / a4, as in JAX; the
    plain and the fused form agree with the unfused criterion."""
    pred, tgt, w = _inputs(4)
    args = tuple(map(torch.from_numpy, (pred, tgt, w)))
    got = steps.make_train_criterion(regime, True)(*args)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsteps.make_train_criterion(regime, True)(
            *map(jnp.asarray, (pred, tgt, w))))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    for fused, plain in ((True, True), (False, False)):
        other = steps.make_train_criterion(regime, fused, plain)(*args)
        np.testing.assert_allclose(other.numpy(), got.numpy(), rtol=RTOL,
                                   atol=1e-7)
