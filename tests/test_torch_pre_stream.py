"""The pre-stream chain on an embedding that is already computed
(``fused_pre_stream``, the port of the Pallas ``_pre_kernel``) against the
JAX package on the CPU: its plain version against the pure-XLA oracle
``pre_stream_reference`` and the Pallas kernel in interpret mode, with and
without the Cycle variant's extra residual.  No route of the model takes
it (the JAX package reaches it only with its embedding kernel switched
off); on the card ``chip_smoke.py`` holds the kernel against this plain
version."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    pointwise as jpw)
from keypoints_interpolation_transformer_torch.ops import kernels

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D = 2, 16, 128
# float32 on both sides: the same chain, its sums in another order
TOL = 2e-5


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


def _operands(rng):
    e = (rng.normal(size=(B, T, D)) * 2 + 0.5).astype(np.float32)
    pe = rng.normal(size=(T, D)).astype(np.float32)
    w = [(rng.normal(size=(D, D)) * D ** -0.5).astype(np.float32)
         for _ in range(3)]
    b = [(rng.normal(size=(D,)) * 0.05).astype(np.float32) for _ in range(3)]
    return e, pe, w, b


@pytest.mark.parametrize("pe_residual", [False, True])
def test_pre_stream_plain_matches_jax(rng, pe_residual):
    e, pe, (w1, w2, w3), (b1, b2, b3) = _operands(rng)
    jargs = [jnp.asarray(a) for a in (e, pe, w1, b1, w2, b2, w3, b3)]
    with jax.default_matmul_precision("highest"):
        want_ref = np.asarray(jpw.pre_stream_reference(*jargs, pe_residual))
    with _interpret():
        want_kernel = np.asarray(jpw.fused_pre_stream(*jargs, pe_residual))
    w12 = np.concatenate([w1, w2], 1)
    b12 = np.concatenate([b1, b2])
    args = [torch.from_numpy(a) for a in (e, pe, w12, b12, w3, b3)]
    got = kernels.pre_stream_plain(*args, pe_residual).numpy()
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=0)
    # the wrapper takes its plain version for a CPU tensor, uncounted
    kernels.reset_launches()
    assert torch.equal(kernels.fused_pre_stream(*args, pe_residual),
                       torch.from_numpy(got))
    assert kernels.launch_counts()["pre_stream"] == 0


def test_pre_stream_is_the_embed_kernels_second_half(rng):
    """``pre_stream_embed_plain`` is the embedding followed by this chain,
    as the JAX ``_pre_embed_kernel`` is its ``_pre_kernel`` after the
    Linear."""
    e, pe, (w1, w2, w3), (b1, b2, b3) = _operands(rng)
    x = rng.uniform(0.2, 0.8, (B, T, 108)).astype(np.float32)
    wemb = (rng.normal(size=(108, D)) * 0.1).astype(np.float32)
    bemb = (rng.normal(size=(D,)) * 0.05).astype(np.float32)
    w12 = np.concatenate([w1, w2], 1)
    b12 = np.concatenate([b1, b2])
    t = [torch.from_numpy(a) for a in (x, wemb, bemb, pe, w12, b12, w3, b3)]
    for res in (False, True):
        s, emb = kernels.pre_stream_embed_plain(*t, res, True)
        assert torch.equal(kernels.pre_stream_plain(emb, *t[3:], res), s)
