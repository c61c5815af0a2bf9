"""The port's training kernels (their plain versions, the path the wrappers
take for CPU tensors) against the JAX package on the CPU: the FF and
attention-sublayer training forwards and backwards against the Pallas
kernels in interpret mode and against ``jax.vjp`` of the pure-XLA
references, on the same numpy-seeded inputs; and the ``autograd.Function``s
that tie each training forward to its backward."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attn_sublayer as jasl, ffn as jffn)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    attn_sublayer as tasl, ffn as tffn)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

T_, D_, H_, FF_ = 16, 32, 4, 64


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _close_scaled(got, want, scale, atol, what=""):
    got = np.zeros_like(np.asarray(want)) if got is None else np.asarray(got)
    np.testing.assert_allclose(got / scale, np.asarray(want) / scale,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# feed-forward sublayer
# ---------------------------------------------------------------------------

def _ffn_operands(rng, N=24, D=D_, FF=FF_):
    r = rng.normal(size=(2, N // 2, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, FF)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(FF,)) * 0.01).astype(np.float32)
    w2 = (rng.normal(size=(FF, D)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.01).astype(np.float32)
    g1, be1, g2, be2 = [(s + 0.1 * rng.normal(size=(D,))).astype(np.float32)
                        for s in (1.0, 0.0, 1.0, 0.0)]
    return r, w1, b1, w2, b2, g1, be1, g2, be2


@pytest.mark.parametrize("pre_ln", [False, True])
def test_ffn_train_forward_matches_pallas_residuals(rng, pre_ln):
    ops = _ffn_operands(rng)
    with _interpret():
        want = jffn._ffn_fwd_pallas(*map(jnp.asarray, ops), pre_ln,
                                    want_residuals=True)
    got = kernels.fused_ffn_train(*_t(*ops), pre_ln)
    for name, g, w in zip("yuz", got, want):
        # the Pallas kernel's rational erf differs from erf by < 4e-7
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_ffn_bwd_matches_pallas_and_vjp(rng, pre_ln):
    ops = _ffn_operands(rng)
    r, w1, b1, w2, b2, g1, be1, g2, be2 = ops
    g = rng.normal(size=r.shape).astype(np.float32)
    jops = [jnp.asarray(a) for a in ops]
    with _interpret():
        _, u, z = jffn._ffn_fwd_pallas(*jops, pre_ln, want_residuals=True)
    with pltpu.force_tpu_interpret_mode():
        pallas = jffn._ffn_bwd_pallas(jops[0], jnp.asarray(g), *jops[1:],
                                      pre_ln, "f32", u, z)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: jffn.ffn_reference(*a, pre_ln=pre_ln),
                         *jops)
        ref = vjp(jnp.asarray(g))
    _, tu, tz = tffn.ffn_train_plain(*_t(*ops), pre_ln)
    dr, dw1t, db1, dw2t, db2, dg1, dbe1, dg2, dbe2 = kernels.ffn_bwd(
        *_t(g, r), tu, tz, *_t(w1.T.copy(), w2.T.copy(), g1, be1, g2),
        pre_ln)
    got = (dr, dw1t.T, db1, dw2t.T, db2, dg1, dbe1, dg2, dbe2)
    for i, (a, p, w) in enumerate(zip(got, pallas, ref)):
        s = float(jnp.max(jnp.abs(w))) + 1e-9
        a = None if a is None else a.numpy()
        _close_scaled(a, w, s, 1e-5, f"output {i} vs jax.vjp")
        _close_scaled(a, p, s, 1e-5, f"output {i} vs the Pallas backward")


# ---------------------------------------------------------------------------
# attention sublayer
# ---------------------------------------------------------------------------

def _sublayer_operands(rng, post_ln, all_padded=False, B=2, T=T_, D=D_):
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mem = rng.normal(size=(B, T, D)).astype(np.float32)
    ws = [(rng.normal(size=(D, D)) * 0.1).astype(np.float32)
          for _ in range(4)]
    bs = [(rng.normal(size=(D,)) * 0.05).astype(np.float32)
          for _ in range(4)]
    ln = ((1 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
          (0.1 * rng.normal(size=(D,))).astype(np.float32)) if post_ln \
        else (None, None)
    mask = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, T - 6:] = 0.0             # a padded row
    if all_padded:
        valid[0] = 0.0                 # every key blocked: uniform rows
    return x, mem, ws, bs, ln, mask, valid


def _jax_params(ws, bs, ln):
    lnj = [jnp.asarray(a) for a in ln] if ln[0] is not None else \
        [jnp.zeros((0,), jnp.float32)] * 2
    return (*(jnp.asarray(a) for a in (ws[0], bs[0], ws[1], bs[1], ws[2],
                                       bs[2], ws[3], bs[3])), *lnj)


_CASES = [
    # (self_attn, kind, add_keypad, post_ln, all_padded)
    (True, "repeat-inc", True, False, False),   # encoder self-attention
    (True, "repeat-inc", False, True, False),   # decoder self-attention
    (False, "all", False, False, False),        # cross-attention
    (False, "all", False, False, True),         # cross, a row all padded
]


def _torch_side(x, mem, ws, bs, ln, mask, valid, self_attn, kind, keypad,
                post_ln):
    wqkv = np.concatenate(ws[:3], axis=1)
    bqkv = np.concatenate(bs[:3])
    return kernels.fused_attn_sublayer_train(
        *_t(x, None if self_attn else mem, wqkv, bqkv, ws[3], bs[3], *ln,
            mask, valid), kind, keypad, H_)


@pytest.mark.parametrize("self_attn,kind,keypad,post_ln,all_padded", _CASES)
def test_attn_sublayer_train_forward_matches_pallas_residuals(
        rng, self_attn, kind, keypad, post_ln, all_padded):
    x, mem, ws, bs, ln, mask, valid = _sublayer_operands(rng, post_ln,
                                                         all_padded)
    with _interpret():
        y, (q, k, v, a, _, r) = jasl._fwd_pallas(
            jnp.asarray(x), None if self_attn else jnp.asarray(mem),
            _jax_params(ws, bs, ln), jnp.asarray(mask), jnp.asarray(valid),
            kind, keypad, post_ln, H_, want_residuals=True)
    ty, qkv, ta, stats, tr, _ = _torch_side(x, mem, ws, bs, ln, mask, valid,
                                            self_attn, kind, keypad, post_ln)
    tq, tk, tv = qkv.split(D_, -1)
    for name, g, w in (("y", ty, y), ("q", tq, q), ("k", tk, k),
                       ("v", tv, v), ("a", ta, a)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=name)
    if post_ln:
        np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=2e-5)
    else:
        assert tr is None
    assert stats.shape == (2, H_, T_, 2) and bool(torch.isfinite(stats).all())
    assert bool((stats[..., 1] >= 1.0).all())  # each row sum holds exp(0)


@pytest.mark.parametrize("self_attn,kind,keypad,post_ln,all_padded", _CASES)
@pytest.mark.parametrize("save_probs", [True, False])
def test_attn_sublayer_bwd_matches_pallas_and_vjp(
        rng, self_attn, kind, keypad, post_ln, all_padded, save_probs):
    x, mem, ws, bs, ln, mask, valid = _sublayer_operands(rng, post_ln,
                                                         all_padded)
    g = rng.normal(size=x.shape).astype(np.float32)
    jx, jm = jnp.asarray(x), None if self_attn else jnp.asarray(mem)
    params = _jax_params(ws, bs, ln)
    jmask, jvalid = jnp.asarray(mask), jnp.asarray(valid)
    with _interpret():
        _, res = jasl._fwd_pallas(jx, jm, params, jmask, jvalid, kind,
                                  keypad, post_ln, H_, want_residuals=True,
                                  save_probs=save_probs)
        pdx, pdmem, pdp = jasl._bwd_pallas(
            jx, jm, params, res, jnp.asarray(g), post_ln, H_, mask=jmask,
            valid=jvalid, kind=kind, add_keypad=keypad)

    def ref(x_, m_, p_):
        return jasl.attn_sublayer_reference(x_, m_, p_, jmask, jvalid, kind,
                                            keypad, post_ln, H_)
    with jax.default_matmul_precision("highest"):
        if self_attn:
            _, vjp = jax.vjp(lambda x_, p_: ref(x_, None, p_), jx, params)
            rdx, rdp = vjp(jnp.asarray(g))
            rdmem = None
        else:
            _, vjp = jax.vjp(ref, jx, jm, params)
            rdx, rdmem, rdp = vjp(jnp.asarray(g))

    _, qkv, a, stats, r, _ = _torch_side(x, mem, ws, bs, ln, mask, valid,
                                         self_attn, kind, keypad, post_ln)
    w_in = np.concatenate([w.T for w in ws[:3]])
    dx, dmem, dw_in, db_in, dw_out, db_out, dg, dbe = kernels.\
        attn_sublayer_bwd(*_t(g, x, None if self_attn else mem), qkv, a,
                          stats, r, *_t(w_in, ws[3].T.copy(), ln[0], mask,
                                        valid), kind, keypad, H_)
    for t in (dx, dw_in, db_in, dw_out, db_out):
        assert bool(torch.isfinite(t).all())
    dwq, dwk, dwv = (w.T.numpy() for w in dw_in.split(D_))
    dbq, dbk, dbv = db_in.split(D_)
    got_p = [dwq, dbq, dwk, dbk, dwv, dbv, dw_out.T.numpy(), db_out,
             dg, dbe]
    # dbk is exactly zero in exact arithmetic (each softmax gradient sums
    # to zero over the keys): compare against the global gradient scale
    gscale = max(float(jnp.max(jnp.abs(t)))
                 for t in [rdx, *rdp] if t.size) + 1e-9
    for want_dx, want_dmem, want_p, who in ((rdx, rdmem, rdp, "jax.vjp"),
                                            (pdx, pdmem, pdp, "Pallas")):
        _close_scaled(dx.numpy(), want_dx, gscale, 2e-5, f"dx vs {who}")
        if not self_attn:
            _close_scaled(dmem.numpy(), want_dmem, gscale, 2e-5,
                          f"dmem vs {who}")
        for i, (a_, w_) in enumerate(zip(got_p, want_p)):
            if w_.size:
                a_ = None if a_ is None else np.asarray(a_)
                _close_scaled(a_, w_, gscale, 2e-5, f"param {i} vs {who}")
    assert (dmem is None) == self_attn and (dg is None) == (not post_ln)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

def _ffn_params(rng, D, FF, dtype):
    def t(*shape, scale=0.3, shift=0.0):
        return torch.tensor(rng.normal(size=shape) * scale + shift,
                            dtype=dtype, requires_grad=True)
    return (t(FF, D), t(FF, scale=0.05), t(D, FF), t(D, scale=0.05),
            t(D, shift=1.0, scale=0.1), t(D, scale=0.1),
            t(D, shift=1.0, scale=0.1), t(D, scale=0.1))


@pytest.mark.parametrize("pre_ln", [False, True])
def test_ffn_function_gradcheck_and_plain_autograd(rng, pre_ln):
    # one video of 3 tokens at D = 4, FF = 8: a float64 gradcheck in well
    # under a second
    p64 = _ffn_params(rng, 4, 8, torch.float64)
    r64 = torch.tensor(rng.normal(size=(1, 3, 4)), requires_grad=True)
    fn = lambda r, *p: kernels.FFNFunction.apply(r, *p, pre_ln)  # noqa
    assert torch.autograd.gradcheck(fn, (r64, *p64), eps=1e-6, atol=1e-5,
                                    fast_mode=True)

    p32 = _ffn_params(rng, D_, FF_, torch.float32)
    r32 = torch.tensor(rng.normal(size=(2, 5, D_)), dtype=torch.float32,
                       requires_grad=True)
    g = torch.from_numpy(rng.normal(size=(2, 5, D_)).astype(np.float32))
    leaves = (r32, *p32)
    got = torch.autograd.grad(fn(*leaves), leaves, g, allow_unused=True)
    w1t, b1, w2t, b2, g1, be1, g2, be2 = p32
    plain = kernels.ffn_plain(r32, w1t.t(), b1, w2t.t(), b2, g1, be1, g2,
                              be2, pre_ln)
    want = torch.autograd.grad(plain, leaves, g, allow_unused=True)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0, i
            continue
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


def _attn_leaves(rng, D, T, dtype, post_ln, videos=2):
    def t(*shape, scale=0.3, shift=0.0):
        return torch.tensor(rng.normal(size=shape) * scale + shift,
                            dtype=dtype, requires_grad=True)
    x, mem = t(videos, T, D, scale=1.0), t(videos, T, D, scale=1.0)
    ln = (t(D, shift=1.0, scale=0.1), t(D, scale=0.1)) if post_ln \
        else (None, None)
    return x, mem, (t(3 * D, D), t(3 * D, scale=0.05), t(D, D),
                    t(D, scale=0.05), *ln)


@pytest.mark.parametrize("self_attn,kind,keypad,post_ln,all_padded",
                         _CASES[:3])
def test_attn_function_gradcheck_and_plain_autograd(rng, self_attn, kind,
                                                    keypad, post_ln,
                                                    all_padded):
    # one video of 5 frames, 2 heads of 4, its last two keys padded
    T = 5
    mask = torch.tensor([[0, 1, 0, 1, 1]], dtype=torch.float64)
    valid = torch.tensor([[1, 1, 1, 0, 0]], dtype=torch.float64)
    x, mem, p = _attn_leaves(rng, 8, T, torch.float64, post_ln, videos=1)
    memory = None if self_attn else mem

    def fn(x_, m_, *p_):
        return kernels.AttnSublayerFunction.apply(
            x_, m_, *p_, mask, valid, kind, keypad, 2)
    leaves = (x, memory, *p)
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-5,
                                    fast_mode=True)

    x, mem, p = _attn_leaves(rng, D_, T_, torch.float32, post_ln)
    memory = None if self_attn else mem
    mask32 = torch.from_numpy((rng.random((2, T_)) < 0.3).astype(np.float32))
    valid32 = torch.ones(2, T_)
    valid32[1, T_ - 6:] = 0.0
    g = torch.from_numpy(rng.normal(size=(2, T_, D_)).astype(np.float32))
    leaves = [t for t in (x, memory, *p) if t is not None]
    got_y = kernels.AttnSublayerFunction.apply(
        x, memory, *p, mask32, valid32, kind, keypad, H_)
    got = torch.autograd.grad(got_y, leaves, g)
    w_in, b_in, w_out, b_out, ln_w, ln_b = p
    want_y = kernels.attn_sublayer_plain(
        x, memory, w_in.t(), b_in, w_out.t(), b_out, ln_w, ln_b, mask32,
        valid32, kind, keypad, H_)
    want = torch.autograd.grad(want_y, leaves, g)
    torch.testing.assert_close(got_y, want_y, atol=2e-5, rtol=0)
    scale = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a / scale, b / scale, atol=2e-5, rtol=0)
