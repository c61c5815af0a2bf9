"""The precision modes' tensor-core FF kernels: their order of work and
their launch rules, on the CPU.

``csrc/ffn.cu`` runs "high" (bf16x3) and "default" (one bf16 pass) on
Hopper's warpgroup products fed by a TMA ring (``csrc/mma_bf16.cuh``):

  * the forward (``ffn_tc_kernel``) walks the FF axis in ``FC_TC``-wide
    chunks; u = x1 W1 + b1 sums the mode's passes at every 16-deep step
    into one float32 accumulator, gelu(u) is split into hi / lo bf16 in
    registers and feeds z += h W2 the same way; where its row tiles fill
    less than half the card the chunks of a tile are shared by
    ``tc_parts`` blocks and a second pass adds the parts in order;
  * the backward (``kit_ffn_bwd_split``) writes bf16 planes of dz, gelu(u),
    du and x1 once and runs its four products on one core, the weight
    gradients over ``tc_bwd_splits`` row ranges of whole 64-row steps and
    db1 over the du product's 128-row tiles, added in order.

A float64 numpy model of that order, its operand rounding the kernels'
(tiles, chunks, parts and row ranges read from the CUDA source and the
wrapper), is held against ``ffn_train_plain`` / ``ffn_bwd_split_plain`` in
both modes and against the JAX Pallas kernels (``_kernel_split``,
``_kernel_single``'s bf16 mode, ``_ffn_bwd_kernel_a`` / ``_b`` and the bf16
monolith) in interpret mode, as ``tests/test_torch_precision.py`` runs
them, at ragged row counts and an FF that is no multiple of the chunk.
The wrappers' parts, splits and scratch are held to the C entries' rules,
and every build of both kernels to an H100 block's shared memory.
"""

import contextlib
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import ffn as jffn
from keypoints_interpolation_transformer_torch.ops.kernels import (
    _build, ffn as tffn)
from keypoints_interpolation_transformer_torch.ops.kernels.precision import (
    split_bf16)
from keypoints_interpolation_transformer_torch.ops.kernels.widths import (
    KERNEL_WIDTHS, kernel_width)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

# test_torch_precision.py's tolerances: "high" the same exact bf16
# products summed in another order; "default" also the values that order
# moves across a bf16 rounding boundary, one bf16 step of their term
TOL = {"bf16x3": 2e-5, "bf16": 2e-3}
PREC = {"bf16x3": "high", "bf16": "default"}
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may have
LN_EPS = 1e-5


def _source(name):
    return (_build.CSRC / name).read_text()


# ffn.cu with the headers that hold its tensor-core forward and product
# (shared with layer_modes.cu)
FFN = "".join(_source(n) for n in ("ffn.cu", "ffn_tc.cuh", "tc_gemm.cuh"))
MMA = _source("mma_bf16.cuh")


def _const(name, src):
    m = re.search(r"constexpr int " + name + r" = ([^;]+);", src)
    assert m, name
    return int(eval(m.group(1)))  # a literal or a product of literals


FC = _const("FC_TC", FFN)
TILE = _const("TC_TILE", MMA)
MAX_STAGES = _const("MAX_STAGES", MMA)
TC_SMEM = _const("TC_SMEM", MMA)
STEP = 16  # the k of wgmma m64nNk16 for bf16


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _split(x):
    """hi / lo planes of a float32 array as float64 (the kernels' split)."""
    hi, lo = split_bf16(torch.from_numpy(np.asarray(x, np.float32)))
    return hi.double().numpy(), lo.double().numpy()


def _planes(x, mode):
    hi, lo = _split(x)
    return hi, (lo if mode == "bf16x3" else None)


def _product(a, b, mode):
    """sum over k of A(m, k) B(k, n) as the kernels take it: per 16-deep
    step A_hi B_hi, then (bf16x3) A_hi B_lo and A_lo B_hi, into one sum."""
    ah, al = a
    bh, bl = b
    acc = np.zeros((ah.shape[0], bh.shape[1]))
    for k in range(0, ah.shape[1], STEP):
        s = slice(k, k + STEP)
        acc = acc + ah[:, s] @ bh[s]
        if mode == "bf16x3":
            acc = acc + ah[:, s] @ bl[s] + al[:, s] @ bh[s]
    return acc


def _product_stages(a, b, mode):
    """``tc_gemm_kernel``'s order: the 64-deep stages (each as
    ``_product``) summed into two accumulators, even and odd stages, added
    at the end."""
    acc = [0.0, 0.0]
    for i, k in enumerate(range(0, a[0].shape[1], 64)):
        s = slice(k, k + 64)
        cut = lambda p, rows=False: tuple(  # noqa: E731
            None if x is None else (x[s] if rows else x[:, s]) for x in p)
        acc[i % 2] = acc[i % 2] + _product(cut(a), cut(b, True), mode)
    return acc[0] + acc[1]


def _ln(x, g, b, n):
    xs = x[:, :n]
    m = xs.mean(1, keepdims=True)
    inv = 1.0 / np.sqrt(((xs - m) ** 2).mean(1, keepdims=True) + LN_EPS)
    out = np.zeros_like(x)
    out[:, :n] = (xs - m) * inv
    return out * g + b


def _ln_bwd(dy, x, gamma, n):
    """LayerNorm backward over the first n columns (0 beyond): dx, dgamma,
    dbeta."""
    xs = x[:, :n]
    m = xs.mean(1, keepdims=True)
    inv = 1.0 / np.sqrt(((xs - m) ** 2).mean(1, keepdims=True) + LN_EPS)
    nrm = (xs - m) * inv
    dn = dy[:, :n] * gamma[:n]
    dx = np.zeros_like(x)
    dx[:, :n] = (dn - dn.mean(1, keepdims=True)
                 - nrm * (dn * nrm).mean(1, keepdims=True)) * inv
    dg = np.zeros(x.shape[1])
    db = np.zeros(x.shape[1])
    dg[:n] = (dy[:, :n] * nrm).sum(0)
    db[:n] = dy[:, :n].sum(0)
    return dx, dg, db


def _gelu(u):
    return 0.5 * u * (1.0 + scipy.special.erf(u / math.sqrt(2.0)))


def _gelu_grad(u):
    return (0.5 * (1.0 + scipy.special.erf(u / math.sqrt(2.0)))
            + u * np.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi))


def _pad(a, *shape):
    out = np.zeros(shape)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def tc_forward(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln, mode):
    """(y, u, z) as ``ffn_tc_kernel`` computes them, in float64 over the
    kernels' rounded operands: zero-padded to the kernel width D and FF to a
    multiple of 16; x1 = LN1(r) split once; per part (``tc_parts``), its
    contiguous share of the FC-wide chunks: u = x1 W1_c + b1 (the passes
    per 16-deep step), gelu(u) rounded to float32 and split, z += h W2_c;
    the parts added in order; z = x1 + (sum + b2), y = LN2(z)."""
    M, n = r.shape
    F = w1.shape[1]
    D, F16 = kernel_width("model", n), -(-F // 16) * 16
    parts = tffn.tc_parts(M, D, F16)
    chunks = -(-F16 // FC)
    x = _pad(r, M, D)
    W1, W2 = _pad(w1, D, F16), _pad(w2, F16, D)
    B1, B2 = _pad(b1, F16), _pad(b2, D)
    G1, E1, G2, E2 = (_pad(t, D) for t in (g1, be1, g2, be2))
    x1 = (_ln(x, G1, E1, n) if pre_ln else x).astype(np.float32)
    xp = _planes(x1, mode)
    w1t, w2t = _planes(W1.T, mode), _planes(W2.T, mode)  # torch's layout
    u = np.zeros((M, F16))
    total = None
    for q in range(parts):
        part = np.zeros((M, D))
        for c in range(q * chunks // parts, (q + 1) * chunks // parts):
            cols = slice(c * FC, min((c + 1) * FC, F16))
            w1c = tuple(None if p is None else p[cols].T for p in w1t)
            u[:, cols] = _product(xp, w1c, mode) + B1[cols]
            hp = _planes(_gelu(u[:, cols].astype(np.float32)), mode)
            w2c = tuple(None if p is None else p[:, cols].T for p in w2t)
            part = part + _product(hp, w2c, mode)
        total = part if total is None else total + part
    z = x1 + (total + B2)
    y = _ln(z, G2, E2, n)
    return y[:, :n], u[:, :F], z[:, :n]


def _row_ranges(N, splits):
    """The weight gradients' row ranges: ``csrc/ffn.cu`` tc_gemm's krows,
    whole 64-row steps, the last range ending at N."""
    krows = -(-(-(-N // splits)) // 64) * 64
    return [slice(s * krows, min(N, (s + 1) * krows)) for s in range(splits)
            if s * krows < N]


def tc_backward(g, r, u, z, w1t, w2t, g1, be1, g2, pre_ln, mode):
    """``kit_ffn_bwd_split``'s gradients in float64 over the kernels'
    rounded operands: dz = LN2'(g) and its planes; du = (dz W2^T)
    gelu'(u), then its planes, and gelu(u)'s planes; dW2^T and dW1^T summed
    per row range (``tc_bwd_splits``, whole 64-row steps) and the ranges
    added in order; db1 per 128-row tile, the tiles added in order; dx1 =
    du W1^T + dz; db2 column sums; dr = LN1'(dx1).  Every product in the
    core's order (``_product_stages``)."""
    N, n = r.shape
    F = w1t.shape[0]
    D, F16 = kernel_width("model", n), -(-F // 16) * 16
    G, R, Z = (_pad(a, N, D) for a in (g, r, z))
    U = _pad(u, N, F16)
    W1t, W2t = _pad(w1t, F16, D), _pad(w2t, D, F16)
    G1, E1, G2 = (_pad(t, D) for t in (g1, be1, g2))
    dz, dg2, dbe2 = _ln_bwd(G, Z, G2, n)
    dz = dz.astype(np.float32)
    dzp = _planes(dz, mode)
    hp = _planes(_gelu(U.astype(np.float32)), mode)
    w1p, w2p = _planes(W1t, mode), _planes(W2t, mode)
    du = (_product_stages(dzp, w2p, mode) * _gelu_grad(U)).astype(np.float32)
    dup = _planes(du, mode)
    x1 = (_ln(R, G1, E1, n) if pre_ln else R).astype(np.float32)
    xp = _planes(x1, mode)
    s_w = tffn.tc_bwd_splits(N, D, F16)
    T = lambda p, rows: tuple(None if a is None else a[rows].T  # noqa: E731
                              for a in p)
    R_ = lambda p, rows: tuple(None if a is None else a[rows]  # noqa: E731
                               for a in p)
    dw2t = dw1t = 0.0
    for rows in _row_ranges(N, s_w):
        dw2t = dw2t + _product_stages(T(dzp, rows), R_(hp, rows), mode)
        dw1t = dw1t + _product_stages(T(dup, rows), R_(xp, rows), mode)
    # db1: du's column sums per 128-row tile of the du product, in order
    db1 = 0.0
    for t0 in range(0, N, 128):
        db1 = db1 + du[t0:t0 + 128].sum(0)
    dx1 = _product_stages(dup, w1p, mode) + dz
    if pre_ln:
        dr, dg1, dbe1 = _ln_bwd(dx1, R, G1, n)
    else:
        dr, dg1, dbe1 = dx1, None, None
    cut = lambda a: None if a is None else a[:n]  # noqa: E731
    return (dr[:, :n], dw1t[:F, :n], db1[:F], dw2t[:n, :F],
            dz.sum(0)[:n], cut(dg1), cut(dbe1), dg2[:n], dbe2[:n])


# ---------------------------------------------------------------------------
# the model against the plain versions and the JAX Pallas kernels
# ---------------------------------------------------------------------------

def _inputs(seed, M, n, F):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale  # noqa: E731
                               ).astype(np.float32)
    u = lambda i, o: rng.uniform(-1, 1, (i, o)).astype(  # noqa: E731
        np.float32) / math.sqrt(i)
    return (f(M, n), u(n, F), f(F, scale=0.05), u(F, n), f(n, scale=0.05),
            1.0 + f(n, scale=0.1), f(n, scale=0.1), 1.0 + f(n, scale=0.1),
            f(n, scale=0.1)), f(M, n)


def _close(got, want, tol, what):
    """Within ``tol`` of the larger of 1 and the reference's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0,
                               err_msg=what)


def _grads_close(got, want, mode):
    """Each gradient against its own largest value (some are exactly zero
    in exact arithmetic)."""
    for name, a, b in zip(("dr", "dw1t", "db1", "dw2t", "db2", "dg1",
                           "dbe1", "dg2", "dbe2"), got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = float(np.abs(b).max()) or 1.0
        np.testing.assert_allclose(a / scale, b / scale, atol=TOL[mode],
                                   rtol=0, err_msg=f"{mode} {name}")


# (M, n, FF, pre_ln): one 128-frame video (the FF split), a ragged row
# count, the 600-frame request's bucket; at kernel widths 128 and 256, one
# of them padded (n < D), FF a multiple of the chunk and not
MODEL_CASES = [(128, 128, 512, True), (300, 200, 1000, False),
               (608, 256, 2048, True), (130, 128, 200, True)]


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("M,n,F,pre_ln", MODEL_CASES)
def test_tc_forward_model_matches_plain(M, n, F, pre_ln, mode):
    """The model's y, u and z against ``ffn_train_plain`` in the mode."""
    args, _ = _inputs(M + n + F, M, n, F)
    want = tc_forward(*(a.astype(np.float64) for a in args), pre_ln, mode)
    got = tffn.ffn_train_plain(*(torch.from_numpy(a) for a in args), pre_ln,
                               mode)
    for name, w, p in zip("yuz", want, got):
        assert np.isfinite(w).all()
        _close(p.numpy(), w, TOL[mode], f"{mode} {name}")


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("M,n,F,pre_ln", MODEL_CASES)
def test_tc_backward_model_matches_plain(M, n, F, pre_ln, mode):
    """The model's gradients against ``ffn_bwd_split_plain`` in the mode,
    from the plain forward's residuals."""
    args, g = _inputs(M + n + F + 1, M, n, F)
    tt = [torch.from_numpy(a) for a in args]
    _, u, z = tffn.ffn_train_plain(*tt, pre_ln, mode)
    r, w1, _, w2, _, g1, be1, g2, _ = args
    w1t, w2t = w1.T.copy(), w2.T.copy()
    want = tc_backward(g, r, u.numpy(), z.numpy(), w1t, w2t, g1, be1, g2,
                       pre_ln, mode)
    got = tffn.ffn_bwd_split_plain(
        torch.from_numpy(g), tt[0], u, z, torch.from_numpy(w1t),
        torch.from_numpy(w2t), tt[5], tt[6], tt[7], pre_ln, mode)
    _grads_close([None if t is None else t.numpy() for t in got], want, mode)


@contextlib.contextmanager
def _interpret(prec):
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("M,n,F", [(130, 128, 200), (300, 256, 1000)])
def test_tc_model_matches_pallas(M, n, F, mode):
    """The model against the JAX package's kernels in interpret mode under
    the ambient precision: the forward (``_kernel_split`` at "high",
    ``_kernel_single``'s bf16 mode at "default") and, from its residuals,
    the backward (``_ffn_bwd_kernel_a`` / ``_b`` at "high", the monolith's
    bf16 route at "default")."""
    args, g = _inputs(M * n + F, M, n, F)
    with _interpret(PREC[mode]):
        y, u, z = jffn._ffn_fwd_pallas(*map(jnp.asarray, args), True,
                                       want_residuals=True)
        fn = jffn._ffn_bwd_pallas if mode == "bf16" else \
            jffn._ffn_bwd_pallas_split
        r, w1, b1, w2, b2, g1, be1, g2, be2 = args
        jg = fn(*map(jnp.asarray, (r, g, w1, b1, w2, b2, g1, be1, g2, be2)),
                True, mode, u, z)
    want = tc_forward(*(a.astype(np.float64) for a in args), True, mode)
    for name, w, j in zip("yuz", want, (y, u, z)):
        _close(np.asarray(j), w, TOL[mode], f"{mode} {name}")
    grads = tc_backward(g, r, np.asarray(u), np.asarray(z), w1.T, w2.T, g1,
                        be1, g2, True, mode)
    jax_grads = [np.asarray(t) for t in jg]
    # the JAX backward returns dW1 (D, FF) and dW2 (FF, D), the Flax layout
    jax_grads[1], jax_grads[3] = jax_grads[1].T, jax_grads[3].T
    _grads_close(jax_grads, grads, mode)


# ---------------------------------------------------------------------------
# the launch rules
# ---------------------------------------------------------------------------

def test_tc_constants_are_the_sources():
    """The wrapper's chunk and tile are the CUDA source's; the forward's
    rows a block (``TcFwd::ROWS``), the backward's row ranges of whole
    64-row steps and the C entries' checks."""
    assert tffn.TC_FC == FC == 64
    assert tffn.TC_TILE == 128 and TILE == 64 * 128 * 2
    assert "ROWS = SPLIT_D ? 64 : 128;" in FFN
    assert "SPLIT_D = D > 256;" in FFN
    for D in KERNEL_WIDTHS:
        assert tffn.tc_rows(D) == (64 if D > 256 else 128)
    assert "parts > (FF + FC_TC - 1) / FC_TC" in FFN
    assert "p.krows = round_up((p.K + splits - 1) / splits, 64);" in FFN


def test_tc_parts_at_the_path_shapes():
    """No split at the serving batch (256 tiles of 128 rows); two parts a
    tile at the A1 step's 8192 rows (64 tiles: half the card idle
    without); every chunk its own block at one 128-frame video (one tile,
    32 chunks); 26 parts at the 600-frame request's 608 rows (five tiles,
    130 blocks).  Everywhere: at least one chunk a part, at most about one
    block an SM."""
    sms = tffn.SMS
    assert tffn.tc_parts(256 * 128, 256, 2048) == 1
    assert tffn.tc_parts(64 * 128, 256, 2048) == 2
    assert tffn.tc_parts(128, 256, 2048) == 32
    assert tffn.tc_parts(608, 256, 2048) == 26
    for M in (1, 40, 128, 300, 608, 1000, 4096, 8192, 8448, 32768):
        for D in KERNEL_WIDTHS:
            for F in (16, 208, 1008, 2048, 4096):
                parts = tffn.tc_parts(M, D, F)
                tiles = -(-M // tffn.tc_rows(D))
                assert 1 <= parts <= -(-F // FC)
                if 2 * tiles >= sms:
                    assert parts == 1
                else:
                    assert parts * tiles <= sms or parts == 1


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(tffn._build, "bind", lambda name, sigs: None)
    monkeypatch.setattr(tffn._build, "call",
                        lambda lib, fn, device, *a: calls.append((fn, a)))
    return calls


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("M", (128, 608, 16384))
@pytest.mark.parametrize("D", KERNEL_WIDTHS)
def test_tc_forward_passes_its_parts_and_scratch(monkeypatch, D, M, mode):
    """``kit_ffn_tc`` gets the widths, ``tc_parts`` at the padded widths
    and, with the split, parts x M x D floats of scratch (none without
    it), the planes in torch's layout padded to the kernel widths."""
    calls = _capture(monkeypatch)
    g = torch.Generator().manual_seed(D + M)
    n, F = D - 24, 4 * D - 6  # zero-padded to D and to a multiple of 16
    F16 = -(-F // 16) * 16
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w1, w2 = rnd(n, F), rnd(F, n)
    planes = tffn.ff_weight_planes(w1.t(), w2.t(), mode)
    tffn._launch_forward(rnd(M, n), w1, rnd(F), w2, rnd(n), rnd(n), rnd(n),
                         rnd(n), rnd(n), True, mode, planes)
    (fn, a), = calls
    assert fn == "kit_ffn_tc"
    parts = tffn.tc_parts(M, D, F16)
    assert a[:7] == ({"bf16x3": 3, "bf16": 1}[mode], a[1], M, D, n, F16,
                     parts)
    w1h, w1l, _, w2h, w2l = a[7:12]
    assert tuple(w1h.shape) == (F16, D) and tuple(w2h.shape) == (D, F16)
    assert (w1l is None) == (w2l is None) == (mode == "bf16")
    assert torch.equal(w1h[:F, :n], planes[0])
    assert not (w1h[F:] != 0).any() and not (w1h[:, n:] != 0).any()
    scratch = a[-1]
    if parts == 1:
        assert scratch is None
    else:
        assert scratch.numel() == parts * M * D


def _c_scratch_floats(N, D, FF, s_w1, s_w2, s_vec):
    """``kit_ffn_bwd_split``'s scratch as its note counts it: the LayerNorm
    parts per 32-row block, the weight gradients' per row range, db2's per
    range, db1's per 128-row tile, then the four operand planes (hi and
    lo, two bf16 a float)."""
    return (-(-N // 32) * 4 * D + s_w1 * FF * D + s_w2 * D * FF + s_vec * D
            + -(-N // 128) * FF + N * (2 * D + 2 * FF))


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("N", (40, 608, 2048))
@pytest.mark.parametrize("D", KERNEL_WIDTHS)
def test_tc_backward_passes_its_splits_and_scratch(monkeypatch, D, N, mode):
    """``kit_ffn_bwd_split`` gets the forward's planes (torch's layout, the
    same tensors where no padding is due), ``tc_bwd_splits`` for both
    weight gradients and the scratch its C entry lays out."""
    calls = _capture(monkeypatch)
    gen = torch.Generator().manual_seed(D + N)
    rnd = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    for n, F in ((D, 8 * D), (D - 24, 4 * D - 6)):
        calls.clear()
        F16 = -(-F // 16) * 16
        w1t, w2t = rnd(F, n), rnd(n, F)
        planes = tffn.ff_weight_planes(w1t, w2t, mode)
        tffn._launch_bwd_split(rnd(N, n), rnd(N, n), rnd(N, F), rnd(N, n),
                               planes, rnd(n), rnd(n), rnd(n), True, mode)
        (fn, a), = calls
        assert fn == "kit_ffn_bwd_split"
        assert a[0] == {"bf16x3": 3, "bf16": 1}[mode]
        w1h, w1l, w2h, w2l = a[5:9]
        if (n, F) == (D, F16):
            assert w1h is planes[0] and w2h is planes[2]
        assert tuple(w1h.shape) == (F16, D) and tuple(w2h.shape) == (D, F16)
        assert (w1l is None) == (mode == "bf16")
        N_, D_, n_, FF, s_w1, s_w2, s_vec = a[11:18]
        assert (N_, D_, n_, FF) == (N, D, n, F16)
        assert s_w1 == s_w2 == tffn.tc_bwd_splits(N, D, F16)
        assert 1 <= s_w1 <= tffn.SMS
        assert s_w1 * (D // 128) * -(-F16 // 128) <= tffn.SMS or s_w1 == 1
        scratch = a[-1]
        assert scratch.numel() == _c_scratch_floats(N, D, F16, s_w1, s_w2,
                                                    s_vec)
        # the planes start 16-byte aligned after the float32 partials
        assert (scratch.numel() - N * (2 * D + 2 * F16)) % 4 == 0
        assert "p_db1 + (size_t)tiles * FF" in FFN


def test_row_ranges_cover_the_rows_once():
    """The weight gradients' row ranges: whole 64-row steps except the
    last, in order, covering [0, N) once (an empty range writes zeros)."""
    for N in (1, 40, 64, 65, 608, 1000, 8192):
        for s in (1, 2, 3, 4, 9):
            rows = _row_ranges(N, s)
            assert rows[0].start == 0 and rows[-1].stop == N
            for a, b in zip(rows, rows[1:]):
                assert a.stop == b.start and (a.stop - a.start) % 64 == 0


def _fwd_smem(D, passes):
    """``TcFwd<TN, PASSES>::SMEM``: x1's planes (ROWS x D bf16 each), the
    ring of min(MAX_STAGES, (TC_SMEM - x1) / stage) stages of one TILE a
    plane; z + b2 (ROWS x (D + 8) floats) reuses them; 1 KB to align."""
    rows = 64 if D > 256 else 128
    planes = 2 if passes == 3 else 1
    x1 = rows * D * 2 * planes
    stage = TILE * planes
    stages = min(MAX_STAGES, (TC_SMEM - x1) // stage)
    return stages, max(x1 + stages * stage, rows * (D + 8) * 4) + 1024


def _gemm_smem(passes):
    """``TcGemm<PASSES>::SMEM``: stages of A's and B's tiles."""
    planes = 2 if passes == 3 else 1
    stage = 2 * TILE * planes
    stages = min(MAX_STAGES, TC_SMEM // stage)
    return stages, stages * stage + 1024


@pytest.mark.parametrize("passes", (1, 3))
def test_tc_builds_fit_the_card(passes):
    """Every build of both kernels: at least three stages in the ring,
    within an H100 block's shared memory with the barriers (static, 16
    bytes a stage); the backward's 128 x 128 output tile fits its ring."""
    assert "STAGES = cmin(MAX_STAGES, (TC_SMEM - XP * PLANES) / STAGE);" \
        in FFN
    assert "STAGES = cmin(MAX_STAGES, TC_SMEM / STAGE);" in FFN
    assert TC_SMEM == SMEM_LIMIT - 2048
    for D in KERNEL_WIDTHS:
        stages, smem = _fwd_smem(D, passes)
        assert stages >= 3 and smem + 16 * stages <= SMEM_LIMIT, (D, smem)
    stages, smem = _gemm_smem(passes)
    assert stages >= 3 and smem + 16 * stages <= SMEM_LIMIT
    assert 128 * (128 + 8) * 4 <= smem - 1024


def test_weight_planes_are_torch_layout_splits():
    """``ff_weight_planes`` (what the forward reads, the backward too) is
    the hi / lo split of W1^T (FF, D) and W2^T (D, FF), contiguous; no lo
    planes in "bf16"."""
    g = torch.Generator().manual_seed(3)
    w1t, w2t = torch.randn(200, 96, generator=g), torch.randn(96, 200,
                                                              generator=g)
    w1h, w1l, w2h, w2l = tffn.ff_weight_planes(w1t, w2t, "bf16x3")
    for (h, lo), w in (((w1h, w1l), w1t), ((w2h, w2l), w2t)):
        sh, sl = split_bf16(w)
        assert torch.equal(h, sh) and torch.equal(lo, sl)
        assert h.is_contiguous() and lo.is_contiguous()
    w1h, w1l, w2h, w2l = tffn.ff_weight_planes(w1t, w2t, "bf16")
    assert w1l is None and w2l is None
    assert torch.equal(w1h, w1t.to(torch.bfloat16))
