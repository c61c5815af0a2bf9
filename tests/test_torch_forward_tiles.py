"""The per-sublayer float32 forwards' tiling and launch rules on the CPU.

``csrc/ffn.cu`` runs the FF forward on ``csrc/sgemm.cuh``'s 8 x 8 core in
one of two builds: row tiles of ``row_tile(D)`` rows with D-wide FF chunks
where those tiles fill the card, and otherwise the FF split, tiles of
``FF_SPLIT_ROWS`` rows whose ``FF_SPLIT_COLS``-wide chunks are shared by
``ff_parts`` blocks, their sums added in order by a second pass.  A float64
numpy model of that order (the tiles, chunks and parts read from the CUDA
source and the wrapper) is held against ``ffn_train_plain`` and the JAX
``ffn_reference`` / ``_ffn_reference_with_residuals`` for y, u and z at the
path's row counts, and the wrapper's parts and scratch against the C
entry's rules.  ``csrc/attn_sublayer.cu``'s forward now takes its
attention core and statistics from ``csrc/attention_fwd.cuh``:
``attn_sublayer_train_plain``'s (row max, row sum) and attention output
are held against the float64 model of that core on the packed qkv.  Every
build of both forwards is held to an H100 block's shared memory.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from keypoints_interpolation_transformer_tpu.ops.pallas import ffn as jffn
from keypoints_interpolation_transformer_torch.ops.kernels import (
    _build, attn_sublayer as tasl, ffn as tffn)
from keypoints_interpolation_transformer_torch.ops.kernels.widths import (
    KERNEL_WIDTHS, kernel_width, row_tile)
from test_torch_attention_fwd import tiled_forward

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

TOL = 2e-5  # the JAX kernel tests' f32 forward tolerance
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may have
SMEM_SM = 233472     # an H100 SM's shared memory, 1 KB of it per block
NT = 256             # threads a block (csrc/common.cuh)
LN_EPS = 1e-5


def _source(name):
    return (_build.CSRC / name).read_text()


def _const(name, src):
    m = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert m, name
    return int(m.group(1))


def _rule(name, src):
    """(limit, then, else) of a ``name(int D) { return D <= limit ? then :
    else; }`` rule, as the CUDA build reads it."""
    m = re.search(name + r"\(int \w+\) \{ return \w+ <= (\d+) \? (\d+) : "
                  r"(\d+); \}", src)
    assert m, name
    return tuple(int(g) for g in m.groups())


SGEMM, FFN, ASL = (_source(n) for n in ("sgemm.cuh", "ffn.cu",
                                        "attn_sublayer.cu"))
BK = _const("BK", _source("common.cuh"))
SMS = _const("SMS", SGEMM)
SPLIT_ROWS, SPLIT_COLS = (_const(n, FFN) for n in ("FF_SPLIT_ROWS",
                                                   "FF_SPLIT_COLS"))
PROJ_ROWS, PROJ_COLS = (_const(n, ASL) for n in ("PROJ_ROWS", "PROJ_COLS"))


def _pick(name, D):
    limit, then, other = _rule(name, SGEMM)
    return then if D <= limit else other


def _rows_fill(M, D):
    """``rows_fill`` of csrc/sgemm.cuh, from its constants."""
    rt = _pick("row_tile", D)
    return 2 * -(-M // rt) >= SMS


# ---------------------------------------------------------------------------
# the FF forward: a float64 model of its order
# ---------------------------------------------------------------------------

def _ln(x, g, b, n):
    """LayerNorm over the first n columns, 0 beyond them (g, b zero
    there), as common.cuh's layer_norm."""
    xs = x[:, :n]
    m = xs.mean(1, keepdims=True)
    inv = 1.0 / np.sqrt(((xs - m) ** 2).mean(1, keepdims=True) + LN_EPS)
    out = np.zeros_like(x)
    out[:, :n] = (xs - m) * inv
    return out * g + b


def _gelu(u):
    return 0.5 * u * (1.0 + scipy.special.erf(u / math.sqrt(2.0)))


def _pad(a, *shape):
    out = np.zeros(shape)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def tiled_ffn(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln):
    """(y, u, z) as ``csrc/ffn.cu`` computes them, in float64: the operands
    zero-padded from n to the kernel width D and from FF to a multiple of
    4; x1 = LN1(r) over the first n columns; the build ``ff_parts`` picks
    (D-wide chunks without the split, ``FF_SPLIT_COLS``-wide ones with
    it); per part, the sum over its contiguous share of the chunks of
    gelu(x1 W1_c + b1_c) W2_c, in chunk order; the parts added in order;
    z = x1 + (sum + b2), y = LN2(z); cut back to n and FF."""
    M, n = r.shape
    F = w1.shape[1]
    D, F4 = kernel_width("model", n), -(-F // 4) * 4
    parts = tffn.ff_parts(M, D, F4)
    fc = D if parts == 1 else SPLIT_COLS
    chunks = -(-F4 // fc)
    x = _pad(r, M, D)
    W1, W2 = _pad(w1, D, F4), _pad(w2, F4, D)
    B1, B2 = _pad(b1, F4), _pad(b2, D)
    G1, E1, G2, E2 = (_pad(t, D) for t in (g1, be1, g2, be2))
    x1 = _ln(x, G1, E1, n) if pre_ln else x
    u = x1 @ W1 + B1
    total = None
    for q in range(parts):
        part = np.zeros((M, D))
        for c in range(q * chunks // parts, (q + 1) * chunks // parts):
            cols = slice(c * fc, min((c + 1) * fc, F4))
            part = part + _gelu(u[:, cols]) @ W2[cols]
        total = part if total is None else total + part
    z = x1 + (total + B2)
    y = _ln(z, G2, E2, n)
    return y[:, :n], u[:, :F], z[:, :n]


def _ff_inputs(seed, M, n, F):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale  # noqa: E731
                               ).astype(np.float32)
    u = lambda i, o: rng.uniform(-1, 1, (i, o)).astype(  # noqa: E731
        np.float32) / math.sqrt(i)
    return (f(M, n), u(n, F), f(F, scale=0.05), u(F, n), f(n, scale=0.05),
            1.0 + f(n, scale=0.1), f(n, scale=0.1), 1.0 + f(n, scale=0.1),
            f(n, scale=0.1))


# (M, n, FF, pre_ln): one 128-frame video and the 600-frame request's
# bucket (the split), the A1 step's rows (the row-tile build), at the
# flagship width and a padded one (n < D, FF not a multiple of the chunk)
FF_CASES = [(M, n, F, pre_ln) for M in (128, 608)
            for n, F in ((256, 2048), (200, 1598)) for pre_ln in (True, False)]
FF_CASES += [(8192, 256, 2048, True), (8192, 200, 1598, False)]


@pytest.mark.parametrize("M,n,F,pre_ln", FF_CASES)
def test_tiled_ffn_matches_plain_and_jax(M, n, F, pre_ln):
    """The model's y, u and z against ``ffn_train_plain`` (and its y
    against ``ffn_plain``) and the JAX ``_ffn_reference_with_residuals``
    and ``ffn_reference``, within the JAX tests' forward tolerance."""
    args = _ff_inputs(M + n + pre_ln, M, n, F)
    want = tiled_ffn(*(a.astype(np.float64) for a in args), pre_ln)
    for w in want:
        assert np.isfinite(w).all()
    tt = [torch.from_numpy(a) for a in args]
    plain = tffn.ffn_train_plain(*tt, pre_ln)
    jres = jffn._ffn_reference_with_residuals(*map(jnp.asarray, args),
                                              pre_ln)
    for name, w, p, j in zip("yuz", want, plain, jres):
        np.testing.assert_allclose(p.numpy(), w, atol=TOL, rtol=0,
                                   err_msg=f"plain {name}")
        np.testing.assert_allclose(np.asarray(j), w, atol=TOL, rtol=0,
                                   err_msg=f"jax {name}")
    np.testing.assert_allclose(tffn.ffn_plain(*tt, pre_ln).numpy(), want[0],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        np.asarray(jffn.ffn_reference(*map(jnp.asarray, args), pre_ln)),
        want[0], atol=TOL, rtol=0)


def test_ff_parts_at_the_path_shapes():
    """The rule's constants are the CUDA source's; no split at the serving
    and training batches (B = 256 and 64 at T = 128: 512 and 128 row
    tiles); at one 128-frame video and the 600-frame request's 608 rows
    the split gives 64 blocks (every 128-wide chunk of the four tiles its
    own block) and 247 (two an SM fit at D = 256): at least 64 and one
    wave of the card's 264 block slots, at least one chunk a part."""
    assert (tffn.SMS, tffn.SPLIT_ROWS, tffn.SPLIT_COLS) == (
        SMS, SPLIT_ROWS, SPLIT_COLS)
    assert tffn.ff_parts(64 * 128, 256, 2048) == 1
    assert tffn.ff_parts(256 * 128, 256, 2048) == 1
    assert tffn.ff_parts(128, 256, 2048) == 16
    assert tffn.ff_parts(608, 256, 2048) == 13
    for M, parts in ((128, 16), (608, 13)):
        blocks = -(-M // SPLIT_ROWS) * parts
        assert 64 <= blocks <= 2 * SMS
    for M in (1, 40, 128, 300, 608, 1000, 4095, 4096, 4224, 8192, 32768):
        for D in KERNEL_WIDTHS:
            for F in (4, 100, 1024, 1598, 2048, 4096):
                parts = tffn.ff_parts(M, D, F)
                assert tffn.rows_fill(M, D) == _rows_fill(M, D)
                if _rows_fill(M, D):
                    assert parts == 1
                    continue
                # the C entry's check: at least one chunk a part
                assert 1 <= parts <= -(-F // SPLIT_COLS)
                slots = SMS * (2 if D <= 256 else 1)
                assert parts == 1 or parts * -(-M // SPLIT_ROWS) <= slots
    assert ("parts > (FF + FF_SPLIT_COLS - 1) / FF_SPLIT_COLS" in FFN)


def _capture(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module._build, "bind", lambda name, sigs: None)
    monkeypatch.setattr(module._build, "call",
                        lambda lib, fn, device, *a: calls.append((fn, a)))
    return calls


@pytest.mark.parametrize("D", KERNEL_WIDTHS)
@pytest.mark.parametrize("M", (128, 608, 8192))
@pytest.mark.parametrize("train", (False, True))
def test_ffn_passes_its_parts_and_scratch(monkeypatch, D, M, train):
    """The float32 forward's launch half hands ``kit_ffn`` its widths,
    ``ff_parts`` at the padded widths and, with the split, parts x M x D
    floats of scratch (none without it); the residuals only in
    training."""
    calls = _capture(monkeypatch, tffn)
    g = torch.Generator().manual_seed(D + M)
    n, F = D - 24, 4 * D - 6  # zero-padded to D and to a multiple of 4
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    tffn._launch_forward(r(M, n), r(n, F), r(F), r(F, n), r(n), r(n), r(n),
                         r(n), r(n), train, "f32", None)
    (fn, a), = calls
    assert fn == "kit_ffn"
    assert a[1:6] == (M, D, n, 4 * D - 4, tffn.ff_parts(M, D, 4 * D - 4))
    parts, (y, u, z, scratch) = a[5], a[-4:]
    assert tuple(y.shape) == (M, D)
    assert (u is None, z is None) == (not train, not train)
    if train:
        assert tuple(u.shape) == (M, 4 * D - 4) and tuple(z.shape) == (M, D)
    if parts == 1:
        assert scratch is None
    else:
        assert scratch.numel() == tffn.ff_scratch_floats(M, D, parts) \
            == parts * M * D


def _ff_ring(D, fc):
    """(stages, depth) of ``FfGeo<TN, BM, FC>``'s ring (csrc/ffn.cu): two
    of 2 BK up to D = 256 in the row-tile build (FC = D), else
    sgemm.cuh's ring_stages(D) of BK."""
    assert "DEEP = FC == D && D <= 256;" in FFN
    assert "STAGES = DEEP ? 2 : ring_stages(D);" in FFN
    assert "DEPTH = DEEP ? 2 * BK : BK;" in FFN
    deep = fc == D and D <= 256
    return (2, 2 * BK) if deep else (_pick("ring_stages", D), BK)


def _ff_smem(D, bm, fc):
    """``FfGeo<TN, BM, FC>::SMEM``: x1 and one GELU chunk k-major (row
    stride BM + 4), then the ring of D-wide tiles."""
    stages, depth = _ff_ring(D, fc)
    return 4 * ((D + fc) * (bm + 4) + stages * depth * D)


def _proj_smem(D, bm, np_):
    """``ProjGeo<TN, BM, NP>::SMEM`` (csrc/attn_sublayer.cu): the rows
    k-major, then the ring of BK-deep NP-wide tiles."""
    return 4 * (D * (bm + 4) + _pick("ring_stages", D) * BK * np_)


def _thread_tile(bm, n):
    """Mma<BM, N> (csrc/sgemm.cuh): whole float4 groups of rows and
    columns a thread; its weight tile whole 16-byte copies for 256
    threads."""
    return (bm // 8) % 4 == 0 and (n // 32) % 4 == 0


@pytest.mark.parametrize("D", KERNEL_WIDTHS)
def test_forward_builds_fit_the_card(D):
    """Every build of both forwards at kernel width D: the FF forward's
    row-tile build (``row_tile(D)`` rows, D-wide chunks; two accumulator
    tiles of at most 64 sums a thread) and its split build (two blocks an
    SM up to D = 256, as its launch bounds ask), the projections' row-tile
    and narrow builds; each within an H100 block's shared memory, its
    products whole thread tiles, the split's W1 tiles the ring's size."""
    rt = _pick("row_tile", D)
    assert rt == row_tile(D)
    for bm, fc in ((rt, D), (SPLIT_ROWS, SPLIT_COLS)):
        assert _ff_smem(D, bm, fc) <= SMEM_LIMIT
        assert _thread_tile(bm, fc) and _thread_tile(bm, D)
        assert bm * D // NT <= 64 and bm * fc // NT <= 64
        stages, depth = _ff_ring(D, fc)
        depth1 = depth * D // fc  # FfGeo::DEPTH1
        assert depth1 * fc == depth * D and depth1 % 2 == 0
        assert D % depth1 == 0 and depth * D // 4 % NT == 0 and stages >= 2
    if D <= 256:
        assert 2 * (_ff_smem(D, SPLIT_ROWS, SPLIT_COLS) + 1024) <= SMEM_SM
    assert D % PROJ_COLS == 0
    for bm, np_ in ((rt, D), (PROJ_ROWS, PROJ_COLS), (PROJ_ROWS, D)):
        assert _proj_smem(D, bm, np_) <= SMEM_LIMIT
        assert _thread_tile(bm, np_) and BK * np_ // 4 % NT == 0


def test_projection_grids_at_small_batches():
    """The projections' grid at one 128-frame video: narrow (PROJ_ROWS x
    PROJ_COLS) tiles, one a block, give 24 qkv blocks where row tiles
    (their three parts a block) would give 2; the path batches keep the
    row tiles."""
    D, M = 256, 128
    assert not _rows_fill(M, D)
    assert -(-M // PROJ_ROWS) * (3 * D // PROJ_COLS) == 24
    assert -(-M // row_tile(D)) == 2
    assert "launch_qkv<TN, BR, D, 3>" in ASL
    assert "launch_qkv<TN, PROJ_ROWS, PROJ_COLS, 1>" in ASL
    assert _rows_fill(64 * 128, D) and _rows_fill(256 * 128, D)


# ---------------------------------------------------------------------------
# the attention sublayer's statistics: the per-op forward's core
# ---------------------------------------------------------------------------

VARIANTS = (("enc", None, "repeat-inc", True),
            ("dec", None, "repeat-inc", False),
            ("cross", "memory", "all", False))


@pytest.mark.parametrize("T", (40, 129, 300))
@pytest.mark.parametrize("n,heads", ((64, 4), (128, 4)))
@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_sublayer_stats_match_the_tiled_core(variant, n, heads, T):
    """``attn_sublayer_train_plain``'s (row max, row sum) and attention
    output against the float64 model of ``csrc/attention_fwd.cuh``'s core
    (``tests/test_torch_attention_fwd.py``) on its own packed qkv: the
    sublayer's forward now writes them with that core, so its backward
    rebuilds p from the same score.  Head widths 16 and 32, one to three
    key tiles, a padded tail and a video whose keys are all padded."""
    _, memory, kind, keypad = variant
    B = 3
    rng = np.random.default_rng(T + n)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x, mem = f(B, T, n), f(B, T, n)
    wqkv = (rng.uniform(-1, 1, (n, 3 * n)) / math.sqrt(n)).astype(np.float32)
    wo = (rng.uniform(-1, 1, (n, n)) / math.sqrt(n)).astype(np.float32)
    bqkv, bo = f(3 * n) * 0.05, f(n) * 0.05
    mask = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, T - T // 5:] = 0.0
    valid[2] = 0.0
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y, qkv, a, stats, _ = tasl.attn_sublayer_train_plain(
        t(x), t(mem) if memory else None, t(wqkv), t(bqkv), t(wo), t(bo),
        None, None, t(mask), t(valid), kind, keypad, heads)
    dh = n // heads
    q, k, v = (p.numpy().reshape(B, T, heads, dh)
               for p in qkv.split(n, -1))
    out, mstats = tiled_forward(q, k, v, mask, valid, kind, keypad)
    np.testing.assert_allclose(a.numpy(), out.reshape(B, T, n), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(stats[..., 0].numpy(), mstats[..., 0],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(stats[..., 1].numpy(), mstats[..., 1],
                               rtol=1e-5)
    assert np.isfinite(y.numpy()).all()
    assert (mstats[2, ..., 0] <= -1e9 / 2).all()  # the fully padded video
