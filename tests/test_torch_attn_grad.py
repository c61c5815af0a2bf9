"""The training backwards' tiled algorithms and launch rules on the CPU.

``csrc/attention_grad.cuh`` computes the attention core's backward in one
pass per (video, head, key tile); a float64 numpy model of that tiling
(key tiles of ``AB_KT``, query tiles of ``AB_QT``, both read from the
CUDA source; delta from dA and a; P from the forward's saved (row max,
row sum); each key tile's dq part added in the kernel's order) is held
against the attention-core part of the plain version
(``attn_core_bwd_plain``), against ``jax.vjp`` of the JAX package's
attention reference, and, assembled into the whole sublayer's gradients,
against ``jax.vjp`` of ``attn_sublayer_reference``.  The wrappers' row
splits, scratch and the shared memory of every build are held against the
rules read from the CUDA sources.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attention as jatt, attn_sublayer as jasl)
from keypoints_interpolation_transformer_torch.ops.kernels import (
    _build, attn_sublayer as tasl, ffn as tffn)
from keypoints_interpolation_transformer_torch.ops.kernels.widths import (
    KERNEL_WIDTHS, row_tile)
from keypoints_interpolation_transformer_torch.ops.masks import NEG

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may have


def _source(name):
    return (_build.CSRC / name).read_text()


def _const(name, src):
    m = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert m, name
    return int(m.group(1))


AB_KT = _const("AB_KT", _source("attention_grad.cuh"))
AB_QT = _const("AB_QT", _source("attention_grad.cuh"))


def _tiled_heads():
    m = re.search(r"tiled_head\(int dh\) \{ return ([^;]+); \}",
                  _source("attention_grad.cuh"))
    assert m
    return tuple(int(v) for v in re.findall(r"dh == (\d+)", m.group(1)))


# ---------------------------------------------------------------------------
# the one-pass attention core: a float64 model of its tiling
# ---------------------------------------------------------------------------

def tiled_core_bwd(da, qkv, a, stats, mask, valid, kind, add_keypad, heads):
    """(dq, dk, dv), each (B, T, D), as ``attention_grad.cuh`` computes
    them: per (video, head, key tile) the key tile's dk and dv summed over
    the query tiles in order, each query tile's dq part for this key tile,
    and dq the parts added in order of the tiles.  Scores are rounded to
    float32 as the kernel's (and the forward's) are, so a fully padded
    video's scores are NEG to the last bit; the rest is float64."""
    B, T, D = a.shape
    dh = D // heads
    scale = 1.0 / math.sqrt(dh)
    f = lambda t: np.asarray(t, np.float64).reshape(B, T, heads, dh)  # noqa
    q, k, v = (f(t) for t in np.split(np.asarray(qkv), 3, -1))
    g, out = f(da), f(a)
    delta = (g * out).sum(-1)                                  # (B, T, H)
    mask = np.zeros((B, T)) if mask is None else np.asarray(mask)
    valid = np.ones((B, T)) if valid is None else np.asarray(valid)
    qi, kj = np.arange(T)[:, None], np.arange(T)[None, :]
    tiles = -(-T // AB_KT)
    parts = np.zeros((tiles, B, T, heads, dh))
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for b in range(B):
        bias = np.where((kind == "repeat-inc") & (kj > qi)
                        & (mask[b][None, :] > 0), NEG, 0.0)
        if add_keypad:
            bias = bias + mask[b][None, :]
        bias = bias + np.where(valid[b][None, :] > 0, 0.0, NEG)
        for h in range(heads):
            m, l = (np.asarray(stats[b, h, :, i], np.float64)
                    for i in (0, 1))
            for t in range(tiles):
                keys = slice(t * AB_KT, min(T, (t + 1) * AB_KT))
                kt, vt = k[b, keys, h], v[b, keys, h]
                dkt, dvt = np.zeros_like(kt), np.zeros_like(vt)
                for q0 in range(0, T, AB_QT):
                    qs = slice(q0, min(T, q0 + AB_QT))
                    s = (q[b, qs, h] @ kt.T * scale + bias[qs, keys])
                    s = s.astype(np.float32).astype(np.float64)
                    p = np.exp(s - m[qs, None]) / l[qs, None]
                    dp = g[b, qs, h] @ vt.T
                    ds = p * (dp - delta[b, qs, h][:, None])
                    dvt += p.T @ g[b, qs, h]
                    dkt += ds.T @ q[b, qs, h]
                    parts[t, b, qs, h] = ds @ kt * scale
                dk[b, keys, h], dv[b, keys, h] = dkt * scale, dvt
    dq = parts[0]
    for t in range(1, tiles):
        dq = dq + parts[t]
    return tuple(x.reshape(B, T, D) for x in (dq, dk, dv))


def _inputs(rng, B, T, D, heads, cross, post_ln, kind, keypad):
    """The sublayer's operands and its plain training forward's
    residuals: keys padded at the end of the last video, every key of the
    first video padded where B > 1."""
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mem = rng.normal(size=(B, T, D)).astype(np.float32) if cross else None
    ws = [(rng.normal(size=(D, D)) / math.sqrt(D)).astype(np.float32)
          for _ in range(4)]
    bs = [(rng.normal(size=(D,)) * 0.05).astype(np.float32)
          for _ in range(4)]
    ln = ((1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
          (0.1 * rng.normal(size=(D,))).astype(np.float32)) if post_ln \
        else (None, None)
    mask = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[-1, T - max(T // 5, 1):] = 0.0
    if B > 1:
        valid[0] = 0.0
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    _, qkv, a, stats, r = tasl.attn_sublayer_train_plain(
        t(x), t(mem), t(np.concatenate(ws[:3], 1)), t(np.concatenate(bs[:3])),
        t(ws[3]), t(bs[3]), t(ln[0]), t(ln[1]), t(mask), t(valid), kind,
        keypad, heads)
    return x, mem, ws, bs, ln, mask, valid, qkv, a, stats, r


_CORE = [(kind, keypad) for kind in ("repeat-inc", "all")
         for keypad in (True, False)]


@pytest.mark.parametrize("T", (5, 40, 128, 200, 300, 512))
@pytest.mark.parametrize("kind,keypad", _CORE)
def test_tiled_core_matches_plain_and_vjp(rng, T, kind, keypad):
    """The model's dq, dk and dv against the plain core and against
    ``jax.vjp`` of the JAX attention reference, given dA and the forward's
    residuals; 1 to 4 key tiles, a video whose keys are all padded and one
    with a padded tail, cross-attention at T = 5 and 300."""
    B, D, H = 2, 16, 2
    x, mem, ws, bs, ln, mask, valid, qkv, a, stats, _ = _inputs(
        rng, B, T, D, H, T in (5, 300), False, kind, keypad)
    da = rng.normal(size=(B, T, D)).astype(np.float32)
    got = tiled_core_bwd(da, qkv, a, stats, mask, valid, kind, keypad, H)
    plain = tasl.attn_core_bwd_plain(torch.from_numpy(da), qkv, a, stats,
                                     torch.from_numpy(mask),
                                     torch.from_numpy(valid), kind, keypad,
                                     H)
    q, k, v = (jnp.asarray(t.numpy().reshape(B, T, H, D // H))
               for t in qkv.split(D, -1))
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda q_, k_, v_: jatt._xla_attention(
            q_, k_, v_, jnp.asarray(mask), jnp.asarray(valid), kind,
            keypad)[0], q, k, v)
        want = vjp(jnp.asarray(da.reshape(B, T, H, D // H)))
    scale = max(float(np.abs(w).max()) for w in want)
    for name, mine, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        w = np.asarray(w).reshape(B, T, D)
        np.testing.assert_allclose(mine / scale, p.numpy() / scale,
                                   atol=2e-6, err_msg=f"{name} vs plain")
        np.testing.assert_allclose(mine / scale, w / scale, atol=2e-6,
                                   err_msg=f"{name} vs jax.vjp")


@pytest.mark.parametrize("cross,post_ln,kind,keypad", [
    (False, True, "repeat-inc", False), (False, False, "repeat-inc", True),
    (True, False, "all", False)])
def test_tiled_sublayer_gradients_match_vjp(rng, cross, post_ln, kind,
                                            keypad):
    """The whole sublayer's gradients with the modelled core (two key
    tiles) and the kernel's order of the rest (LN backward, da = dr Wo^T,
    the weight and bias gradients, dx and dmem) against ``jax.vjp`` of
    ``attn_sublayer_reference``."""
    B, T, D, H = 2, 200, 16, 4
    x, mem, ws, bs, ln, mask, valid, qkv, a, stats, r = _inputs(
        rng, B, T, D, H, cross, post_ln, kind, keypad)
    dy = rng.normal(size=(B, T, D)).astype(np.float32)
    g = torch.from_numpy(dy.reshape(-1, D))
    if post_ln:
        g, dg, dbe = tffn._ln_bwd_plain(g, r.reshape(-1, D),
                                        torch.from_numpy(ln[0]))
    dr = g.double().numpy()
    da = (dr @ ws[3].T.astype(np.float64)).reshape(B, T, D)
    dq, dk, dv = (t.reshape(-1, D) for t in tiled_core_bwd(
        da, qkv, a, stats, mask, valid, kind, keypad, H))
    xf = x.reshape(-1, D).astype(np.float64)
    mf = xf if mem is None else mem.reshape(-1, D).astype(np.float64)
    af = a.numpy().reshape(-1, D).astype(np.float64)
    mine = {"wq": xf.T @ dq, "bq": dq.sum(0), "wk": mf.T @ dk,
            "bk": dk.sum(0), "wv": mf.T @ dv, "bv": dv.sum(0),
            "wo": af.T @ dr, "bo": dr.sum(0)}
    dx = dr + dq @ ws[0].T
    dkv = dk @ ws[1].T + dv @ ws[2].T
    dmem = None if mem is None else dkv.reshape(B, T, D)
    if mem is None:
        dx = dx + dkv
    params = (*(jnp.asarray(t) for t in (ws[0], bs[0], ws[1], bs[1], ws[2],
                                         bs[2], ws[3], bs[3])),
              *((jnp.asarray(ln[0]), jnp.asarray(ln[1])) if post_ln else
                (jnp.zeros((0,), jnp.float32),) * 2))

    def ref(x_, m_, p_):
        return jasl.attn_sublayer_reference(
            x_, m_, p_, jnp.asarray(mask), jnp.asarray(valid), kind, keypad,
            post_ln, H)
    with jax.default_matmul_precision("highest"):
        if mem is None:
            _, vjp = jax.vjp(lambda x_, p_: ref(x_, None, p_),
                             jnp.asarray(x), params)
            wdx, wp = vjp(jnp.asarray(dy))
            wdmem = None
        else:
            _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(mem), params)
            wdx, wdmem, wp = vjp(jnp.asarray(dy))
    scale = max(float(jnp.abs(t).max()) for t in (wdx, *wp) if t.size)
    np.testing.assert_allclose(dx.reshape(B, T, D) / scale,
                               np.asarray(wdx) / scale, atol=2e-5)
    if mem is not None:
        np.testing.assert_allclose(dmem / scale, np.asarray(wdmem) / scale,
                                   atol=2e-5)
    for i, name in enumerate(("wq", "bq", "wk", "bk", "wv", "bv", "wo",
                              "bo")):
        np.testing.assert_allclose(mine[name] / scale,
                                   np.asarray(wp[i]) / scale, atol=2e-5,
                                   err_msg=name)
    if post_ln:
        for got_, want_ in ((dg, wp[8]), (dbe, wp[9])):
            np.testing.assert_allclose(got_.numpy() / scale,
                                       np.asarray(want_) / scale, atol=2e-5)


# ---------------------------------------------------------------------------
# the launch rules, read from the CUDA sources
# ---------------------------------------------------------------------------

SGEMM = _source("sgemm_grad.cuh")
SD = _const("SD", SGEMM)
BK = _const("BK", _source("common.cuh"))


def _rule(name, src):
    """(limit, then, else) of a ``name(int N) { return N <= limit ? then :
    else; }`` rule, as the CUDA build reads it."""
    m = re.search(name + r"\(int \w+\) \{ return \w+ <= (\d+) \? (\d+) : "
                  r"(\d+); \}", src)
    assert m, name
    return tuple(int(g) for g in m.groups())


def _stages(n):
    limit, many, few = _rule("grad_stages", SGEMM)
    return many if n <= limit else few


def _stream_bytes(bm, n, a_rows):
    """``Stream<BM, N, A_ROWS>::SMEM`` (csrc/sgemm_grad.cuh): the ring of
    A and B tiles, then two k-major A tiles."""
    a_land = bm * (SD + 4) if a_rows else SD * bm
    return 4 * (_stages(n) * (a_land + SD * n) + 2 * SD * (bm + 4))


def _resident_bytes(bm, n, d):
    """``Resident<BM, N, D>::SMEM``: the A tile k-major, sgemm.cuh's
    3-stage ring of BK-deep W tiles, the epilogue's u tile."""
    return 4 * (d * (bm + 4) + 3 * BK * n + bm * n)


def test_tiled_core_rules_are_the_builds():
    """The wrapper's key tile and tiled head widths are the CUDA build's,
    and each build of the core fits an H100 block's shared memory
    (``AbTiles`` in csrc/attention_grad.cuh)."""
    assert tasl.KEY_TILE == AB_KT and AB_KT % 4 == 0
    assert tasl.TILED_HEADS == _tiled_heads() == (16, 32, 64)
    assert AB_QT * 8 == 256  # the dq tile: one query per 8 threads
    # S and dP on sgemm.cuh's thread layout: 4 x 4 sums a thread; dv and dk
    # at 4 keys a thread, 32 of them
    assert (AB_QT // 8) % 4 == 0 and (AB_KT // 32) % 4 == 0
    assert AB_KT == 4 * 32
    for dh in tasl.TILED_HEADS:
        ldh, ldq, ldp = dh + 4, AB_QT + 4, AB_KT + 4
        floats = (2 * dh * AB_KT + AB_KT * ldh + 2 * dh * ldq
                  + 2 * AB_QT * ldh + 2 * AB_QT * ldp + 2 * AB_KT
                  + 3 * AB_QT)
        assert floats * 4 <= SMEM_LIMIT and dh % 8 == 0
        assert 32 % (dh // 4) == 0  # delta's lanes of a query in one warp


@pytest.mark.parametrize("D", KERNEL_WIDTHS)
def test_streamed_products_fit_an_sm(D):
    """The builds of the backward products at kernel width D: the streamed
    row-major products and the weight gradients at (row_tile(D), D), du's
    with its A tile resident (resident_rows(D) x 256 tiles); each within an
    H100 block's shared memory, its thread tile whole float4 groups (Mma in
    csrc/sgemm.cuh), its B tile whole 16-byte copies for 256 threads, at
    most 64 sums a thread, and a k-major A's column groups one a thread."""
    bm = row_tile(D)
    for rows, n, a_rows in ((bm, D, True), (bm, D, False)):
        assert _stream_bytes(rows, n, a_rows) <= SMEM_LIMIT
        assert (rows // 8) % 4 == 0 and (n // 32) % 4 == 0
        assert SD * n // 4 % 256 == 0
        assert rows * n // 256 <= 64
        assert 256 % (rows // 4) == 0
        assert _stages(n) >= 3
    limit, tall, short = _rule("resident_rows", SGEMM)
    rows = tall if D <= limit else short
    assert _resident_bytes(rows, 256, D) <= SMEM_LIMIT
    assert (rows // 8) % 4 == 0 and rows * 256 // 4 % 256 == 0
    assert SD % 4 == 0 and D % BK == 0


def _capture(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module._build, "bind", lambda name, sigs: None)
    monkeypatch.setattr(module._build, "call",
                        lambda lib, fn, device, *a: calls.append((fn, a)))
    return calls


def _splits_cover(rows, splits):
    """Every split of ``rows`` (grad.cuh ``rows_per_split``) starts inside
    the rows, and together they cover them."""
    per = (-(-rows // splits) + 31) // 32 * 32
    return per * splits >= rows and per * (splits - 1) < rows + per


@pytest.mark.parametrize("D", KERNEL_WIDTHS)
@pytest.mark.parametrize("N", (1, 77, 8192))
def test_ffn_bwd_passes_its_splits_and_scratch(monkeypatch, D, N):
    """``ffn_bwd``'s launch half hands ``kit_ffn_bwd`` the splits of its
    [dW1^T | dW2^T] launch (2 FF / row_tile(D) row tiles, one wave of the
    card's 132 SMs) and the scratch its C entry lays out: the two
    LayerNorms' sums per 32-row block, 2 FF D + FF per split (the weight
    gradients and db1), db2's per 64-row tile."""
    calls = _capture(monkeypatch, tffn)
    g = torch.Generator().manual_seed(D + N)
    n, F = D - 24, 4 * D - 8  # zero-padded to D and to a multiple of 4
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    tffn._launch_backward(r(N, n), r(N, n), r(N, F), r(N, n), r(F, n),
                          r(n, F), r(n), r(n), r(n), True)
    (fn, a), = calls
    assert fn == "kit_ffn_bwd"
    M, Dk, nk, FF, splits = a[8:13]
    assert (M, Dk, nk, FF) == (N, D, n, 4 * D - 8)
    tiles = 2 * -(-FF // row_tile(D))
    assert splits == max(1, min(132 // tiles, N // 256))
    assert splits * tiles <= 132 or splits == 1
    assert _splits_cover(N, splits)
    scratch = a[-1]
    limit, tall, short = _rule("resident_rows", SGEMM)
    rows = tall if D <= limit else short
    assert tffn.du_rows(D) == rows
    assert scratch.numel() == (-(-N // 32) * 4 * D
                               + splits * (2 * FF * D + FF)
                               + -(-N // rows) * D)
    du = a[16]
    assert tuple(du.shape) == (N, FF)


@pytest.mark.parametrize("D", KERNEL_WIDTHS)
@pytest.mark.parametrize("B,T,heads", [(1, 40, 8), (3, 130, 16),
                                       (2, 300, 4), (1, 512, 1)])
def test_attn_sublayer_bwd_passes_its_splits_and_scratch(monkeypatch, D, B,
                                                         T, heads):
    """``attn_sublayer_bwd``'s launch half hands its C entry the splits of
    the [dW_in^T | dW_out^T] launch (4 D / row_tile(D) row tiles, one wave
    of the card) and the scratch ``kit_attn_sublayer_bwd`` lays out, with a
    dq part per key tile where the head width takes the one-pass core and
    T spans more than one key tile."""
    calls = _capture(monkeypatch, tasl)
    g = torch.Generator().manual_seed(D + T)
    n = D if D % heads == 0 and D // heads <= 512 else D - D % heads
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    M = B * T
    tasl._launch_backward(r(B, T, n), r(B, T, n), None, r(B, T, 3 * n),
                          r(B, T, n), r(B, heads, T, 2), None, r(3 * n, n),
                          r(n, n), None, r(B, T), r(B, T), "repeat-inc",
                          True, heads)
    (fn, a), = calls
    assert fn == "kit_attn_sublayer_bwd"
    assert a[12:17] == (B, T, D, n, heads)
    s_w = a[19]
    tiles = 4 * D // row_tile(D)
    assert s_w == max(1, min(132 // tiles, M // 256))
    assert _splits_cover(M, s_w)
    dh = n // heads
    key_tiles = -(-T // AB_KT)
    parts = key_tiles * M * D if dh in _tiled_heads() and key_tiles > 1 \
        else 0
    assert a[-1].numel() == (5 * M * D + -(-B * heads * T // 4) * 4
                             + -(-M // 32) * 2 * D
                             + s_w * (4 * D * D + 4 * D) + parts)
