"""The per-op attention forward's register tiling and its statistics
contract with the backward, on the CPU.

``csrc/attention_fwd.cuh`` computes the forward per (64 queries, head,
video): key tiles of ``AF_KT``, each row's max over the warp's lanes, the
online rescale, each lane's share of the row sum and each key group's
share of the output, added at the end, and writes (row max, row sum) for
the backward, which rebuilds p = exp(s - m) / l from them
(``csrc/attention_grad.cuh``).  A float64 numpy model of that tiling (the
tiles and groups read from the CUDA source) is held against
``attention_plain``, the JAX ``xla_attention`` and the Pallas
``fused_attention`` in interpret mode; the plain forward's statistics and
the residual form of the plain backward against ``jax.vjp``;
``AttentionFunction``'s saved residuals; the wrappers' scratch and every
build's shared memory against the rules read from the CUDA sources.
"""

import contextlib
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attention as jattn)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    _build, attention as tatt, attn_sublayer as tasl)
from keypoints_interpolation_transformer_torch.ops.masks import NEG

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

TOL = 2e-5  # the JAX kernel tests' f32 forward and gradient tolerance
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may have
SMEM_SM = 233472     # an H100 SM's shared memory, 1 KB of it per block
NT = 256             # threads a block (csrc/common.cuh)
B, H, DH = 3, 2, 16
# the mask variants of chip_smoke.KernelCheck.per_op_calls: (name, kind,
# add_keypad, mask): the encoder's, the decoder's, the Cycle model's
# (all-ones masks added), cross-attention (padding only)
VARIANTS = (("enc", "repeat-inc", True, "frames"),
            ("dec", "repeat-inc", False, "frames"),
            ("cycle", "all", True, "ones"),
            ("cross", "all", False, None))


def _source(name):
    return (_build.CSRC / name).read_text()


def _const(name, src):
    m = re.search(r"constexpr int " + name + r" = (\d+);", src)
    assert m, name
    return int(m.group(1))


FWD = _source("attention_fwd.cuh")
AF_QT, AF_KT = _const("AF_QT", FWD), _const("AF_KT", FWD)
AB_KT = _const("AB_KT", _source("attention_grad.cuh"))


def _tiled_heads():
    m = re.search(r"tiled_head\(int dh\) \{ return ([^;]+); \}",
                  _source("attention_grad.cuh"))
    assert m
    return tuple(int(v) for v in re.findall(r"dh == (\d+)", m.group(1)))


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


def _bias(b, mask, valid, kind, add_keypad, rows, keys):
    """key_bias (csrc/attention.cuh) of video b for query rows x keys."""
    qi, kj = rows[:, None], keys[None, :]
    km = mask[b][np.minimum(keys, mask.shape[1] - 1)][None, :]
    kv = valid[b][np.minimum(keys, valid.shape[1] - 1)][None, :]
    bias = np.where((kind == "repeat-inc") & (kj > qi) & (km > 0), NEG, 0.0)
    if add_keypad:
        bias = bias + km
    return bias + np.where(kv > 0, 0.0, NEG)


def tiled_forward(q, k, v, mask, valid, kind, add_keypad):
    """(out (B, T, H, dh), stats (B, H, T, 2)) as ``attention_fwd.cuh``
    computes them: per (video, head, AF_QT queries, padded with zero rows)
    the key tiles of AF_KT in order (keys at or past T -inf), each tile's
    row max, the running max, the rescale of each lane's share of the row
    sum (lane j: keys j + 32 u) and of each key group's share of the output
    (group g of 128 / dh: the chunks of 4 keys g, g + 128 / dh, ...), then
    the shares added.  Scores are rounded to float32 as the kernel's are;
    the rest is float64."""
    Bq, T, Hq, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    kg = 32 // (dh // 4)
    mask = np.zeros((Bq, T)) if mask is None else np.asarray(mask)
    valid = np.ones((Bq, T)) if valid is None else np.asarray(valid)
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    out = np.zeros_like(q)
    stats = np.zeros((Bq, Hq, T, 2))
    for b in range(Bq):
        for h in range(Hq):
            for q0 in range(0, T, AF_QT):
                rows = q0 + np.arange(AF_QT)
                live = rows < T
                qt = np.zeros((AF_QT, dh))
                qt[live] = q[b, rows[live], h]
                m = np.full(AF_QT, -np.inf)
                lane_l = np.zeros((AF_QT, 32))
                group_o = np.zeros((AF_QT, kg, dh))
                for k0 in range(0, T, AF_KT):
                    keys = k0 + np.arange(AF_KT)
                    kin = keys < T
                    kt, vt = np.zeros((AF_KT, dh)), np.zeros((AF_KT, dh))
                    kt[kin], vt[kin] = k[b, keys[kin], h], v[b, keys[kin], h]
                    s = qt @ kt.T * scale + _bias(b, mask, valid, kind,
                                                  add_keypad, rows, keys)
                    s = s.astype(np.float32).astype(np.float64)
                    s[:, ~kin] = -np.inf
                    mnew = np.maximum(m, s.max(1))
                    corr = np.exp(m - mnew)
                    m = mnew
                    lane_l *= corr[:, None]
                    group_o *= corr[:, None, None]
                    p = np.exp(s - mnew[:, None])
                    lane_l += p.reshape(AF_QT, AF_KT // 32, 32).sum(1)
                    for g in range(kg):
                        chunks = np.arange(g, AF_KT // 4, kg)
                        sel = (4 * chunks[:, None] + np.arange(4)).ravel()
                        group_o[:, g] += p[:, sel] @ vt[sel]
                l = lane_l.sum(1)
                o = group_o.sum(1) / l[:, None]
                out[b, rows[live], h] = o[live]
                stats[b, h, rows[live]] = np.stack([m, l], -1)[live]
    return out, stats


def _inputs(seed, T, variant, dh=DH):
    """q, k, v, g (B, T, H, dh); the variant's mask; valid with a padded
    tail in video 1 and every key of video 2 padded."""
    _, kind, keypad, masks = variant
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
                  for _ in range(4))
    frames = (rng.random((B, T)) < 0.3).astype(np.float32)
    mask = {"frames": frames, "ones": np.ones((B, T), np.float32),
            None: None}[masks]
    valid = np.ones((B, T), np.float32)
    valid[1, T - max(T // 5, 1):] = 0.0
    valid[2] = 0.0
    return q, k, v, g, mask, valid, kind, keypad


def _t(*a):
    return [None if x is None else torch.from_numpy(np.array(x)) for x in a]


def _jax_mask(mask, T):
    return jnp.zeros((B, T), jnp.float32) if mask is None else \
        jnp.asarray(mask)


@pytest.mark.parametrize("T", (5, 40, 128, 129, 300, 608))
def test_tiled_forward_matches_plain_and_jax(T):
    """The model's out and stats against ``attention_plain`` (its
    statistics form), the JAX ``xla_attention`` and the Pallas kernel in
    interpret mode, for every mask variant: one to five key tiles, padded
    query rows, a padded tail and a video whose keys are all padded (its
    rows average v uniformly over the keys repeat-inc leaves them)."""
    for variant in VARIANTS:
        q, k, v, _, mask, valid, kind, keypad = _inputs(T, T, variant)
        out, stats = tiled_forward(q, k, v, mask, valid, kind, keypad)
        assert np.isfinite(out).all() and np.isfinite(stats).all()
        pout, pstats = kernels.attention_plain(*_t(q, k, v, mask, valid),
                                               kind, keypad, stats=True)
        np.testing.assert_allclose(out, pout.numpy(), atol=TOL, rtol=0,
                                   err_msg=variant[0])
        np.testing.assert_allclose(stats[..., 0], pstats[..., 0].numpy(),
                                   rtol=1e-6, atol=1e-5, err_msg=variant[0])
        np.testing.assert_allclose(stats[..., 1], pstats[..., 1].numpy(),
                                   rtol=1e-5, err_msg=variant[0])
        # the plain forward's two forms agree
        np.testing.assert_allclose(
            kernels.attention_plain(*_t(q, k, v, mask, valid), kind,
                                    keypad).numpy(), pout.numpy(),
            atol=1e-6, rtol=0)
        jargs = (*map(jnp.asarray, (q, k, v)), _jax_mask(mask, T),
                 jnp.asarray(valid), kind, keypad)
        np.testing.assert_allclose(out, np.asarray(jattn.xla_attention(
            *jargs)), atol=TOL, rtol=0, err_msg=variant[0])
        with _interpret():
            pallas = np.asarray(jattn.fused_attention(*jargs))
        np.testing.assert_allclose(out, pallas, atol=TOL, rtol=0,
                                   err_msg=variant[0])
        allowed = np.ones((T, T))
        if kind == "repeat-inc":
            allowed = ~((np.arange(T)[None] > np.arange(T)[:, None])
                        & (mask[2][None] > 0))
        uniform = allowed / allowed.sum(1, keepdims=True)
        np.testing.assert_allclose(out[2], np.einsum("qk,khd->qhd", uniform,
                                                     v[2]), atol=1e-5)
        # a fully blocked row: its max is the blocker, its sum the count
        # of the keys at it, both kept apart (m + log l would round log l
        # away)
        assert (stats[2, ..., 0] <= NEG / 2).all()
        np.testing.assert_allclose(stats[2, ..., 1],
                                   np.broadcast_to(allowed.sum(1), (H, T)))


@pytest.mark.parametrize("T", (40, 129))
@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_residual_backward_matches_jax_vjp(T, variant):
    """The plain backward given the plain forward's out and stats (p
    rebuilt from them), the standalone plain backward, and the one-pass
    core's plain version (``attn_core_bwd_plain``, which
    ``csrc/attention_grad.cuh`` computes) given the modelled forward's out
    and stats, each against ``jax.vjp`` of ``xla_attention``."""
    q, k, v, g, mask, valid, kind, keypad = _inputs(1000 + T, T, variant)
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn.xla_attention(
        q_, k_, v_, _jax_mask(mask, T), jnp.asarray(valid), kind, keypad),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    scale = max(float(np.abs(w).max()) for w in want)
    tq, tk, tv, tg, tm, tval = _t(q, k, v, g, mask, valid)
    out, stats = kernels.attention_plain(tq, tk, tv, tm, tval, kind, keypad,
                                         stats=True)
    mout, mstats = tiled_forward(q, k, v, mask, valid, kind, keypad)
    D = H * DH
    qkv = torch.cat([t.reshape(B, T, D) for t in (tq, tk, tv)], -1)
    core = tasl.attn_core_bwd_plain(
        tg.reshape(B, T, D), qkv, torch.from_numpy(mout.astype(np.float32))
        .reshape(B, T, D), torch.from_numpy(mstats.astype(np.float32)), tm,
        tval, kind, keypad, H)
    for form, got in (
            ("given", kernels.attention_bwd_plain(tq, tk, tv, tg, tm, tval,
                                                  kind, keypad, out, stats)),
            ("standalone", kernels.attention_bwd_plain(tq, tk, tv, tg, tm,
                                                       tval, kind, keypad)),
            ("core", [t.reshape(B, T, H, DH) for t in core])):
        for name, a, w in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy() / scale,
                                       np.asarray(w) / scale, atol=TOL,
                                       rtol=0, err_msg=f"{form} d{name}")


def test_attention_function_saves_the_forward_residuals(monkeypatch):
    """``AttentionFunction`` saves q, k, v, the masks and the forward's out
    and stats, and its backward hands the last two to ``attention_bwd``;
    its gradients match ``jax.vjp``."""
    variant = VARIANTS[0]
    T = 40
    q, k, v, g, mask, valid, kind, keypad = _inputs(7, T, variant)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tm, tval = _t(mask, valid)
    seen = []
    real = tatt.attention_bwd

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(tatt, "attention_bwd", spy)
    out = kernels.AttentionFunction.apply(tq, tk, tv, tm, tval, kind, keypad)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7
    want_out, want_stats = kernels.attention_plain(*_t(q, k, v, mask, valid),
                                                   kind, keypad, stats=True)
    torch.testing.assert_close(saved[5], want_out, atol=0, rtol=0)
    torch.testing.assert_close(saved[6], want_stats, atol=0, rtol=0)
    assert tuple(saved[6].shape) == (B, H, T, 2)
    out.backward(torch.from_numpy(g))
    assert len(seen) == 1 and seen[0]["out"] is not None \
        and seen[0]["stats"] is not None
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn.xla_attention(
        q_, k_, v_, jnp.asarray(mask), jnp.asarray(valid), kind, keypad),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    scale = max(float(np.abs(w).max()) for w in want)
    for name, a, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(w) / scale,
                                   atol=TOL, rtol=0, err_msg=f"d{name}")
    with pytest.raises(ValueError, match="together"):
        kernels.attention_bwd(*_t(q, k, v, g, mask, valid), kind, keypad,
                              out=want_out)


def _fwd_bytes(dh, slots):
    """``AfTiles<DH>::bytes`` (csrc/attention_fwd.cuh): the query and P
    tiles, then the ring's slots of k and v rows (stride dh + 4) and the
    keys' mask and valid values."""
    ldh, ldp = dh + 4, AF_KT + 4
    return 4 * (AF_QT * ldh + AF_QT * ldp + slots * (2 * AF_KT * ldh
                                                     + 2 * AF_KT))


def test_forward_tiles_fit_the_card():
    """The forward's tiles are whole warps and lanes (8 rows a warp, 4
    keys a lane, one mask or valid value a thread, dh / 4 column groups
    dividing the warp); each tiled build fits an H100 block's shared
    memory with its two-slot ring, and two blocks an SM with one slot
    (T <= 128) at dh <= 32, as its launch bounds ask; the lanes' k rows
    (stride dh + 4) of a quarter-warp fall on distinct banks."""
    assert _tiled_heads() == tasl.TILED_HEADS == (16, 32, 64)
    assert AF_QT == 8 * (NT // 32) and AF_KT == 4 * 32 and 2 * AF_KT == NT
    assert AF_KT == AB_KT == tasl.KEY_TILE
    for dh in tasl.TILED_HEADS:
        cg = dh // 4
        assert 32 % cg == 0 and (AF_KT // 4) % (32 // cg) == 0
        assert _fwd_bytes(dh, 2) <= SMEM_LIMIT
        if dh <= 32:
            assert 2 * (_fwd_bytes(dh, 1) + 1024) <= SMEM_SM
        banks = {(j * (dh + 4)) % 32 for j in range(8)}
        assert len(banks) == 8 and all(b_ % 4 == 0 for b_ in banks)
    assert re.search(r"__launch_bounds__\(NT, DH <= 32 \? 2 : 1\)", FWD)
    assert re.search(r"bytes\(a\.T > AF_KT \? 2 : 1\)", FWD)


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(tatt._build, "bind", lambda name, sigs: None)
    monkeypatch.setattr(tatt._build, "call",
                        lambda lib, fn, device, *a: calls.append((fn, a)))
    return calls


@pytest.mark.parametrize("dh", (16, 32, 64, 8, 48))
@pytest.mark.parametrize("T", (40, 128, 129, 608))
@pytest.mark.parametrize("given", (True, False))
def test_wrappers_pass_their_scratch(monkeypatch, dh, T, given):
    """The launch halves hand ``kit_attention`` the stats tensor (B, H, T,
    2) and ``kit_attention_bwd`` the residuals and the scratch its C entry
    lays out (``bwd_scratch`` in csrc/attention.cu), each part a multiple
    of 4 floats: room for out and stats without them; delta (B H T) at
    the head widths of the two passes; a dq part per key tile (AB_KT keys)
    at the tiled head widths over more than one key tile."""
    calls = _capture(monkeypatch)
    Bs, Hs = 2, 3
    g = torch.Generator().manual_seed(T + dh)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    q = r(Bs, T, Hs, dh)
    out, stats = tatt._launch_forward(q, q, q, None, None, "all", False,
                                      True)
    assert tuple(stats.shape) == (Bs, Hs, T, 2)
    res = (r(Bs, T, Hs, dh), r(Bs, Hs, T, 2)) if given else (None, None)
    tatt._launch_backward(q, q, q, q, None, None, "all", False, *res)
    (fwd, fa), (bwd, ba) = calls
    assert fwd == "kit_attention" and fa[-1] is stats and fa[-2] is out
    assert bwd == "kit_attention_bwd" and ba[12] is res[0] \
        and ba[13] is res[1]
    assert ba[6:10] == (Bs, T, Hs, dh)

    def r4(n):
        return -(-n // 4) * 4
    n = 0 if given else Bs * T * Hs * dh + r4(2 * Bs * Hs * T)
    if dh in _tiled_heads():
        tiles = -(-T // AB_KT)
        n += tiles * Bs * T * Hs * dh if tiles > 1 else 0
    else:
        n += r4(Bs * Hs * T)
    assert ba[-1].numel() == n
    src = _source("attention.cu")
    assert "round_up((int)(2 * rows), 4)" in src and \
        "round_up((int)rows, 4)" in src and "key_tiles(T)" in src
