"""The port's corruption and augmentation against the JAX package on the
CPU: the deterministic parts on the same inputs (and on the same random
parameters, replayed from the JAX keys), and the samplers, whose random
streams differ from JAX's, by their distributions over many draws."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.transforms import (
    augment as jaug, corruption as jcorr)
from keypoints_interpolation_transformer_torch.data.keypoints import body_map
from keypoints_interpolation_transformer_torch.transforms import (
    augment, corruption)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

DEG = math.pi / 180.0


def _video(rng, B=3, T=20):
    return rng.uniform(0.1, 0.9, (B, T, 54, 2)).astype(np.float32)


def _runs(mask_row):
    """[start, end) of each run of ones."""
    m = np.concatenate([[0], mask_row, [0]])
    d = np.diff(m)
    return list(zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]))


# ---------------------------------------------------------------------------
# deterministic parts
# ---------------------------------------------------------------------------

def test_freeze_fill_matches_jax(rng):
    v = _video(rng, B=2, T=24)
    # overlapping references: block 1 starts right after block 0's end
    # frame, so its reference frame is itself a copy
    starts = np.array([[2, 6, 14, 0], [0, 9, 16, 20]])
    ends = np.array([[5, 9, 17, 0], [4, 12, 19, 23]])
    active = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    got_v, got_m = corruption._freeze_fill(torch.from_numpy(v),
                                           torch.from_numpy(starts),
                                           torch.from_numpy(ends),
                                           torch.from_numpy(active))
    for b in range(2):
        want_v, want_m = jcorr._freeze_fill(
            jnp.asarray(v[b]), jnp.asarray(starts[b]), jnp.asarray(ends[b]),
            jnp.asarray(active[b]), 24)
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_m[b].numpy(), np.asarray(want_m))


def test_rotation_and_homography_match_jax(rng):
    pts = rng.uniform(size=(5, 7, 2)).astype(np.float32)
    origin = rng.uniform(size=(5, 1, 2)).astype(np.float32)
    ang = np.float32(0.3)
    np.testing.assert_allclose(
        augment._rotate_about(torch.from_numpy(pts), torch.from_numpy(origin),
                              torch.tensor(ang)).numpy(),
        np.asarray(jaug._rotate_about(jnp.asarray(pts), jnp.asarray(origin),
                                      ang)), atol=1e-6)
    quads = rng.uniform(-0.2, 1.2, (4, 4, 2)).astype(np.float32)
    got = augment.perspective_from_unit_quad(torch.from_numpy(quads))
    for i in range(4):
        want = jaug.perspective_from_unit_quad(jnp.asarray(quads[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-5)
        unit = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
        mapped = augment.apply_homography(torch.from_numpy(unit), got[i])
        np.testing.assert_allclose(mapped.numpy(), quads[i], atol=1e-5)


def test_augment_branches_with_replayed_draws_match_jax(rng):
    """Each branch given the parameters the JAX branch draws from its key
    returns the JAX branch's video."""
    v = _video(rng, B=2)
    keys = [jax.random.key(s) for s in (3, 4)]
    bm = body_map()
    jv = [jnp.asarray(v[b]) for b in range(2)]
    tv = torch.from_numpy(v)

    ang = torch.tensor([float(jax.random.uniform(k, (), minval=-15.0,
                                                 maxval=15.0)) * DEG
                        for k in keys])
    got = augment.rotate_by(tv, ang)
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(), np.asarray(
            jaug.rotate(keys[b], jv[b])), atol=1e-6)

    for kind in ("squeeze", "perspective"):
        quads = []
        for k in keys:
            k1, k2, _ = jax.random.split(k, 3)
            r1 = float(jax.random.uniform(k1, (), minval=-0.15, maxval=0.15))
            if kind == "squeeze":
                r2 = float(jax.random.uniform(k2, (), minval=-0.15,
                                              maxval=0.15))
                quads.append([[r1, 1], [1 - r2, 1], [r1, 0], [1 - r2, 0]])
            elif float(jax.random.uniform(k2, ())) < 0.5:
                quads.append([[r1, 1 - r1], [1, 1], [r1, r1], [1, 0]])
            else:
                quads.append([[0, 1], [1 - r1, 1 - r1], [0, 0], [1 - r1, r1]])
        got = augment.shear_by(tv, torch.tensor(quads, dtype=torch.float32))
        for b in range(2):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(
                jaug.shear(keys[b], jv[b], kind)), atol=2e-6, err_msg=kind)

    J = sum(len(c) for c in bm.arm_chains)
    fire = np.zeros((2, J), bool)
    angle = np.zeros((2, J), np.float32)
    for b, k in enumerate(keys):
        for i, kk in enumerate(jax.random.split(k, J)):
            k_pass, k_ang = jax.random.split(kk)
            fire[b, i] = float(jax.random.uniform(k_pass, ())) < 0.5
            angle[b, i] = float(jax.random.uniform(
                k_ang, (), minval=-15.0, maxval=15.0)) * DEG
    got = augment.arm_joint_rotate_by(tv, torch.from_numpy(fire),
                                      torch.from_numpy(angle))
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(), np.asarray(
            jaug.arm_joint_rotate(keys[b], jv[b])), atol=1e-6)


# ---------------------------------------------------------------------------
# samplers: distributions
# ---------------------------------------------------------------------------

def test_blocks_all_distribution_and_fill(rng):
    B, T = 400, 64
    v = torch.from_numpy(_video(rng, B=B, T=T))
    g = torch.Generator().manual_seed(0)
    out, mask = corruption.put_missing_frames(g, v, dataset_name="all")
    out, mask, v = out.numpy(), mask.numpy(), v.numpy()
    counts, sizes = [], []
    for b in range(B):
        runs = _runs(mask[b])
        counts.append(len(runs))
        for i, (s, e) in enumerate(runs):
            sizes.append(e - s)
            ref = e if i == 0 else s - 1
            assert mask[b, ref] == 0
            np.testing.assert_array_equal(out[b, s:e],
                                          np.broadcast_to(v[b, ref],
                                                          out[b, s:e].shape))
        np.testing.assert_array_equal(out[b][mask[b] == 0],
                                      v[b][mask[b] == 0])
    # 4-7 blocks, uniform; 3-8 frames each, uniform
    assert set(counts) == {4, 5, 6, 7}
    assert abs(np.mean(counts) - 5.5) < 0.25
    assert set(sizes) == set(range(3, 9))
    assert abs(np.mean(sizes) - 5.5) < 0.2


def test_random_missing_fraction(rng):
    B, T = 300, 50
    v = torch.from_numpy(_video(rng, B=B, T=T))
    length = torch.from_numpy(rng.integers(20, T + 1, B))
    g = torch.Generator().manual_seed(1)
    out, mask = corruption.put_missing_frames(g, v, is_random_missing=True,
                                              t_actual=length)
    out, mask = out.numpy(), mask.numpy()
    frac, want = [], []
    for b in range(B):
        t = int(length[b])
        assert mask[b, t:].sum() == 0
        n = (t * 6) // 10  # 60 % of the frames drawn, with replacement
        frac.append(mask[b, :t].mean())
        want.append(1.0 - (1.0 - 1.0 / t) ** n)
        assert np.all(out[b][mask[b] == 1] == 0.0)
    assert abs(np.mean(frac) - np.mean(want)) < 0.01


def test_blocks_dataset_distribution_matches_jax():
    stats = corruption.DatasetMissingStats(6.0, 1.5, 4.0, 1.0, 200)
    jstats = jcorr.DatasetMissingStats(6.0, 1.5, 4.0, 1.0, 200)
    B, T = 400, 96
    video = np.zeros((T, 54, 2), np.float32)
    g = torch.Generator().manual_seed(2)
    _, mask = corruption.put_missing_frames(
        g, torch.zeros(B, T, 54, 2), dataset_name="x", stats=stats)
    jmask = jax.vmap(lambda k: jcorr.missing_blocks_dataset(
        k, jnp.asarray(video), jstats)[1])(
            jax.random.split(jax.random.key(0), B))
    ours = [len(_runs(m)) for m in mask.numpy()]
    theirs = [len(_runs(m)) for m in np.asarray(jmask)]
    assert set(ours) == set(theirs)
    assert abs(np.mean(ours) - np.mean(theirs)) < 0.3
    assert abs(mask.numpy().mean() - np.asarray(jmask).mean()) < 0.02
    with pytest.raises(ValueError):
        corruption.put_missing_frames(g, torch.zeros(1, T, 54, 2),
                                      dataset_name="x")


def test_random_augment_gate_and_angle_range(rng):
    B, T = 2000, 4
    v = torch.from_numpy(_video(rng, B=B, T=T))
    g = torch.Generator().manual_seed(3)
    out = augment.random_augment(g, v, 0.5)
    changed = (out != v).flatten(1).any(1).float().mean().item()
    # p = 0.5, and an arm rotation with no joint firing (1 / 64 of them)
    # leaves the video as it was
    assert abs(changed - 0.5 * (1 - 0.25 / 64)) < 0.035
    ang = augment._uniform(g, (B,), -15.0, 15.0, None)
    rot = augment.rotate_by(v, ang * DEG)
    nose = body_map().index_of["pose_nose"]
    d0 = v[:, 0, nose] - 0.5
    d1 = rot[:, 0, nose] - 0.5
    turned = torch.atan2(d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0],
                         (d0 * d1).sum(-1)) / DEG
    assert float(turned.abs().max()) <= 15.0 + 1e-3
    assert abs(float(turned.std()) - 30 / math.sqrt(12)) < 0.5
    hand = body_map().left_hand[0]
    h0, h1 = v[:, 0, hand] - 0.5, rot[:, 0, hand] - 0.5
    hturn = torch.atan2(h0[:, 0] * h1[:, 1] - h0[:, 1] * h1[:, 0],
                        (h0 * h1).sum(-1)) / DEG
    torch.testing.assert_close(hturn, 2 * turned, atol=1e-2, rtol=0)
