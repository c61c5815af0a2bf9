"""The port's data feed against the JAX package on the CPU: synthetic
videos bit for bit, the bad-video filter, signing-space normalization
(<= 1e-5), the cubic-spline baseline (<= 5e-5), the registry, and the batch
composition of ``batches`` / ``device_batches`` against the JAX
``batches`` / ``device_batch_plan`` for the same seed; the validation
corruption is deterministic for a seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.data import pipeline as jpipe
from keypoints_interpolation_transformer_tpu.data import synthetic as jsyn
from keypoints_interpolation_transformer_tpu.ops import cubic_spline as jcub
from keypoints_interpolation_transformer_tpu.transforms import (
    filters as jfilters)
from keypoints_interpolation_transformer_tpu.transforms import (
    normalize as jnorm)
from keypoints_interpolation_transformer_tpu.utils import registry as jreg
from keypoints_interpolation_transformer_torch.data import pipeline, synthetic
from keypoints_interpolation_transformer_torch.data.keypoints import body_map
from keypoints_interpolation_transformer_torch.ops.cubic_spline import (
    cubic_interpolation_batch)
from keypoints_interpolation_transformer_torch.transforms import (
    filters, normalize)
from keypoints_interpolation_transformer_torch.utils import registry

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [dict(motion="smooth"),
                                dict(motion="gestures", vocab=3)])
def test_synthetic_dataset_is_bit_identical(kw):
    got = synthetic.synthetic_dataset(9, 10, 50, seed=4, **kw)
    want = jsyn.synthetic_dataset(9, 10, 50, seed=4, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_filter_videos_matches_jax():
    bm = body_map()
    vids = synthetic.synthetic_dataset(6, 12, 40, seed=1)
    vids += [np.zeros((0, 54, 2), np.float32),   # empty: kept
             vids[0][:7].copy()]                  # under 10 frames: dropped
    bad = vids[1].copy()                          # a failed right hand
    idx = bm.index_of
    bad[10, idx["rightHand_thumb_tip"]] = bad[10, idx["pose_right_wrist"]]
    bad[10, idx["rightHand_middle_finger_dip"], 0] = \
        bad[10, idx["pose_right_wrist"], 0]
    late = vids[2].copy()                         # bad only at the last
    n = len(late) - 9                             # inspected frame: kept
    late[n, idx["leftHand_thumb_tip"]] = late[n, idx["pose_left_wrist"]]
    late[n, idx["leftHand_middle_finger_dip"]] = late[n,
                                                      idx["pose_left_wrist"]]
    vids += [bad, late]
    kept, dropped = filters.filter_videos(vids)
    jkept, jdropped = jfilters.filter_videos(vids)
    assert dropped == jdropped == 2
    assert [len(v) for v in kept] == [len(v) for v in jkept]
    assert [filters.is_bad_video(v) for v in vids] == \
        [jfilters.is_bad_video(v) for v in vids]


def test_normalize_pose_batch_matches_jax():
    bm = body_map()
    vids = synthetic.synthetic_dataset(3, 20, 20, seed=2)
    x = np.stack(vids)
    x[0, :4, bm.index_of["pose_left_shoulder"], 0] = 0.0   # no bbox yet
    x[1, 6:9, bm.index_of["pose_right_shoulder"], 0] = 0.0  # carried
    x[2, :, 5, 0] = 0.0                                     # skipped point
    x[2, 15:] = 0.0                                         # padding
    got = normalize.normalize_pose_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(jnorm.normalize_pose_batch(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[0, :4], x[0, :4])
    hands = x[:, :, list(bm.left_hand)]
    np.testing.assert_allclose(
        normalize.normalize_hand(torch.from_numpy(hands)).numpy(),
        np.stack([np.asarray(jnorm.normalize_hand(jnp.asarray(h)))
                  for h in hands]), atol=1e-5)


def test_cubic_spline_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.uniform(0.2, 0.8, (3, 40, 54, 2)).astype(np.float32)
    m = (rng.random((3, 40)) < 0.3).astype(np.float32)
    v[0, :, 3] = 0.0                                     # no knot: zeros
    v[1, :, 5, 0] = 0.0
    v[1, [3, 9, 20], 5, 0] = 0.5                          # 3 knots: parabola
    m[1, [3, 9, 20]] = 0.0
    v[2, :, 7] = 0.0
    v[2, [4, 30], 7] = 0.4                                # 2 knots: a line
    m[2, [4, 30]] = 0.0
    got = cubic_interpolation_batch(torch.from_numpy(v), torch.from_numpy(m))
    want = np.asarray(jcub.cubic_interpolation_batch(jnp.asarray(v),
                                                     jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_registry_matches_jax():
    for name in ("AUTSL", "AEC", "PUCP_PSL_DGI305"):
        assert registry.missing_stats(name).__dict__ == \
            jreg.missing_stats(name).__dict__
    assert registry.missing_stats("all") is None
    with pytest.raises(KeyError):
        registry.missing_stats("LSA64")
    assert registry.load_registry(include_all_index=False).keys() == \
        jreg.load_registry(include_all_index=False).keys()
    assert registry.dataset_name_from_path("data/validation--AUTSL.hdf5") \
        == "AUTSL"


@pytest.fixture(scope="module")
def datasets():
    vids = synthetic.synthetic_dataset(23, 10, 60, seed=9)
    kw = dict(max_seq_len=48, bucket_multiple=16)
    return (pipeline.KeypointDataset(videos=vids, normalize=False, **kw),
            jpipe.KeypointDataset(videos=vids, normalize=False, **kw),
            vids, kw)


def test_dataset_normalizes_as_jax(datasets):
    _, _, vids, kw = datasets
    got = pipeline.KeypointDataset(videos=vids, **kw)
    want = jpipe.KeypointDataset(videos=vids, **kw)
    assert len(got) == len(want) and got.dropped == want.dropped
    for a, b in zip(got.videos, want.videos):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax(datasets, shuffle):
    ds, jds, _, _ = datasets
    assert ds.num_batches(5) == jds.num_batches(5)
    got = list(ds.batches(5, shuffle=shuffle, seed=3))
    want = list(jds.batches(5, shuffle=shuffle, seed=3))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("clean", "length", "weight"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_array_equal(a.valid, b.valid)


def test_device_batches_match_jax_batch_plan(datasets):
    ds, jds, _, _ = datasets
    buckets = ds.device_buckets(device="cpu")
    jbuckets = jds.device_buckets()
    assert list(buckets) == list(jbuckets)
    got = list(ds.device_batches(buckets, 4, shuffle=True, seed=6))
    plan = list(jds.device_batch_plan(jbuckets, 4, shuffle=True, seed=6))
    jgot = list(jds.device_batches(jbuckets, 4, shuffle=True, seed=6))
    i = 0
    for t_pad, entry, rows, wts in plan:
        for r, w in zip(np.asarray(rows), wts):
            g_t, picked, weight = got[i]
            assert g_t == t_pad
            np.testing.assert_array_equal(weight, w)
            np.testing.assert_array_equal(
                picked["clean"].numpy(), np.asarray(entry["clean"])[r])
            np.testing.assert_array_equal(
                picked["length"].numpy(), np.asarray(entry["length"])[r])
            np.testing.assert_array_equal(picked["clean"].numpy(),
                                          np.asarray(jgot[i][1]["clean"]))
            i += 1
    assert i == len(got)


def test_precompute_corruption_is_deterministic(datasets):
    ds = datasets[0]
    a = ds.precompute_corruption(seed=5, device="cpu")
    b = ds.precompute_corruption(seed=5, device="cpu")
    c = ds.precompute_corruption(seed=6, device="cpu")
    assert a.keys() == b.keys() == set(range(len(ds)))
    for i in a:
        np.testing.assert_array_equal(a[i][0], b[i][0])
        np.testing.assert_array_equal(a[i][1], b[i][1])
        assert a[i][0].shape == ds.videos[i].shape
        assert a[i][1].shape == (len(ds.videos[i]),)
        # non-missing frames are the clean frames
        keep = a[i][1] == 0
        np.testing.assert_array_equal(a[i][0][keep], ds.videos[i][keep])
    assert any(not np.array_equal(a[i][1], c[i][1]) for i in a)
    # batch assembly prepends the start frame, as the JAX package does
    batch = next(ds.batches(4, corrupted=a))
    jbatch = next(datasets[1].batches(4, corrupted=a))
    np.testing.assert_array_equal(batch.inputs, jbatch.inputs)
    np.testing.assert_array_equal(batch.mask, jbatch.mask)


def test_hdf5_paths_are_refused():
    with pytest.raises(NotImplementedError, match="h5py"):
        pipeline.KeypointDataset(path="data/training--AUTSL.hdf5")
