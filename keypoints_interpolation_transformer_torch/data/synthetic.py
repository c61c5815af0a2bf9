"""Synthetic keypoint sequences (port of the JAX ``data/synthetic.py``):
numpy only, and the same draws from the same seed, so the two packages
build the same videos bit for bit.

Plausible signing-like clips (smooth random joint trajectories around a
fixed skeleton with valid shoulders) for hermetic training runs, tests and
benchmarks; the reference's pipeline only runs on its HDF5 corpora.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .keypoints import NUM_KEYPOINTS, body_map


def synthetic_video(rng: np.random.Generator, t: int) -> np.ndarray:
    """One (t, 54, 2) clip: a static plausible base pose + smooth noise."""
    bm = body_map()
    base = rng.uniform(0.25, 0.75, size=(NUM_KEYPOINTS, 2)).astype(np.float32)
    # the normalization landmarks at plausible positions
    base[bm.index_of["pose_left_shoulder"]] = (0.62, 0.42)
    base[bm.index_of["pose_right_shoulder"]] = (0.38, 0.42)
    base[bm.index_of["pose_right_eye"]] = (0.46, 0.30)
    base[bm.index_of["pose_chest_middle_up"]] = (0.50, 0.48)

    # per-keypoint trajectories: a sum of two low-frequency sinusoids
    tt = np.arange(t, dtype=np.float32)[:, None, None]
    f1 = rng.uniform(0.02, 0.08, size=(1, NUM_KEYPOINTS, 2))
    f2 = rng.uniform(0.08, 0.2, size=(1, NUM_KEYPOINTS, 2))
    p1 = rng.uniform(0, 2 * np.pi, size=(1, NUM_KEYPOINTS, 2))
    p2 = rng.uniform(0, 2 * np.pi, size=(1, NUM_KEYPOINTS, 2))
    a1 = rng.uniform(0.01, 0.05, size=(1, NUM_KEYPOINTS, 2))
    a2 = rng.uniform(0.002, 0.01, size=(1, NUM_KEYPOINTS, 2))
    wiggle = a1 * np.sin(2 * np.pi * f1 * tt + p1) + \
        a2 * np.sin(2 * np.pi * f2 * tt + p2)
    return (base[None] + wiggle).astype(np.float32)


def gesture_vocabulary(rng: np.random.Generator, vocab: int = 8,
                       proto_len: int = 256) -> np.ndarray:
    """(vocab, proto_len, 54, 2) prototype gesture trajectories."""
    return np.stack([synthetic_video(rng, proto_len) for _ in range(vocab)])


def synthetic_dataset(num_videos: int, min_len: int = 24, max_len: int = 96,
                      seed: int = 42, motion: str = "smooth",
                      vocab: int = 8, noise: float = 0.004
                      ) -> List[np.ndarray]:
    """motion="smooth": independent low-frequency clips.
    motion="gestures": every clip is a random window of one of ``vocab``
    shared prototype trajectories plus small noise."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=num_videos)
    if motion == "smooth":
        return [synthetic_video(rng, int(t)) for t in lens]
    if motion != "gestures":
        raise ValueError(f"unknown motion kind {motion!r}")
    protos = gesture_vocabulary(rng, vocab, proto_len=max(256, max_len + 1))
    out = []
    for t in lens:
        g = int(rng.integers(vocab))
        start = int(rng.integers(0, protos.shape[1] - int(t) + 1))
        clip = protos[g, start:start + int(t)].copy()
        clip += rng.normal(0, noise, clip.shape).astype(np.float32)
        out.append(clip.astype(np.float32))
    return out
