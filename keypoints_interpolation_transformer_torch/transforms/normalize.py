"""Signing-space normalization (port of the JAX ``transforms/normalize.py``),
batched over (B, T, K, 2) videos.

The reference's ``normalize_pose``:
  * bbox from the shoulder distance: head = ||ls - rs|| / 2, mid fixed at
    (0.5, 0.5); x in mid +- 3 head; y from right_eye.y - head / 2 down to
    mid.y + 3.5 head;
  * a frame whose shoulders are undetected (x == 0) reuses the last valid
    frame's bbox; frames before the first valid bbox stay unnormalized.
    The JAX package carries the bbox forward with a ``lax.scan`` over
    frames; here each frame gathers the bbox of its last valid frame, whose
    index is a running maximum (``cummax``) over the frames;
  * keypoints with x == 0 are skipped;
  * y is flipped: y' = 1 - (y - ey) / (sy - ey).
"""

from __future__ import annotations

import torch

from ..data.keypoints import body_map


def normalize_pose_batch(video: torch.Tensor, bm=None) -> torch.Tensor:
    """Normalize (B, T, K, 2) videos into signing space; zero-padded
    frames are left as they are."""
    bm = bm or body_map()
    ls = video[:, :, bm.index_of["pose_left_shoulder"]]     # (B, T, 2)
    rs = video[:, :, bm.index_of["pose_right_shoulder"]]
    rey = video[:, :, bm.index_of["pose_right_eye"], 1]      # (B, T)
    ok = (ls[..., 0] != 0.0) & (rs[..., 0] != 0.0)

    head = torch.sqrt(((ls - rs) ** 2).sum(-1)) / 2.0
    start = torch.stack([0.5 - 3.0 * head, rey - head / 2.0], -1)
    end = torch.stack([0.5 + 3.0 * head, 0.5 + 3.5 * head], -1)
    frames = torch.arange(video.shape[1], device=video.device)
    last = torch.where(ok, frames, -1).cummax(dim=1).values  # (B, T)
    has = last >= 0
    src = last.clamp_min(0)[..., None].expand(-1, -1, 2)
    start = torch.where(has[..., None], start.gather(1, src), 0.0)
    end = torch.where(has[..., None], end.gather(1, src), 0.0)

    sx, sy = start[..., 0:1], start[..., 1:2]              # (B, T, 1)
    ex, ey = end[..., 0:1], end[..., 1:2]
    x, y = video[..., 0], video[..., 1]                    # (B, T, K)
    nx = (x - sx) / (ex - sx)
    ny = (y - ey) / (sy - ey)
    out = torch.stack([nx, 1.0 - ny], -1)
    skip = (x == 0.0) | ~has[..., None]
    return torch.where(skip[..., None], video, out)


def normalize_hand(points: torch.Tensor) -> torch.Tensor:
    """Square-bbox part normalization with a 10 % margin over (..., T, P,
    2) points (the reference's ``normalize_hand``, unused by its pipeline
    but part of its surface)."""
    x, y = points[..., 0], points[..., 1]                  # (..., T, P)
    min_x, max_x = x.amin(-1, keepdim=True), x.amax(-1, keepdim=True)
    min_y, max_y = y.amin(-1, keepdim=True), y.amax(-1, keepdim=True)
    w, h = max_x - min_x, max_y - min_y
    wide = w > h
    dx = torch.where(wide, 0.1 * w, 0.1 * h + (h - w) / 2.0)
    dy = torch.where(wide, 0.1 * w + (w - h) / 2.0, 0.1 * h)
    sx, sy = min_x - dx, min_y - dy
    ex, ey = max_x + dx, max_y + dy
    out = torch.stack([(x - sx) / (ex - sx), (y - sy) / (ey - sy)], -1)
    degenerate = ((ex - sx) == 0.0) | ((sy - ey) == 0.0)
    skip = (x == 0.0) | degenerate
    return torch.where(skip[..., None], points, out)
