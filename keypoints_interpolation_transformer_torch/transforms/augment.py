"""Geometric augmentations (port of the JAX ``transforms/augment.py``),
batched over (B, T, K, 2) videos and driven by an explicit
``torch.Generator`` on the batch's device.

The reference's quirks are kept:

  * rotate turns every keypoint about (0.5, 0.5); the hands belong to both
    the BODY and the HAND lists, so they turn twice (``double_hand_rotation``,
    on by default as in the reference).
  * shear ("squeeze" or "perspective") maps the body points through the
    homography of the unit square onto a random quad, in closed form
    (``perspective_from_unit_quad``); a coordinate equal to the image of
    (0, 0) is pinned back to 0, elementwise.
  * arm_joint_rotate walks each arm chain root to tip and, with
    probability p per joint, turns every downstream joint about that
    joint's (already augmented) position.

Each function splits into the draw of its random parameters and a
deterministic part that takes them, so the tests can hand both packages
the same parameters.
"""

from __future__ import annotations

import math

import torch

from ..data.keypoints import body_map

DEG2RAD = math.pi / 180.0


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _rotate_about(points, origin, angle):
    """Counterclockwise rotation of (..., 2) points about ``origin``
    (broadcastable (..., 2)) by ``angle`` (broadcastable to points[..., 0])."""
    c, s = torch.cos(angle), torch.sin(angle)
    d = points - origin
    return torch.stack([origin[..., 0] + c * d[..., 0] - s * d[..., 1],
                        origin[..., 1] + s * d[..., 0] + c * d[..., 1]], -1)


def rotate_by(video, angle, bm=None, double_hand_rotation: bool = True):
    """Turn (B, T, K, 2) videos about (0.5, 0.5) by ``angle`` (B,) radians."""
    bm = bm or body_map()
    a = angle[:, None, None]
    origin = torch.full((2,), 0.5, device=video.device, dtype=video.dtype)
    body = list(bm.body_identifiers)
    out = video.clone()
    out[:, :, body] = _rotate_about(video[:, :, body], origin, a)
    if double_hand_rotation:  # the hands are in BODY too: turned again
        hands = list(bm.hand_identifiers)
        out[:, :, hands] = _rotate_about(out[:, :, hands], origin, a)
    return out


def rotate(g, video, angle_range=(-15.0, 15.0), bm=None,
           double_hand_rotation: bool = True):
    """Rotate each video by its own angle drawn from ``angle_range``
    (degrees)."""
    angle = _uniform(g, video.shape[:1], *angle_range, video.device) * DEG2RAD
    return rotate_by(video, angle, bm, double_hand_rotation)


def perspective_from_unit_quad(dst):
    """(..., 3, 3) homographies mapping the unit square's corners (0, 1),
    (1, 1), (0, 0), (1, 0) onto ``dst`` (..., 4, 2), in that order, in
    closed form (the unit-square-to-quad texture-mapping solution)."""
    q01, q11, q00, q10 = dst[..., 0, :], dst[..., 1, :], dst[..., 2, :], \
        dst[..., 3, :]
    dx1 = q10 - q11
    dx2 = q01 - q11
    sx = q00 - q10 - q01 + q11
    det = dx1[..., 0] * dx2[..., 1] - dx2[..., 0] * dx1[..., 1]
    g_ = (sx[..., 0] * dx2[..., 1] - dx2[..., 0] * sx[..., 1]) / det
    h = (dx1[..., 0] * sx[..., 1] - sx[..., 0] * dx1[..., 1]) / det
    a = q10[..., 0] - q00[..., 0] + g_ * q10[..., 0]
    b = q01[..., 0] - q00[..., 0] + h * q01[..., 0]
    c = q00[..., 0]
    d = q10[..., 1] - q00[..., 1] + g_ * q10[..., 1]
    e = q01[..., 1] - q00[..., 1] + h * q01[..., 1]
    f = q00[..., 1]
    one = torch.ones_like(a)
    return torch.stack([torch.stack([a, b, c], -1),
                        torch.stack([d, e, f], -1),
                        torch.stack([g_, h, one], -1)], -2)


def apply_homography(points, H):
    """Projective transform of (..., N, 2) points by (..., 3, 3) ``H``
    (leading axes broadcast; ``H`` gets one axis per point axis)."""
    x, y = points[..., 0], points[..., 1]
    Hc = lambda i, j: H[..., i, j, None]  # noqa: E731
    w = Hc(2, 0) * x + Hc(2, 1) * y + Hc(2, 2)
    u = (Hc(0, 0) * x + Hc(0, 1) * y + Hc(0, 2)) / w
    v = (Hc(1, 0) * x + Hc(1, 1) * y + Hc(1, 2)) / w
    return torch.stack([u, v], -1)


def shear_by(video, dst, bm=None):
    """Map the body points of (B, T, K, 2) videos through the homography
    of the unit square onto ``dst`` (B, 4, 2)."""
    bm = bm or body_map()
    H = perspective_from_unit_quad(dst)[:, None]            # (B, 1, 3, 3)
    body = list(bm.body_identifiers)
    pts = apply_homography(video[:, :, body], H)
    zero = apply_homography(torch.zeros_like(video[:, :1, :1]), H)
    pts = torch.where(pts == zero, 0.0, pts)  # elementwise pin-back
    out = video.clone()
    out[:, :, body] = pts
    return out


def shear_quads(g, B, kind: str, squeeze_ratio=(-0.15, 0.15), device=None):
    """(B, 4, 2) destination quads of the "squeeze" or "perspective"
    shear."""
    lo, hi = squeeze_ratio
    one = torch.ones(B, device=device)
    zero = torch.zeros(B, device=device)
    if kind == "squeeze":
        ml = _uniform(g, (B,), lo, hi, device)
        mr = _uniform(g, (B,), lo, hi, device)
        pts = [(ml, one), (1.0 - mr, one), (ml, zero), (1.0 - mr, zero)]
        return torch.stack([torch.stack(p, -1) for p in pts], 1)
    if kind == "perspective":
        r = _uniform(g, (B,), lo, hi, device)
        left = torch.rand(B, generator=g, device=device) < 0.5
        dst_left = [(r, 1.0 - r), (one, one), (r, r), (one, zero)]
        dst_right = [(zero, one), (1.0 - r, 1.0 - r), (zero, zero),
                     (1.0 - r, r)]
        ql = torch.stack([torch.stack(p, -1) for p in dst_left], 1)
        qr = torch.stack([torch.stack(p, -1) for p in dst_right], 1)
        return torch.where(left[:, None, None], ql, qr)
    raise ValueError(f"unsupported shear kind: {kind!r}")


def shear(g, video, kind: str, squeeze_ratio=(-0.15, 0.15), bm=None):
    """"squeeze" or "perspective" shear of the body points."""
    return shear_by(video, shear_quads(g, video.shape[0], kind,
                                       squeeze_ratio, video.device), bm)


def arm_joint_rotate_by(video, fire, angle, bm=None):
    """Arm-chain rotation with given draws: ``fire`` (B, J) bool and
    ``angle`` (B, J) radians, one column per joint of the chains in order
    (the chain's last joint's column is drawn but unused, as in the
    reference)."""
    bm = bm or body_map()
    out = video.clone()
    col = 0
    for chain in bm.arm_chains:
        for j, origin_idx in enumerate(chain):
            c = col
            col += 1
            if j + 1 >= len(chain):
                continue
            down = list(chain[j + 1:])
            a = torch.where(fire[:, c], angle[:, c], 0.0)[:, None, None]
            origin = out[:, :, origin_idx, None, :]      # (B, T, 1, 2)
            out[:, :, down] = _rotate_about(out[:, :, down], origin, a)
    return out


def arm_joint_rotate(g, video, probability=0.5, angle_range=(-15.0, 15.0),
                     bm=None):
    """Randomly rotate downstream arm joints about each chain joint."""
    bm = bm or body_map()
    B = video.shape[0]
    J = sum(len(c) for c in bm.arm_chains)
    fire = torch.rand(B, J, generator=g, device=video.device) < probability
    angle = _uniform(g, (B, J), *angle_range, video.device) * DEG2RAD
    return arm_joint_rotate_by(video, fire, angle, bm)


def random_augment(g, video, probability=0.5, bm=None,
                   double_hand_rotation: bool = True):
    """The reference's per-video policy: with probability p apply ONE of
    {rotate, perspective shear, squeeze shear, arm-joint rotate}, chosen
    uniformly.  All four run on the whole batch and each video keeps its
    pick (the batched form of the JAX ``lax.switch``)."""
    B = video.shape[0]
    dev = video.device
    apply_any = torch.rand(B, generator=g, device=dev) < probability
    which = torch.randint(0, 4, (B,), generator=g, device=dev)
    branches = torch.stack([
        rotate(g, video, (-15.0, 15.0), bm, double_hand_rotation),
        shear(g, video, "perspective", (-0.15, 0.15), bm),
        shear(g, video, "squeeze", (-0.15, 0.15), bm),
        arm_joint_rotate(g, video, 0.5, (-15.0, 15.0), bm)])
    picked = branches[which, torch.arange(B, device=dev)]
    return torch.where(apply_any[:, None, None, None], picked, video)
