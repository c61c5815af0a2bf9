"""Not-a-knot cubic-spline interpolation (port of the JAX
``ops/cubic_spline.py``), batched over series.

The reference's classical baseline: per keypoint and coordinate, zeros
(masked frames and undetected landmarks) become holes that a not-a-knot
cubic spline through the remaining knots fills, extrapolating at both
ends, with 0 for series it cannot fill.  As in the JAX package:

  * the valid knots of each series are compacted to the front (a stable
    argsort), the padding continues the last knot's position by 1 a step;
  * the not-a-knot system is reduced to a tridiagonal one over the
    interior second derivatives (the end conditions substituted into the
    first and last interior rows) and solved by the Thomas algorithm, one
    sweep over the frames each way, every series of the batch at once;
  * degenerate knot counts: 3 -> the parabola through them, 2 -> the line,
    1 -> a constant, 0 -> zeros.
"""

from __future__ import annotations

import torch


def _solve_tridiagonal(a, b, c, d):
    """Thomas algorithm over the last axis of (N, T) rows (b != 0)."""
    T = a.shape[-1]
    cp, dp = [], []
    c_prev = torch.zeros_like(a[:, 0])
    d_prev = torch.zeros_like(a[:, 0])
    for i in range(T):
        denom = b[:, i] - a[:, i] * c_prev
        c_prev = c[:, i] / denom
        d_prev = (d[:, i] - a[:, i] * d_prev) / denom
        cp.append(c_prev)
        dp.append(d_prev)
    x = torch.zeros_like(a[:, 0])
    out = [None] * T
    for i in range(T - 1, -1, -1):
        x = dp[i] - cp[i] * x
        out[i] = x
    return torch.stack(out, -1)


def _take(arr, idx):
    """arr[n, clip(idx[n], 0, T - 1)] for (N, T) ``arr`` and (N,) ``idx``."""
    T = arr.shape[-1]
    return arr.gather(1, idx.clamp(0, T - 1)[:, None])[:, 0]


def _second_derivatives(xs, ys, m):
    """Not-a-knot second derivatives M_0 .. M_{m-1} of each (N, T) series
    (padded to T), and the knot spacings h."""
    N, T = xs.shape
    i = torch.arange(T, device=xs.device)
    h = torch.diff(xs, append=xs[:, -1:] + 1.0)
    h = torch.where(i < T - 1, h, 1.0)
    h = torch.where(h > 0, h, 1.0)
    slope = torch.diff(ys, append=ys[:, -1:]) / h
    d = 6.0 * (slope - torch.cat([slope[:, :1], slope[:, :-1]], 1))

    h0, h1 = h[:, 0], h[:, 1]
    hm3, hm2 = _take(h, m - 3), _take(h, m - 2)
    h_prev = torch.cat([torch.ones_like(h[:, :1]), h[:, :-1]], 1)
    a, b, c = h_prev, 2.0 * (h_prev + h), h

    r = h0 / h1                       # first reduced row: M_0 substituted
    b1 = h0 * (1.0 + r) + 2.0 * (h0 + h1)
    c1 = h1 - h0 * r
    q = hm2 / hm3                     # last reduced row: M_{m-1} substituted
    am2 = hm3 - hm2 * q
    bm2 = 2.0 * (hm3 + hm2) + hm2 * (1.0 + q)

    first = i[None] == 1
    last = i[None] == (m - 2)[:, None]
    inside = (i[None] >= 1) & (i[None] <= (m - 2)[:, None])
    a = torch.where(first, 0.0, torch.where(last, am2[:, None], a))
    b = torch.where(first, b1[:, None], torch.where(last, bm2[:, None], b))
    c = torch.where(first, c1[:, None], torch.where(last, 0.0, c))
    a = torch.where(inside, a, 0.0)
    b = torch.where(inside, b, 1.0)
    c = torch.where(inside, c, 0.0)
    d = torch.where(inside, d, 0.0)
    M = _solve_tridiagonal(a, b, c, d)

    m1, m2 = M[:, 1], M[:, 2]
    mm2, mm3 = _take(M, m - 2), _take(M, m - 3)
    M = torch.where(i[None] == 0, ((1.0 + r) * m1 - r * m2)[:, None], M)
    M = torch.where(i[None] == (m - 1)[:, None],
                    ((1.0 + q) * mm2 - q * mm3)[:, None], M)
    return M, h


def _eval_spline(t, xs, ys, M, h, m):
    """The M-form cubic at positions t (N, T), the end polynomials
    extrapolated."""
    T = xs.shape[-1]
    j = torch.searchsorted(xs, t, right=True) - 1
    j = torch.minimum(j.clamp_min(0), (m - 2).clamp_min(0)[:, None])
    j1 = (j + 1).clamp(max=T - 1)
    xj, xj1 = xs.gather(1, j), xs.gather(1, j1)
    yj, yj1 = ys.gather(1, j), ys.gather(1, j1)
    Mj, Mj1 = M.gather(1, j), M.gather(1, j1)
    hj = h.gather(1, j)
    u, w = xj1 - t, t - xj
    return (Mj * u ** 3 + Mj1 * w ** 3) / (6.0 * hj) + \
        (yj / hj - Mj * hj / 6.0) * u + (yj1 / hj - Mj1 * hj / 6.0) * w


def _parabola(t, x, y):
    """The Lagrange parabola through 3 points per series: x, y (N, 3)."""
    x0, x1, x2 = (x[:, k:k + 1] for k in range(3))
    y0, y1, y2 = (y[:, k:k + 1] for k in range(3))
    l0 = (t - x1) * (t - x2) / ((x0 - x1) * (x0 - x2))
    l1 = (t - x0) * (t - x2) / ((x1 - x0) * (x1 - x2))
    l2 = (t - x0) * (t - x1) / ((x2 - x0) * (x2 - x1))
    return y0 * l0 + y1 * l1 + y2 * l2


def interpolate_series(values: torch.Tensor) -> torch.Tensor:
    """Fill the zeros of each (N, T) series by not-a-knot cubic spline
    (pandas ``interpolate(method='cubicspline', limit_direction='both')``
    on the zeros, then NaN -> 0)."""
    N, T = values.shape
    valid = values != 0.0
    m = valid.sum(-1)
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    pos = torch.arange(T, dtype=values.dtype, device=values.device)
    xs_raw = pos[order]
    ys_raw = values.gather(1, order)
    last_x, last_y = _take(xs_raw, m - 1), _take(ys_raw, m - 1)
    i = torch.arange(T, device=values.device)[None]
    before = i < m[:, None]
    xs = torch.where(before, xs_raw,
                     last_x[:, None] + (i - m[:, None] + 1).to(values.dtype))
    ys = torch.where(before, ys_raw, last_y[:, None])

    M, h = _second_derivatives(xs, ys, m)
    t = pos.expand(N, T).contiguous()
    cubic = _eval_spline(t, xs, ys, M, h, m)
    para = _parabola(t, xs[:, :3], ys[:, :3])
    x0, x1, y0, y1 = xs[:, :1], xs[:, 1:2], ys[:, :1], ys[:, 1:2]
    line = y0 + (t - x0) * (y1 - y0) / torch.where(x1 != x0, x1 - x0, 1.0)
    const = y0.expand(N, T)
    mm = m[:, None]
    filled = torch.where(mm >= 4, cubic, torch.where(
        mm == 3, para, torch.where(mm == 2, line, torch.where(
            mm == 1, const, 0.0))))
    return torch.where(valid, values, torch.nan_to_num(filled))


def cubic_interpolation_batch(video: torch.Tensor,
                              missing_mask: torch.Tensor) -> torch.Tensor:
    """The reference baseline on (B, T, K, 2) videos: zero the masked
    frames ((B, T) mask, 1 = missing), then spline-fill every zero, per
    keypoint and coordinate."""
    B, T = video.shape[:2]
    v = torch.where(missing_mask[..., None, None] > 0, 0.0, video)
    series = v.reshape(B, T, -1).transpose(1, 2).reshape(-1, T)
    out = interpolate_series(series)
    return out.reshape(B, -1, T).transpose(1, 2).reshape(video.shape)
