"""Missing-frame corruption and input preparation (port of the JAX
``transforms/corruption.py``), batched over B and driven by an explicit
``torch.Generator`` on the batch's device.

Three modes, as the reference's ``put_missing_frames``:

  * random: zero 60 % of the frames, chosen with replacement; mask 1 on
    the chosen frames.
  * blocks "all": 4-7 blocks of 3-8 frames, one per equal section, each at
    offset 0 of its section (the reference's ``randint(0, min(0, ...))``).
  * blocks per dataset: block count and block size ranges from the 25th /
    75th percentiles of Gaussian samples of the dataset's statistics, one
    block per section at a random offset.

In the block modes the missing frames are filled with a freeze-frame copy:
block 0 copies its end frame, a later block the frame just before it, and
because the copies are made in block order a later block's reference frame
may itself be a copy (``_freeze_fill`` resolves that through a source-index
map).

The random streams are torch's, so single draws differ from the JAX
package's; the distributions are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

# unroll bound of the built-in modes: mode "all" draws 4-7 blocks
MAX_BLOCKS = 16


@dataclasses.dataclass(frozen=True)
class DatasetMissingStats:
    """Per-dataset missingness statistics (``dataset_config.json``)."""

    mean_consecutive_missing: float
    std_consecutive_missing: float
    mean_number_missing_blocks: float
    std_number_missing_blocks: float
    samples: int


def static_max_blocks(stats: DatasetMissingStats) -> int:
    """Upper bound on the block count the per-dataset sampler can draw: a
    6-sigma margin over the Gaussian whose 75th percentile sets it."""
    hi = stats.mean_consecutive_missing + 6.0 * stats.std_consecutive_missing
    return max(MAX_BLOCKS, int(math.ceil(hi)) + 1)


def _randint(g, low, high, shape, device):
    """Uniform integers in [low, high) elementwise (``low``/``high`` int
    tensors broadcast against ``shape``, or ints)."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    low = torch.as_tensor(low, device=device)
    high = torch.as_tensor(high, device=device)
    span = (high - low).clamp_min(1)
    return (low + (u * span).floor().long().clamp_max(span - 1)).long()


def random_missing(g, video, t_actual=None):
    """Zero 60 % of the first ``t_actual`` frames of each (B, T, K, 2)
    video, chosen with replacement.  Returns (video, mask (B, T))."""
    B, T = video.shape[:2]
    dev = video.device
    t = (torch.full((B,), T, device=dev) if t_actual is None
         else t_actual.to(dev).long())
    n_max = max(int(T * 0.6), 1)
    idx = _randint(g, 0, t.clamp_min(1)[:, None], (B, n_max), dev)
    take = torch.arange(n_max, device=dev)[None] < ((t * 6) // 10)[:, None]
    mask = torch.zeros(B, T, device=dev).scatter_reduce(
        1, idx, take.float(), "amax")
    return zero_missing_frames(video, mask), mask


def _freeze_fill(video, starts, ends, active):
    """Freeze-frame fill and mask of (B, T, K, 2) videos for blocks
    [starts, ends) (B, NB), in block order with reference propagation."""
    B, T = video.shape[:2]
    frames = torch.arange(T, device=video.device)[None]
    src = frames.expand(B, T)
    mask = torch.zeros(B, T, device=video.device)
    for i in range(starts.shape[1]):
        ref = ends[:, 0] if i == 0 else starts[:, i] - 1
        resolved = src.gather(1, ref.clamp(0, T - 1)[:, None])
        hit = ((frames >= starts[:, i:i + 1]) & (frames < ends[:, i:i + 1])
               & active[:, i:i + 1])
        src = torch.where(hit, resolved, src)
        mask = torch.where(hit, 1.0, mask)
    filled = video.gather(1, src[:, :, None, None].expand_as(video))
    return filled, mask


def _blocks_from_sections(g, t, num_blocks, section, rest, size_min,
                          size_max, random_offset: bool,
                          max_blocks: int = MAX_BLOCKS):
    """Block placement, one block per section; every argument but the
    flags is a (B,) tensor or an int.  Returns (starts, ends, active),
    each (B, max_blocks)."""
    dev = t.device
    B = t.shape[0]
    i = torch.arange(max_blocks, device=dev)[None]
    col = lambda a: torch.as_tensor(a, device=dev).reshape(-1, 1)  # noqa
    active = i < col(num_blocks)
    sizes = _randint(g, col(size_min), col(size_max) + 1, (B, max_blocks),
                     dev)
    num_ceros = torch.minimum(sizes, col(section))
    rest_i = torch.where(i == col(num_blocks) - 1, col(rest), 0)
    if random_offset:
        hi = (rest_i + col(section) - num_ceros).clamp_min(0)
        offset = _randint(g, 0, hi + 1, (B, max_blocks), dev)
    else:
        offset = torch.zeros(B, max_blocks, dtype=torch.long, device=dev)
    starts = col(section) * i + offset
    ends = torch.minimum(starts + num_ceros, col(t) - 1)
    return starts, ends, active


def missing_blocks_all(g, video, t_actual=None):
    """Mode for dataset name "all"."""
    B, T = video.shape[:2]
    dev = video.device
    t = (torch.full((B,), T, device=dev) if t_actual is None
         else t_actual.to(dev).long())
    num_blocks = _randint(g, 4, 8, (B,), dev)
    section = t // num_blocks
    rest = t % num_blocks
    starts, ends, active = _blocks_from_sections(
        g, t, num_blocks, section, rest, 3, 8, random_offset=False)
    return _freeze_fill(video, starts, ends, active)


def _percentiles(x):
    """25th and 75th percentiles along the last axis, linear
    interpolation (numpy's default)."""
    q = torch.tensor([0.25, 0.75], device=x.device, dtype=x.dtype)
    return torch.quantile(x, q, dim=-1)


def missing_blocks_dataset(g, video, stats: DatasetMissingStats,
                           t_actual=None):
    """Per-dataset mode."""
    B, T = video.shape[:2]
    dev = video.device
    t = (torch.full((B,), T, device=dev) if t_actual is None
         else t_actual.to(dev).long())
    n = stats.samples
    lim = stats.mean_consecutive_missing + stats.std_consecutive_missing * \
        torch.randn(B, n, generator=g, device=dev)
    siz = stats.mean_number_missing_blocks + \
        stats.std_number_missing_blocks * \
        torch.randn(B, n, generator=g, device=dev)
    block_limit = _percentiles(lim)
    block_size = _percentiles(siz)
    nb_min = block_limit[0].floor().long().clamp_min(1)
    nb_max = torch.maximum(block_limit[1].ceil().long(), nb_min)
    bs_min = block_size[0].floor().long().clamp_min(1)
    bs_max = torch.maximum(block_size[1].ceil().long(), bs_min)

    max_blocks = static_max_blocks(stats)
    num_blocks = _randint(g, nb_min, nb_max + 1, (B,), dev).clamp_max(
        max_blocks)
    section = (t // num_blocks).clamp_min(1)
    # sections too narrow for the largest block plus padding are widened to
    # bs_max + 4 and the block count shrunk to fit
    need = bs_max + 4
    adj = section < need
    nb_adj = (t // need.clamp_min(1)).clamp(1, max_blocks)
    num_blocks = torch.where(adj, nb_adj, num_blocks)
    section = torch.where(adj, need.clamp_min(1), section)
    rest = t % num_blocks
    starts, ends, active = _blocks_from_sections(
        g, t, num_blocks, section, rest, bs_min, bs_max, random_offset=True,
        max_blocks=max_blocks)
    return _freeze_fill(video, starts, ends, active)


def put_missing_frames(g, video, *, is_random_missing: bool = False,
                       dataset_name: str = "all",
                       stats: Optional[DatasetMissingStats] = None,
                       t_actual=None):
    """The reference's mode selection.  Returns (corrupted, mask)."""
    if is_random_missing:
        return random_missing(g, video, t_actual)
    if dataset_name == "all":
        return missing_blocks_all(g, video, t_actual)
    if stats is None:
        raise ValueError(
            f"dataset {dataset_name!r} needs DatasetMissingStats")
    return missing_blocks_dataset(g, video, stats, t_actual)


def zero_missing_frames(video: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Replace masked frames of a (..., T, K, 2) video with zeros."""
    return torch.where(mask[..., None, None] > 0,
                       torch.zeros((), dtype=video.dtype,
                                   device=video.device), video)


def add_sos(video: torch.Tensor, mask: torch.Tensor = None,
            sos_value: float = 1.0):
    """Prepend an all-``sos_value`` start frame to a (..., T, K, 2) video
    and a 0 to its (..., T) mask."""
    out = F.pad(video, (0, 0, 0, 0, 1, 0), value=sos_value)
    if mask is None:
        return out
    return out, F.pad(mask, (1, 0), value=0.0)
