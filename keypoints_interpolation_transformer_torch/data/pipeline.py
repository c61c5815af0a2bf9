"""Dataset runtime (port of the JAX ``data/pipeline.py``): ragged videos ->
filtered, normalized, bucketed, padded batches.

Videos are padded into length buckets and fed as (B, T_pad, 54, 2) batches
with per-video length and weight vectors; padded frames carry zero weight
in every loss, so per-video losses equal the reference's batch-size-1
losses.  Batch composition comes from the same numpy generator calls as in
the JAX package, so both packages see the same batches for the same seed.

Corruption and augmentation of training batches run inside the train step
on the card (``train/steps.py``); the validation corruption is computed
once (``precompute_corruption``), from a ``torch.Generator`` seeded with
the run's seed, as the reference's ``create_validation_data`` does.

Two feeds: device-resident buckets (``device_buckets``: each bucket one
stack of tensors on the card, uploaded once; a batch is an
``index_select`` there) and host batches (``batches``) copied to the card
from pinned memory (``to_device``), the port's prefetch.  Reading HDF5
splits (``path=``) waits for ``h5py`` on the card's machine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..transforms.corruption import put_missing_frames
from ..transforms.filters import filter_videos
from ..transforms.normalize import normalize_pose_batch
from ..utils.device import resolve_device
from ..utils.registry import missing_stats


def bucket_length(t: int, multiple: int, max_len: int) -> int:
    return min(((t + multiple - 1) // multiple) * multiple, max_len)


def pad_videos(videos: Sequence[np.ndarray], t_pad: int):
    """Ragged videos -> (B, t_pad, K, 2) float32 zero-padded, and (B,)
    int32 lengths (clamped to t_pad)."""
    out = np.zeros((len(videos), t_pad) + videos[0].shape[1:], np.float32)
    lens = np.zeros(len(videos), np.int32)
    for i, v in enumerate(videos):
        t = min(len(v), t_pad)
        out[i, :t] = v[:t]
        lens[i] = t
    return out, lens


def pad_with_sos(videos: Sequence[np.ndarray], t_pad: int,
                 sos_value: float):
    """(B, t_pad + 1, ...) with a constant start frame prepended to each
    zero-padded video (the reference's ``add_sos``)."""
    padded, _ = pad_videos(videos, t_pad)
    out = np.full((len(videos), t_pad + 1) + padded.shape[2:], sos_value,
                  np.float32)
    out[:, 1:] = padded
    return out


def _assemble_corrupted(corrupted, ids, t_pad):
    """Precorrupted videos and masks -> (B, t_pad + 1, K, 2) inputs and
    (B, t_pad + 1) masks with the start frame (1.0, mask 0) prepended."""
    return (pad_with_sos([corrupted[i][0] for i in ids], t_pad, 1.0),
            pad_with_sos([corrupted[i][1] for i in ids], t_pad, 0.0))


@dataclasses.dataclass
class Batch:
    """One padded batch on the host.  ``weight`` zeroes the rows that
    repeat row 0 to fill a short batch, so epoch means ignore them."""

    clean: np.ndarray              # (B, T, K, 2)
    length: np.ndarray             # (B,)
    weight: np.ndarray             # (B,)
    inputs: Optional[np.ndarray] = None   # (B, T+1, K, 2) precorrupted + SOS
    mask: Optional[np.ndarray] = None     # (B, T+1)

    @property
    def valid(self) -> np.ndarray:
        T = self.clean.shape[1]
        return (np.arange(T)[None, :] < self.length[:, None]).astype(
            np.float32)


def to_device(arrays, device) -> tuple:
    """Host arrays -> tensors on ``device``; for the card, each is copied
    from pinned memory without blocking the host, so the copy of the next
    batch overlaps the card's work on this one."""
    dev = torch.device(device)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return tuple(out)


class KeypointDataset:
    """Load -> filter -> normalize, held on the host as a ragged float32
    list of (T_i, 54, 2) videos."""

    def __init__(self, videos: Optional[List[np.ndarray]] = None,
                 path: Optional[str] = None,
                 dataset_name: Optional[str] = None,
                 normalize: bool = True, apply_filter: bool = True,
                 max_seq_len: int = 512, bucket_multiple: int = 32):
        if videos is None:
            raise NotImplementedError(
                f"KeypointDataset(path={path!r}): reading HDF5 splits waits "
                "for h5py on the card's machine; pass videos=")
        self.dataset_name = dataset_name or "all"
        self.max_seq_len = max_seq_len
        self.bucket_multiple = bucket_multiple
        videos = [np.asarray(v, np.float32)[:max_seq_len] for v in videos]
        if apply_filter:
            videos, self.dropped = filter_videos(videos)
        else:
            self.dropped = 0
        if normalize and videos:
            videos = self._normalize_bucketed(videos)
        self.videos = videos

    def _buckets(self, order=None, videos=None) -> Dict[int, List[int]]:
        """{t_pad: video indices}, each list in ``order`` (default: the
        videos' own), the buckets in the order they first occur."""
        videos = self.videos if videos is None else videos
        out: Dict[int, List[int]] = {}
        for i in range(len(videos)) if order is None else order:
            out.setdefault(bucket_length(len(videos[i]), self.bucket_multiple,
                                         self.max_seq_len), []).append(int(i))
        return out

    def _normalize_bucketed(self, videos):
        """Normalize once per bucket shape, on the host."""
        out: List[Optional[np.ndarray]] = [None] * len(videos)
        for t_pad, idxs in self._buckets(videos=videos).items():
            padded, lens = pad_videos([videos[i] for i in idxs], t_pad)
            res = normalize_pose_batch(torch.from_numpy(padded)).numpy()
            for row, i in enumerate(idxs):
                out[i] = res[row, :lens[row]]
        return out

    def __len__(self):
        return len(self.videos)

    # -- batching ----------------------------------------------------------

    def _bucketed_indices(self, order: np.ndarray, batch_size: int):
        for t_pad, idxs in sorted(self._buckets(order).items()):
            for s in range(0, len(idxs), batch_size):
                yield t_pad, idxs[s:s + batch_size]

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0,
                corrupted: Optional[Dict[int, tuple]] = None
                ) -> Iterator[Batch]:
        """Fixed-shape host batches; a short batch is filled by repeating
        its first row with weight 0."""
        order = np.arange(len(self.videos))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for t_pad, idxs in self._bucketed_indices(order, batch_size):
            fill = batch_size - len(idxs)
            src = idxs + [idxs[0]] * fill
            clean, lens = pad_videos([self.videos[i] for i in src], t_pad)
            weight = np.concatenate([np.ones(len(idxs), np.float32),
                                     np.zeros(fill, np.float32)])
            batch = Batch(clean=clean, length=lens, weight=weight)
            if corrupted is not None:
                batch.inputs, batch.mask = _assemble_corrupted(
                    corrupted, src, t_pad)
            yield batch

    def num_batches(self, batch_size: int) -> int:
        return sum(1 for _ in self._bucketed_indices(
            np.arange(len(self.videos)), batch_size))

    # -- device-resident batching -------------------------------------------

    def device_buckets(self, corrupted: Optional[Dict[int, tuple]] = None,
                       device="cuda") -> Dict[int, dict]:
        """Each length bucket uploaded once, as stacked tensors on
        ``device`` (the card unless the caller asks for the CPU):
        {t_pad: {"clean", "length", "ids" and, with ``corrupted``,
        "inputs", "mask"}}, in increasing t_pad."""
        dev = resolve_device(device, "KeypointDataset.device_buckets")
        out: Dict[int, dict] = {}
        for t_pad, idxs in sorted(self._buckets().items()):
            clean, lens = pad_videos([self.videos[i] for i in idxs], t_pad)
            arrays = [clean, lens.astype(np.int64)]
            if corrupted is not None:
                arrays += list(_assemble_corrupted(corrupted, idxs, t_pad))
            tensors = to_device(arrays, dev)
            entry = {"clean": tensors[0], "length": tensors[1], "ids": idxs}
            if corrupted is not None:
                entry["inputs"], entry["mask"] = tensors[2], tensors[3]
            out[t_pad] = entry
        return out

    def device_batches(self, buckets: Dict[int, dict], batch_size: int,
                       shuffle: bool = False, seed: int = 0):
        """Batches gathered on the device from ``device_buckets()``:
        (t_pad, {name: tensor}, weight (B,) on the host).  Short batches
        repeat their first row with weight 0, as the host batches do; the
        order is the JAX ``device_batches`` / ``device_batch_plan`` one."""
        rng = np.random.default_rng(seed)
        for t_pad, entry in buckets.items():
            n = len(entry["ids"])
            order = rng.permutation(n) if shuffle else np.arange(n)
            dev = entry["clean"].device
            for s in range(0, n, batch_size):
                rows = order[s:s + batch_size]
                fill = batch_size - len(rows)
                weight = np.concatenate([np.ones(len(rows), np.float32),
                                         np.zeros(fill, np.float32)])
                if fill:
                    rows = np.concatenate([rows, [rows[0]] * fill])
                idx = torch.from_numpy(rows.astype(np.int64)).to(dev)
                picked = {k: v.index_select(0, idx)
                          for k, v in entry.items() if k != "ids"}
                yield t_pad, picked, weight

    # -- validation corruption (computed once) -------------------------------

    def precompute_corruption(self, seed: int = 42,
                              is_random_missing: bool = False,
                              registry_path: Optional[str] = None,
                              device="cuda") -> Dict[int, tuple]:
        """Corrupt every video once, per bucket on ``device`` from a
        generator seeded with ``seed``: {video index: (corrupted (T, K, 2),
        mask (T,))} on the host, without the start frame (batch assembly
        prepends it).  The same seed and device give the same result."""
        dev = resolve_device(device, "KeypointDataset.precompute_corruption")
        stats = None
        name = self.dataset_name
        if not is_random_missing and name != "all":
            try:
                stats = missing_stats(name, registry_path)
            except KeyError:
                stats = None  # the generic 'all' block mode (train/loop.py)
        g = torch.Generator(device=dev).manual_seed(seed)
        out: Dict[int, tuple] = {}
        for t_pad, idxs in self._buckets().items():
            padded, lens = pad_videos([self.videos[i] for i in idxs], t_pad)
            video, length = to_device([padded, lens.astype(np.int64)], dev)
            with torch.no_grad():
                vv, mm = put_missing_frames(
                    g, video, is_random_missing=is_random_missing,
                    dataset_name="all" if stats is None else name,
                    stats=stats, t_actual=length)
            vv, mm = vv.cpu().numpy(), mm.cpu().numpy()
            for row, i in enumerate(idxs):
                t = lens[row]
                out[i] = (vv[row, :t], mm[row, :t])
        return out
