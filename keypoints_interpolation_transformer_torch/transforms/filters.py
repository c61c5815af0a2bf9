"""Load-time video filters (port of the JAX ``transforms/filters.py``):
vectorized numpy, on the host, run once.

The reference's bad-video filter, with its control-flow quirks:

  * videos shorter than 10 frames are dropped, except zero-length videos,
    which are kept;
  * only frames 8 .. T - 8 are inspected (the stored video is not
    trimmed);
  * a frame is bad when a wrist coincides (in any coordinate) with both
    the hand's thumb tip and middle-finger DIP;
  * the flag is read one frame late, so a bad last inspected frame alone
    never rejects the video.
"""

from __future__ import annotations

import numpy as np

from ..data.keypoints import body_map


def is_bad_video(video: np.ndarray, bm=None) -> bool:
    """True if the video should be dropped."""
    bm = bm or body_map()
    n = len(video)
    if n == 0:
        return False
    if n < 10:
        return True
    v = video[8:-8]
    if len(v) == 0:
        return False
    idx = bm.index_of
    rw = v[:, idx["pose_right_wrist"]]
    lw = v[:, idx["pose_left_wrist"]]
    bad_r = (np.any(rw == v[:, idx["rightHand_thumb_tip"]], axis=1)
             & np.any(rw == v[:, idx["rightHand_middle_finger_dip"]], axis=1))
    bad_l = (np.any(lw == v[:, idx["leftHand_thumb_tip"]], axis=1)
             & np.any(lw == v[:, idx["leftHand_middle_finger_dip"]], axis=1))
    return bool(np.any((bad_r | bad_l)[:-1]))


def filter_videos(videos, bm=None):
    """(kept videos, number dropped)."""
    bm = bm or body_map()
    kept = [v for v in videos if not is_bad_video(v, bm)]
    return kept, len(videos) - len(kept)
