"""The 54-keypoint catalog of the port (its own copy of the JAX package's
``data/keypoints.py`` constants and body map).

Layout of the 54 keypoints (sections and their sizes):
  pose      (10): nose, eyes, shoulders, elbows, wrists, chest_middle_up
  face       (2): mouth corners
  leftHand  (21): MediaPipe hand landmarks
  rightHand (21): MediaPipe hand landmarks
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

NUM_KEYPOINTS = 54
NUM_COORDS = 2
FRAME_FEATURES = NUM_KEYPOINTS * NUM_COORDS  # 108

_POSE_PARTS = ("nose", "left_eye", "right_eye", "left_shoulder",
               "right_shoulder", "left_elbow", "right_elbow", "left_wrist",
               "right_wrist", "chest_middle_up")
_FACE_PARTS = ("mouth_left", "mouth_right")
_HAND_PARTS = (
    "wrist", "thumb_cmc", "thumb_mcp", "thumb_ip", "thumb_tip",
    "index_finger_mcp", "index_finger_pip", "index_finger_dip",
    "index_finger_tip", "middle_finger_mcp", "middle_finger_pip",
    "middle_finger_dip", "middle_finger_tip", "ring_finger_mcp",
    "ring_finger_pip", "ring_finger_dip", "ring_finger_tip", "pinky_mcp",
    "pinky_pip", "pinky_dip", "pinky_tip")


def _build_tables():
    sections, parts = [], []
    for p in _POSE_PARTS:
        sections.append("pose")
        parts.append(f"pose_{p}")
    for p in _FACE_PARTS:
        sections.append("face")
        parts.append(f"face_{p}")
    for hand in ("leftHand", "rightHand"):
        for p in _HAND_PARTS:
            sections.append(hand)
            parts.append(f"{hand}_{p}")
    return tuple(sections), tuple(parts)


SECTIONS, PART_NAMES = _build_tables()
if len(PART_NAMES) != NUM_KEYPOINTS:
    raise RuntimeError("the keypoint catalog must hold 54 parts")


@dataclasses.dataclass(frozen=True)
class BodyMap:
    """Index sets per body section; ``pose`` holds both the 'pose' and the
    'face' sections (the reference's ``bodyKeypointMap`` quirk)."""

    pose: tuple
    face: tuple
    left_hand: tuple
    right_hand: tuple
    index_of: dict  # part name -> column index

    @property
    def body_identifiers(self) -> tuple:
        """pose(+face) + leftHand + rightHand: the augmentation working
        set."""
        return self.pose + self.left_hand + self.right_hand

    @property
    def hand_identifiers(self) -> tuple:
        return self.left_hand + self.right_hand

    @property
    def arm_chains(self) -> tuple:
        """Per-side arm chains (chest, shoulder, elbow, wrist) of the
        arm-joint-rotate augmentation."""
        left = ("pose_chest_middle_up", "pose_left_shoulder",
                "pose_left_elbow", "pose_left_wrist")
        right = ("pose_chest_middle_up", "pose_right_shoulder",
                 "pose_right_elbow", "pose_right_wrist")
        return (tuple(self.index_of[p] for p in left),
                tuple(self.index_of[p] for p in right))


@lru_cache(maxsize=1)
def body_map(sections=SECTIONS, parts=PART_NAMES) -> BodyMap:
    return BodyMap(
        pose=tuple(i for i, s in enumerate(sections) if s in ("pose", "face")),
        face=tuple(i for i, s in enumerate(sections) if s == "face"),
        left_hand=tuple(i for i, s in enumerate(sections) if s == "leftHand"),
        right_hand=tuple(i for i, s in enumerate(sections)
                         if s == "rightHand"),
        index_of={p: i for i, p in enumerate(parts)})
