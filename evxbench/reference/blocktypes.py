"""Copy of cairo_tpu.blocktypes: block type codes and the struct-of-arrays block table."""

from __future__ import annotations

import dataclasses

import numpy as np

INTRA_BIT = 1
MOTION_BIT = 2
COPY_BIT = 4

INTRA_DEFAULT = 1       # intra, no motion, delta (vs nothing)
INTRA_MOTION_COPY = 7
INTRA_MOTION_DELTA = 3
INTER_COPY = 4
INTER_DELTA = 0
INTER_MOTION_COPY = 6
INTER_MOTION_DELTA = 2

FRAME_INTRA = 0
FRAME_INTER = 1


def is_intra(t):
    return (t & INTRA_BIT) != 0


def is_motion(t):
    return (t & MOTION_BIT) != 0


def is_copy(t):
    return (t & COPY_BIT) != 0


@dataclasses.dataclass
class BlockTable:
    """Per-macroblock descriptors, struct-of-arrays (common.h:78-95)."""

    block_type: np.ndarray         # uint8, 3-bit code
    prediction_target: np.ndarray  # uint8, ring offset (0 intra, 1..3 inter)
    motion_x: np.ndarray           # int16
    motion_y: np.ndarray           # int16
    sp_pred: np.ndarray            # bool
    sp_amount: np.ndarray          # bool (0 half-pel, 1 quarter-pel)
    sp_index: np.ndarray           # uint8, 3-bit direction
    q_index: np.ndarray            # uint8, per-block QP
    variance: np.ndarray           # int16, debug/peek only

    @classmethod
    def zeros(cls, n: int) -> "BlockTable":
        return cls(
            block_type=np.full(n, INTRA_DEFAULT, dtype=np.uint8),
            prediction_target=np.zeros(n, dtype=np.uint8),
            motion_x=np.zeros(n, dtype=np.int16),
            motion_y=np.zeros(n, dtype=np.int16),
            sp_pred=np.zeros(n, dtype=bool),
            sp_amount=np.zeros(n, dtype=bool),
            sp_index=np.zeros(n, dtype=np.uint8),
            q_index=np.zeros(n, dtype=np.uint8),
            variance=np.zeros(n, dtype=np.int16),
        )

    def __len__(self):
        return len(self.block_type)

    def copy(self) -> "BlockTable":
        return BlockTable(**{f: getattr(self, f).copy() for f in (
            "block_type", "prediction_target", "motion_x", "motion_y",
            "sp_pred", "sp_amount", "sp_index", "q_index", "variance")})


# Sub-pel direction <-> 3-bit index mapping (motion.cpp:61-109):
# index: 0 1 2   correspond to (dx,dy): (-1,-1) (0,-1) (1,-1)
#        3   4                           (-1, 0)        (1, 0)
#        5 6 7                           (-1, 1) (0, 1) (1, 1)
SP_INDEX_TO_DIR = np.array(
    [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1)],
    dtype=np.int16)


def sp_dir_to_index(dx: int, dy: int) -> int:
    i, j = dx + 1, dy + 1
    if j == 0:
        return i
    if j == 1:
        return 3 if i == 0 else 4
    return i + 5
