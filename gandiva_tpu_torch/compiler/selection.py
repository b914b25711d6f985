"""SelectionVector — typed row-index vectors.

Reference: gandiva/selection_vector.h (libgandiva.pxd:43-71): a typed index
vector (UINT16/UINT32/UINT64 modes) produced by Filter and consumed by
Projector, convertible to an Arrow array.

As in gandiva_tpu, a selection is an ``(indices[capacity], count)`` pair:
indices of selected rows packed to the front in row order, with ``count`` a
0-d int32 device tensor, so producing one never syncs the host. Only
``indices[:count]`` is meaningful. The indices are int32 for UINT16 and
UINT32 (row counts stay below 2^31) and int64 for UINT64; numpy and Arrow
see the mode's unsigned type.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class SelectionMode(enum.Enum):
    NONE = "none"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"


_MODE_NP = {
    SelectionMode.UINT16: np.uint16,
    SelectionMode.UINT32: np.uint32,
    SelectionMode.UINT64: np.uint64,
}


def mode_index_dtype(mode: SelectionMode) -> torch.dtype:
    return torch.int64 if mode is SelectionMode.UINT64 else torch.int32


def check_uint16_capacity(capacity: int) -> None:
    """Reference parity: MakeInt16 bounds capacity at construction
    (libgandiva.pxd:58-71); wrapping indices ≥ 65536 would corrupt
    downstream gathers."""
    if capacity > (1 << 16):
        raise ValueError(
            "selection mode UINT16 cannot address batches over 65536 rows "
            f"(batch capacity {capacity})")


class SelectionVector:
    """(indices, count) pair."""

    def __init__(self, indices, count, mode: SelectionMode = SelectionMode.UINT32):
        self.indices = indices
        self.count = count
        self.mode = mode

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[0])

    def __len__(self) -> int:
        """Host-syncing logical count (mirrors SelectionVector GetNumSlots)."""
        return int(self.count)

    def to_numpy(self) -> np.ndarray:
        return self.indices[:len(self)].cpu().numpy().astype(_MODE_NP[self.mode])

    def to_array(self):
        """First ``count`` indices as a pyarrow array (gandiva ToArray,
        gandiva.pyx:174-176)."""
        import pyarrow as pa

        return pa.array(self.to_numpy())

    @staticmethod
    def from_mask(mask, mode: SelectionMode = SelectionMode.UINT32,
                  capacity: int | None = None) -> "SelectionVector":
        """Compact a boolean mask into packed indices; with ``capacity``,
        that many (survivors past it drop, ``count`` stays the full
        count)."""
        from ..ops.compaction import compact_mask

        if mode is SelectionMode.UINT16 and mask.shape[0] > (1 << 16):
            raise ValueError(
                "selection mode UINT16 cannot address masks over 65536 "
                f"rows (got {mask.shape[0]})")
        idx, count = compact_mask(mask, capacity=capacity,
                                  index_dtype=mode_index_dtype(mode))
        return SelectionVector(idx, count, mode)
