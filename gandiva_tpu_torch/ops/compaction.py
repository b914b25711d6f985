"""Stream compaction: boolean mask → packed row indices (+ payload).

The engine-wide primitive behind SelectionVector production (Filter's hot
loop in the reference writes selected row indices sequentially —
SURVEY.md §3.3). All formulations share one contract: outputs of length n,
survivors packed to the front in row order, meaningful on ``[:count]``,
``count`` a 0-d int32 tensor; indices are int32 row numbers, or of the
``index_dtype`` asked for, unsigned types held as the signed bits of the
same width (as ``dtypes.py`` holds them).

- ``compact_best``: kernel K1 (ops/kernels/compaction.py) — the hand-written
  CUDA kernel for tensors on a card, its plain version for CPU tensors;
- ``compact_mask`` / ``compact_values``: the same, for indices only / one
  column; with ``capacity`` the output holds that many rows, the survivors
  past it drop and the rest is zero, as the reference's, while ``count``
  stays the full count;
- ``compact_fragnet``: kernel K2 (ops/kernels/compaction_fragnet.py), the
  single-pass look-back compaction, with the same contract; the join's
  residue compactions take it;
- ``compact_sort``: a stable sort on the 1-bit drop key carrying the indices
  and payloads — the reference's portable formulation, kept as an
  independent check (its tail holds the dropped rows, permuted).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .kernels.compaction import compact_columns
from .kernels.compaction_fragnet import compact_fragnet_columns


_SIGNED = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def index_storage(index_dtype) -> torch.dtype:
    """The torch dtype holding indices of ``index_dtype`` (a torch or numpy
    integer dtype): uint16, uint32 and uint64 as the signed type of the
    same width, every other integer type as itself."""
    if isinstance(index_dtype, torch.dtype):
        if index_dtype.is_floating_point or index_dtype.is_complex \
                or index_dtype == torch.bool:
            raise ValueError(f"index_dtype must be an integer type, got "
                             f"{index_dtype}")
        if index_dtype in (torch.uint16, torch.uint32, torch.uint64):
            return _SIGNED[index_dtype.itemsize]
        return index_dtype
    dt = np.dtype(index_dtype)
    if dt.kind not in "iu":
        raise ValueError(f"index_dtype must be an integer type, got {dt}")
    if dt.kind == "u" and dt.itemsize > 1:
        return _SIGNED[dt.itemsize]
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _to_capacity(x: torch.Tensor, count: torch.Tensor,
                 capacity: Optional[int]) -> torch.Tensor:
    """``x`` cut or zero-padded to ``capacity`` rows, zero from ``count``
    on: the reference's capacity-sized buffer. No host sync."""
    if capacity is None:
        return x
    if capacity < 0:
        raise ValueError(f"capacity must be non-negative, got {capacity}")
    n = x.shape[0]
    out = x[:capacity] if capacity <= n else torch.cat(
        [x, x.new_zeros(capacity - n)])
    keep = torch.arange(capacity, device=x.device) < count
    return torch.where(keep, out, out.new_zeros(()))


def compact_best(mask, payload: Sequence = (), index_dtype=torch.uint32):
    """Returns (indices, count, packed payloads) — the reference's
    compact_best contract, on kernel K1."""
    idx, cols, count = compact_columns(mask, list(payload))
    return idx.to(index_storage(index_dtype)), count, cols


def compact_fragnet(mask, payload: Sequence = ()):
    """Returns (indices, count, packed payloads) — ``compact_best``'s
    contract, on kernel K2."""
    idx, cols, count = compact_fragnet_columns(mask, list(payload))
    return idx, count, cols


def compact_mask(mask, capacity: Optional[int] = None,
                 index_dtype=torch.uint32):
    """Return (indices, count): positions of True packed to the front; with
    ``capacity``, ``capacity`` of them, the tail zero."""
    idx, count, _ = compact_best(mask, index_dtype=index_dtype)
    return _to_capacity(idx, count, capacity), count


def compact_values(mask, values, capacity: Optional[int] = None):
    """Pack ``values[mask]`` to the front. Returns (packed, count); with
    ``capacity``, ``capacity`` rows, the tail zero."""
    _, count, (packed,) = compact_best(mask, [values])
    return _to_capacity(packed, count, capacity), count


def compact_sort(mask, payload: Sequence = (), index_dtype=torch.uint32):
    """Sort-based compaction: returns (indices, count, packed payloads)."""
    drop = torch.logical_not(mask).to(torch.uint8)
    _, perm = torch.sort(drop, stable=True)
    count = torch.sum(mask, dtype=torch.int32)
    return perm.to(index_storage(index_dtype)), count, \
        [p[perm] for p in payload]
