"""Stream compaction: boolean mask → packed row indices (+ payload).

The engine-wide primitive behind SelectionVector production (Filter's hot
loop in the reference writes selected row indices sequentially —
SURVEY.md §3.3). All formulations share one contract: outputs of length n,
survivors packed to the front in row order, meaningful on ``[:count]``,
``count`` a 0-d int32 tensor; indices are int32 row numbers.

- ``compact_best``: kernel K1 (ops/kernels/compaction.py) — the hand-written
  CUDA kernel for tensors on a card, its plain version for CPU tensors;
- ``compact_mask`` / ``compact_values``: the same, for indices only / one
  column;
- ``compact_fragnet``: kernel K2 (ops/kernels/compaction_fragnet.py), the
  single-pass look-back compaction, with the same contract; the join's
  residue compactions take it;
- ``compact_sort``: a stable sort on the 1-bit drop key carrying the indices
  and payloads — the reference's portable formulation, kept as an
  independent check (its tail holds the dropped rows, permuted).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .kernels.compaction import compact_columns
from .kernels.compaction_fragnet import compact_fragnet_columns


def compact_best(mask, payload: Sequence = ()):
    """Returns (indices, count, packed payloads) — the reference's
    compact_best contract, on kernel K1."""
    idx, cols, count = compact_columns(mask, list(payload))
    return idx, count, cols


def compact_fragnet(mask, payload: Sequence = ()):
    """Returns (indices, count, packed payloads) — ``compact_best``'s
    contract, on kernel K2."""
    idx, cols, count = compact_fragnet_columns(mask, list(payload))
    return idx, count, cols


def compact_mask(mask):
    """Return (indices, count): positions of True packed to the front."""
    idx, count, _ = compact_best(mask)
    return idx, count


def compact_values(mask, values):
    """Pack ``values[mask]`` to the front. Returns (packed, count)."""
    _, count, (packed,) = compact_best(mask, [values])
    return packed, count


def compact_sort(mask, payload: Sequence = ()):
    """Sort-based compaction: returns (indices, count, packed payloads)."""
    drop = torch.logical_not(mask).to(torch.uint8)
    _, perm = torch.sort(drop, stable=True)
    count = torch.sum(mask, dtype=torch.int32)
    return perm.to(torch.int32), count, [p[perm] for p in payload]
