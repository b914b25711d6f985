"""Kernel K1: stable stream compaction, hand-written in CUDA for Hopper.

Replaces ``gandiva_tpu/ops/kernels/compaction_pallas.py::_kernel`` (reached
through ``compact_pallas_u32`` and ``compact_columns`` there). Source:
``csrc/compaction.cu``, built by ``build.py`` and bound with ctypes.

Contract (the reference's): a bool ``mask[n]`` and payload columns go in;
``indices`` (int32 holding the uint32 row numbers, so n < 2^31) and each
payload come out packed to the front in row order, every output of length
n and meaningful on ``[:count]``; ``count`` is a 0-d int32 device tensor, so
a caller that does not ask for it never syncs the host. Any number of
payloads: one scatter launch moves up to ``MAX_PAYLOADS`` of them, so the
wrapper launches one per group over the same tile counts.

Bound: bytes. Each row's 1 B mask is read once; each survivor's payloads
are read once and written once with its 4 B index
(``chip_smoke.py::compaction_bytes``). The flagship batch (n = 64Mi rows,
survivor fraction ≈ 0.474, payloads f64 + bool) moves 67.1 MB of mask and
31.8M × (4 + 2 × 9) B ≈ 0.767 GB in all: 0.2289 ms at the H100 SXM's
3.35 TB/s. The design (a count pass over 16-byte mask vectors, then the
offsets-given scatter of ``compaction_tile.cuh``, which sums the counts
before each tile itself and loads dense tiles whole with bulk copies) is
described in the source.

``compact_columns`` launches the kernel for CUDA tensors and takes
``compact_columns_plain`` only for CPU tensors; there is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ... import tracing
from . import LAUNCHES, build
from .build import INT, LL, VP, check

MAX_PAYLOADS = 8
_WIDTHS = (1, 2, 4, 8)
_FUNCTIONS = {
    "gt_compact_count": (INT, [VP, LL, VP, VP]),
    "gt_compact_scatter": (INT, [VP, LL, VP, VP, VP, INT, VP, VP, VP, VP]),
    "gt_compact_scatter_shape": (INT, [INT, VP, VP]),
    "gt_compact_tile_rows": (INT, []),
    "gt_compact_max_payloads": (INT, [])}
_EXPECT = {"gt_compact_max_payloads": MAX_PAYLOADS}


def _lib() -> ctypes.CDLL:
    """K1's kernel library, built at first use."""
    return build.load("compaction", _FUNCTIONS, _EXPECT)


def _validate(mask: torch.Tensor, columns: Sequence[torch.Tensor]) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"mask must be a 1-D bool tensor, got {mask.dtype} "
                         f"of shape {tuple(mask.shape)}")
    n = mask.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"compaction takes fewer than 2^31 rows, got {n}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    for c in columns:
        if c.device != mask.device:
            raise ValueError(f"payload on {c.device}, mask on {mask.device}")
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"payload of shape {tuple(c.shape)} for a mask "
                             f"of {n} rows")
        if not c.is_contiguous():
            raise ValueError("payload columns must be contiguous")
        if c.element_size() not in _WIDTHS:
            raise ValueError(f"payload dtype {c.dtype} is not 1, 2, 4 or 8 "
                             "bytes wide")


def payload_group(columns: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor], group: range) -> list:
    """One launch's payload arguments: ctypes arrays of the group's input
    and output pointers and element widths, as void pointers."""
    ins = (ctypes.c_void_p * MAX_PAYLOADS)(
        *[columns[i].data_ptr() for i in group])
    outp = (ctypes.c_void_p * MAX_PAYLOADS)(*[outs[i].data_ptr()
                                              for i in group])
    widths = (ctypes.c_int * MAX_PAYLOADS)(
        *[columns[i].element_size() for i in group])
    return [ctypes.cast(a, ctypes.c_void_p) for a in (ins, outp, widths)]


def tile_counts(mask: torch.Tensor) -> torch.Tensor:
    """K1's count pass: the survivors of each 4096-row tile of a CUDA
    ``mask``, as int32."""
    lib = _lib()
    n = mask.shape[0]
    counts = torch.empty(-(-n // lib.gt_compact_tile_rows()),
                         dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        check(lib, lib.gt_compact_count(mask.data_ptr(), n,
                                        counts.data_ptr(), stream),
              "gt_compact_count")
    return counts


def scatter(mask: torch.Tensor, counts: torch.Tensor,
            columns: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """K1's second pass: each tile's survivors to the run after those of
    the tiles before it (``counts``: ``tile_counts``), one launch per group
    of ``MAX_PAYLOADS`` columns; the first (which may have no column)
    writes the row indices and the count. Returns (indices, packed
    columns, count)."""
    lib = _lib()
    n = mask.shape[0]
    indices = torch.empty(n, dtype=torch.int32, device=mask.device)
    outs = [torch.empty_like(c) for c in columns]
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        for g in range(0, max(len(columns), 1), MAX_PAYLOADS):
            group = range(g, min(g + MAX_PAYLOADS, len(columns)))
            check(lib, lib.gt_compact_scatter(
                mask.data_ptr(), n, counts.data_ptr(),
                indices.data_ptr() if g == 0 else None,
                count.data_ptr() if g == 0 else None, len(group),
                *payload_group(columns, outs, group), stream),
                "gt_compact_scatter")
            LAUNCHES["compact"] += 1
    return indices, outs, count


def scatter_shape(columns: Sequence[torch.Tensor]) -> Tuple[int, int, int]:
    """The scatter's persistent grid (SMs × CTAs an SM), its stages and its
    dynamic shared memory in bytes, for the first group of ``columns`` on
    the current card."""
    lib = _lib()
    group = range(min(len(columns), MAX_PAYLOADS))
    widths = (ctypes.c_int * MAX_PAYLOADS)(
        *[columns[i].element_size() for i in group])
    shape = (ctypes.c_int * 3)()
    check(lib, lib.gt_compact_scatter_shape(len(group), widths, shape),
          "gt_compact_scatter_shape")
    return shape[0], shape[1], shape[2]


def compact_columns_cuda(mask: torch.Tensor, columns: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                    torch.Tensor]:
    """Launch K1 on ``mask``'s card: (indices, packed columns, count)."""
    if mask.device.type != "cuda":
        raise ValueError(f"compact_columns_cuda takes CUDA tensors, got "
                         f"{mask.device}")
    _validate(mask, columns)
    if mask.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=mask.device),
                [torch.empty_like(c) for c in columns],
                torch.zeros((), dtype=torch.int32, device=mask.device))
    return scatter(mask, tile_counts(mask), columns)


def compact_columns_plain(mask: torch.Tensor, columns: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                     torch.Tensor]:
    """K1's plain torch version: nonzero + index_select into n-sized
    outputs (tail zero). Syncs the host on a card (nonzero's size)."""
    _validate(mask, columns)
    n = mask.shape[0]
    with tracing.sync("nonzero"):
        sel = torch.nonzero(mask).flatten()
    c = sel.shape[0]
    indices = torch.zeros(n, dtype=torch.int32, device=mask.device)
    indices[:c] = sel.to(torch.int32)
    outs = []
    for col in columns:
        out = torch.zeros_like(col)
        out[:c] = col.index_select(0, sel)
        outs.append(out)
    return indices, outs, torch.tensor(c, dtype=torch.int32,
                                       device=mask.device)


def compact_columns(mask: torch.Tensor, columns: Sequence[torch.Tensor]):
    """K1's wrapper: the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (indices, packed columns, count)."""
    if mask.device.type == "cuda":
        return compact_columns_cuda(mask, columns)
    if mask.device.type == "cpu":
        return compact_columns_plain(mask, columns)
    raise ValueError(f"no compaction for device {mask.device}")
