"""Kernel K2: single-pass stable stream compaction with decoupled look-back,
hand-written in CUDA for Hopper.

Replaces ``gandiva_tpu/ops/kernels/compaction_pallas.py::_kernel_fragnet``
(reached through ``compact_pallas_u32_fragnet`` there). Source:
``csrc/compaction_fragnet.cu``, which shares its tile code with K1's
(``csrc/compaction_tile.cuh``); built by ``build.py`` and bound with ctypes.

Contract (K1's, ``compaction.py``): a 1-D bool ``mask[n]`` and payload
columns of 1, 2, 4 or 8 bytes go in; int32 ``indices`` and each payload come
out packed to the front in row order, every output of length n and
meaningful on ``[:count]``; ``count`` is a 0-d int32 device tensor, written
by the kernel, so nothing syncs the host.

Bound: bytes. Each input read once (the mask's 1 B a row and the payload
bytes), each output written once (a 4 B index and the payload bytes a
survivor); K2 reads the mask once where K1 reads it twice.

The wrapper zeroes the tiles' descriptors and the tile counter with one
``torch.zeros`` per call and launches the single pass, which moves up to
``MAX_PAYLOADS`` payloads. The kernel stages a tile's payloads in shared
memory, in groups of columns it plans from their widths; the first group's
loads are in flight during the look-back. More payloads than
``MAX_PAYLOADS``: the single pass also records each tile's survivor count,
and one launch per later group of K1's offsets-given scatter
(``csrc/compaction_tile.cuh``) reuses them.
``compact_fragnet_columns`` launches the kernel for CUDA tensors and takes
``compact_fragnet_plain`` only for CPU tensors; there is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ...utils.ints import signed_view
from . import LAUNCHES, build
from .build import INT, LL, VP, check
from .compaction import MAX_PAYLOADS, _validate, payload_group

_FUNCTIONS = {
    "gt_fragnet_compact": (INT, [VP, LL, VP, VP, VP, VP, INT, VP, VP, VP,
                                 VP]),
    "gt_fragnet_scatter": (INT, [VP, LL, VP, INT, VP, VP, VP, VP]),
    "gt_fragnet_tile_rows": (INT, []),
    "gt_fragnet_max_payloads": (INT, [])}
_EXPECT = {"gt_fragnet_max_payloads": MAX_PAYLOADS}


def library() -> ctypes.CDLL:
    """K2's kernel library, built at first use."""
    return build.load("compaction_fragnet", _FUNCTIONS, _EXPECT)


def compact_fragnet_cuda(mask: torch.Tensor, columns: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                    torch.Tensor]:
    """Launch K2 on ``mask``'s card: (indices, packed columns, count)."""
    if mask.device.type != "cuda":
        raise ValueError(f"compact_fragnet_cuda takes CUDA tensors, got "
                         f"{mask.device}")
    _validate(mask, columns)
    n = mask.shape[0]
    dev = mask.device
    indices = torch.empty(n, dtype=torch.int32, device=dev)
    outs = [torch.empty_like(c) for c in columns]
    if n == 0:
        return indices, outs, torch.zeros((), dtype=torch.int32, device=dev)
    lib = library()
    tiles = -(-n // lib.gt_fragnet_tile_rows())
    status = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    more = len(columns) > MAX_PAYLOADS
    tile_counts = torch.empty(tiles, dtype=torch.int32, device=dev) \
        if more else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        first = range(min(len(columns), MAX_PAYLOADS))
        check(lib, lib.gt_fragnet_compact(
            mask.data_ptr(), n, status.data_ptr(),
            tile_counts.data_ptr() if more else None, count.data_ptr(),
            indices.data_ptr(), len(first),
            *payload_group(columns, outs, first), stream),
            "gt_fragnet_compact")
        LAUNCHES["compact_fragnet"] += 1
        for g in range(MAX_PAYLOADS, len(columns), MAX_PAYLOADS):
            group = range(g, min(g + MAX_PAYLOADS, len(columns)))
            check(lib, lib.gt_fragnet_scatter(
                mask.data_ptr(), n, tile_counts.data_ptr(), len(group),
                *payload_group(columns, outs, group), stream),
                "gt_fragnet_scatter")
            LAUNCHES["compact_fragnet"] += 1
    return indices, outs, count


def compact_fragnet_plain(mask: torch.Tensor, columns: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                     torch.Tensor]:
    """K2's plain torch version, the reference's portable formulation
    (``gandiva_tpu/ops/compaction.py::compact_mask``): an exclusive cumsum
    of the mask gives each survivor its slot, and the row ids and payloads
    scatter into n + 1 buffers whose last slot takes every dropped row.
    Outputs are zero past ``count``; nothing syncs the host."""
    _validate(mask, columns)
    n = mask.shape[0]
    dev = mask.device
    m = mask.to(torch.int32)
    inclusive = torch.cumsum(m, 0, dtype=torch.int32)
    count = inclusive[-1].clone() if n else torch.zeros(
        (), dtype=torch.int32, device=dev)
    slot = torch.where(mask, inclusive - m, n).to(torch.int64)
    indices = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indices[slot] = torch.arange(n, dtype=torch.int32, device=dev)
    outs = []
    for col in columns:
        bits = signed_view(col)
        out = torch.zeros(n + 1, dtype=bits.dtype, device=dev)
        out[slot] = bits
        outs.append(out[:n].view(col.dtype))
    return indices[:n], outs, count


def compact_fragnet_columns(mask: torch.Tensor,
                            columns: Sequence[torch.Tensor]):
    """K2's wrapper: the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (indices, packed columns, count)."""
    if mask.device.type == "cuda":
        return compact_fragnet_cuda(mask, columns)
    if mask.device.type == "cpu":
        return compact_fragnet_plain(mask, columns)
    raise ValueError(f"no compaction for device {mask.device}")
