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
wrapper launches one per group over the same tile offsets.

Bound: bytes. The flagship batch (n = 64Mi rows, survivor fraction ≈ 0.474,
payloads f64 + bool) must read mask 1 B + f64 8 B + validity 1 B = 10 B/row
and write 0.474 × (4 + 8 + 1) ≈ 6.2 B/row: ≈ 16.2 B/row, ≈ 1.08 GB per
call, ≈ 0.32 ms at the H100 SXM's 3.35 TB/s. The design (two passes over
4096-row tiles, warp ballots, coalesced stores) is described in the source.

``compact_columns`` launches the kernel for CUDA tensors and takes
``compact_columns_plain`` only for CPU tensors; there is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import LAUNCHES, build

MAX_PAYLOADS = 8
_WIDTHS = (1, 2, 4, 8)


def _lib() -> ctypes.CDLL:
    lib = build.load("compaction")
    if not getattr(lib, "_gt_typed", False):
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gt_compact_count.argtypes = [vp, ll, vp, vp]
        lib.gt_compact_count.restype = ci
        lib.gt_compact_scatter.argtypes = [vp, ll, vp, vp, ci, vp, vp, vp, vp]
        lib.gt_compact_scatter.restype = ci
        lib.gt_compact_tile_rows.restype = ci
        lib.gt_compact_max_payloads.restype = ci
        lib.gt_error_string.argtypes = [ci]
        lib.gt_error_string.restype = ctypes.c_char_p
        if lib.gt_compact_max_payloads() != MAX_PAYLOADS:
            raise RuntimeError("csrc/compaction.cu disagrees on MAX_PAYLOADS")
        lib._gt_typed = True
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} failed: {lib.gt_error_string(code).decode()} ({code})")


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


def compact_columns_cuda(mask: torch.Tensor, columns: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                    torch.Tensor]:
    """Launch K1 on ``mask``'s card: (indices, packed columns, count)."""
    if mask.device.type != "cuda":
        raise ValueError(f"compact_columns_cuda takes CUDA tensors, got "
                         f"{mask.device}")
    _validate(mask, columns)
    n = mask.shape[0]
    dev = mask.device
    indices = torch.empty(n, dtype=torch.int32, device=dev)
    outs = [torch.empty_like(c) for c in columns]
    if n == 0:
        return indices, outs, torch.zeros((), dtype=torch.int32, device=dev)
    lib = _lib()
    tile = lib.gt_compact_tile_rows()
    counts = torch.empty(-(-n // tile), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.gt_compact_count(mask.data_ptr(), n,
                                         counts.data_ptr(), stream),
               "gt_compact_count")
        inclusive = torch.cumsum(counts, 0, dtype=torch.int32)
        offsets = inclusive - counts
        # one scatter per group of MAX_PAYLOADS columns, all over the same
        # offsets; the first group (which may be empty) writes the indices
        for g in range(0, max(len(columns), 1), MAX_PAYLOADS):
            group = range(g, min(g + MAX_PAYLOADS, len(columns)))
            _check(lib, lib.gt_compact_scatter(
                mask.data_ptr(), n, offsets.data_ptr(),
                indices.data_ptr() if g == 0 else None, len(group),
                *payload_group(columns, outs, group), stream),
                "gt_compact_scatter")
            LAUNCHES["compact"] += 1
    return indices, outs, inclusive[-1]


def compact_columns_plain(mask: torch.Tensor, columns: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                     torch.Tensor]:
    """K1's plain torch version: nonzero + index_select into n-sized
    outputs (tail zero). Syncs the host on a card (nonzero's size)."""
    _validate(mask, columns)
    n = mask.shape[0]
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
