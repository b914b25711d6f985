"""Kernel K4: the block sort, hand-written in CUDA for Hopper.

Replaces ``gandiva_tpu/ops/kernels/sort_bitonic.py::_block_kernel`` in the
use the merge sort makes of it (``_run_block_stages`` with
``local_dirs=True``, the leaf of ``merge_sort_u32``). Source:
``csrc/sort_bitonic.cu``, built by ``build.py`` and bound with ctypes.

Contract: ``words`` is a contiguous int64 tensor [k, n], the comparator
words of n rows, most significant first, each holding bits in unsigned
order. Every W-row tile (W = 2^w_log2; the last one may be ragged) comes
out sorted ascending by (words as unsigned, row index): ``block_sort``
returns (``idx`` int32 [n], the row indices; the sorted words [k, n]).
The row index makes the order total, so the result is stable.

Bound: bytes. It must read 8k B a row and write 8k + 4 B a row: at BASELINE
configs[2] (one word, n = 100,000,000) 2 GB, about 0.60 ms at an H100 SXM's
3.35 TB/s. The design (one CTA per tile, ``ITEMS`` rows a thread sorted in
registers, then merge-path levels in shared memory) is described in the
source.

``block_sort`` launches the kernel for CUDA tensors and takes
``block_sort_plain`` only for CPU tensors; there is no fallback from one to
the other. The bitonic passes across tiles of the reference
(``bitonic_sort_u32``, ``_xla_stage``) are not ported: the merge rounds of
``merge_path.py`` take their place.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, build
from .build import INT, LL, VP, check

SMEM_BYTES = 232_448        # dynamic shared memory one Hopper block may use
ITEMS = 16                  # rows a K4 thread holds in registers
DEFAULT_W_LOG2 = 13         # W = 8192 rows, halved until a tile fits
MIN_W_LOG2 = 6
MAX_W_LOG2 = 14             # ITEMS · 1024 threads
I64_MIN = -(1 << 63)
_FUNCTIONS = {"gt_block_sort": (INT, [VP, LL, INT, INT, VP, VP, VP]),
              "gt_block_sort_smem_limit": (INT, []),
              "gt_block_sort_items": (INT, [])}
_EXPECT = {"gt_block_sort_smem_limit": SMEM_BYTES,
           "gt_block_sort_items": ITEMS}


def tile_smem(num_words: int, w_log2: int) -> int:
    """K4's shared memory for a tile: words 1 .. k-1 (8 B a row) and the
    merge buffer's first word and position (12 B a slot: every row, one pad
    slot every ``ITEMS`` rows and one slack row)."""
    w = 1 << w_log2
    return 8 * (num_words - 1) * w + 12 * (w + w // ITEMS + 1)


def tile_log2(num_words: int, w_log2: int = DEFAULT_W_LOG2) -> int:
    """log2 of the tile: ``w_log2`` halved until a tile fits one block's
    shared memory (``tile_smem``); at most ``MAX_W_LOG2``."""
    w_log2 = min(w_log2, MAX_W_LOG2)
    while w_log2 >= MIN_W_LOG2 and tile_smem(num_words, w_log2) > SMEM_BYTES:
        w_log2 -= 1
    if w_log2 < MIN_W_LOG2:
        raise ValueError(f"{num_words} sort words do not fit a tile of "
                         f"{1 << MIN_W_LOG2} rows")
    return w_log2


def validate_words(words: torch.Tensor, w_log2: int) -> None:
    if words.dtype != torch.int64 or words.dim() != 2 \
            or not words.is_contiguous() or words.shape[0] < 1:
        raise ValueError("words must be a contiguous [k, n] int64 tensor with "
                         f"k >= 1, got {words.dtype} of shape "
                         f"{tuple(words.shape)}")
    if not MIN_W_LOG2 <= w_log2 <= MAX_W_LOG2:
        raise ValueError(f"w_log2 must lie in [{MIN_W_LOG2}, {MAX_W_LOG2}], "
                         f"got {w_log2}")
    if words.shape[1] + (1 << w_log2) >= 1 << 31:
        raise ValueError(f"the sort takes fewer than 2^31 - W rows, got "
                         f"{words.shape[1]}")
    if tile_smem(words.shape[0], w_log2) > SMEM_BYTES:
        raise ValueError(f"a tile of 2^{w_log2} rows of {words.shape[0]} "
                         "words does not fit shared memory (tile_log2)")


def _lib() -> ctypes.CDLL:
    return build.load("sort_bitonic", _FUNCTIONS, _EXPECT)


def block_sort_cuda(words: torch.Tensor, w_log2: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on ``words``' card: (row indices, sorted words)."""
    if words.device.type != "cuda":
        raise ValueError(f"block_sort_cuda takes CUDA tensors, got "
                         f"{words.device}")
    validate_words(words, w_log2)
    k, n = words.shape
    dev = words.device
    out = torch.empty_like(words)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return idx, out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib, lib.gt_block_sort(words.data_ptr(), n, k, w_log2,
                                     out.data_ptr(), idx.data_ptr(), stream),
              "gt_block_sort")
        LAUNCHES["sort_block"] += 1
    return idx, out


def segment_sort_plain(words: torch.Tensor, idx: torch.Tensor, seg: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort every ``seg``-row segment of ``words`` [k, n] stably by its
    words as unsigned, carrying ``idx``: successive stable ``torch.sort``
    passes over the [segments, seg] view, least significant word first,
    each word compared as signed after its sign bit is flipped. The ragged
    last segment is padded with all-ones words, which sort behind its real
    rows (the sort is stable), and cut off again."""
    k, n = words.shape
    if n == 0:
        return idx.clone(), words.clone()
    segs = -(-n // seg)
    pad = segs * seg - n
    padded = torch.cat([words, words.new_full((k, pad), -1)], 1) \
        .view(k, segs, seg)
    order = torch.arange(seg, device=words.device).expand(segs, seg)
    for w in range(k - 1, -1, -1):
        key = torch.gather(padded[w], 1, order) ^ I64_MIN
        _, o = torch.sort(key, dim=1, stable=True)
        order = torch.gather(order, 1, o)
    out = torch.gather(padded, 2, order.expand(k, segs, seg)) \
        .reshape(k, -1)[:, :n].contiguous()
    pidx = torch.cat([idx, idx.new_full((pad,), -1)]).view(segs, seg)
    return torch.gather(pidx, 1, order).reshape(-1)[:n].contiguous(), out


def block_sort_plain(words: torch.Tensor, w_log2: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain torch version: the same contract, by ``segment_sort_plain``
    over W-row tiles with the row index as the carried column (rows start in
    index order, so a stable sort by the words orders ties by index)."""
    validate_words(words, w_log2)
    idx = torch.arange(words.shape[1], dtype=torch.int32,
                       device=words.device)
    return segment_sort_plain(words, idx, 1 << w_log2)


def block_sort(words: torch.Tensor, w_log2: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper: the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (row indices int32 [n], sorted words [k, n])."""
    if words.device.type == "cuda":
        return block_sort_cuda(words, w_log2)
    if words.device.type == "cpu":
        return block_sort_plain(words, w_log2)
    raise ValueError(f"no block sort for device {words.device}")
