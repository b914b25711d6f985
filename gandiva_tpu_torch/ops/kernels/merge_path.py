"""Kernel K3: one merge-path round, hand-written in CUDA for Hopper, and
the merge sort that drives it over the block sort (K4).

Replaces ``gandiva_tpu/ops/kernels/merge_path.py::_merge_kernel`` (reached
through ``_merge_round`` there) and the split search the reference runs
between rounds outside the kernel (``_diag_search``, ``_round_meta``): a
round is two launches, a partition pass that finds where every tile of T
outputs starts on the merge path, and the merge. Source:
``csrc/merge_path.cu``, built by ``build.py`` and bound with ctypes.

Contract of a round: ``words`` [k, n] int64 (comparator words, most
significant first, unsigned order) and ``idx`` [n] int32, whose runs of
``run`` rows are each sorted; adjacent runs A, B merge into runs of
2 · run rows, A winning ties (so the merge is stable). The last pair may be
short; a last run with no partner is copied through.

Bound: bytes. A round reads and writes 8k + 4 B a row each way: at BASELINE
configs[2] (one word, n = 100,000,000) 2.4 GB, about 0.72 ms at an H100
SXM's 3.35 TB/s. The design (the partition pass, then each CTA copies its
segments into shared memory asynchronously and merges T outputs) is
described in the source.

``merge_sort`` runs the block sort once, then rounds r = 0, 1, …
while W · 2^r < n, between two ping-pong buffers. The number of rounds
follows from n on the host, so a call never syncs the host. The reference's
uint32 limbs, int32 bias flip and payload "carries" are not ported: keys
stay 64-bit words, and callers gather payloads once by the permutation.

``merge_round`` launches the kernel for CUDA tensors and takes
``merge_round_plain`` only for CPU tensors; there is no fallback from one
to the other, and no size threshold hands the card's sort to ``torch.sort``.
``LAUNCHES["merge_path"]`` counts rounds: one per ``merge_round`` call,
whose two launches it does not count apart.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import LAUNCHES, build
from .build import INT, LL, VP, check
from .sort_bitonic import (DEFAULT_W_LOG2, MIN_W_LOG2, SMEM_BYTES,
                           block_sort, segment_sort_plain, tile_log2,
                           validate_words)

Pair = Tuple[torch.Tensor, torch.Tensor]

MERGE_T_LOG2 = 12           # T = 4096 outputs a K3 CTA, at most
MERGE_ITEMS = 8             # outputs a K3 thread merges
_FUNCTIONS = {
    "gt_merge_round": (INT, [VP, VP, LL, INT, LL, INT, VP, VP, VP, VP]),
    "gt_merge_partition": (INT, [VP, LL, INT, LL, INT, VP, VP]),
    "gt_merge_path_smem_limit": (INT, []),
    "gt_merge_path_items": (INT, [])}
_EXPECT = {"gt_merge_path_smem_limit": SMEM_BYTES,
           "gt_merge_path_items": MERGE_ITEMS}


def merge_smem(num_words: int, t_log2: int) -> int:
    """K3's shared memory for a tile of T outputs: the first words (T rows
    and one slack row), the other words, the indices, and the output map
    (4 B a slot: every output and one pad slot every ``MERGE_ITEMS``, and
    one more)."""
    t = 1 << t_log2
    return 8 * (t + 1) + 8 * (num_words - 1) * t + 4 * t \
        + 4 * (t + t // MERGE_ITEMS + 1)


def merge_tile_log2(num_words: int, run_log2: int) -> int:
    """log2 of the outputs one K3 CTA produces: ``MERGE_T_LOG2``, at most
    the run (so T divides it and a tile lies in one pair), halved until a
    tile fits one block's shared memory (``merge_smem``)."""
    t = min(run_log2, MERGE_T_LOG2)
    while t >= MIN_W_LOG2 and merge_smem(num_words, t) > SMEM_BYTES:
        t -= 1
    if t < MIN_W_LOG2:
        raise ValueError(f"{num_words} sort words or runs of 2^{run_log2} "
                         f"rows do not fit a merge tile of "
                         f"{1 << MIN_W_LOG2} rows")
    return t


def num_rounds(n: int, w_log2: int) -> int:
    """R = ⌈log2 ⌈n / W⌉⌉: rounds until one run holds all n rows."""
    r = 0
    while (1 << (w_log2 + r)) < n:
        r += 1
    return r


def _validate(words: torch.Tensor, idx: Optional[torch.Tensor],
              run: int) -> None:
    validate_words(words, MIN_W_LOG2)
    n = words.shape[1]
    if idx is not None and (
            idx.dtype != torch.int32 or idx.shape != (n,)
            or not idx.is_contiguous() or idx.device != words.device):
        raise ValueError("idx must be a contiguous int32 tensor of n rows on "
                         "the words' device")
    if run < 1 or run & (run - 1):
        raise ValueError(f"run must be a power of two, got {run}")


def _outputs(words: torch.Tensor, idx: torch.Tensor,
             out: Optional[Pair]) -> Pair:
    if out is None:
        return torch.empty_like(words), torch.empty_like(idx)
    ow, oi = out
    if ow.shape != words.shape or ow.dtype != words.dtype \
            or not ow.is_contiguous() or ow.device != words.device \
            or oi.shape != idx.shape or oi.dtype != idx.dtype \
            or not oi.is_contiguous() or oi.device != idx.device:
        raise ValueError("out must be a (words, idx) pair shaped like the "
                         "inputs")
    if ow.data_ptr() == words.data_ptr() or oi.data_ptr() == idx.data_ptr():
        raise ValueError("a merge round cannot write over its input")
    return ow, oi


def _lib() -> ctypes.CDLL:
    return build.load("merge_path", _FUNCTIONS, _EXPECT)


def _splits(words: torch.Tensor, run: int) -> Tuple[int, torch.Tensor]:
    """K3's tile for ``words`` and ``run``, and a splits buffer of one int32
    per tile."""
    k, n = words.shape
    t_log2 = merge_tile_log2(k, run.bit_length() - 1)
    return t_log2, torch.empty(-(-n >> t_log2), dtype=torch.int32,
                               device=words.device)


def merge_round_cuda(words: torch.Tensor, idx: torch.Tensor, run: int,
                     out: Optional[Pair] = None) -> Pair:
    """Launch K3 once (its partition pass and its merge) on the inputs'
    card: (merged words, merged idx), written into ``out`` when it is
    given."""
    if words.device.type != "cuda":
        raise ValueError(f"merge_round_cuda takes CUDA tensors, got "
                         f"{words.device}")
    _validate(words, idx, run)
    k, n = words.shape
    ow, oi = _outputs(words, idx, out)
    if n == 0:
        return ow, oi
    t_log2, splits = _splits(words, run)
    lib = _lib()
    dev = words.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib, lib.gt_merge_round(
            words.data_ptr(), idx.data_ptr(), n, k, run, t_log2,
            splits.data_ptr(), ow.data_ptr(), oi.data_ptr(), stream),
            "gt_merge_round")
        LAUNCHES["merge_path"] += 1
    return ow, oi


def merge_splits_cuda(words: torch.Tensor, run: int) -> torch.Tensor:
    """K3's partition pass alone on ``words``' card: for each tile of T
    outputs (``merge_tile_log2``), the number of A rows of its pair's merge
    before it. Not counted in ``LAUNCHES``: a round counts once."""
    if words.device.type != "cuda":
        raise ValueError(f"merge_splits_cuda takes CUDA tensors, got "
                         f"{words.device}")
    _validate(words, None, run)
    t_log2, splits = _splits(words, run)
    if words.shape[1] == 0:
        return splits
    lib = _lib()
    dev = words.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib, lib.gt_merge_partition(
            words.data_ptr(), words.shape[1], words.shape[0], run, t_log2,
            splits.data_ptr(), stream), "gt_merge_partition")
    return splits


def merge_splits_plain(words: torch.Tensor, run: int) -> torch.Tensor:
    """The partition pass's plain torch version: merge each pair by
    ``segment_sort_plain`` with the positions as the carried column, mark
    the outputs that come from A, and count them from the pair's start to
    each tile's start."""
    _validate(words, None, run)
    k, n = words.shape
    t_log2 = merge_tile_log2(k, run.bit_length() - 1)
    pos = torch.arange(n, dtype=torch.int32, device=words.device)
    src, _ = segment_sort_plain(words, pos, 2 * run)
    from_a = (src.long() // run) % 2 == 0
    before = torch.cumsum(from_a, 0) - from_a.long()  # A rows before each
    starts = torch.arange(0, n, 1 << t_log2, device=words.device)
    pair_starts = starts // (2 * run) * (2 * run)
    return (before[starts] - before[pair_starts]).to(torch.int32)


def merge_round_plain(words: torch.Tensor, idx: torch.Tensor, run: int,
                      out: Optional[Pair] = None) -> Pair:
    """K3's plain torch version: each pair's concatenation sorted stably by
    its words (``segment_sort_plain`` over 2 · run rows). A's rows come
    before B's, so that is the merge with A winning ties."""
    _validate(words, idx, run)
    ow, oi = _outputs(words, idx, out)
    merged_idx, merged = segment_sort_plain(words, idx, 2 * run)
    ow.copy_(merged)
    oi.copy_(merged_idx)
    return ow, oi


def merge_round(words: torch.Tensor, idx: torch.Tensor, run: int,
                out: Optional[Pair] = None) -> Pair:
    """K3's wrapper: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if words.device.type == "cuda":
        return merge_round_cuda(words, idx, run, out)
    if words.device.type == "cpu":
        return merge_round_plain(words, idx, run, out)
    raise ValueError(f"no merge round for device {words.device}")


def merge_sort(words: Sequence[torch.Tensor],
               w_log2: int = DEFAULT_W_LOG2) -> Pair:
    """Stable ascending sort of n rows by their 64-bit comparator words
    (int64 tensors of n rows, unsigned order, most significant first).
    Returns (perm int32 [n], the sorted words [k, n]).

    The tile is W = 2^w_log2 rows, halved until it fits shared memory
    (``tile_log2``). K4 sorts every tile once (its ragged last tile padded in
    shared memory), then K3 runs R = ⌈log2 ⌈n / W⌉⌉ rounds between two
    ping-pong buffers. CPU tensors take the plain versions through the same
    rounds."""
    # one [k, n] buffer; a view when there is one word
    stacked = words[0].contiguous().unsqueeze(0) if len(words) == 1 \
        else torch.stack(list(words))
    w_log2 = tile_log2(stacked.shape[0], w_log2)
    idx, cur = block_sort(stacked, w_log2)
    rounds = num_rounds(stacked.shape[1], w_log2)
    spare = (torch.empty_like(cur), torch.empty_like(idx)) if rounds else None
    for r in range(rounds):
        merged = merge_round(cur, idx, 1 << (w_log2 + r), out=spare)
        spare = (cur, idx)
        cur, idx = merged
    return idx, cur
