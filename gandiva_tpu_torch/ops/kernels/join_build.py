"""The join build's run detection and first-fit placement, hand-written in
CUDA for Hopper.

Replaces no Pallas kernel: the reference builds the duplicate-run table
with array operations (``gandiva_tpu/ops/hash_join.py::_build_ranges_table``,
a reversed ``lax.cummin`` and the placement's ``lax.cummax``). The plain
version is the port's torch chain in ``ops/hash_join.py::_build_ranges_table``,
which CPU tensors take; ``build_ranges_cuda`` is what CUDA tensors take.
Source: ``csrc/join_build.cu``, built by ``build.py`` and bound with ctypes.

Contract (the plain version's): over ``nb`` sorted int64 keys, whose first
``n_valid`` rows are valid, and an optional ``perm`` (sorted row → original
row), the table int32 [T + nb, 4] holds one (key lo, key hi, start, len) row
per run of equal valid keys at its first-fit slot from ``hash32(key) % T``,
and ``all_unique`` (a 0-d bool) says that every run has one row and ``perm``
was given. The table equals the plain version's bit for bit.

Bound: bytes. Detection reads each key once and writes each row's 8-byte
home word and each run's 16-byte row (≈ 36 B a row); placement reads each
run's home word, order entry and row, and writes the row into the table (≈
44 B a run, 12 B a row of the sort's output besides). The design (two
single-pass scans with decoupled look-back, each fused with the elementwise
work around it) is described in the source.

Three launches a build: detection, the sort of the home words (K4 and K3,
``merge_sort``) and placement, with one ``torch.zeros`` for the table and
one for the scans' descriptors. ``n_valid`` may be a device tensor, read by
the kernel, so nothing syncs the host. ``LAUNCHES["join_build"]`` counts
the two kernels' launches: two a build.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES, build
from .build import INT, LL, VP, check
from .merge_path import merge_sort

_MAX_ROWS = (1 << 31) - 1       # the rows hold positions in int32
_FUNCTIONS = {
    "gt_join_detect": (INT, [VP, LL, VP, LL, VP, LL, LL, VP, VP, VP, VP,
                             VP]),
    "gt_join_place": (INT, [VP, VP, LL, LL, VP, VP, VP, VP]),
    "gt_join_build_tile_rows": (INT, [])}


def library() -> ctypes.CDLL:
    """The join build's kernel library, built at first use."""
    return build.load("join_build", _FUNCTIONS)


def build_ranges_cuda(sk64: torch.Tensor, n_valid,
                      perm: Optional[torch.Tensor], T: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table int32 [T + nb, 4], all_unique) of the sorted int64 keys
    ``sk64`` on their card, ``n_valid`` an int or a 0-d tensor, ``perm``
    int32 or None, ``T`` the table's home slots."""
    dev = sk64.device
    if dev.type != "cuda" or sk64.dtype != torch.int64 or sk64.dim() != 1:
        raise ValueError(f"build_ranges_cuda takes a 1-D int64 CUDA tensor, "
                         f"got {sk64.dtype} on {dev}")
    nb = sk64.shape[0]
    if nb > _MAX_ROWS:
        raise ValueError(f"the join build's rows hold int32 positions: at "
                         f"most 2^31 - 1 build rows, got {nb}")
    T_tot = T + nb
    table = torch.zeros(T_tot, 4, dtype=torch.int32, device=dev)
    if nb == 0:
        return table, torch.full((), perm is not None, dtype=torch.bool,
                                 device=dev)
    lib = library()
    sk64 = sk64.contiguous()
    nv_ptr, nv_value = None, 0
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.to(device=dev, dtype=torch.int32)
        nv_ptr = n_valid.data_ptr()
    else:
        nv_value = int(n_valid)
    if perm is not None:
        perm = perm.to(torch.int32).contiguous()
    tiles = -(-nb // lib.gt_join_build_tile_rows())
    status = torch.zeros(2 * tiles + 4, dtype=torch.int64, device=dev)
    rows = torch.empty(nb, 4, dtype=torch.int32, device=dev)
    homes = torch.empty(nb, dtype=torch.int64, device=dev)
    all_unique = torch.empty((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib, lib.gt_join_detect(
            sk64.data_ptr(), nb, nv_ptr, nv_value,
            perm.data_ptr() if perm is not None else None, T, T_tot,
            status.data_ptr(), rows.data_ptr(), homes.data_ptr(),
            all_unique.data_ptr(), stream), "gt_join_detect")
        LAUNCHES["join_build"] += 1
        # the home words are the norms the sort takes: its stable order
        order, homes_sorted = merge_sort([homes])
        check(lib, lib.gt_join_place(
            homes_sorted[0].data_ptr(), order.data_ptr(), nb, T_tot,
            rows.data_ptr(), table.data_ptr(), status.data_ptr(), stream),
            "gt_join_place")
        LAUNCHES["join_build"] += 1
    return table, all_unique
