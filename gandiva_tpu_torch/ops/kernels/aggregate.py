"""Kernel K5: one-pass GROUP BY over at most 1024 distinct int64 keys,
hand-written in CUDA for Hopper.

Replaces ``gandiva_tpu/ops/kernels/agg_pallas.py::_kernel`` (reached
through ``aggregate_pallas`` there). Source: ``csrc/aggregate.cu``, built
by ``build.py`` and bound with ctypes.

Contract: int64 ``keys[n]`` (``groupby.key_to_i64`` images), an optional
uint8 ``code[n]`` (0 not in the table, 1 valid key, 2 null key; None means
every row is 1) and value columns (``ValueColumn``: int64 data of kind
INT64 (ints widened) or UINT64 (the bits of uint64 values), or float64 data
(floats widened), each with an optional bool validity). Per group it
computes count_all and, per column, count_valid, the sum (mod 2^64 for
integers, f64 for floats) and min and max as int64 order keys
(``order_keys``; decode with ``int_from_key`` / ``float_from_key``).

Output order: groups in ASCENDING int64 key order in rows [0, count), the
null-key group in row ``gcap``, identities in every other row (count 0,
sum 0, min key int64::max, max key int64::min). More than
``capacity_for(max_groups)`` distinct keys sets ``overflow`` and leaves the
rest unspecified. Float min/max ignore NaN unless a group holds nothing
else, as pyarrow does; -0.0 orders below +0.0.

Bound: bytes. At BASELINE configs[1] (n = 100,000,000, int64 key, one f64
column, no nulls) it must read 16 B per row, 1.6 GB, about 0.48 ms at an
H100 SXM's 3.35 TB/s. The design (per-CTA shared-memory tables, loads
issued before the probes, warp-aggregated updates of per-warp accumulator
copies where one a warp fits shared memory and shared atomics on fewer
copies where they do not, a global merge, a ranking pass) is described in
the source; ``accumulator_copies`` says which variant a shape takes.

``aggregate`` launches the kernel for CUDA tensors (one launch per group of
``MAX_VALUES`` columns over the same keys; a query with no value columns
takes one) and takes ``aggregate_plain`` only for CPU tensors; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import LAUNCHES, build
from .build import INT, LL, VP, check

MAX_VALUES = 4
MAX_GROUPS = 1024
INT64, UINT64, FLOAT64 = 0, 1, 2
_WANT_SUM, _WANT_MINMAX = 1, 2
ROW_COUNT_VALID, ROW_SUM, ROW_MIN, ROW_MAX = 0, 1, 2, 3
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_NAN_MIN_KEY = 0x7FF8_0000_0000_0000   # above +inf
_NAN_MAX_KEY = _I64_MIN + 1            # below -inf
_FUNCTIONS = {
    "gt_aggregate": (INT, [VP, VP, LL, INT, VP, VP, VP, VP, INT, VP, LL, VP,
                           VP, VP, VP, VP]),
    "gt_aggregate_scratch_bytes": (LL, [INT, INT]),
    "gt_aggregate_copies": (INT, [INT, INT]),
    "gt_aggregate_warps": (INT, []),
    "gt_aggregate_max_values": (INT, []),
    "gt_aggregate_max_groups": (INT, [])}
_EXPECT = {"gt_aggregate_max_values": MAX_VALUES,
           "gt_aggregate_max_groups": MAX_GROUPS}


class ValueColumn(NamedTuple):
    data: torch.Tensor                # int64 (INT64, UINT64) or float64
    kind: int
    valid: Optional[torch.Tensor] = None
    want_sum: bool = True
    want_minmax: bool = True


class AggResult(NamedTuple):
    keys: torch.Tensor       # int64[gcap], ascending on [:count], 0 after
    count: torch.Tensor      # 0-d int64: distinct keys (capped at gcap)
    overflow: torch.Tensor   # 0-d bool
    count_all: torch.Tensor  # int64[gcap + 2]
    acc: torch.Tensor        # int64[C, 4, gcap + 2]: count_valid, sum
    #                          bits, min key, max key per column


def capacity_for(max_groups: int) -> int:
    """Table capacity: max_groups rounded up to a multiple of 8, ≤ 1024."""
    return min(MAX_GROUPS, max(8, -(-max_groups // 8) * 8))


def order_keys(data: torch.Tensor, kind: int):
    """(min key, max key) of each value: int64 whose signed order is the
    value order. uint64 bits take the 2^63 bias; float64 bits the total
    order (negative values' bits complemented), with NaN above +inf for
    min and below -inf for max, so both ignore NaN unless a group holds
    nothing else."""
    if kind == INT64:
        return data, data
    if kind == UINT64:
        k = data ^ _I64_MIN
        return k, k
    bits = data.view(torch.int64)
    k = torch.where(bits >= 0, bits, bits ^ _I64_MAX)
    nan = torch.isnan(data)
    return (torch.where(nan, _NAN_MIN_KEY, k),
            torch.where(nan, _NAN_MAX_KEY, k))


def int_from_key(key: torch.Tensor, kind: int) -> torch.Tensor:
    """Invert ``order_keys`` for INT64 / UINT64 (the latter as int64 bits);
    the empty identities decode to int64::max/min, uint64::max/0."""
    return key ^ _I64_MIN if kind == UINT64 else key


def float_from_key(key: torch.Tensor, is_max: bool) -> torch.Tensor:
    """Invert ``order_keys`` for FLOAT64; the empty identity decodes to
    -inf for max and +inf for min, NaN to the canonical NaN."""
    bits = torch.where(key >= 0, key, key ^ _I64_MAX)
    if is_max:
        bits = torch.where(key == _NAN_MAX_KEY, _NAN_MIN_KEY, bits)
    empty = key == (_I64_MIN if is_max else _I64_MAX)
    return torch.where(empty, float("-inf") if is_max else float("inf"),
                       bits.view(torch.float64))


def _validate(keys, code, columns: Sequence[ValueColumn],
              max_groups: int) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int64 tensor, got "
                         f"{keys.dtype} of shape {tuple(keys.shape)}")
    if not 1 <= max_groups:
        raise ValueError(f"max_groups must be positive, got {max_groups}")
    n = keys.shape[0]
    if code is not None and (code.dtype != torch.uint8 or code.shape != (n,)
                             or not code.is_contiguous()
                             or code.device != keys.device):
        raise ValueError("code must be a contiguous uint8 tensor of n rows "
                         "on the keys' device")
    for c in columns:
        want = torch.float64 if c.kind == FLOAT64 else torch.int64
        if c.kind not in (INT64, UINT64, FLOAT64):
            raise ValueError(f"unknown value kind {c.kind}")
        if c.data.dtype != want or c.data.shape != (n,) \
                or not c.data.is_contiguous() or c.data.device != keys.device:
            raise ValueError(f"value column of kind {c.kind} must be a "
                             f"contiguous {want} tensor of n rows on the "
                             f"keys' device, got {c.data.dtype} "
                             f"{tuple(c.data.shape)} on {c.data.device}")
        if c.valid is not None and (
                c.valid.dtype != torch.bool or c.valid.shape != (n,)
                or not c.valid.is_contiguous()
                or c.valid.device != keys.device):
            raise ValueError("validity must be a contiguous bool tensor of n "
                             "rows on the keys' device")


def _outputs(gcap: int, ncols: int, dev):
    rows = gcap + 2
    return (torch.zeros(gcap, dtype=torch.int64, device=dev),
            torch.empty(2, dtype=torch.int64, device=dev),
            torch.empty(rows, dtype=torch.int64, device=dev),
            torch.empty((ncols, 4, rows), dtype=torch.int64, device=dev))


def _lib() -> ctypes.CDLL:
    return build.load("aggregate", _FUNCTIONS, _EXPECT)


def accumulator_copies(gcap: int, ncols: int) -> Tuple[int, bool]:
    """The accumulator copies a CTA of K5 keeps for a launch of ``ncols``
    (≤ MAX_VALUES) columns at table capacity ``gcap``, and whether that is
    one a warp: the private variant (warp-aggregated plain stores), else the
    shared one (atomics). The kernel library decides, so this needs the
    card's toolchain."""
    lib = _lib()
    copies = lib.gt_aggregate_copies(gcap, ncols)
    return copies, copies == lib.gt_aggregate_warps()


def aggregate_cuda(keys: torch.Tensor, code: Optional[torch.Tensor],
                   columns: Sequence[ValueColumn], max_groups: int
                   ) -> AggResult:
    """Launch K5 on ``keys``' card: one launch per group of MAX_VALUES
    columns, each over all the rows."""
    if keys.device.type != "cuda":
        raise ValueError(f"aggregate_cuda takes CUDA tensors, got "
                         f"{keys.device}")
    _validate(keys, code, columns, max_groups)
    gcap = capacity_for(max_groups)
    dev = keys.device
    out_keys, meta, count_all, acc = _outputs(gcap, len(columns), dev)
    lib = _lib()
    per_launch = min(len(columns), MAX_VALUES)
    nbytes = lib.gt_aggregate_scratch_bytes(gcap, per_launch)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g in range(0, max(len(columns), 1), MAX_VALUES):
            group = columns[g:g + MAX_VALUES]
            k = len(group)
            data = (ctypes.c_void_p * MAX_VALUES)(
                *[c.data.data_ptr() for c in group])
            valids = (ctypes.c_void_p * MAX_VALUES)(
                *[None if c.valid is None else c.valid.data_ptr()
                  for c in group])
            kinds = (ctypes.c_int * MAX_VALUES)(*[c.kind for c in group])
            flags = (ctypes.c_int * MAX_VALUES)(
                *[_WANT_SUM * c.want_sum + _WANT_MINMAX * c.want_minmax
                  for c in group])
            # the same keys, count and count_all are written by every launch
            check(lib, lib.gt_aggregate(
                keys.data_ptr(), None if code is None else code.data_ptr(),
                keys.shape[0], k, ctypes.cast(data, ctypes.c_void_p),
                ctypes.cast(valids, ctypes.c_void_p),
                ctypes.cast(kinds, ctypes.c_void_p),
                ctypes.cast(flags, ctypes.c_void_p), gcap,
                scratch.data_ptr(), nbytes, out_keys.data_ptr(),
                meta.data_ptr(), count_all.data_ptr(),
                acc[g:g + k].data_ptr() if k else None, stream),
                "gt_aggregate")
            LAUNCHES["aggregate"] += 1
    return AggResult(out_keys, meta[0], meta[1] != 0, count_all, acc)


def aggregate_plain(keys: torch.Tensor, code: Optional[torch.Tensor],
                    columns: Sequence[ValueColumn], max_groups: int
                    ) -> AggResult:
    """K5's plain torch version, the same contract: ``torch.unique`` on the
    in-table keys for the ascending group table, then ``index_add_`` and
    ``scatter_reduce_`` over the group rows (a sacrificial row takes the
    rows outside every group). O(n) memory. Syncs the host on a card."""
    _validate(keys, code, columns, max_groups)
    gcap = capacity_for(max_groups)
    rows = gcap + 2
    dev = keys.device
    n = keys.shape[0]
    in_table = (torch.ones(n, dtype=torch.bool, device=dev) if code is None
                else code == 1)
    uniq, inv = torch.unique(keys[in_table], sorted=True, return_inverse=True)
    count = min(uniq.shape[0], gcap)
    slot = torch.full((n,), rows, dtype=torch.int64, device=dev)
    slot[in_table] = torch.where(inv < gcap, inv, rows)
    if code is not None:
        slot[code == 2] = gcap

    def add(s, src, dtype=torch.int64):
        out = torch.zeros(rows + 1, dtype=dtype, device=dev)
        return out.index_add_(0, s, src)[:rows]

    def reduce(s, src, ident, how):
        out = torch.full((rows + 1,), ident, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, s, src, how)[:rows]

    ones = torch.ones(n, dtype=torch.int64, device=dev)
    count_all = add(slot, ones)
    out_keys, _, _, acc = _outputs(gcap, len(columns), dev)
    out_keys[:count] = uniq[:count]
    for v, c in enumerate(columns):
        s = slot if c.valid is None else torch.where(c.valid, slot, rows)
        acc[v, ROW_COUNT_VALID] = count_all if c.valid is None else \
            add(s, ones)
        acc[v, ROW_SUM] = 0
        if c.want_sum:
            acc[v, ROW_SUM] = (add(s, c.data, torch.float64).view(torch.int64)
                               if c.kind == FLOAT64 else add(s, c.data))
        acc[v, ROW_MIN] = _I64_MAX
        acc[v, ROW_MAX] = _I64_MIN
        if c.want_minmax:
            kmin, kmax = order_keys(c.data, c.kind)
            acc[v, ROW_MIN] = reduce(s, kmin, _I64_MAX, "amin")
            acc[v, ROW_MAX] = reduce(s, kmax, _I64_MIN, "amax")
    return AggResult(out_keys,
                     torch.tensor(count, dtype=torch.int64, device=dev),
                     torch.tensor(uniq.shape[0] > gcap, device=dev),
                     count_all, acc)


def aggregate(keys: torch.Tensor, code: Optional[torch.Tensor],
              columns: Sequence[ValueColumn], max_groups: int) -> AggResult:
    """K5's wrapper: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if keys.device.type == "cuda":
        return aggregate_cuda(keys, code, columns, max_groups)
    if keys.device.type == "cpu":
        return aggregate_plain(keys, code, columns, max_groups)
    raise ValueError(f"no aggregate for device {keys.device}")

