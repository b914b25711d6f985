"""Hash aggregate: GROUP BY key with sum/count/count_all/min/max/mean (from
gandiva_tpu.ops.hash_aggregate).

Behavioural oracle: pyarrow.acero's 'aggregate' (BASELINE configs[1]).
Null keys form their own group (optional), sum/count/min/max skip null
values, count counts non-null values, count_all every row of the group.
Float min/max ignore NaN unless a group holds nothing else, as pyarrow
does. Float sums are order-dependent everywhere; compare them with a
tolerance.

Two paths with one output contract:

- **Kernel K5** (``ops/kernels/aggregate.py``): integer or bool keys,
  integer or float values, at most 1024 groups. One pass over the rows
  finds the groups and accumulates every aggregate; groups come out in
  ascending key order. ``backend="pallas"`` and ``"pallas_interpret"`` take
  it (its wrapper launches the CUDA kernel for tensors on a card and takes
  its plain version for CPU tensors); ``"auto"`` takes it for CUDA tensors
  when the query is eligible.
- **Generic torch** (``backend="xla"``, ``"auto"`` otherwise): group ids
  from ``distinct_small`` (≤ 256 groups, ascending) or ``group_ids`` (hash
  order), then one ``segment_reduce`` scatter per aggregate.

Inputs are torch tensors on one device. Unsigned columns are torch's
uint8/16/32/64 tensors (as ``torch.from_numpy`` gives them); inside they
are handled as signed bits, widened by zero extension, and come back as
unsigned tensors: unsigned sums as uint64, min/max in the input's type.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..utils.ints import UNSIGNED, UNSIGNED_VIEW, widen
from .groupby import distinct_small, group_ids, key_to_i64
from .kernels import aggregate as k5

_LANE = 128
_I64_MIN = -(1 << 63)
_SIGNED_INTS = (torch.int8, torch.int16, torch.int32, torch.int64)
_FLOATS = (torch.float32, torch.float64)
_KINDS = ("sum", "count", "count_all", "min", "max", "mean")


def _pad_groups(g: int) -> int:
    return max(_LANE, -(-g // _LANE) * _LANE)


def _narrow(wide: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 holding values of ``dtype`` → a tensor of ``dtype``."""
    if dtype in UNSIGNED_VIEW:
        return wide.to(UNSIGNED_VIEW[dtype]).view(dtype)
    return wide.to(dtype)


def _u64_to_f64(bits: torch.Tensor) -> torch.Tensor:
    """The uint64 values held in ``bits`` as float64, correctly rounded:
    hi·2^32 and lo are exact, so their sum rounds once."""
    hi = ((bits >> 32) & 0xFFFF_FFFF).to(torch.float64)
    return hi * 4294967296.0 + (bits & 0xFFFF_FFFF).to(torch.float64)


def segment_reduce(gid: torch.Tensor, values: torch.Tensor, num_groups: int,
                   kind: str, valid=None) -> torch.Tensor:
    """Reduce ``values`` into ``num_groups`` buckets keyed by ``gid``.

    ``gid`` rows outside [0, num_groups) fall into no bucket; ``valid``
    masks out null values (rows still belong to their group for
    count_all). The result has ``_pad_groups(num_groups)`` entries (the
    reference's lane padding), the tail holding the identities.

    One scatter pass for every G (``index_add_``, ``scatter_reduce_``):
    masked rows go to a sacrificial bucket that is sliced off. Integer sums
    widen to int64 (uint64 for unsigned inputs) and wrap mod 2^64; float
    sums accumulate in float64 and return the input's type.
    """
    G = _pad_groups(num_groups)
    dev = values.device
    gid = gid.to(torch.int64)
    idx = torch.where((gid >= 0) & (gid < num_groups), gid, G)
    if valid is not None and kind != "count_all":
        idx = torch.where(valid, idx, G)
    dt = values.dtype

    if kind in ("sum", "mean"):
        if dt in _FLOATS:
            out = torch.zeros(G + 1, dtype=torch.float64, device=dev)
            out.index_add_(0, idx, values.to(torch.float64))
            return out[:G].to(dt)
        out = torch.zeros(G + 1, dtype=torch.int64, device=dev)
        out.index_add_(0, idx, widen(values))
        return out[:G].view(torch.uint64) if dt in UNSIGNED \
            else out[:G]
    if kind in ("count", "count_all"):
        out = torch.zeros(G + 1, dtype=torch.int64, device=dev)
        return out.index_add_(0, idx, torch.ones_like(idx))[:G]
    if kind not in ("min", "max"):
        raise ValueError(f"unknown aggregate kind {kind!r}")
    is_max = kind == "max"
    how = "amax" if is_max else "amin"
    if dt in _FLOATS:
        kmin, kmax = k5.order_keys(values.to(torch.float64), k5.FLOAT64)
        ident = _I64_MIN if is_max else ~_I64_MIN
        out = torch.full((G + 1,), ident, dtype=torch.int64, device=dev)
        out.scatter_reduce_(0, idx, kmax if is_max else kmin, how)
        return k5.float_from_key(out[:G], is_max).to(dt)
    if dt == torch.uint64:
        key = widen(values) ^ _I64_MIN
        out = torch.full((G + 1,), _I64_MIN if is_max else ~_I64_MIN,
                         dtype=torch.int64, device=dev)
        out.scatter_reduce_(0, idx, key, how)
        return (out[:G] ^ _I64_MIN).view(torch.uint64)
    info = torch.iinfo(dt)
    out = torch.full((G + 1,), info.min if is_max else info.max,
                     dtype=torch.int64, device=dev)
    out.scatter_reduce_(0, idx, widen(values), how)
    return _narrow(out[:G], dt)


def _kernel_eligible(keys, aggs, values, max_groups: int,
                     backend: str) -> bool:
    """K5's preconditions: integer or bool keys, integer or float values,
    at most 1024 groups; ``auto`` takes it only for tensors on a card."""
    if backend == "xla":
        return False
    if backend == "auto" and keys.device.type != "cuda":
        return False
    if max_groups > k5.MAX_GROUPS:
        return False
    if keys.dtype.is_floating_point or keys.dtype.is_complex:
        return False
    for name, kind in aggs:
        if kind not in _KINDS:
            return False
        if kind == "count_all":
            continue
        dt = values[name][0].dtype
        if dt not in _SIGNED_INTS + UNSIGNED + _FLOATS:
            return False
    return True


def _kernel_column(arr: torch.Tensor, valid, want_sum: bool,
                   want_minmax: bool) -> k5.ValueColumn:
    dt = arr.dtype
    if dt in _FLOATS:
        data, kind = arr.to(torch.float64), k5.FLOAT64
    elif dt == torch.uint64:
        data, kind = widen(arr), k5.UINT64
    else:
        data, kind = widen(arr), k5.INT64
    return k5.ValueColumn(data.contiguous(), kind,
                          None if valid is None else valid.contiguous(),
                          want_sum, want_minmax)


def _hash_aggregate_kernel(keys, aggs, values, key_valid, row_valid,
                           max_groups: int, null_path: bool):
    """The decode layer over kernel K5: the hash_aggregate output contract
    (dict keys, dtypes, empty-group identities) from its group rows."""
    dev = keys.device
    code = None
    if key_valid is not None or row_valid is not None:
        rv = torch.ones_like(keys, dtype=torch.bool) if row_valid is None \
            else row_valid
        kv = torch.ones_like(keys, dtype=torch.bool) if key_valid is None \
            else key_valid
        code = (rv & kv).to(torch.uint8)
        if null_path:
            code = code + 2 * (rv & ~kv).to(torch.uint8)

    order: List[str] = []
    need: Dict[str, List[bool]] = {}
    for name, kind in aggs:
        if kind == "count_all":
            continue
        if name not in need:
            need[name] = [False, False]
            order.append(name)
        need[name][0] |= kind in ("sum", "mean")
        need[name][1] |= kind in ("min", "max")
    cols = [_kernel_column(values[name][0], values[name][1], *need[name])
            for name in order]
    res = k5.aggregate(key_to_i64(keys).contiguous(), code, cols, max_groups)

    gcap = k5.capacity_for(max_groups)
    G_out = max_groups + 1
    slots = torch.arange(G_out, device=dev)
    cnt = res.count
    has_null = (res.count_all[gcap] > 0) if null_path else \
        torch.zeros((), dtype=torch.bool, device=dev)
    # group rows [0, cnt) keep their place, the null-key group moves from
    # row gcap to row cnt, every other slot reads the identity row gcap + 1
    src = torch.where(slots < cnt, slots,
                      torch.where((slots == cnt) & has_null, gcap, gcap + 1))
    keys_rows = torch.cat([res.keys, torch.zeros(2, dtype=torch.int64,
                                                 device=dev)])
    out = {
        "keys": keys_rows[src],
        "key_is_null": (slots == cnt) & has_null,
        "group_count": (cnt + has_null.to(cnt.dtype)).to(torch.int32),
        "overflow": res.overflow | (cnt > max_groups),
    }
    col_of = {name: j for j, name in enumerate(order)}
    for name, kind in aggs:
        if kind == "count_all":
            out[f"agg:{name}:count_all"] = res.count_all[src]
            continue
        acc = res.acc[col_of[name]][:, src]
        vdt = values[name][0].dtype
        cv = acc[k5.ROW_COUNT_VALID]
        if kind == "count":
            out[f"agg:{name}:count"] = cv
        elif kind in ("sum", "mean"):
            if vdt in _FLOATS:
                s = torch.where(cv > 0, acc[k5.ROW_SUM].view(torch.float64),
                                0.0)
                total = s.to(vdt)
                as_f64 = s
            elif vdt in UNSIGNED:
                total = acc[k5.ROW_SUM].view(torch.uint64)
                as_f64 = _u64_to_f64(acc[k5.ROW_SUM])
            else:
                total = acc[k5.ROW_SUM]
                as_f64 = total.to(torch.float64)
            if kind == "sum":
                out[f"agg:{name}:sum"] = total
            else:
                r = as_f64 / cv.clamp(min=1)
                out[f"agg:{name}:mean"] = torch.where(cv > 0, r, float("nan"))
        else:
            is_max = kind == "max"
            key = acc[k5.ROW_MAX if is_max else k5.ROW_MIN]
            if vdt in _FLOATS:
                d = k5.float_from_key(key, is_max).to(vdt)
            elif vdt == torch.uint64:
                d = k5.int_from_key(key, k5.UINT64).view(torch.uint64)
            elif vdt == torch.int64:
                d = key
            else:
                # swap the int64 empty identity for the narrow one before
                # narrowing (int64::max would wrap to -1)
                info = torch.iinfo(vdt)
                d = _narrow(torch.where(cv == 0, info.max if not is_max
                                        else info.min, key), vdt)
            out[f"agg:{name}:{kind}"] = d
    return out


def hash_aggregate(keys: torch.Tensor, aggs: Sequence[Tuple[str, str]],
                   values: Dict[str, Tuple], key_valid=None, row_valid=None,
                   max_groups: int = 4096, group_null_keys: bool = True,
                   backend: str = "auto"):
    """GROUP BY ``keys`` computing ``aggs`` = [(value_name, kind), ...].

    ``values[name] = (tensor, validity-or-None)``. Returns a dict:
      {"keys": unique_keys[max_groups+1] (int64 ``key_to_i64`` images),
       "key_is_null": bool[...], "group_count": 0-d int32,
       "overflow": 0-d bool, "agg:<name>:<kind>": tensor[max_groups+1]}
    Groups occupy the first group_count slots; the (optional) null-key
    group, when present, is the slot at index group_count-1 with
    key_is_null set. Slots beyond hold the empty-group identities (sum and
    count 0, min/max the type's max/min or ±inf, mean NaN). ``overflow``
    set means more distinct keys than ``max_groups``: the rest is then
    unspecified, and the caller retries with a larger ``max_groups``.
    """
    if backend not in ("auto", "xla", "pallas", "pallas_interpret"):
        raise ValueError(f"unknown hash_aggregate backend {backend!r}")
    if _kernel_eligible(keys, aggs, values, max_groups, backend):
        return _hash_aggregate_kernel(
            keys, aggs, values, key_valid, row_valid, max_groups,
            null_path=group_null_keys and key_valid is not None)

    n = keys.shape[0]
    dev = keys.device
    if row_valid is None:
        row_valid = torch.ones(n, dtype=torch.bool, device=dev)
    if key_valid is None:
        key_valid = torch.ones(n, dtype=torch.bool, device=dev)
    in_table = row_valid & key_valid
    if max_groups <= 256:
        gid, uniq, gcount, overflow = distinct_small(keys, in_table,
                                                     max_groups=max_groups)
    else:
        gid, uniq, gcount, overflow = group_ids(keys, in_table,
                                                max_groups=max_groups)
    G_out = max_groups + 1  # slot for the null-key group
    overflow = overflow | (gcount > max_groups)
    if uniq.shape[0] < G_out:  # distinct_small returns exactly max_groups
        uniq = torch.cat([uniq, torch.zeros(G_out - uniq.shape[0],
                                            dtype=uniq.dtype, device=dev)])

    if group_null_keys:
        null_rows = row_valid & ~key_valid
        has_null_group = null_rows.any()
        gid = torch.where(null_rows, gcount, gid)  # dense id after the groups
        total_groups = gcount + has_null_group.to(gcount.dtype)
    else:
        has_null_group = torch.zeros((), dtype=torch.bool, device=dev)
        total_groups = gcount

    out = {
        "keys": uniq[:G_out],
        "key_is_null": (torch.arange(G_out, device=dev) == gcount)
        & has_null_group,
        "group_count": total_groups,
        "overflow": overflow,
    }
    for name, kind in aggs:
        if kind == "count_all":
            arr, vv = torch.zeros(n, dtype=torch.int64, device=dev), None
        else:
            arr, vv = values[name]
        if kind == "mean":
            s = segment_reduce(gid, arr, G_out, "sum", vv)[:G_out]
            c = segment_reduce(gid, arr, G_out, "count", vv)[:G_out]
            s = _u64_to_f64(s.view(torch.int64)) if s.dtype == torch.uint64 \
                else s.to(torch.float64)
            r = s / c.clamp(min=1)
            out[f"agg:{name}:mean"] = torch.where(c > 0, r, float("nan"))
        else:
            out[f"agg:{name}:{kind}"] = segment_reduce(gid, arr, G_out, kind,
                                                       vv)[:G_out]
    return out
