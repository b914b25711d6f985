"""Sort: multi-column, null-aware, padding-aware ordering (from
gandiva_tpu.ops.sort).

Behavioural oracle: ``pyarrow.compute.sort_indices`` + ``take`` (BASELINE
configs[2]: 64-bit keys with payload columns, nulls first). Keys normalize
to unsigned lanes whose unsigned order is the value order; each key adds a
rank word for its placement class, and the rows sort stably by (words…,
row index) through ``ops/kernels/merge_path.merge_sort``: the block sort K4
once, then ⌈log2 ⌈n / W⌉⌉ merge-path rounds K3. CUDA tensors always take
the kernels, at every n; CPU tensors their plain versions through the same
rounds. Payloads are gathered once by the permutation.

Normalized keys are unsigned lanes whose unsigned order is the requested
value order: the IEEE-754 total-order trick for floats (with -0.0 == 0.0
and every NaN one class, after +inf), the sign-bit bias for signed ints,
the bitwise complement for descending order. The unsigned lanes are held as
the port holds unsigned columns (``dtypes.py``): uint8 as torch.uint8, the
16/32/64-bit ones as the bits of the signed type of the same width. Float64
takes its true 64-bit pattern; the reference's double-float (hi, lo) pair
exists only because a TPU cannot bitcast 64-bit types.

The sort places NaN and null as Arrow does: nulls at the end that
``nulls_first`` names, NaN between them and the values, in both orders (a
rank word, not the norm, places NaN). The reference sorts NaN by its norm,
above +inf, and lets descending order flip it; the two agree only for
ascending with nulls last and descending with nulls first (ROADMAP §3
item 4).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.ints import UNSIGNED_VIEW, signed_view
from .kernels.merge_path import merge_sort

_MIN = {torch.int8: -(1 << 7), torch.int16: -(1 << 15),
        torch.int32: -(1 << 31), torch.int64: -(1 << 63)}
_FLOAT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
_LOW_BITS = {torch.int16: 0xFFFF, torch.int32: 0xFFFF_FFFF}
_FIRST, _NAN, _LAST = 0, 1, 2      # placement classes


class SortKey(NamedTuple):
    values: torch.Tensor
    validity: Optional[torch.Tensor] = None
    ascending: bool = True
    nulls_first: bool = True


def _canonical(values: torch.Tensor) -> torch.Tensor:
    """-0.0 → +0.0 and every NaN → the canonical NaN."""
    values = torch.where(values == 0.0, torch.zeros_like(values), values)
    return torch.where(torch.isnan(values),
                       torch.full_like(values, float("nan")), values)


def _norm_float(values: torch.Tensor) -> torch.Tensor:
    """float32/64 → the signed-storage bits of an unsigned lane whose
    unsigned order is IEEE total order (Arrow equality classes)."""
    bits = _canonical(values).view(_FLOAT_BITS[values.dtype])
    sign = _MIN[bits.dtype]
    return torch.where(bits < 0, ~bits, bits | sign)


def normalize_key(values: torch.Tensor, ascending: bool = True
                  ) -> torch.Tensor:
    """Map a numeric column to unsigned lanes whose unsigned order equals
    the requested value order (bool, f32, int32 → 32-bit lanes; int8 →
    uint8; int16 → 16-bit; f64, int64 → 64-bit; unsigned → themselves).
    Takes torch's uint16/32/64 tensors as unsigned columns."""
    dt = values.dtype
    if dt == torch.bool:
        u = values.to(torch.int32)
    elif dt in _FLOAT_BITS:
        u = _norm_float(values)
    elif dt == torch.int8:
        u = (values ^ _MIN[dt]).view(torch.uint8)
    elif dt in _MIN:
        u = values ^ _MIN[dt]
    elif dt == torch.uint8 or dt in UNSIGNED_VIEW:
        u = signed_view(values)
    else:
        raise TypeError(f"normalize_key: unsupported dtype {dt}")
    return u if ascending else ~u


def denormalize_key(u: torch.Tensor, dtype: torch.dtype,
                    ascending: bool = True) -> torch.Tensor:
    """Inverse of ``normalize_key``: the CANONICAL column values (−0.0 and
    NaN come back as their class's canonical member) in ``dtype``."""
    if not ascending:
        u = ~u
    if dtype == torch.bool:
        return u != 0
    if dtype in _FLOAT_BITS:
        bits = u.view(_FLOAT_BITS[dtype])
        sign = _MIN[bits.dtype]
        return torch.where(bits < 0, bits ^ sign, ~bits).view(dtype)
    if u.dtype == torch.uint8:
        u = u.view(torch.int8)
    signed = UNSIGNED_VIEW.get(dtype, dtype)
    if signed == torch.uint8:
        return u.view(torch.uint8)
    out = u.to(signed)
    if signed in _MIN and dtype not in UNSIGNED_VIEW:
        out = out ^ _MIN[signed]
    return out if dtype == signed else out.view(dtype)


def _widen(norm: torch.Tensor) -> torch.Tensor:
    """A normalized lane as a 64-bit word by zero extension, so the word
    equals the unsigned norm (uint8 zero-extends by itself)."""
    if norm.dtype == torch.int64:
        return norm
    wide = norm.to(torch.int64)
    low = _LOW_BITS.get(norm.dtype)
    return wide if low is None else wide & low


def _build_operands(keys: Sequence[SortKey], length
                    ) -> Tuple[List[torch.Tensor], List[int],
                               List[torch.dtype]]:
    """The comparator words, most significant first, each an int64 tensor
    holding bits in unsigned order; the index of each key's norm word; each
    norm's own dtype.

    Each key has a rank word before its norm that holds its placement class
    (nulls first: null 0, NaN 1, value 2; nulls last: value 0, NaN 1,
    null 2), NaN and null rows with a zeroed norm; the first key's rank also
    holds the padding bit above the class (rows at index ≥ ``length`` sort
    last). A rank word that is statically all zero is left out: that of a
    key that is not a float and has no validity (and, for the first key, no
    ``length``). A float key always has one: whether it holds a NaN is not
    known without reading it."""
    if not keys:
        raise ValueError("sort needs at least one key")
    n = keys[0].values.shape[0]
    dev = keys[0].values.device
    words: List[torch.Tensor] = []
    key_word: List[int] = []
    norm_dtypes: List[torch.dtype] = []
    for i, k in enumerate(keys):
        if k.values.shape != (n,) or k.values.device != dev:
            raise ValueError("sort keys must be 1-D columns of the same "
                             "length on one device")
        norm = normalize_key(k.values, k.ascending)
        norm_dtypes.append(norm.dtype)
        norm = _widen(norm)
        is_float = k.values.dtype in _FLOAT_BITS
        padded = i == 0 and length is not None
        if is_float or k.validity is not None or padded:
            rank = torch.full((n,), _LAST if k.nulls_first else _FIRST,
                              dtype=torch.int64, device=dev)
            hidden = None
            if is_float:
                hidden = torch.isnan(k.values)
                rank = torch.where(hidden, _NAN, rank)
            if k.validity is not None:
                null = ~k.validity.to(torch.bool)
                rank = torch.where(null, _FIRST if k.nulls_first else _LAST,
                                   rank)
                hidden = null if hidden is None else hidden | null
            if hidden is not None:
                norm = torch.where(hidden, 0, norm)
            if padded:
                rank = rank | (torch.arange(n, device=dev) >= length
                               ).to(torch.int64) << 2
            words.append(rank)
        key_word.append(len(words))
        words.append(norm)
    return words, key_word, norm_dtypes


def _sort_full(keys: Sequence[SortKey], length
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(perm int32, the sorted norm of each key in its own dtype)."""
    words, key_word, norm_dtypes = _build_operands(keys, length)
    perm, sorted_words = merge_sort(words)
    return perm, [sorted_words[j].to(dt)
                  for j, dt in zip(key_word, norm_dtypes)]


def sort_permutation(keys: Sequence[SortKey], length=None) -> torch.Tensor:
    """Return the stable permutation (int32 indices) ordering rows by the
    given keys; padding rows (index ≥ length) sort to the back."""
    perm, _ = _sort_full(keys, length)
    return perm


def _take(column: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return signed_view(column).index_select(0, perm).view(column.dtype)


def sort_columns(keys: Sequence[SortKey],
                 payload: Sequence[torch.Tensor] = (),
                 length=None):
    """Sort key columns plus payload columns; returns (perm, sorted key
    value tensors, sorted payloads).

    Non-null integer and bool keys come back from their sorted norms
    (``denormalize_key``). Float keys, nullable keys and every payload come
    back by one ``index_select`` by ``perm``, so sorted float keys keep
    -0.0 and NaN bits as Arrow's ``take`` does (the reference returns its
    canonical +0.0 and NaN there: ROADMAP §3 item 4)."""
    perm, sorted_norms = _sort_full(keys, length)
    sorted_keys = []
    for k, sn in zip(keys, sorted_norms):
        if k.validity is None and k.values.dtype not in _FLOAT_BITS:
            sorted_keys.append(denormalize_key(sn, k.values.dtype,
                                               k.ascending))
        else:
            sorted_keys.append(_take(k.values, perm))
    return perm, sorted_keys, [_take(p, perm) for p in payload]
