"""Order-preserving key normalization (from gandiva_tpu.ops.sort).

Only the key normalization is ported so far, because the group-by maps
float keys through it; ``SortKey``, ``sort_permutation`` and ``sort_columns``
come with the sort slice.

Normalized keys are unsigned lanes whose unsigned order is the requested
value order: the IEEE-754 total-order trick for floats (with -0.0 == 0.0
and every NaN one class, after +inf), the sign-bit bias for signed ints,
the bitwise complement for descending order. The unsigned lanes are held as
the port holds unsigned columns (``dtypes.py``): uint8 as torch.uint8, the
16/32/64-bit ones as the bits of the signed type of the same width. Float64
takes its true 64-bit pattern; the reference's double-float (hi, lo) pair
exists only because a TPU cannot bitcast 64-bit types.
"""
from __future__ import annotations

import torch

from ..utils.ints import UNSIGNED_VIEW, signed_view

_MIN = {torch.int8: -(1 << 7), torch.int16: -(1 << 15),
        torch.int32: -(1 << 31), torch.int64: -(1 << 63)}
_FLOAT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


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


def _norm_f32(values: torch.Tensor) -> torch.Tensor:
    """float32 → uint32 lane (as int32 bits), ordered as IEEE total order."""
    return _norm_float(values)


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
