"""Hash registry functions over numeric/temporal columns.

The torch counterpart of gandiva_tpu.registry.hash_ops (Gandiva's
precompiled/hash.cc + function_registry_hash.cc, SURVEY.md §2b "Hash"):
hash32/hash64 with an optional chainable seed, on utils.hashing's
murmur-fmix32 family. Seeds and results keep the reference's bits: hash32
returns the int32 bits of the uint32 hash, hash64 the int64 bits of the
uint64 one, and the AsDouble forms convert the unsigned hash to float64 with
one rounding. The string hashes (FNV-1a 64 per distinct dictionary value)
live in string_ops.py. Each entry's emitter runs the same chain in C++ for
the plan compiler (``gt_hash32`` / ``gt_hash64`` of csrc/plan_prelude.h).
"""
from __future__ import annotations

import torch

from .. import dtypes as dt
from ..utils.hashing import hash32, hash64
from ..utils.ints import widen
from .numeric import NUMERIC, TEMPORAL, ctype, emit_to_float, to_float
from .registry import global_registry

_R = global_registry()

_HASHABLE = NUMERIC + TEMPORAL + [dt.bool_]


def _int32_bits(h):
    """A 32-bit hash held in int64 ([0, 2^32)) as the int32 of its bits."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _key(v):
    """The column as utils.hashing takes it: uint16, held as int16 bits,
    viewed unsigned again so that it zero-extends as the reference's does."""
    if v.dtype.kind is dt.TypeKind.UINT16:
        return v.value.view(torch.uint16)
    return v.value


def _hash32_impl(ctx, args):
    seed = 0
    if len(args) == 2:
        seed = widen(args[1].value) & 0xFFFF_FFFF   # the int32 seed's bits
    return _int32_bits(hash32(_key(args[0]), seed))


def _hash64_impl(ctx, args):
    seed = 0
    if len(args) == 2:
        seed = args[1].value                        # the int64 seed's bits
    return hash64(_key(args[0]), seed)


def _hash32_double(ctx, args):
    return hash32(_key(args[0])).to(torch.float64)


def _hash64_double(ctx, args):
    # the unsigned hash: bits ≥ 2^63 are read as negative int64
    return to_float(hash64(_key(args[0])), dt.uint64, torch.float64)


def _c_hash(bits: int, args) -> str:
    """The unsigned hash of the first argument, seeded by the second's bits
    (or 0)."""
    x = args[0]
    seed = f"(uint{bits}_t){args[1].v}" if len(args) == 2 else "0"
    return f"gt_hash{bits}<{ctype(x.dtype)}>({x.v}, {seed})"


def _emit_hash(bits: int, as_double: bool):
    def emit(g, args, rt):
        h = _c_hash(bits, args)
        if as_double:
            return emit_to_float(dt.uint32 if bits == 32 else dt.uint64,
                                 dt.float64, h)
        return f"(int{bits}_t){h}"
    return emit


for _t in _HASHABLE:
    _R.register("hash32", [_t], dt.int32, _hash32_impl, aliases=["hash"],
                emit=_emit_hash(32, False))
    _R.register("hash64", [_t], dt.int64, _hash64_impl,
                emit=_emit_hash(64, False))
    _R.register("hash32", [_t, dt.int32], dt.int32, _hash32_impl,
                emit=_emit_hash(32, False))
    _R.register("hash64", [_t, dt.int64], dt.int64, _hash64_impl,
                emit=_emit_hash(64, False))
    _R.register("hash32AsDouble", [_t], dt.float64, _hash32_double,
                emit=_emit_hash(32, True))
    _R.register("hash64AsDouble", [_t], dt.float64, _hash64_double,
                emit=_emit_hash(64, True))
