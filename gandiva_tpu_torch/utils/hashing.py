"""Vectorized hash functions (a JAX-free copy of gandiva_tpu.utils.hashing).

The murmur3 fmix32 avalanche with a boost-style chainable combine, as the
reference defines them; results match it bit for bit. Torch has no shift or
add on uint32, so the 32-bit lanes are computed in int64 and masked to
32 bits: ``hash32`` returns int64 values in [0, 2^32), ``hash64`` the int64
bit pattern of the uint64 hash. 64-bit inputs (int64, uint64, float64) hash
as their (lo, hi) 32-bit halves; floats hash by bit pattern with -0.0 taken
as +0.0 (SQL equality). ``partition_of`` is the engine-wide partitioning
function of the distribution layer (``parallel/``).
"""
from __future__ import annotations

import torch

from .ints import widen

_M32 = 0xFFFF_FFFF
_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9


def fmix32(h):
    """murmur3 finalizer on 32-bit values held in int64 (products wrap mod
    2^64, which keeps their low 32 bits exact)."""
    h = h & _M32
    h = h ^ (h >> 16)
    h = (h * _C1) & _M32
    h = h ^ (h >> 13)
    h = (h * _C2) & _M32
    return h ^ (h >> 16)


def _combine(seed, v):
    """boost-style hash_combine on 32-bit values held in int64."""
    return seed ^ ((fmix32(v) + _GOLDEN + ((seed << 6) & _M32) + (seed >> 2))
                   & _M32)


def _lanes(x: torch.Tensor):
    """``x`` as the 32-bit lanes the reference hashes, each an int64 tensor
    in [0, 2^32): one lane for ≤32-bit types, (lo, hi) for 64-bit ones."""
    if x.is_floating_point():
        x = torch.where(x == 0.0, torch.zeros_like(x), x)  # -0.0 → +0.0
        x = x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
    w = widen(x)  # ≤32-bit: two's complement or zero-extended, as astype
    if x.element_size() == 8:
        return w & _M32, (w >> 32) & _M32
    return (w & _M32,)


def hash32(x: torch.Tensor, seed=0) -> torch.Tensor:
    """Hash any integer/float column to 32 bits (int64 values in
    [0, 2^32)), chainable via ``seed`` (an int or an int64 tensor)."""
    h = seed
    for lane in _lanes(x):
        h = _combine(h, lane)
    return h


def hash64(x: torch.Tensor, seed=0) -> torch.Tensor:
    """64-bit hash assembled from two independent 32-bit passes; the uint64
    result's bits as int64. ``seed`` is a uint64 value (int or the int64
    bits of one)."""
    lo = hash32(x, seed & _M32)
    hi = hash32(x, ((seed >> 32) & _M32) ^ 0xDEAD_BEEF)
    return (hi << 32) | lo


def partition_of(keys: torch.Tensor, num_partitions: int, seed=0
                 ) -> torch.Tensor:
    """Partition id in [0, num_partitions) for each key, as int32 — the
    engine-wide partitioning function (tables co-partition iff they use the
    same seed). The reference takes ``hash32 % P`` on uint32; ``hash32``
    here is already the unsigned value in int64, so ``%`` sees no sign."""
    return (hash32(keys, seed) % num_partitions).to(torch.int32)
