"""Native host runtime loader (ctypes over the C ABI in host_runtime.cpp).

The port's own copy of gandiva_tpu's host runtime: a memory pool, the Arrow
validity-bitmap codec, the SQL LIKE / ILIKE matcher over string
dictionaries and FNV-1a-64 byte hashing. ``host_runtime.cpp`` is compiled
on first use by ``g++`` into ``build/native/`` at the root of the checkout,
loaded and bound from ``_FUNCTIONS`` by ``ops/kernels/build.py``
(``build.load_runtime``).

There is no fallback: an entry point raises ``RuntimeError`` when the
library cannot be built or loaded. ``available()`` reports whether it can.
The one other route is the caller's, not this module's: ``like_match`` and
``hash_bytes`` return None for a dictionary that is not a plain utf8 array
(``_string_view``), and the string registry then matches by Python regex.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.kernels import build

_SRC = Path(__file__).resolve().parent / "host_runtime.cpp"
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_FUNCTIONS = {
    "gt_pool_create": (_VP, []),
    "gt_pool_destroy": (None, [_VP]),
    "gt_pool_alloc": (_VP, [_VP, _I64, _I64]),
    "gt_pool_free": (None, [_VP, _VP, _I64, _I64]),
    "gt_pool_bytes_allocated": (_I64, [_VP]),
    "gt_pool_peak_bytes": (_I64, [_VP]),
    "gt_pool_num_allocs": (_I64, [_VP]),
    "gt_unpack_bitmap": (None, [_VP, _I64, _I64, _U8P]),
    "gt_pack_bitmap": (None, [_U8P, _I64, _U8P]),
    "gt_like_match_many": (None, [_VP, _I32P, _I64, ctypes.c_char_p, _I64,
                                  ctypes.c_uint8, ctypes.c_int32, _U8P]),
    "gt_ilike_match_many": (None, [_VP, _I32P, _I64, ctypes.c_char_p, _I64,
                                   _U8P]),
    "gt_hash_bytes_many": (None, [_VP, _I32P, _I64, ctypes.c_uint64, _U64P])}


def load() -> ctypes.CDLL:
    """The native library, built at first use; raises RuntimeError if it
    cannot be built or loaded."""
    return build.load_runtime(_SRC, _FUNCTIONS)


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


class MemoryPool:
    """Aligned host allocator with live/peak accounting — the
    arrow::MemoryPool analogue (the reference passes one to every Evaluate,
    libgandiva.pxd:219). Buffers are numpy views over pool memory; ``free``
    returns them and updates the counters."""

    def __init__(self):
        self._lib = load()
        self._handle = self._lib.gt_pool_create()
        self._allocs = {}

    def allocate(self, size: int, alignment: int = 64) -> np.ndarray:
        ptr = self._lib.gt_pool_alloc(self._handle, size, alignment)
        if not ptr:
            raise MemoryError(f"pool allocation of {size} bytes failed")
        buf = (ctypes.c_uint8 * size).from_address(ptr)
        arr = np.frombuffer(buf, dtype=np.uint8, count=size)
        self._allocs[arr.ctypes.data] = (ptr, size, alignment)
        return arr

    def free(self, arr: np.ndarray) -> None:
        rec = self._allocs.pop(arr.ctypes.data, None)
        if rec is not None:
            self._lib.gt_pool_free(self._handle, *rec)

    @property
    def bytes_allocated(self) -> int:
        return self._lib.gt_pool_bytes_allocated(self._handle)

    @property
    def peak_bytes(self) -> int:
        return self._lib.gt_pool_peak_bytes(self._handle)

    @property
    def num_allocations(self) -> int:
        return self._lib.gt_pool_num_allocs(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gt_pool_destroy(self._handle)
            self._handle = None


_default_pool: Optional[MemoryPool] = None


def default_pool() -> MemoryPool:
    global _default_pool
    if _default_pool is None:
        _default_pool = MemoryPool()
    return _default_pool


def unpack_bitmap(bits_buffer, bit_offset: int, n: int) -> np.ndarray:
    """Arrow packed validity bits (a pyarrow Buffer, or None for all valid)
    → a bool per row."""
    out = np.empty(n, dtype=np.uint8)
    addr = 0 if bits_buffer is None else bits_buffer.address
    load().gt_unpack_bitmap(ctypes.c_void_p(addr or None), bit_offset, n,
                            out)
    return out.view(bool)


def pack_bitmap(bools: np.ndarray) -> np.ndarray:
    """A bool per row → Arrow packed bits (LSB first), ``ceil(n / 8)``
    bytes."""
    n = len(bools)
    out = np.zeros((n + 7) // 8, dtype=np.uint8)
    load().gt_pack_bitmap(np.ascontiguousarray(bools, dtype=np.uint8), n,
                          out)
    return out


def _string_view(arrow_array):
    """(values address, offsets int32 array, n) of a pyarrow string array,
    nulls as empty strings; None if the layout is not plain utf8."""
    import pyarrow as pa

    if not pa.types.is_string(arrow_array.type):
        return None
    if arrow_array.null_count:
        arrow_array = arrow_array.fill_null("")
    bufs = arrow_array.buffers()
    if len(bufs) < 3 or bufs[1] is None:
        return None
    offsets = np.frombuffer(bufs[1], dtype=np.int32,
                            count=len(arrow_array) + 1 + arrow_array.offset)
    offsets = np.ascontiguousarray(offsets[arrow_array.offset:])
    values_addr = bufs[2].address if bufs[2] is not None else 0
    # the array keeps its buffers alive while the caller reads them
    return values_addr, offsets, len(arrow_array), arrow_array


def like_match(arrow_strings, pattern: str, escape: Optional[str] = None,
               ignore_case: bool = False) -> Optional[np.ndarray]:
    """SQL LIKE (ILIKE: ASCII case folded, no escape) of ``pattern`` over
    each value of a pyarrow string array, as bools; None for an array that
    is not plain utf8."""
    lib = load()
    view = _string_view(arrow_strings)
    if view is None:
        return None
    addr, offsets, n, _keep = view
    out = np.empty(n, dtype=np.uint8)
    pat = pattern.encode()
    if ignore_case:
        lib.gt_ilike_match_many(ctypes.c_void_p(addr or None), offsets, n,
                                pat, len(pat), out)
    else:
        esc = escape.encode()[0] if escape else 0
        lib.gt_like_match_many(ctypes.c_void_p(addr or None), offsets, n,
                               pat, len(pat), esc, 1 if escape else 0, out)
    return out.view(bool)


def hash_bytes(arrow_strings, seed: int = 0) -> Optional[np.ndarray]:
    """FNV-1a-64 over each value's utf8 bytes (nulls as empty), as uint64
    (bit-identical to registry/string_ops.hash_bytes_np); None for an array
    that is not plain utf8."""
    lib = load()
    view = _string_view(arrow_strings)
    if view is None:
        return None
    addr, offsets, n, _keep = view
    out = np.empty(n, dtype=np.uint64)
    lib.gt_hash_bytes_many(ctypes.c_void_p(addr or None), offsets, n,
                           np.uint64(seed & 0xFFFF_FFFF_FFFF_FFFF), out)
    return out
