"""Columnar substrate: device-resident batches with validity masks.

The torch counterpart of gandiva_tpu.batch: an Arrow RecordBatch becomes a
``Batch`` of ``Column``s, each a values tensor plus a bool validity tensor on
one explicit device.

- validity is a full ``bool`` per row, not a packed bitmap, as in the
  reference package;
- no padding: the reference pads to 2048 rows for its TPU compaction block,
  while the port's kernel masks the ragged tail itself. ``pad_to`` still
  builds a larger capacity when a caller wants one (padding rows invalid);
- unsigned 16/32/64-bit columns hold the bits of the signed type of the same
  width (``DataType.storage_np_dtype``); numpy and Arrow see unsigned values;
- decimal128 columns hold two int64 tensors, as the reference's do: ``data``
  the low 64 bits (as int64 bits) and ``extra`` the high 64 bits, signed;
- string and binary columns are dictionary-encoded at ingest, as the
  reference's are: ``data`` holds int32 codes on the device (0 in null
  rows), and ``dictionary`` the distinct values, a pyarrow Array on the
  host. String functions run once per distinct value on the host and are
  gathered by code on the device (registry/string_ops.py); padding and the
  selection path keep the same dictionary object, which the plans' table
  memo keys on.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import dtypes as dt
from .device import DEFAULT_DEVICE, resolve_device


class Column:
    """One device column: ``data`` and ``validity`` tensors of equal length
    (False ⇒ NULL), the logical ``dtype``, and the host ``dictionary`` /
    secondary ``extra`` buffer slots that string and decimal columns use."""

    def __init__(self, data, validity, dtype: dt.DataType, dictionary=None,
                 extra=None):
        self.data = data
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary
        self.extra = extra

    def __repr__(self):
        return (f"Column({self.dtype}, shape={tuple(self.data.shape)}, "
                f"device={self.data.device})")

    def _map(self, fn) -> "Column":
        return Column(fn(self.data), fn(self.validity), self.dtype,
                      self.dictionary,
                      None if self.extra is None else fn(self.extra))

    def to(self, device) -> "Column":
        """The column's tensors on ``device``; the dictionary is the same
        object."""
        return self._map(lambda t: t.to(device))

    def slice(self, start: int, stop: int) -> "Column":
        """Rows ``[start, stop)`` as views; the dictionary is the same
        object."""
        return self._map(lambda t: t[start:stop])


class Batch:
    """An ordered set of equal-length Columns + the logical row count
    (``length`` ≤ capacity, a Python int)."""

    def __init__(self, columns: Dict[str, Column], length: int):
        self.columns = dict(columns)
        self.length = length

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        first = next(iter(self.columns.values()))
        return int(first.data.shape[0])

    @property
    def device(self) -> Optional[torch.device]:
        if not self.columns:
            return None
        return next(iter(self.columns.values())).data.device

    def column(self, name: str) -> Column:
        return self.columns[name]

    def to(self, device) -> "Batch":
        """Every column on ``device`` (dictionaries kept, as objects)."""
        return Batch({k: c.to(device) for k, c in self.columns.items()},
                     self.length)

    def slice(self, start: int, stop: int) -> "Batch":
        """Rows ``[start, stop)`` of the capacity as views (dictionaries
        kept, as objects); the length is the part of them below ``length``.
        """
        stop = min(stop, self.capacity)
        return Batch({k: c.slice(start, stop)
                      for k, c in self.columns.items()},
                     max(0, min(stop, self.length) - start))

    def __contains__(self, name):
        return name in self.columns

    def __repr__(self):
        return f"Batch(len={self.length}, cols={list(self.columns)})"


# ---------------------------------------------------------------------------
# numpy <-> tensor
# ---------------------------------------------------------------------------

def tensor_from_numpy(arr: np.ndarray, dtype: dt.DataType,
                      device) -> torch.Tensor:
    """Host values of logical ``dtype`` → a tensor of its storage dtype."""
    arr = np.ascontiguousarray(np.asarray(arr).astype(dtype.np_dtype,
                                                      copy=False))
    arr = arr.view(dtype.storage_np_dtype)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor, dtype: dt.DataType) -> np.ndarray:
    """Storage tensor → host values of logical ``dtype`` (unsigned again)."""
    return t.detach().cpu().numpy().view(dtype.np_dtype)


def _padded(vals: np.ndarray, validity: np.ndarray, cap: int):
    n = len(vals)
    if cap < n:
        raise ValueError(f"pad_to {cap} < length {n}")
    if cap == n:
        return vals, validity
    pv = np.zeros(cap, dtype=vals.dtype)
    pv[:n] = vals
    pm = np.zeros(cap, dtype=bool)
    pm[:n] = validity
    return pv, pm


def _column(vals, validity, logical: dt.DataType, cap: int, dev,
            dictionary=None) -> Column:
    vals, validity = _padded(np.asarray(vals).astype(logical.np_dtype,
                                                     copy=False),
                             np.asarray(validity, dtype=bool), cap)
    return Column(tensor_from_numpy(vals, logical, dev),
                  torch.from_numpy(np.array(validity, dtype=bool)).to(dev),
                  logical, dictionary=dictionary)


def _validity(arr) -> np.ndarray:
    """An Arrow array's validity, a bool per row (native bitmap codec)."""
    n = len(arr)
    if not arr.null_count:
        return np.ones(n, dtype=bool)
    from . import native

    return native.unpack_bitmap(arr.buffers()[0], arr.offset, n)


# ---------------------------------------------------------------------------
# Arrow <-> device conversion
# ---------------------------------------------------------------------------

def _np_from_arrow(arr):
    """Return (values ndarray, validity bool ndarray, dictionary or None):
    string, large_string, binary and large_binary arrays are
    dictionary-encoded, a dictionary array keeps its dictionary; the codes
    of null rows are 0."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    validity = _validity(arr)
    t = arr.type
    if pa.types.is_string(t) or pa.types.is_large_string(t) \
            or pa.types.is_binary(t) or pa.types.is_large_binary(t):
        arr = pc.dictionary_encode(arr)
        t = arr.type
    if pa.types.is_dictionary(t):
        codes = arr.indices.fill_null(0).to_numpy(zero_copy_only=False)
        return codes.astype(np.int32), validity, arr.dictionary
    if pa.types.is_boolean(t):
        return (arr.fill_null(False).to_numpy(zero_copy_only=False),
                validity, None)
    zero = pa.scalar(0.0 if pa.types.is_floating(t) else 0, type=t)
    try:
        filled = arr.fill_null(zero)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        filled = arr
    vals = filled.to_numpy(zero_copy_only=False)
    if vals.dtype.kind in "Mm":  # datetime64/timedelta64 → int64 view
        vals = vals.view(np.int64)
    return vals, validity, None


def _decimal_limbs(arr):
    """pyarrow decimal128 array → (lo int64, hi int64, validity bool), the
    16-byte little-endian two's complement values read from the array's
    ``offset``; null rows hold 0."""
    n = len(arr)
    validity = _validity(arr)
    raw = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                        count=2 * (n + arr.offset))[2 * arr.offset:]
    pairs = raw.reshape(n, 2)
    lo = np.where(validity, pairs[:, 0], 0)
    hi = np.where(validity, pairs[:, 1], 0)
    return lo, hi, validity


def _decimal_column(lo, hi, validity, logical: dt.DataType, cap: int,
                    dev) -> Column:
    validity = np.asarray(validity, dtype=bool)
    hi, _ = _padded(np.asarray(hi, dtype=np.int64), validity, cap)
    lo, validity = _padded(np.asarray(lo, dtype=np.int64), validity, cap)
    return Column(tensor_from_numpy(lo, logical, dev),
                  torch.from_numpy(np.array(validity, dtype=bool)).to(dev),
                  logical, extra=tensor_from_numpy(hi, logical, dev))


def column_from_arrow(arr, pad_to: Optional[int] = None,
                      device=DEFAULT_DEVICE) -> Column:
    """Convert a pyarrow Array/ChunkedArray into a device Column."""
    import pyarrow as pa

    logical = dt.from_arrow(arr.type)
    dev = resolve_device(device)
    if logical.is_decimal:
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        lo, hi, validity = _decimal_limbs(arr)
        return _decimal_column(lo, hi, validity, logical,
                               pad_to if pad_to is not None else len(arr),
                               dev)
    vals, validity, dictionary = _np_from_arrow(arr)
    n = len(vals)
    cap = pad_to if pad_to is not None else n
    vals = vals.astype(logical.np_dtype, copy=False)
    # timestamps: gandiva uses millis; normalize arrow timestamp units to ms
    if pa.types.is_timestamp(arr.type) and arr.type.unit != "ms":
        scale = {"s": 1000, "ms": 1, "us": 1 / 1000, "ns": 1 / 1000000}[arr.type.unit]
        vals = vals * int(scale) if scale >= 1 else vals // int(1 / scale)
    return _column(vals, validity, logical, cap, dev, dictionary)


def from_arrow(batch, pad_to: Optional[int] = None,
               device=DEFAULT_DEVICE) -> Batch:
    """Convert a pyarrow RecordBatch/Table into a device Batch."""
    import pyarrow as pa

    if isinstance(batch, pa.Table):
        batch = batch.combine_chunks()
        names = batch.column_names
    else:
        names = batch.schema.names
    arrays = [batch.column(i) for i in range(batch.num_columns)]
    n = batch.num_rows
    cap = pad_to if pad_to is not None else n
    cols = {name: column_from_arrow(arr, pad_to=cap, device=device)
            for name, arr in zip(names, arrays)}
    return Batch(cols, n)


def column_to_arrow(col: Column, length: int):
    """Convert a device Column back to a pyarrow Array (first ``length`` rows)."""
    import pyarrow as pa

    vals = tensor_to_numpy(col.data[:length], col.dtype)
    mask = ~col.validity[:length].cpu().numpy()  # True ⇒ null
    arrow_type = dt.to_arrow(col.dtype)
    if col.dtype.is_varlen:
        codes = pa.array(vals, mask=mask, type=pa.int32())
        return pa.DictionaryArray.from_arrays(
            codes, col.dictionary).cast(arrow_type)
    if col.dtype.is_decimal:
        pairs = np.empty((length, 2), dtype=np.int64)
        pairs[:, 0] = vals
        pairs[:, 1] = tensor_to_numpy(col.extra[:length], col.dtype)
        nulls = int(mask.sum())
        validity_buf = pa.array(~mask).buffers()[1] if nulls else None
        return pa.Array.from_buffers(arrow_type, length,
                                     [validity_buf, pa.py_buffer(pairs)],
                                     null_count=nulls)
    if col.dtype.is_temporal:
        # temporal values are physically int32/int64; build as integers and
        # reinterpret-cast to the temporal arrow type
        phys = pa.int32() if vals.dtype == np.int32 else pa.int64()
        return pa.array(vals, mask=mask, type=phys).cast(arrow_type)
    return pa.array(vals, mask=mask, type=arrow_type)


def to_arrow(batch: Batch):
    """Convert a Batch back into a pyarrow RecordBatch."""
    import pyarrow as pa

    names = list(batch.columns)
    arrays = [column_to_arrow(batch.columns[n], batch.length) for n in names]
    return pa.RecordBatch.from_arrays(arrays, names=names)


def from_numpy(data: Dict[str, np.ndarray],
               validity: Optional[Dict[str, np.ndarray]] = None,
               pad_to: Optional[int] = None,
               device=DEFAULT_DEVICE) -> Batch:
    """Build a Batch from plain numpy arrays (all-valid unless masks given)."""
    dev = resolve_device(device)
    n = len(next(iter(data.values())))
    cap = pad_to if pad_to is not None else n
    cols = {}
    for name, arr in data.items():
        arr = np.asarray(arr)
        m = None if not validity else validity.get(name)
        m = np.ones(n, dtype=bool) if m is None else np.asarray(m, dtype=bool)
        cols[name] = _column(arr, m, _logical_from_np(arr.dtype), cap, dev)
    return Batch(cols, n)


def from_columns_numpy(columns: Dict[str, tuple], length: int,
                       device=DEFAULT_DEVICE) -> Batch:
    """Build a Batch from another engine's columns, taken apart into numpy.

    ``columns``: ``{name: (dtype, data, validity[, extra[, dictionary]])}``,
    where ``dtype`` is a DataType or its string form (``str(dtype)``), and
    ``data``/``validity`` cover the whole capacity. This carries a
    gandiva_tpu Batch over with its padding, so both engines start from the
    same state. A decimal column's ``data`` is its low limb and ``extra``
    its high limb (int64 each); a string or binary column's ``data`` is its
    int32 codes and ``dictionary`` its pyarrow dictionary, taken as it is
    (the same object)."""
    dev = resolve_device(device)
    cols = {}
    for name, (dtype, data, validity, *rest) in columns.items():
        extra, dictionary = (list(rest) + [None, None])[:2]
        logical = parse_dtype(dtype)
        if logical.is_varlen != (dictionary is not None):
            raise ValueError(f"column {name!r}: a string or binary column, "
                             "and only one, carries a dictionary")
        data = np.asarray(data)
        if logical.is_decimal:
            cols[name] = _decimal_column(data, extra, validity, logical,
                                         len(data), dev)
            continue
        if extra is not None:
            raise ValueError(f"column {name!r}: only decimal columns carry "
                             "an extra limb")
        cols[name] = _column(data, validity, logical, len(data), dev,
                             dictionary)
    return Batch(cols, length)


def parse_dtype(dtype) -> dt.DataType:
    """A DataType, or the string ``str(DataType)`` prints, → DataType."""
    if isinstance(dtype, dt.DataType):
        return dtype
    s = str(dtype)
    if s.startswith("decimal128("):
        p, sc = s[len("decimal128("):-1].split(",")
        return dt.decimal128(int(p), int(sc))
    return dt.DataType(dt.TypeKind(s))


def _logical_from_np(np_dtype) -> dt.DataType:
    m = {
        np.dtype(np.bool_): dt.bool_,
        np.dtype(np.int8): dt.int8,
        np.dtype(np.int16): dt.int16,
        np.dtype(np.int32): dt.int32,
        np.dtype(np.int64): dt.int64,
        np.dtype(np.uint8): dt.uint8,
        np.dtype(np.uint16): dt.uint16,
        np.dtype(np.uint32): dt.uint32,
        np.dtype(np.uint64): dt.uint64,
        np.dtype(np.float32): dt.float32,
        np.dtype(np.float64): dt.float64,
    }
    try:
        return m[np.dtype(np_dtype)]
    except KeyError:
        raise ValueError(f"unsupported numpy dtype {np_dtype}") from None
