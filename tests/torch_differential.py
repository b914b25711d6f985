"""Shared pieces of the registry differentials (tests/test_torch_datetime.py,
test_torch_decimal.py, test_torch_plan_io.py): columns made with numpy from
a seed, given to gandiva_tpu (JAX on the CPU) and to the port (device
"cpu") as the same state, one expression per package, and the outputs held
bit for bit, null rows included; string and binary outputs, whose codes
index each engine's own dictionary, are held by their decoded values."""
import dataclasses

import numpy as np
import pyarrow as pa

import jax.numpy as jnp

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu.batch import Batch as GBatch, Column as GColumn

CPU = "cpu"
NULL_SHARE = 0.05
# civil days of 1600-01-01 and 2400-12-31
DAY_MIN, DAY_MAX = -135140, 157419
MS_PER_DAY = 86_400_000


def dtype_of(p, name: str):
    """The DataType named ``name`` (``str(DataType)``) in package ``p``."""
    if name.startswith("decimal128("):
        prec, scale = name[len("decimal128("):-1].split(",")
        return p.dtypes.decimal128(int(prec), int(scale))
    return p.dtypes.DataType(p.dtypes.TypeKind(name))


def decimal_limbs(values):
    """Python ints → (lo, hi) int64 limb arrays (two's complement, 128-bit
    wrap)."""
    mask = (1 << 64) - 1
    lo = np.array([(v & mask) - ((v & mask) >> 63 << 64) for v in values],
                  dtype=np.int64)
    hi = np.array([(v >> 64) for v in values], dtype=np.int64)
    return lo, hi


def limbs_to_ints(lo, hi):
    return [int(h) * (1 << 64) + (int(lw) & ((1 << 64) - 1))
            for h, lw in zip(hi, lo)]


def random_decimals(rng, n, precision: int):
    """``n`` unscaled values uniform in (-10^precision, 10^precision), with
    0, ±1 and the extremes among them."""
    top = 10 ** precision - 1
    vals = [int(x) for x in rng.integers(-(10 ** 18), 10 ** 18, n)]
    if precision > 18:
        hi = 10 ** (precision - 18)
        vals = [v * hi + int(x) for v, x in
                zip(vals, rng.integers(0, min(hi, 1 << 62), n))]
    vals = [max(-top, min(top, v % (2 * top + 1) - top)) for v in vals]
    vals[:5] = [0, 1, -1, top, -top][:n]
    return vals


def column(type_name: str, rng, n: int, kind: str = "any"):
    """Random (data, validity, hi limbs or None) of the type ``type_name``
    at ``n`` rows, 5% nulls. ``kind="amount"`` keeps integers small (day,
    month and second counts of the date functions)."""
    valid = rng.random(n) >= NULL_SHARE
    t = dtype_of(gt, type_name)
    hi = None
    if t.is_decimal:
        data, hi = decimal_limbs(random_decimals(rng, n, t.precision))
    elif type_name == "date32":
        data = rng.integers(DAY_MIN, DAY_MAX, n, endpoint=True
                            ).astype(np.int32)
    elif type_name in ("date64", "timestamp"):
        data = (rng.integers(DAY_MIN, DAY_MAX, n, endpoint=True)
                * MS_PER_DAY + rng.integers(0, MS_PER_DAY, n))
        if type_name == "date64":
            data[::3] -= data[::3] % MS_PER_DAY   # midnight, as date64 holds
    elif type_name == "time32":
        data = rng.integers(0, MS_PER_DAY, n).astype(np.int32)
    elif type_name == "time64":
        data = rng.integers(0, MS_PER_DAY * 1000, n)
    elif type_name == "interval_day":
        days = rng.integers(-20000, 20000, n)
        data = (days << 32) | rng.integers(0, MS_PER_DAY, n)
    elif type_name == "interval_year":
        data = rng.integers(-2400, 2400, n).astype(np.int32)
    elif type_name == "bool":
        data = rng.random(n) < 0.5
    elif t.is_float:
        data = (rng.standard_normal(n) * 1e6).astype(t.np_dtype)
        data[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.5][:n]
    elif kind == "amount":
        data = rng.integers(-50000, 50000, n).astype(t.np_dtype)
    else:
        info = np.iinfo(t.np_dtype)
        data = rng.integers(info.min, info.max, n, dtype=t.np_dtype,
                            endpoint=True)
    return np.asarray(data), valid, hi


def text_column(type_name: str, rng, n: int, values):
    """(codes, validity, None, dictionary) of a string or binary column of
    ``n`` rows over the distinct ``values`` (5% nulls, codes 0 there)."""
    valid = rng.random(n) >= NULL_SHARE
    codes = np.where(valid, rng.integers(0, len(values), n), 0)
    typ = pa.string() if type_name == "string" else pa.binary()
    return codes.astype(np.int32), valid, None, pa.array(values, type=typ)


def batches(columns: dict, n: int):
    """``{name: (type name, data, validity, hi or None[, dictionary])}`` →
    (gandiva_tpu Batch, port Batch on the CPU) holding the same state, a
    string column's dictionary the same object in both."""
    ref = {}
    for name, (tn, data, valid, hi, *d) in columns.items():
        ref[name] = GColumn(jnp.asarray(data), jnp.asarray(valid),
                            dtype_of(g, tn), dictionary=(d or [None])[0],
                            extra=None if hi is None else jnp.asarray(hi))
    port = gt.from_columns_numpy(columns, n, device=CPU)
    return GBatch(ref, n), port


def decoded(col, dictionary=None):
    """A string or binary column's values row by row (None where null)."""
    codes = np.asarray(col.data).astype(np.int32)
    valid = np.asarray(col.validity)
    d = (col.dictionary if dictionary is None else dictionary).to_pylist()
    return [d[c] if ok else None for c, ok in zip(codes, valid)]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.bool_:
        return a
    return a.view(f"i{a.itemsize}")


def assert_same_column(ref, port, what=""):
    """Bit for bit over every row, null rows included; NaN equals NaN (libm
    NaN payloads differ), validity equal; strings and binaries by value."""
    rv = np.asarray(ref.validity)
    pv = port.validity.numpy()
    np.testing.assert_array_equal(pv, rv, err_msg=f"{what} validity")
    if port.dtype.is_varlen:
        assert decoded(port) == decoded(ref), what
        return
    rd, pd = np.asarray(ref.data), port.data.numpy()
    if rd.dtype.kind == "f":
        nan = np.isnan(rd)
        np.testing.assert_array_equal(np.isnan(pd), nan, err_msg=what)
        rd, pd = np.where(nan, 0, rd), np.where(nan, 0, pd)
    np.testing.assert_array_equal(_bits(pd), _bits(rd), err_msg=what)
    if ref.extra is not None or port.extra is not None:
        np.testing.assert_array_equal(port.extra.numpy(),
                                      np.asarray(ref.extra),
                                      err_msg=f"{what} hi limb")


def project_both(make_exprs, columns: dict, n: int, config=None):
    """``make_exprs(p, schema)`` → expressions of package ``p``; evaluated
    by both packages' Projector on the same columns; outputs held bit for
    bit. Returns the port's output Batch."""
    ref_b, port_b = batches(columns, n)
    outs = {}
    for p, b in ((g, ref_b), (gt, port_b)):
        schema = p.dtypes.Schema([p.dtypes.Field(name, dtype_of(p, c[0]))
                                  for name, c in columns.items()])
        kw = {"device": CPU} if p is gt else {}
        proj = p.make_projector(schema, make_exprs(p, schema),
                                config=config, use_cache=False, **kw)
        outs[p] = proj.evaluate_device(b)
    for name in outs[g].columns:
        assert_same_column(outs[g].column(name), outs[gt].column(name), name)
    return outs[gt]


def to_reference(x):
    """A port tree (node, Expression, Condition, Field, DataType, Schema)
    rebuilt as gandiva_tpu's, class by class and field by field."""
    if isinstance(x, gt.dtypes.DataType):
        return dtype_of(g, str(x))
    if isinstance(x, gt.dtypes.Field):
        return g.dtypes.Field(x.name, to_reference(x.dtype), x.nullable)
    if isinstance(x, gt.dtypes.Schema):
        return g.dtypes.Schema([to_reference(f) for f in x])
    if isinstance(x, tuple):
        return tuple(to_reference(v) for v in x)
    if dataclasses.is_dataclass(x):
        cls = getattr(g.expr.nodes, type(x).__name__)
        return cls(*(to_reference(getattr(x, f.name))
                     for f in dataclasses.fields(x) if f.init))
    return x
