"""The plan compiler's fixed-width families on the CPU: date/time and
intervals, math and rounding, hashes and castDECIMAL compiled into the
generated kernel (compiler/codegen.py, csrc/plan_prelude.h), built for the
host with g++ (``jit.host_build``) and held against gandiva_tpu (JAX on the
CPU with x64) on inputs made from a numpy seed.

Bit for bit against the reference: the dedicated cases below (pre-epoch
dates and timestamps, int64 extremes, ISO weeks at year ends, add_months
onto the 29th-31st and February of leap years, round ties at ±x.5, the
hashes of ±0.0 and NaN). The math functions are held bit for bit to the
host's libm (called through ctypes), which the generated source calls, and
to the reference within test_math_close_to_reference's tolerance, since
XLA's libm differs from the host's by ulps. round / truncate to d digits
of a number are held bit for bit to IEEE arithmetic (numpy, with libm's
pow), and the float ones within an ulp of the reference, which multiplies
by a rounded reciprocal (ROADMAP §3, "round / truncate"). Every other
emitter is held against the reference over hazard columns by
test_torch_codegen.py::test_emitters_match_reference."""
import ctypes
import ctypes.util

import numpy as np
import pyarrow as pa
import pytest

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu_torch.compiler import jit

from test_torch_codegen import (INTS, MATH, N, columns, emitter_signatures,
                                hold_compiled, project)
from torch_differential import (CPU, DAY_MAX, DAY_MIN, MS_PER_DAY,
                                assert_same_column, dtype_of)

MATH_RTOL = 4e-16 * 8           # test_math_close_to_reference's
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _f in ("cbrt", "exp", "log", "log10", "log2", "sin", "cos", "tan", "asin",
           "acos", "atan", "sinh", "cosh", "tanh", "atan2", "pow"):
    getattr(LIBM, _f).restype = ctypes.c_double
    getattr(LIBM, _f).argtypes = [ctypes.c_double] * (
        2 if _f in ("atan2", "pow") else 1)
LIBM.powf.restype = ctypes.c_float
LIBM.powf.argtypes = [ctypes.c_float, ctypes.c_float]


def _module(sig) -> str:
    fn = gt.global_registry().lookup(sig[0], [dtype_of(gt, t)
                                              for t in sig[1]])
    return fn.impl.__module__.rsplit(".", 1)[-1]


_STORAGE = {"date32": "int32", "time32": "int32", "interval_year": "int32",
            "date64": "int64", "timestamp": "int64", "interval_day": "int64"}


def _col(t: str, values, rng, n: int = N):
    """(type, data, validity, hi) of ``n`` rows: ``values`` first, in
    order, then drawn from them at random; all valid but every 17th row
    after the values."""
    values = np.asarray(values, dtype=np.dtype(_STORAGE.get(t, t)))
    data = np.concatenate([values, rng.choice(values, n - len(values))])
    valid = np.ones(n, dtype=bool)
    valid[len(values)::17] = False
    return (t, data, valid, None)


# ---------------------------------------------------------------------------
# which entries compile
# ---------------------------------------------------------------------------

def test_registry_emitters_by_family():
    """Every registry entry has an emitter but the ones that stay eager by
    design (ROADMAP §1 item 3): random (its draws are the eager route's
    torch.Generator stream) and the per-row string routes that read device
    values back to the host, castVARCHAR / castVARBINARY of a number or a
    decimal. (concat of two non-literal strings, the third per-row route,
    has an emitter and stays eager by node: test_torch_codegen_strings.py.)
    Every entry that takes a string or binary argument has a host side
    (its tables, the parses' among them), but isnull / isnotnull, which
    read the validity only, and next_day, whose weekday is a literal the
    source holds."""
    from gandiva_tpu_torch.registry import decimal_ops

    reg = gt.global_registry()
    wide = [dtype_of(gt, "decimal128(32,4)"), dtype_of(gt, "decimal128(38,6)")]
    decimal_ops.ensure_registered(wide)
    seen, eager = set(), set()
    for (name, params), f in reg._table.items():
        module = f.impl.__module__.rsplit(".", 1)[-1]
        per_row = name in ("castVARCHAR", "castVARBINARY") and \
            not params[0].is_varlen
        if name == "random" or per_row:
            assert f.emit is None and f.host is None, f.signature
            eager.add((name, str(params[0]) if params else None))
            continue
        assert f.emit is not None, f.signature
        seen.add(module)
        if any(p.is_varlen for p in params) and name not in (
                "isnull", "isnotnull", "next_day"):
            assert f.host is not None, f.signature
    assert seen == {"numeric", "cast", "datetime_ops", "hash_ops",
                    "decimal_ops", "string_ops"}
    assert {n for n, _ in eager} == {"random", "castVARCHAR",
                                     "castVARBINARY"}


# ---------------------------------------------------------------------------
# math: libm bit for bit, the reference within MATH_RTOL
# ---------------------------------------------------------------------------

def _libm(name: str, params, args) -> np.ndarray:
    """What the generated source computes for ``name``, element by element
    through the host's libm."""
    if name == "power" and params[0] == "float32":
        return np.array([LIBM.powf(a, b) for a, b in zip(*args)],
                        dtype=np.float32)
    # each argument as float64 with one rounding, as the eager route's
    # to_float converts it
    xs = [a.astype(np.float64) for a in args]
    if name == "cbrt":
        return np.array([(x if x == 0 or x != x else np.copysign(1.0, x))
                         * LIBM.pow(abs(x), 1.0 / 3.0) for x in xs[0]])
    if name == "log" and len(xs) == 2:
        return np.array([LIBM.log(b) / LIBM.log(a) for a, b in zip(*xs)])
    fn = getattr(LIBM, "pow" if name == "power" else name)
    return np.array([fn(*v) for v in zip(*xs)])


def _moderate(t: str, rng):
    """Values where the reference's math is accurate: floats normal(0, 50)
    at one decimal (test_math_close_to_reference's column), half of them
    in [-1, 1]; integers in [-200, 200] (unsigned [0, 200])."""
    if t in ("float32", "float64"):
        x = np.round(rng.normal(0, 50, N), 1)
        x[::2] = rng.uniform(-1, 1, N // 2)
    else:
        lo = 0 if t.startswith("u") else -200
        x = rng.integers(lo, 201, N)
    return (t, x.astype(np.dtype(t)), rng.random(N) >= 0.05, None)


def _close(ref, port, what):
    """Validity equal; values within MATH_RTOL, NaN equal to NaN, and a
    subnormal result equal to any other below the smallest normal number
    (XLA on the CPU flushes subnormals to zero)."""
    rv = np.asarray(ref.validity)
    np.testing.assert_array_equal(port.validity.numpy(), rv, what)
    want = np.asarray(ref.data)[rv]
    np.testing.assert_allclose(port.data.numpy()[rv], want, rtol=MATH_RTOL,
                               atol=np.finfo(want.dtype).tiny,
                               equal_nan=True, err_msg=what)


@pytest.mark.parametrize("name", MATH)
def test_math_matches_libm_and_reference(name):
    """Every signature of ``name``: compiled, over hazard columns (NaN,
    ±inf, ±0.0, values past every range, full-range integers), bit for
    bit with libm (NaN equal to NaN); over moderate columns within
    MATH_RTOL of the reference."""
    sigs = [s for s in emitter_signatures() if s[0] == name]
    types = sorted({t for _, params, _ in sigs for t in params})
    rng = np.random.default_rng(sum(map(ord, name)))
    moderate = {f"{side}_{t}": _moderate(t, rng) for t in types
                for side in "xy"}
    plan = hold_compiled(lambda p, s: project(p, s, sigs), moderate,
                         hold=_close)
    assert plan._program.count("eager") == 0
    hazard = columns(types, rng)
    out = plan.evaluate_device(gt.from_columns_numpy(hazard, N, device=CPU))
    for i, (_, params, _) in enumerate(sigs):
        cols = [hazard[f"{'xy'[j]}_{t}"] for j, t in enumerate(params)]
        valid = np.logical_and.reduce([c[2] for c in cols])
        got = out.column(f"o{i}")
        np.testing.assert_array_equal(got.validity.numpy(), valid)
        want = _libm(name, params, [c[1][valid] for c in cols])
        have = got.data.numpy()[valid]
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(have), nan, str(params))
        np.testing.assert_array_equal(have[~nan], want[~nan], str(params))


# ---------------------------------------------------------------------------
# round / truncate to d digits: IEEE, bit for bit
# ---------------------------------------------------------------------------

def _float_to_int(x: float, t: str) -> int:
    """registry/numeric.float_to_int: truncate, saturate, NaN → 0."""
    info = np.iinfo(np.dtype(t))
    if x != x:
        return 0
    x = np.trunc(x)
    if x >= float(info.max) + 1:
        return int(info.max)
    if x < float(info.min):
        return int(info.min)
    return int(x)


def _digits_oracle(kind, t, x, d, literal):
    """round / truncate(x, d) as numpy computes it in IEEE float64, 10^d by
    Python's float power for a literal and by libm's pow for a column."""
    if kind == "round" and t in INTS and literal and d >= 0:
        return x
    scale = 10.0 ** d if literal else LIBM.pow(10.0, float(d))
    with np.errstate(all="ignore"):     # 0 × inf and 0 / 0 give NaN
        y = np.float64(float(x)) * np.float64(scale)
        if kind == "round":
            r = y if y == 0 or y != y else np.copysign(np.floor(abs(y) + 0.5),
                                                       y)
        else:
            r = np.trunc(y)
        z = np.float64(r) / np.float64(scale)
    if t in INTS:
        return _float_to_int(float(z), t)
    return np.float32(z) if t == "float32" else z


@pytest.mark.parametrize("literal", [None, -2, 0, 3])
@pytest.mark.parametrize("kind", ["round", "truncate"])
def test_digits_are_ieee(kind, literal):
    """round / truncate(x, d) of every numeric type, d a column (hazard
    digits from -2 to 33 and full-range int32) or a literal: bit for bit
    with IEEE float64 arithmetic; the floats within an ulp of the
    reference."""
    types = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
             "uint64", "float32", "float64")
    rng = np.random.default_rng(7 + (literal or 0))
    cols = columns(list(types) + ["int32"], rng)

    def exprs(p, schema):
        B, dt = p.TreeExprBuilder, p.dtypes
        digits = (B.make_field(schema.field("y_int32")) if literal is None
                  else B.make_literal(literal, dt.int32))
        return [B.make_expression(B.make_function(
            kind, [B.make_field(schema.field(f"x_{t}")), digits],
            dtype_of(p, t)), dt.Field(f"o_{t}", dtype_of(p, t)))
            for t in types]

    plans = {}
    for p in (g, gt):
        schema = p.dtypes.Schema([p.dtypes.Field(n, dtype_of(p, c[0]))
                                  for n, c in cols.items()])
        kw = {"device": CPU} if p is gt else {}
        plans[p] = p.make_projector(schema, exprs(p, schema),
                                    use_cache=False, **kw)
    jit.host_build(plans[gt])
    assert plans[gt]._program.count("eager") == 0
    got = plans[gt].evaluate(pa.RecordBatch.from_pydict({
        n: pa.array(c[1], mask=~c[2]) for n, c in cols.items()}))
    ref = plans[g].evaluate(pa.RecordBatch.from_pydict({
        n: pa.array(c[1], mask=~c[2]) for n, c in cols.items()}))
    d = cols["y_int32"][1]
    for t, have, r in zip(types, got, ref):
        x, valid = cols[f"x_{t}"][1], cols[f"x_{t}"][2]
        if literal is None:
            valid = valid & cols["y_int32"][2]
        want = [_digits_oracle(kind, t, x[i], int(d[i]) if literal is None
                               else literal, literal is not None)
                if valid[i] else None for i in range(N)]
        have = have.to_pylist()
        for i in range(N):
            w, h = want[i], have[i]
            if w is None or h is None:
                assert w is None and h is None, (t, i)
            elif t in ("float32", "float64") and w != w:
                assert h != h, (t, i, x[i])
            else:
                assert np.array_equal(np.asarray(h, dtype=np.dtype(t)),
                                      np.asarray(w, dtype=np.dtype(t))), \
                    (t, i, x[i], w, h)
        if t in ("float32", "float64"):
            rv = np.array(r.to_pylist(), dtype=float)
            hv = np.array(have, dtype=float)
            fin = np.isfinite(rv)
            assert np.array_equal(np.isnan(hv), np.isnan(rv))
            assert (np.abs(hv[fin] - rv[fin]) <= np.spacing(np.abs(
                rv[fin]).astype(np.dtype(t))).astype(float) * 1.01
                + 1e-300).all()


# ---------------------------------------------------------------------------
# the dedicated cases, bit for bit against the reference
# ---------------------------------------------------------------------------

def _datetime_sigs():
    return [s for s in emitter_signatures() if _module(s) == "datetime_ops"]


def _dates(rng):
    """date32 days: the epoch's neighbours, 0000-03-01 (-719468) and the day
    before, 1600-01-01, 1899-12-31, 1900-02-28/03-01, leap days, 2400-12-31,
    int32 extremes, and random days of 1600..2400."""
    edge = [0, -1, 1, -719468, -719469, DAY_MIN, DAY_MAX, -25568, -25508,
            -25507, 11016, 11017, 11035, 11036, -2932897, 2932896,
            -(1 << 31), (1 << 31) - 1, -(1 << 31) + 1, 10957, 10956]
    return np.concatenate([edge, rng.integers(DAY_MIN, DAY_MAX, 400)])


def _millis(rng):
    """date64 / timestamp milliseconds: pre-epoch ones not on a day's
    boundary, a day's last millisecond, int64 extremes and their
    neighbours, and random instants of 1600..2400."""
    days = _dates(rng)[:-400].astype(np.int64)
    edge = np.concatenate([days * MS_PER_DAY, days * MS_PER_DAY - 1,
                           days * MS_PER_DAY + 1,
                           [I64_MIN, I64_MAX, I64_MIN + 1, I64_MAX - 1,
                            -1, 1, -MS_PER_DAY, -MS_PER_DAY - 1,
                            I64_MIN + MS_PER_DAY, I64_MAX - MS_PER_DAY]])
    rand = (rng.integers(DAY_MIN, DAY_MAX, 400) * MS_PER_DAY
            + rng.integers(0, MS_PER_DAY, 400))
    return np.concatenate([edge, rand])


def _hazard_temporal(types, rng):
    """Columns x_<type>, y_<type> of the date/time signatures' types with
    the edges of ``_dates`` and ``_millis`` and int extremes."""
    ints = {"int32": [0, 1, -1, 12, -12, 13, -13, 1200, -1200,
                      (1 << 31) - 1, -(1 << 31), 2400, -2400],
            "int64": [0, 1, -1, 12, -13, 1 << 40, -(1 << 40), I64_MAX,
                      I64_MIN, I64_MAX - 1, I64_MIN + 1, 86_400_000,
                      -86_400_001]}
    cols = {}
    for t in types:
        for side in "xy":
            if t == "date32":
                v = _dates(rng)
            elif t in ("date64", "timestamp"):
                v = _millis(rng)
            elif t in ints:
                v = np.concatenate([ints[t], rng.integers(-5000, 5000, 200)])
            elif t == "time32":
                v = [0, 1, MS_PER_DAY - 1, 3_599_999, 3_600_000, -1,
                     (1 << 31) - 1, -(1 << 31)]
            elif t == "interval_day":
                v = [(d << 32) | ms for d in (0, 1, -1, 29, -40000, 1 << 30,
                                              -(1 << 31))
                     for ms in (0, 1, MS_PER_DAY - 1)] + [I64_MIN, I64_MAX]
            elif t == "interval_year":
                v = [0, 1, -1, 11, -11, 12, -13, 1200, (1 << 31) - 1,
                     -(1 << 31)]
            else:
                raise AssertionError(t)
            cols[f"{side}_{t}"] = _col(t, rng.permutation(v), rng)
    return cols


def _hold_sigs(sigs, cols):
    """The signatures compiled, bit for bit against the reference, and
    every output bit for bit against the port's eager route.
    months_between is held bit for bit too: the reference's XLA fuses
    ``(t1 - t2) * (1 / 86,400,000) + (d1 - d2)`` into one FMA, and both of
    the port's routes compute that multiply-add rounded once."""
    plan = hold_compiled(lambda p, s: project(p, s, sigs), cols)
    assert plan._program.count("eager") == 0
    assert plan._program.kernels == 1
    batch = gt.from_columns_numpy(cols, len(next(iter(cols.values()))[1]),
                                  device=CPU)
    eager = gt.make_projector(plan.schema, plan.exprs, use_cache=False,
                              device=CPU).evaluate_device(batch)
    got = plan.evaluate_device(batch)
    for name in eager.columns:
        assert_same_column(eager.column(name), got.column(name), name)


def test_dates_pre_epoch_and_extremes():
    """Every date/time and interval signature over pre-epoch days and
    instants off a day's boundary, 0000-03-01, the int32 and int64
    extremes (the wrapping int64 arithmetic and the floor division of the
    eager route), bit for bit."""
    sigs = _datetime_sigs()
    types = sorted({t for _, params, _ in sigs for t in params})
    _hold_sigs(sigs, _hazard_temporal(types, np.random.default_rng(11)))


def test_iso_weeks_at_year_ends():
    """extractWeek (with the ISO year's 52 or 53 weeks), extractDoy,
    extractDow, date_trunc_Week and extractYear on every day from 20
    December to 10 January around the years 1600..2400 and -400..0."""
    import datetime as pydt

    days = []
    for y in list(range(1600, 2401, 7)) + list(range(1996, 2030)):
        first = (pydt.date(y, 12, 20) - pydt.date(1970, 1, 1)).days
        days += range(first, first + 22)
    base = (pydt.date(1600, 1, 1) - pydt.date(1970, 1, 1)).days
    days += [base - 146097 * k - j for k in (1, 2, 3) for j in range(-12, 12)]
    days = np.array(days)
    rng = np.random.default_rng(12)
    n = len(days)
    cols = {"x_date32": ("date32", days.astype(np.int32), np.ones(n, bool),
                         None),
            "x_date64": ("date64", days * MS_PER_DAY, np.ones(n, bool), None),
            "x_timestamp": ("timestamp", days * MS_PER_DAY
                            + rng.integers(0, MS_PER_DAY, n),
                            np.ones(n, bool), None)}
    names = ("extractWeek", "extractDoy", "extractDow", "date_trunc_Week",
             "extractYear")
    sigs = [s for s in _datetime_sigs() if s[0] in names]
    assert len(sigs) == 15
    _hold_sigs(sigs, cols)


def test_add_months_onto_month_ends():
    """add_months, timestampadd/diff by months, quarters and years,
    months_between, last_day and ± interval_year from the 28th-31st of
    every month of leap and common years (2000, 1900, 2004, 2100, 2023,
    1600, 1601) by ±1, ±11, ±12, ±13, ±24 and ±1200 months."""
    import datetime as pydt

    days = []
    for y in (2000, 1900, 2004, 2100, 2023, 1600, 1601):
        for m in range(1, 13):
            for d in (28, 29, 30, 31):
                try:
                    days.append((pydt.date(y, m, d)
                                 - pydt.date(1970, 1, 1)).days)
                except ValueError:
                    pass
    days = np.array(days)
    months = np.array([1, -1, 11, -11, 12, -12, 13, -13, 24, -24, 1200,
                       -1200])
    rng = np.random.default_rng(13)
    n = len(days) * len(months)
    dd = np.repeat(days, len(months))
    mm = np.tile(months, len(days))
    ms = dd * MS_PER_DAY + rng.integers(0, MS_PER_DAY, n)
    other = np.roll(ms, 7)
    ok = np.ones(n, bool)
    cols = {"x_date32": ("date32", dd.astype(np.int32), ok, None),
            "x_date64": ("date64", dd * MS_PER_DAY, ok, None),
            "y_date64": ("date64", np.roll(dd, 5) * MS_PER_DAY, ok, None),
            "x_timestamp": ("timestamp", ms, ok, None),
            "y_timestamp": ("timestamp", other, ok, None),
            "x_int32": ("int32", mm.astype(np.int32), ok, None),
            "y_int32": ("int32", mm.astype(np.int32), ok, None),
            "x_int64": ("int64", mm, ok, None),
            "y_int64": ("int64", mm, ok, None),
            "x_interval_year": ("interval_year", mm.astype(np.int32), ok,
                                None),
            "y_interval_year": ("interval_year", mm.astype(np.int32), ok,
                                None)}
    names = ("add_months", "timestampaddMonth", "timestampaddQuarter",
             "timestampaddYear", "timestampdiffMonth",
             "timestampdiffQuarter", "timestampdiffYear", "months_between",
             "last_day", "add", "subtract")
    sigs = [s for s in _datetime_sigs() if s[0] in names
            and (s[0] not in ("add", "subtract") or "interval_year" in s[1])
            and set(s[1]) <= {c[0] for c in cols.values()}]
    assert {s[0] for s in sigs} == set(names)
    _hold_sigs(sigs, cols)


def test_round_ties():
    """Ties at ±x.5 (and the double just below 0.5) through round,
    castBIGINT / castINT of floats, castDECIMAL of floats to scales 0 and
    1, and the decimal round family at a tie of the dropped digits."""
    from test_torch_codegen import DEC_TYPES

    rng = np.random.default_rng(14)
    halves = [k + 0.5 for k in range(-6, 6)] + [
        0.49999999999999994, -0.49999999999999994, 2.0 ** 52 + 0.5,
        -(2.0 ** 52) - 1.5, 0.05, 0.15, 0.25, -0.35, 1.45, 2.675]
    tens = [125, -125, 150, -150, 5, -5, 15, -15, 25, 35, 45, 49, 51, -55]
    cols = {"x_float64": _col("float64", halves, rng),
            "x_float32": _col("float32", halves, rng)}
    for t in DEC_TYPES:
        scale = int(t[:-1].split(",")[1])
        vals = [v * 10 ** (scale - 1) for v in tens] if scale else tens
        _, data, valid, _ = _col("int64", vals, rng)
        cols[f"x_{t}"] = (t, data, valid, np.where(data < 0, -1, 0))

    def exprs(p, schema):
        B, dt = p.TreeExprBuilder, p.dtypes
        out = []
        for t in ("float64", "float32"):
            x = B.make_field(schema.field(f"x_{t}"))
            out += [B.make_function("round", [x], dtype_of(p, t)),
                    B.make_function("castBIGINT", [x], dt.int64),
                    B.make_function("castINT", [x], dt.int32)]
            out += [B.make_function(name, [x], dt.decimal128(18, s))
                    for s in (0, 1)
                    for name in ("castDECIMAL", "castDECIMALNullOnOverflow")]
        for t in DEC_TYPES:
            x = B.make_field(schema.field(f"x_{t}"))
            dec = dtype_of(p, t)
            to0 = dt.decimal128(dec.precision, 0)
            out += [B.make_function(k, [x], to0)
                    for k in ("round", "truncate", "ceiling", "floor")]
            out += [B.make_function(k, [x, B.make_literal(1, dt.int32)], dec)
                    for k in ("round", "truncate")]
            out += [B.make_function("castBIGINT", [x], dt.int64),
                    B.make_function("castDECIMAL", [x],
                                    dt.decimal128(dec.precision, 1))]
        return [B.make_expression(r, dt.Field(f"o{i}", r.dtype))
                for i, r in enumerate(out)]

    plan = hold_compiled(exprs, cols)
    assert plan._program.count("eager") == 0


def test_hashes_of_signed_zeros_and_nans():
    """hash32 / hash64 (with and without a seed) and their AsDouble forms
    of float32 and float64 ±0.0 (one hash: -0.0 is taken as +0.0), NaNs
    with their sign and payload bits (each hashed by its bits), ±inf."""
    rng = np.random.default_rng(15)
    f64 = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0,
                    np.uint64(0x7FF0000000000001).view(np.float64),
                    np.uint64(0xFFF8000000000123).view(np.float64)])
    f32 = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0,
                    np.uint32(0x7F800001).view(np.float32),
                    np.uint32(0xFFC00123).view(np.float32)], dtype=np.float32)
    cols = {"x_float64": _col("float64", f64, rng),
            "x_float32": _col("float32", f32, rng),
            "y_int32": _col("int32", [0, -1, 1, -(1 << 31), 12345], rng),
            "y_int64": _col("int64", [0, -1, 1, I64_MIN, 12345], rng)}
    sigs = [s for s in emitter_signatures() if _module(s) == "hash_ops"
            and s[1][0] in ("float32", "float64")]
    assert len(sigs) == 12
    plan = hold_compiled(lambda p, s: project(p, s, sigs), cols)
    out = plan.evaluate_device(gt.from_columns_numpy(cols, N, device=CPU))
    for i, (name, params, _) in enumerate(sigs):
        if len(params) == 1:      # ±0.0 (rows 0 and 1) hash alike
            v = out.column(f"o{i}").data
            assert v[0] == v[1], name


def test_empty_selection():
    """A compiled Projector over a selection of no rows: empty outputs
    from a date, a hash, a math and a rounding function, as the
    reference's."""
    rng = np.random.default_rng(16)
    cols = {"d": ("date32", rng.integers(DAY_MIN, DAY_MAX, 64)
                  .astype(np.int32), np.ones(64, bool), None),
            "f": ("float64", rng.normal(size=64), np.ones(64, bool), None)}
    arrow = pa.RecordBatch.from_pydict({
        "d": pa.array(cols["d"][1], type=pa.date32()),
        "f": pa.array(cols["f"][1])})
    got = {}
    for p in (g, gt):
        B, dt = p.TreeExprBuilder, p.dtypes
        schema = dt.Schema([dt.Field("d", dt.date32),
                            dt.Field("f", dt.float64)])
        d, f = (B.make_field(schema.field(n)) for n in ("d", "f"))
        roots = [B.make_function("extractYear", [d], dt.int64),
                 B.make_function("hash64", [f], dt.int64),
                 B.make_function("exp", [f], dt.float64),
                 B.make_function("round", [f], dt.float64)]
        kw = {"device": CPU} if p is gt else {}
        proj = p.make_projector(schema, [
            B.make_expression(r, dt.Field(f"o{i}", r.dtype))
            for i, r in enumerate(roots)], p.SelectionMode.UINT32,
            use_cache=False, **kw)
        filt = p.make_filter(schema, B.make_condition(B.make_function(
            "less_than", [f, B.make_double_literal(-1e9)], dt.bool_)),
            use_cache=False, **kw)
        if p is gt:
            jit.host_build(proj)
            assert proj._program.count("eager") == 0
        sel = filt.evaluate(arrow)
        assert int(sel.count) == 0
        got[p] = proj.evaluate(arrow, selection=sel)
    for r, q in zip(got[g], got[gt]):
        assert len(q) == 0 and q.equals(r)
