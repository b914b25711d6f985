"""Date/time kernels.

The torch counterpart of gandiva_tpu.registry.datetime_ops (Gandiva's
precompiled/time.cc and timestamp_arithmetic.cc, SURVEY.md §2b
"Date/time"): extract*, date_trunc_*, date/timestamp casts,
timestampadd/timestampdiff, add_months, months_between, datediff,
last_day, unix_timestamp/from_unixtime, next_day, the interval_day /
interval_year casts and arithmetic, and the string-typed functions:
to_date, is_date and castDATE/castTIMESTAMP from utf8 parse each distinct
dictionary value on the host (the ToDateHolder analogue) and gather the
parsed values and parse flags by code on the device.

Representation (dtypes.py): date32 = days since epoch (int32), date64 and
timestamp = milliseconds since epoch (int64), time32 = millis since midnight,
interval_day = (days << 32) | millis in an int64, interval_year = months
(int32). Civil-calendar math uses the days↔(y,m,d) bijection from Howard
Hinnant's public-domain algorithms, as pure integer torch ops: torch's
``//`` and ``%`` floor on integer tensors, as the algorithms need for
pre-epoch dates. Torch keeps an int32 tensor int32 when it is multiplied by
a Python int, so every date32 value widens to int64 before a multiply.

Every fixed-width entry also has an emitter for the plan compiler
(compiler/codegen.py): the same steps in C++ on csrc/plan_prelude.h's
calendar helpers, whose floor division and wrapping int64 arithmetic give
torch's bits (C's ``/`` and ``%`` truncate, and its signed overflow is
undefined).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from .registry import (ExpressionValidationError, Nullability, Val,
                       global_registry)

_R = global_registry()

MS_PER_DAY = 86_400_000
MS_PER_HOUR = 3_600_000
MS_PER_MINUTE = 60_000
MS_PER_SECOND = 1_000

DATE_TYPES = [dt.date32, dt.date64, dt.timestamp]


def _i64(x):
    return x.to(torch.int64)


def _split(a):
    """Veltkamp's split of a float64: hi + lo == a, each of 26 bits."""
    c = a * 134217729.0                    # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    """s + e == a + b exactly, s = a + b rounded."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma_f64(a, b, c):
    """a * b + c rounded once, as a fused multiply-add rounds it, in
    float64 torch operations that each round by themselves: the exact
    product as two floats (Dekker), its exact sum with c (Knuth), and
    the low words summed rounded to odd, so that the last addition
    rounds the exact value once (Boldo and Melquiond, "Emulation of FMA
    and correctly rounded sums: proved algorithms using rounding to
    odd", 2008). Exact for finite values whose product neither
    overflows nor underflows."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, e = _two_sum(tl, pe)
    # round to odd: an inexact sum whose last bit is even moves one ulp
    # toward the part it dropped
    inexact_even = (e != 0) & ((v.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where(inexact_even, torch.nextafter(v, toward), v)
    return th + v


# -- emitters: C++ text of one row (compiler/codegen.py's protocol) ---------

def _c_i64(a) -> str:
    """An argument's value as int64 (a date32 or int32 widened)."""
    return f"((int64_t){a.v})"


def _c_days(a) -> str:
    """``_to_days``: days since epoch, floored."""
    if a.dtype.kind is dt.TypeKind.DATE32:
        return _c_i64(a)
    return f"gt_floordiv_i64({a.v}, GT_MS_PER_DAY)"


def _c_millis(a) -> str:
    """``_to_millis``."""
    if a.dtype.kind is dt.TypeKind.DATE32:
        return f"gt_mul<int64_t>({_c_i64(a)}, GT_MS_PER_DAY)"
    return _c_i64(a)


def _emit(f):
    """An emitter from ``f(*args)`` → the C expression of the value."""
    return lambda g, args, rt: f(*args)


def _emit_days(f):
    """An emitter for a function of days (``f`` of the C days expression)
    whose result is days for a date32 and milliseconds otherwise, as
    ``last_day`` and ``date_trunc_*`` return them."""
    def emit(g, args, rt):
        days = f(_c_days(args[0]))
        if args[0].dtype.kind is dt.TypeKind.DATE32:
            return f"(int32_t)({days})"
        return f"gt_mul<int64_t>({days}, GT_MS_PER_DAY)"
    return emit


def _fd(x: str, d: int) -> str:
    return f"gt_floordiv_i64({x}, (int64_t){d})"


def _fm(x: str, d: int) -> str:
    return f"gt_floormod_i64({x}, (int64_t){d})"


# ---------------------------------------------------------------------------
# civil calendar core
# ---------------------------------------------------------------------------

def civil_from_days(days):
    """days since 1970-01-01 → (year, month, day), int64 tensors."""
    z = _i64(days) + 719468
    era = z // 146097
    doe = z - era * 146097                       # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)   # [0, 365]
    mp = (5 * doy + 2) // 153                    # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1            # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)     # [1, 12]
    year = y + (m <= 2).to(torch.int64)
    return year, m, d


def days_from_civil(y, m, d):
    """(year, month, day) → days since 1970-01-01 (int64)."""
    y = _i64(y) - (m <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def is_leap(y):
    return (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))


def days_in_month(y, m):
    """Days of month ``m`` (1..12) of year ``y``: the non-leap lengths as
    two bits a month of one constant, plus February's leap day."""
    d = 28 + ((0x3BBEECC >> (2 * m)) & 3)
    return torch.where((m == 2) & is_leap(y), 29, d)


def _to_days(val):
    """Any date/timestamp column → days since epoch (floored)."""
    if val.dtype.kind is dt.TypeKind.DATE32:
        return _i64(val.value)
    return val.value // MS_PER_DAY


def _to_millis(val):
    if val.dtype.kind is dt.TypeKind.DATE32:
        return _i64(val.value) * MS_PER_DAY
    return val.value


# ---------------------------------------------------------------------------
# extract* (return int64, matching gandiva's extract signatures)
# ---------------------------------------------------------------------------

def _extract_year(v):
    return civil_from_days(v)[0]


def _extract_month(v):
    return civil_from_days(v)[1]


def _extract_day(v):
    return civil_from_days(v)[2]


def _extract_quarter(v):
    return (civil_from_days(v)[1] - 1) // 3 + 1


def _extract_doy(v):
    y = civil_from_days(v)[0]
    one = torch.ones_like(y)
    return _i64(v) - days_from_civil(y, one, one) + 1


def _extract_dow(v):
    # SQL/Gandiva convention: 1 = Sunday .. 7 = Saturday.
    # 1970-01-01 (days=0) was a Thursday.
    return (_i64(v) + 4) % 7 + 1


def _iso_dow(v):
    # ISO: 1 = Monday .. 7 = Sunday
    return (_i64(v) + 3) % 7 + 1


def _weeks_in_iso_year(y):
    p = (y + y // 4 - y // 100 + y // 400) % 7
    py = y - 1
    p_prev = (py + py // 4 - py // 100 + py // 400) % 7
    return 52 + ((p == 4) | (p_prev == 3)).to(torch.int64)


def _extract_week(v):
    """ISO-8601 week number."""
    days = _i64(v)
    y = civil_from_days(days)[0]
    doy = _extract_doy(days)
    dow = _iso_dow(days)
    w0 = (doy - dow + 10) // 7
    return torch.where(w0 < 1, _weeks_in_iso_year(y - 1),
                       torch.where(w0 > _weeks_in_iso_year(y), 1, w0))


# each with its C counterpart over the days expression
_DAY_EXTRACTORS = {
    "extractYear": (_extract_year, lambda d: f"gt_civil({d}, 0)"),
    "extractMonth": (_extract_month, lambda d: f"gt_civil({d}, 1)"),
    "extractDay": (_extract_day, lambda d: f"gt_civil({d}, 2)"),
    "extractQuarter": (_extract_quarter,
                       lambda d: f"{_fd(f'gt_civil({d}, 1) - 1', 3)} + 1"),
    "extractDoy": (_extract_doy, lambda d: f"gt_doy({d})"),
    "extractDow": (_extract_dow, lambda d: f"gt_dow({d})"),
    "extractWeek": (_extract_week, lambda d: f"gt_iso_week({d})"),
}

for _name, (_f, _cf) in _DAY_EXTRACTORS.items():
    def _impl(ctx, args, _f=_f):
        return _i64(_f(_to_days(args[0])))
    for _t in DATE_TYPES:
        _R.register(_name, [_t], dt.int64, _impl,
                    emit=_emit(lambda a, _cf=_cf: _cf(_c_days(a))))


def _register_time_extract(name, f, cf):
    def impl(ctx, args):
        return _i64(f(_to_millis(args[0])))
    for t in [dt.date64, dt.timestamp]:
        _R.register(name, [t], dt.int64, impl,
                    emit=_emit(lambda a: cf(_c_millis(a))))


def _c_year(ms: str) -> str:
    return f"gt_civil({_fd(ms, MS_PER_DAY)}, 0)"


_register_time_extract("extractHour", lambda ms: (ms // MS_PER_HOUR) % 24,
                       lambda ms: _fm(_fd(ms, MS_PER_HOUR), 24))
_register_time_extract("extractMinute", lambda ms: (ms // MS_PER_MINUTE) % 60,
                       lambda ms: _fm(_fd(ms, MS_PER_MINUTE), 60))
_register_time_extract("extractSecond", lambda ms: (ms // MS_PER_SECOND) % 60,
                       lambda ms: _fm(_fd(ms, MS_PER_SECOND), 60))
_register_time_extract("extractMillennium",
                       lambda ms: (_extract_year(ms // MS_PER_DAY) + 999) // 1000,
                       lambda ms: _fd(f"{_c_year(ms)} + 999", 1000))
_register_time_extract("extractCentury",
                       lambda ms: (_extract_year(ms // MS_PER_DAY) + 99) // 100,
                       lambda ms: _fd(f"{_c_year(ms)} + 99", 100))
_register_time_extract("extractDecade",
                       lambda ms: _extract_year(ms // MS_PER_DAY) // 10,
                       lambda ms: _fd(_c_year(ms), 10))
_register_time_extract("extractEpoch", lambda ms: ms // MS_PER_SECOND,
                       lambda ms: _fd(ms, MS_PER_SECOND))

# time32 (millis since midnight) hour/minute/second
for _name, _f, _cf in [
        ("extractHour", lambda v: v // MS_PER_HOUR,
         lambda v: _fd(v, MS_PER_HOUR)),
        ("extractMinute", lambda v: (v // MS_PER_MINUTE) % 60,
         lambda v: _fm(_fd(v, MS_PER_MINUTE), 60)),
        ("extractSecond", lambda v: (v // MS_PER_SECOND) % 60,
         lambda v: _fm(_fd(v, MS_PER_SECOND), 60))]:
    def _impl(ctx, args, _f=_f):
        return _f(_i64(args[0].value))
    _R.register(_name, [dt.time32], dt.int64, _impl,
                emit=_emit(lambda a, _cf=_cf: _cf(_c_i64(a))))


# ---------------------------------------------------------------------------
# date_trunc_*
# ---------------------------------------------------------------------------

def _trunc_to_days_fn(unit):
    def f(days):
        y, m, d = civil_from_days(days)
        one = torch.ones_like(y)
        if unit == "Year":
            return days_from_civil(y, one, one)
        if unit == "Quarter":
            qm = ((m - 1) // 3) * 3 + 1
            return days_from_civil(y, qm, one)
        if unit == "Month":
            return days_from_civil(y, m, one)
        if unit == "Week":
            # truncate to Monday
            return days - (_iso_dow(days) - 1)
        if unit == "Decade":
            return days_from_civil((y // 10) * 10, one, one)
        if unit == "Century":
            return days_from_civil(((y + 99) // 100) * 100 - 99, one, one)
        if unit == "Millennium":
            return days_from_civil(((y + 999) // 1000) * 1000 - 999, one, one)
        raise AssertionError(unit)
    return f


for _k, _unit in enumerate(["Year", "Quarter", "Month", "Week", "Decade",
                             "Century", "Millennium"]):
    _dayf = _trunc_to_days_fn(_unit)

    def _impl_ms(ctx, args, _dayf=_dayf):
        ms = _to_millis(args[0])
        return _dayf(ms // MS_PER_DAY) * MS_PER_DAY

    def _impl_d32(ctx, args, _dayf=_dayf):
        return _dayf(_i64(args[0].value)).to(torch.int32)

    # gt_trunc_days numbers the units in this order
    _em = _emit_days(lambda d, _k=_k: f"gt_trunc_days({d}, {_k})")
    for _t in [dt.date64, dt.timestamp]:
        _R.register(f"date_trunc_{_unit}", [_t], _t, _impl_ms, emit=_em)
    _R.register(f"date_trunc_{_unit}", [dt.date32], dt.date32, _impl_d32,
                emit=_em)

for _unit, _msq in [("Day", MS_PER_DAY), ("Hour", MS_PER_HOUR),
                    ("Minute", MS_PER_MINUTE), ("Second", MS_PER_SECOND)]:
    def _impl(ctx, args, _msq=_msq):
        ms = _to_millis(args[0])
        return (ms // _msq) * _msq
    for _t in [dt.date64, dt.timestamp]:
        _R.register(f"date_trunc_{_unit}", [_t], _t, _impl, emit=_emit(
            lambda a, _msq=_msq: f"gt_mul<int64_t>({_fd(_c_millis(a), _msq)}"
            f", (int64_t){_msq})"))


# ---------------------------------------------------------------------------
# casts between temporal types
# ---------------------------------------------------------------------------

def _trunc_to_day_ms(ctx, args):
    """castDATE(timestamp / date64) → date64 truncated to day (gandiva
    semantics)."""
    return (args[0].value // MS_PER_DAY) * MS_PER_DAY


def _identity(ctx, args):
    return args[0].value


def _date32_to_ms(ctx, args):
    return _i64(args[0].value) * MS_PER_DAY


_emit_trunc_day = _emit(
    lambda a: f"gt_mul<int64_t>({_c_days(a)}, GT_MS_PER_DAY)")
_emit_identity = _emit(lambda a: a.v)
_emit_ms = _emit(_c_millis)

_R.register("castDATE", [dt.timestamp], dt.date64, _trunc_to_day_ms,
            emit=_emit_trunc_day)
_R.register("castDATE", [dt.date64], dt.date64, _trunc_to_day_ms,
            emit=_emit_trunc_day)
_R.register("castDATE", [dt.int64], dt.date64, _identity,
            emit=_emit_identity)
_R.register("castDATE", [dt.date32], dt.date64, _date32_to_ms, emit=_emit_ms)

_R.register("castTIMESTAMP", [dt.date64], dt.timestamp, _identity,
            emit=_emit_identity)
_R.register("castTIMESTAMP", [dt.date32], dt.timestamp, _date32_to_ms,
            emit=_emit_ms)
_R.register("castTIMESTAMP", [dt.int64], dt.timestamp, _identity,
            emit=_emit_identity)

_R.register("castDATE32", [dt.date64], dt.date32,
            lambda ctx, args: (args[0].value // MS_PER_DAY).to(torch.int32),
            emit=_emit(lambda a: f"(int32_t){_c_days(a)}"))
_R.register("castBIGINT", [dt.timestamp], dt.int64, _identity,
            emit=_emit_identity)
_R.register("castBIGINT", [dt.date64], dt.int64, _identity,
            emit=_emit_identity)


# ---------------------------------------------------------------------------
# arithmetic: date_add / date_sub / datediff / add_months / months_between
# ---------------------------------------------------------------------------

def _date_add_days(ctx, args):
    a, b = args
    if a.dtype.is_temporal:
        datev, intv = a, b
    else:
        datev, intv = b, a
    days = _i64(intv.value)
    if datev.dtype.kind is dt.TypeKind.DATE32:
        return (_i64(datev.value) + days).to(torch.int32)
    return datev.value + days * MS_PER_DAY


def _date_sub_days(ctx, args):
    a, b = args
    days = _i64(b.value)
    if a.dtype.kind is dt.TypeKind.DATE32:
        return (_i64(a.value) - days).to(torch.int32)
    return a.value - days * MS_PER_DAY


def _emit_date_shift(sub: bool):
    """``_date_add_days`` / ``_date_sub_days``."""
    def emit(g, args, rt):
        a, b = args
        datev, intv = (b, a) if not a.dtype.is_temporal else (a, b)
        op = "gt_sub<int64_t>" if sub else "gt_add<int64_t>"
        if datev.dtype.kind is dt.TypeKind.DATE32:
            return f"(int32_t){op}({_c_i64(datev)}, {_c_i64(intv)})"
        return (f"{op}({datev.v}, gt_mul<int64_t>({_c_i64(intv)}, "
                "GT_MS_PER_DAY))")
    return emit


for _dt_ in DATE_TYPES:
    for _it in [dt.int32, dt.int64]:
        _R.register("date_add", [_dt_, _it], _dt_, _date_add_days,
                    aliases=["add"], emit=_emit_date_shift(False))
        _R.register("date_add", [_it, _dt_], _dt_, _date_add_days,
                    emit=_emit_date_shift(False))
        _R.register("date_sub", [_dt_, _it], _dt_, _date_sub_days,
                    aliases=["subtract", "date_diff"],
                    emit=_emit_date_shift(True))


def _datediff(ctx, args):
    return ((args[0].value // MS_PER_DAY)
            - (args[1].value // MS_PER_DAY)).to(torch.int32)


for _dt_ in [dt.date64, dt.timestamp]:
    _R.register("datediff", [_dt_, _dt_], dt.int32, _datediff,
                emit=_emit(lambda a, b: f"(int32_t)gt_sub<int64_t>("
                           f"{_c_days(a)}, {_c_days(b)})"))


def _add_months_days(days, months):
    y, m, d = civil_from_days(days)
    tot = (y * 12 + (m - 1)) + months
    ny, nm = tot // 12, tot % 12 + 1
    nd = torch.minimum(d, days_in_month(ny, nm))
    return days_from_civil(ny, nm, nd)


def _ts_plus_months(ts_ms, months):
    day_part = ts_ms // MS_PER_DAY
    time_part = ts_ms - day_part * MS_PER_DAY
    return _add_months_days(day_part, months) * MS_PER_DAY + time_part


def _add_months(ctx, args):
    datev, mv = args
    months = _i64(mv.value)
    if datev.dtype.kind is dt.TypeKind.DATE32:
        return _add_months_days(_i64(datev.value), months).to(torch.int32)
    return _ts_plus_months(datev.value, months)


def _emit_add_months(g, args, rt):
    datev, mv = args
    if datev.dtype.kind is dt.TypeKind.DATE32:
        return (f"(int32_t)gt_add_months_days({_c_i64(datev)}, "
                f"{_c_i64(mv)})")
    return f"gt_ts_plus_months({datev.v}, {_c_i64(mv)})"


for _dt_ in DATE_TYPES:
    for _it in [dt.int32, dt.int64]:
        _R.register("add_months", [_dt_, _it], _dt_, _add_months,
                    emit=_emit_add_months)


def _months_between(ctx, args):
    ms1, ms2 = _to_millis(args[0]), _to_millis(args[1])
    d1, d2 = ms1 // MS_PER_DAY, ms2 // MS_PER_DAY
    y1, m1, dd1 = civil_from_days(d1)
    y2, m2, dd2 = civil_from_days(d2)
    months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
    last1 = dd1 == days_in_month(y1, m1)
    last2 = dd2 == days_in_month(y2, m2)
    t1 = ms1 - d1 * MS_PER_DAY
    t2 = ms2 - d2 * MS_PER_DAY
    # the reference's compiler divides by a constant as a multiply by its
    # reciprocal, and fuses (t1 - t2) * (1 / MS_PER_DAY) + (dd1 - dd2) into
    # one multiply-add; so does this, for the same bits
    x = (t1 - t2).to(torch.float64)
    frac = fma_f64(x, torch.full_like(x, 1.0 / MS_PER_DAY),
                   (dd1 - dd2).to(torch.float64)) * (1.0 / 31.0)
    return torch.where(last1 & last2, months, months + frac)


def _emit_months_between(g, args, rt):
    from ..compiler.codegen import c_literal

    r1, r31 = (c_literal(1.0 / d, dt.float64) for d in (MS_PER_DAY, 31.0))
    a, b = args
    return f"gt_months_between({_c_millis(a)}, {_c_millis(b)}, {r1}, {r31})"


for _dt_ in [dt.date64, dt.timestamp]:
    _R.register("months_between", [_dt_, _dt_], dt.float64, _months_between,
                emit=_emit_months_between)


def _last_day(ctx, args):
    days = _to_days(args[0])
    y, m, _ = civil_from_days(days)
    out_days = days_from_civil(y, m, days_in_month(y, m))
    if args[0].dtype.kind is dt.TypeKind.DATE32:
        return out_days.to(torch.int32)
    return out_days * MS_PER_DAY


for _dt_ in DATE_TYPES:
    _R.register("last_day", [_dt_], _dt_, _last_day,
                emit=_emit_days(lambda d: f"gt_last_day_days({d})"))


# ---------------------------------------------------------------------------
# timestampadd* / timestampdiff*
# ---------------------------------------------------------------------------

_FIXED_UNITS_MS = {
    "Second": MS_PER_SECOND, "Minute": MS_PER_MINUTE, "Hour": MS_PER_HOUR,
    "Day": MS_PER_DAY, "Week": 7 * MS_PER_DAY,
}

for _unit, _ms_ in _FIXED_UNITS_MS.items():
    def _addimpl(ctx, args, _ms_=_ms_):
        n, ts = args
        return ts.value + _i64(n.value) * _ms_

    def _diffimpl(ctx, args, _ms_=_ms_):
        # gandiva: timestampdiffX(t1, t2) = (t2 - t1) / unit, truncated
        t1, t2 = args
        diff = t2.value - t1.value
        return torch.sign(diff) * (torch.abs(diff) // _ms_)

    for _it in [dt.int32, dt.int64]:
        _R.register(f"timestampadd{_unit}", [_it, dt.timestamp], dt.timestamp,
                    _addimpl, emit=_emit(
                        lambda n, ts, _ms_=_ms_: f"gt_add<int64_t>({ts.v}, "
                        f"gt_mul<int64_t>({_c_i64(n)}, (int64_t){_ms_}))"))
    _R.register(f"timestampdiff{_unit}", [dt.timestamp, dt.timestamp],
                dt.int64, _diffimpl, emit=_emit(
                    lambda a, b, _ms_=_ms_: f"gt_timestampdiff_fixed({a.v}, "
                    f"{b.v}, (int64_t){_ms_})"))

for _unit, _mcount in [("Month", 1), ("Quarter", 3), ("Year", 12)]:
    def _addimpl(ctx, args, _mcount=_mcount):
        n, ts = args
        return _ts_plus_months(ts.value, _i64(n.value) * _mcount)

    def _diffimpl(ctx, args, _mcount=_mcount):
        t1, t2 = args
        d1, d2 = t1.value // MS_PER_DAY, t2.value // MS_PER_DAY
        y1, m1, dd1 = civil_from_days(d1)
        y2, m2, dd2 = civil_from_days(d2)
        months = (y2 - y1) * 12 + (m2 - m1)
        # truncate toward zero on partial months
        partial1 = dd1 * MS_PER_DAY + (t1.value - d1 * MS_PER_DAY)
        partial2 = dd2 * MS_PER_DAY + (t2.value - d2 * MS_PER_DAY)
        adj = torch.where((months > 0) & (partial2 < partial1), -1,
                          torch.where((months < 0) & (partial2 > partial1),
                                      1, 0))
        return (months + adj) // _mcount

    for _it in [dt.int32, dt.int64]:
        _R.register(f"timestampadd{_unit}", [_it, dt.timestamp], dt.timestamp,
                    _addimpl, emit=_emit(
                        lambda n, ts, _mcount=_mcount: "gt_ts_plus_months("
                        f"{ts.v}, gt_mul<int64_t>({_c_i64(n)}, "
                        f"(int64_t){_mcount}))"))
    _R.register(f"timestampdiff{_unit}", [dt.timestamp, dt.timestamp],
                dt.int64, _diffimpl, emit=_emit(
                    lambda a, b, _mcount=_mcount: "gt_timestampdiff_months("
                    f"{a.v}, {b.v}, (int64_t){_mcount})"))


# ---------------------------------------------------------------------------
# unix epoch conversions
# ---------------------------------------------------------------------------

_R.register("unix_timestamp", [dt.timestamp], dt.int64,
            lambda ctx, args: args[0].value // MS_PER_SECOND,
            emit=_emit(lambda a: _fd(a.v, MS_PER_SECOND)))
for _it in (dt.int64, dt.int32):
    _R.register("from_unixtime", [_it], dt.timestamp,
                lambda ctx, args: _i64(args[0].value) * MS_PER_SECOND,
                emit=_emit(lambda a: f"gt_mul<int64_t>({_c_i64(a)}, "
                           f"(int64_t){MS_PER_SECOND})"))


def _weekday(dowv) -> int:
    """next_day's weekday literal ('SU', 'MO', … or full names) as
    extractDow numbers it (1 = Sunday)."""
    if not dowv.is_literal:
        raise ExpressionValidationError("next_day requires a literal weekday")
    name = str(dowv.literal).upper()[:2]
    targets = {"SU": 1, "MO": 2, "TU": 3, "WE": 4, "TH": 5, "FR": 6, "SA": 7}
    if name not in targets:
        raise ExpressionValidationError(f"invalid weekday {dowv.literal!r}")
    return targets[name]


def _next_day_impl(ctx, args):
    """next_day(date, dow_literal): first date after ``date`` that falls on
    the given weekday."""
    datev, dowv = args
    target = _weekday(dowv)
    days = _to_days(datev)
    delta = (target - _extract_dow(days)) % 7
    out = days + torch.where(delta == 0, 7, delta)
    if datev.dtype.kind is dt.TypeKind.DATE32:
        return out.to(torch.int32)
    return out * MS_PER_DAY


def _emit_next_day(g, args, rt):
    datev, dowv = args
    days = g.tmp("int64_t", _c_days(datev))
    delta = g.tmp("int64_t", _fm(f"{_weekday(dowv)} - gt_dow({days})", 7))
    out = f"gt_add<int64_t>({days}, {delta} == 0 ? 7 : {delta})"
    if datev.dtype.kind is dt.TypeKind.DATE32:
        return f"(int32_t)({out})"
    return f"gt_mul<int64_t>({out}, GT_MS_PER_DAY)"


for _dt_ in DATE_TYPES:
    _R.register("next_day", [_dt_, dt.string], _dt_, _next_day_impl,
                emit=_emit_next_day)


# ---------------------------------------------------------------------------
# string → date/timestamp parsing (the ToDateHolder analogue,
# to_date_holder.cc: pattern compiled once at Make, applied per row — here
# applied per *distinct* dictionary value on the host)
# ---------------------------------------------------------------------------

_SQL_TO_STRPTIME = [
    ("YYYY", "%Y"), ("YYY", "%Y"), ("YY", "%y"),
    ("MONTH", "%B"), ("MON", "%b"), ("MM", "%m"),
    ("DDD", "%j"), ("DD", "%d"),
    ("HH24", "%H"), ("HH12", "%I"), ("HH", "%H"),
    ("MI", "%M"), ("SS", "%S"),
]


def sql_format_to_strptime(fmt: str) -> str:
    """SQL date format (YYYY-MM-DD …) → strptime format."""
    out = []
    i = 0
    up = fmt.upper()
    while i < len(fmt):
        for token, repl in _SQL_TO_STRPTIME:
            if up.startswith(token, i):
                out.append(repl)
                i += len(token)
                break
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _parse_tables(ctx, sval, fmt: str):
    """The parse's host side: epoch milliseconds and a parse-ok flag per
    distinct value, [ms table, ok table]."""
    import datetime as _dt

    from ..compiler.decomposer import at_least_one

    strp = sql_format_to_strptime(fmt)
    dthunk = sval.dict_thunk

    def values_thunk(batch, _dt_=dthunk, _f=strp):
        d = _dt_(batch).to_pylist()
        out = np.zeros(len(d), dtype=np.int64)
        for i, v in enumerate(d):
            if v is None:
                continue
            try:
                t = _dt.datetime.strptime(v.strip(), _f)
                out[i] = int((t - _dt.datetime(1970, 1, 1)).total_seconds()
                             * 1000)
            except ValueError:
                out[i] = 0
        return at_least_one(out, 0)

    def ok_thunk(batch, _dt_=dthunk, _f=strp):
        d = _dt_(batch).to_pylist()
        out = np.zeros(len(d), dtype=bool)
        for i, v in enumerate(d):
            if v is None:
                continue
            try:
                _dt.datetime.strptime(v.strip(), _f)
                out[i] = True
            except ValueError:
                pass
        return at_least_one(out, False)

    return [ctx.add_table(values_thunk, cache_on_dicts=True),
            ctx.add_table(ok_thunk, cache_on_dicts=True)]


def _parse_table(ctx, sval, fmt: str):
    """The parse's tables gathered by code: (ms, ok) device tensors."""
    from ..compiler.decomposer import gather_by_code

    return tuple(gather_by_code(t, sval.value)
                 for t in _parse_tables(ctx, sval, fmt))


def _require_string_column(s: Val, fname: str) -> None:
    if s.dict_thunk is None:
        raise ExpressionValidationError(f"{fname} requires a string column")


def _to_date_format(args) -> str:
    _require_string_column(args[0], "to_date")
    if not args[1].is_literal:
        raise ExpressionValidationError("to_date format must be a literal")
    return str(args[1].literal)


def _date_format(args) -> str:
    _require_string_column(args[0], "castDATE")
    return "YYYY-MM-DD"


def _ts_formats(args):
    _require_string_column(args[0], "castTIMESTAMP")
    return ("YYYY-MM-DD HH24:MI:SS", "YYYY-MM-DD")


def _is_date_format(args) -> str:
    _require_string_column(args[0], "is_date")
    return "YYYY-MM-DD" if len(args) < 2 or not args[1].is_literal \
        else str(args[1].literal)


def _to_date_impl(ctx, args):
    """to_date(string, format[, suppress_errors]) → date64; unparseable →
    null (NULL_INTERNAL, matching the holder's suppress-errors mode)."""
    s = args[0]
    ms, ok = _parse_table(ctx, s, _to_date_format(args))
    days_ms = (ms // MS_PER_DAY) * MS_PER_DAY
    validity = ok if s.validity is None else (ok & s.validity)
    return Val(days_ms, validity, dt.date64)


def _cast_date_from_string(ctx, args):
    """castDATE(utf8) — ISO YYYY-MM-DD."""
    s = args[0]
    ms, ok = _parse_table(ctx, s, _date_format(args))
    validity = ok if s.validity is None else (ok & s.validity)
    return Val(ms, validity, dt.date64)


def _cast_ts_from_string(ctx, args):
    s = args[0]
    long_fmt, short_fmt = _ts_formats(args)
    ms, ok = _parse_table(ctx, s, long_fmt)
    ms2, ok2 = _parse_table(ctx, s, short_fmt)
    out = torch.where(ok, ms, ms2)
    okc = ok | ok2
    validity = okc if s.validity is None else (okc & s.validity)
    return Val(out, validity, dt.timestamp)


def _is_date_impl(ctx, args):
    s = args[0]
    _, ok = _parse_table(ctx, s, _is_date_format(args))
    if s.validity is not None:
        ok = ok & s.validity
    return Val(ok, None, dt.bool_)


# the parses' emitters: the kernel reads the ms and ok tables at the row's
# code (in the order _parse_tables builds them), and a failed parse is null

def _emit_parse(kind: str):
    def emit(g, args, rt):
        code, valid = args[0].v, args[0].m
        ms = g.table("int64_t", code)
        ok = g.table("bool", code)
        if kind == "to_date":
            return (f"gt_mul<int64_t>(gt_floordiv_i64({ms}, GT_MS_PER_DAY), "
                    "GT_MS_PER_DAY)", f"({ok}) && ({valid})")
        if kind == "castDATE":
            return ms, f"({ok}) && ({valid})"
        if kind == "is_date":
            return f"({ok}) && ({valid})", None
        ms2 = g.table("int64_t", code)
        ok2 = g.table("bool", code)
        return f"({ok}) ? {ms} : {ms2}", f"(({ok}) || ({ok2})) && ({valid})"
    return emit


def _parse_host(formats):
    """A parse's host side: the tables of each of ``formats(args)``."""
    def host(ctx, args):
        fmts = formats(args)
        return [t for f in ([fmts] if isinstance(fmts, str) else fmts)
                for t in _parse_tables(ctx, args[0], f)], None
    return host


for _name, _params, _rt, _impl, _null, _formats in (
        ("to_date", [dt.string, dt.string], dt.date64, _to_date_impl,
         Nullability.NULL_INTERNAL, _to_date_format),
        ("to_date", [dt.string, dt.string, dt.int32], dt.date64,
         _to_date_impl, Nullability.NULL_INTERNAL, _to_date_format),
        ("castDATE", [dt.string], dt.date64, _cast_date_from_string,
         Nullability.NULL_INTERNAL, _date_format),
        ("castTIMESTAMP", [dt.string], dt.timestamp, _cast_ts_from_string,
         Nullability.NULL_INTERNAL, _ts_formats),
        ("is_date", [dt.string], dt.bool_, _is_date_impl,
         Nullability.NULL_NEVER, _is_date_format),
        ("is_date", [dt.string, dt.string], dt.bool_, _is_date_impl,
         Nullability.NULL_NEVER, _is_date_format)):
    _R.register(_name, _params, _rt, _impl, nullability=_null,
                emit=_emit_parse(_name), host=_parse_host(_formats))


# ---------------------------------------------------------------------------
# interval day/year: casts, timestamp/date ± interval (gandiva
# function_registry_timestamp_arithmetic.cc; castNULLABLEINTERVALDAY/YEAR in
# function_registry_datetime.cc). interval_day packs (days << 32) | millis
# in an int64; interval_year is months (int32).
# ---------------------------------------------------------------------------

_M32 = 0xFFFF_FFFF


def _interval_day_total_ms(v):
    """Packed interval_day -> total milliseconds (int64)."""
    return (v >> 32) * MS_PER_DAY + (v & _M32)


def _cast_interval_day(ctx, args):
    # gandiva castNULLABLEINTERVALDAY(int): the integer is total millis
    ms = _i64(args[0].value)
    days = ms // MS_PER_DAY
    return (days << 32) | (ms - days * MS_PER_DAY)


def _to_int32(ctx, args):
    return args[0].value.to(torch.int32)


_emit_to_int32 = _emit(lambda a: f"(int32_t){a.v}")

for _it in (dt.int32, dt.int64):
    _R.register("castINTERVALDAY", [_it], dt.interval_day,
                _cast_interval_day, aliases=["castNULLABLEINTERVALDAY"],
                emit=_emit(lambda a: f"gt_interval_day_of_ms({_c_i64(a)})"))
    # months
    _R.register("castINTERVALYEAR", [_it], dt.interval_year, _to_int32,
                aliases=["castNULLABLEINTERVALYEAR"], emit=_emit_to_int32)


def _ts_plus_interval_day(ctx, args):
    a, b = args
    if a.dtype.kind is dt.TypeKind.INTERVAL_DAY:
        b, a = a, b
    return a.value + _interval_day_total_ms(_i64(b.value))


def _ts_minus_interval_day(ctx, args):
    ts, iv = args
    return ts.value - _interval_day_total_ms(_i64(iv.value))


def _ts_plus_interval_year(ctx, args):
    a, b = args
    if a.dtype.kind is dt.TypeKind.INTERVAL_YEAR:
        b, a = a, b
    return _ts_plus_months(_i64(a.value), _i64(b.value))


def _ts_minus_interval_year(ctx, args):
    ts, iv = args
    return _ts_plus_months(_i64(ts.value), -_i64(iv.value))


def _emit_interval(sub: bool, year: bool):
    """timestamp/date64 ± an interval (either operand order for add)."""
    ivk = dt.TypeKind.INTERVAL_YEAR if year else dt.TypeKind.INTERVAL_DAY

    def emit(g, args, rt):
        a, b = args
        if a.dtype.kind is ivk:
            a, b = b, a
        if year:
            months = _c_i64(b)
            if sub:
                months = f"gt_neg<int64_t>({months})"
            return f"gt_ts_plus_months({_c_i64(a)}, {months})"
        op = "gt_sub<int64_t>" if sub else "gt_add<int64_t>"
        return f"{op}({a.v}, gt_interval_day_ms({_c_i64(b)}))"
    return emit


for _tt in (dt.timestamp, dt.date64):
    _R.register("add", [_tt, dt.interval_day], _tt, _ts_plus_interval_day,
                aliases=["date_add"], emit=_emit_interval(False, False))
    _R.register("add", [dt.interval_day, _tt], _tt, _ts_plus_interval_day,
                emit=_emit_interval(False, False))
    _R.register("subtract", [_tt, dt.interval_day], _tt,
                _ts_minus_interval_day, aliases=["date_sub"],
                emit=_emit_interval(True, False))
    _R.register("add", [_tt, dt.interval_year], _tt, _ts_plus_interval_year,
                emit=_emit_interval(False, True))
    _R.register("add", [dt.interval_year, _tt], _tt, _ts_plus_interval_year,
                emit=_emit_interval(False, True))
    _R.register("subtract", [_tt, dt.interval_year], _tt,
                _ts_minus_interval_year, emit=_emit_interval(True, True))


def _date32_plus_interval_day(ctx, args):
    a, b = args
    if a.dtype.kind is dt.TypeKind.INTERVAL_DAY:
        b, a = a, b
    return (_i64(a.value) + (_i64(b.value) >> 32)).to(torch.int32)


def _emit_date32_plus_interval_day(g, args, rt):
    a, b = args
    if a.dtype.kind is dt.TypeKind.INTERVAL_DAY:
        a, b = b, a
    return f"(int32_t)gt_add<int64_t>({_c_i64(a)}, {_c_i64(b)} >> 32)"


_R.register("add", [dt.date32, dt.interval_day], dt.date32,
            _date32_plus_interval_day, emit=_emit_date32_plus_interval_day)
_R.register("add", [dt.interval_day, dt.date32], dt.date32,
            _date32_plus_interval_day, emit=_emit_date32_plus_interval_day)


# ---------------------------------------------------------------------------
# interval extraction + interval → integer casts (gandiva precompiled/
# time.cc extractDay_daytimeinterval, function_registry_datetime.cc
# castBIGINT(day_time_interval) / castINT(month_interval))
# ---------------------------------------------------------------------------

_R.register("extractDay", [dt.interval_day], dt.int64,
            lambda ctx, args: _i64(args[0].value) >> 32,
            emit=_emit(lambda a: f"({_c_i64(a)} >> 32)"))
# total milliseconds (the inverse of castINTERVALDAY(int))
_R.register("castBIGINT", [dt.interval_day], dt.int64,
            lambda ctx, args: _interval_day_total_ms(_i64(args[0].value)),
            emit=_emit(lambda a: f"gt_interval_day_ms({_c_i64(a)})"))
_R.register("castINT", [dt.interval_year], dt.int32, _to_int32,
            emit=_emit_to_int32)
_R.register("castBIGINT", [dt.interval_year], dt.int64,
            lambda ctx, args: _i64(args[0].value), emit=_emit(_c_i64))
