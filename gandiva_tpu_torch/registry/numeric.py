"""Arithmetic / comparison / boolean / math kernels.

The torch counterpart of gandiva_tpu.registry.numeric: each entry is a
vectorized torch function over whole columns, registered with the same
signatures as the reference package.

Semantics notes (pinned to the reference's C semantics, not torch's):
- integer divide/mod truncate toward zero (C);
- integer overflow wraps (two's complement), matching C++; ``MIN / -1`` is
  ``MIN`` and ``MIN % -1`` is 0, as in the reference (torch's CPU division
  traps on it, so the divisor is masked first);
- divide-by-zero: by default integer x/0 yields 0 and float x/0 yields ±inf.
  ``Configuration(raise_errors=True)`` raises ``EvaluationError("divide by
  zero error")`` at the Evaluate boundary. Torch raises on an integer zero
  divisor, so the divisor is masked before dividing;
- unsigned 16/32/64-bit values are held as the bits of the signed type of
  the same width (dtypes.py). Add, subtract, multiply and the bitwise
  operations are the same on those bits; order compares flip the sign bit
  (``x ^ MIN``); division, right shift and conversions widen or use the
  unsigned algorithms below;
- float→int casts in the cast module round half away from zero (Java/Gandiva
  ``lround`` semantics) and saturate, with NaN → 0, as the reference does on
  the CPU (``float_to_int``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from .registry import Nullability, Val, global_registry

_R = global_registry()

NUMERIC = [dt.int8, dt.int16, dt.int32, dt.int64,
           dt.uint8, dt.uint16, dt.uint32, dt.uint64,
           dt.float32, dt.float64]
SIGNED_INT = [dt.int8, dt.int16, dt.int32, dt.int64]
INTS = [dt.int8, dt.int16, dt.int32, dt.int64,
        dt.uint8, dt.uint16, dt.uint32, dt.uint64]
FLOATS = [dt.float32, dt.float64]
TEMPORAL = [dt.date32, dt.date64, dt.time32, dt.time64, dt.timestamp]
ORDERED = NUMERIC + TEMPORAL          # types supporting <, > etc. natively
EQ_ONLY_EXTRA = [dt.bool_]

_INT64_MAX = (1 << 63) - 1


def torch_dtype(t: dt.DataType) -> torch.dtype:
    """Storage torch dtype of a logical type."""
    return _TORCH[t.storage_np_dtype]


_TORCH = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.int8, torch.int8), (np.int16, torch.int16),
    (np.int32, torch.int32), (np.int64, torch.int64),
    (np.uint8, torch.uint8), (np.float32, torch.float32),
    (np.float64, torch.float64))}


def _same2(types, ret=None):
    """[(t, t) -> ret or t] combos."""
    return [((t, t), ret if ret is not None else t) for t in types]


def _un(types, ret=None):
    return [((t,), ret if ret is not None else t) for t in types]


# --------------------------------------------------------------------------
# unsigned helpers (bits of the signed type of the same width)
# --------------------------------------------------------------------------

def _signed_bits(t: dt.DataType) -> bool:
    """Unsigned kinds held as signed bits (all but uint8, native in torch)."""
    return t.is_unsigned and t.kind is not dt.TypeKind.UINT8


def ordered(x, t: dt.DataType):
    """Map ``x`` onto signed order: unsigned bits get their sign bit flipped."""
    if _signed_bits(t):
        return x ^ -(1 << (t.bit_width - 1))
    return x


def widen(x, t: dt.DataType):
    """Integer storage → int64 holding the same value (uint64 keeps its
    bits); other types unchanged."""
    if t.kind in (dt.TypeKind.UINT16, dt.TypeKind.UINT32):
        return x.to(torch.int64) & ((1 << t.bit_width) - 1)
    return x


def _logical_shr(x, s, t: dt.DataType):
    """Unsigned right shift by ``s`` in [0, width)."""
    if t.kind is dt.TypeKind.UINT64:
        # arithmetic shift, then clear the copies of the sign bit
        keep = torch.bitwise_right_shift(
            torch.full_like(x, _INT64_MAX), torch.clamp(s - 1, min=0))
        return torch.where(s == 0, x, (x >> s) & keep)
    return (widen(x, t) >> s).to(x.dtype)


def to_float(x, t: dt.DataType, out: torch.dtype):
    """Numeric storage → float with one rounding, as the reference converts."""
    if t.kind is dt.TypeKind.UINT64:
        # values ≥ 2^63: halve with a sticky bit, convert, double (exact
        # rounding: both float widths keep far fewer than 63 bits)
        half = ((x >> 1) & _INT64_MAX) | (x & 1)
        return torch.where(x < 0, half.to(out) * 2, x.to(out))
    return widen(x, t).to(out)


def float_to_int(x, t: dt.DataType):
    """Float → integer type ``t``: truncate toward zero, saturate at the
    type's bounds, NaN → 0 (the reference's CPU conversion; torch's own cast
    gives INT64_MIN for NaN and overflow)."""
    w = t.bit_width
    lo, hi = (0, (1 << w) - 1) if t.is_unsigned else \
        (-(1 << (w - 1)), (1 << (w - 1)) - 1)
    xf = torch.trunc(x.to(torch.float64))
    over = xf >= float(hi + 1)
    under = xf < float(lo)
    safe = torch.where(torch.isnan(xf) | over | under,
                       torch.zeros_like(xf), xf)
    if t.kind is dt.TypeKind.UINT64:
        big = safe >= 2.0 ** 63
        val = torch.where(big, (safe - 2.0 ** 64).to(torch.int64),
                          safe.to(torch.int64))
        hi_bits = -1
    else:
        val = safe.to(torch.int64)
        hi_bits = hi
    val = torch.where(over, hi_bits, torch.where(under, lo, val))
    return val.to(torch_dtype(t))


def convert(x, src: dt.DataType, target: dt.DataType):
    """Value conversion between numeric/bool types (no rounding step)."""
    out = torch_dtype(target)
    if target.is_float:
        return to_float(x, src, out)
    return widen(x, src).to(out)


# --------------------------------------------------------------------------
# emitters: the same functions as C++ text for the plan compiler
# (compiler/codegen.py); the helpers are csrc/plan_prelude.h's
# --------------------------------------------------------------------------

def ctype(t: dt.DataType) -> str:
    from ..compiler.codegen import ctype as c

    return c(t)


def emit_call(helper: str):
    """``helper<T>(args...)`` with T the first argument's C type."""
    def emit(g, args, rt):
        vals = ", ".join(a.v for a in args)
        return f"{helper}<{ctype(args[0].dtype)}>({vals})"
    return emit


def emit_op(op: str):
    """``(T)(a op b)``, or ``(T)(op a)`` for one argument: an operation
    that neither wraps nor traps in T (bitwise, compares)."""
    def emit(g, args, rt):
        if len(args) == 1:
            return f"({ctype(rt)})({op}{args[0].v})"
        return f"({ctype(rt)})({args[0].v} {op} {args[1].v})"
    return emit


def _emit_identity(g, args, rt):
    return args[0].v


def _emit_divmod(helper: str):
    def emit(g, args, rt):
        if not args[0].dtype.is_float:
            g.error(f"{args[1].v} == 0", args, "divide by zero error")
        return emit_call(helper)(g, args, rt)
    return emit


def emit_to_float(src: dt.DataType, target: dt.DataType, x: str) -> str:
    """``to_float``: numeric (or bool) → float with one rounding."""
    return f"gt_to_float<{ctype(target)}, {ctype(src)}>({x})"


def emit_float_to_int(src: dt.DataType, target: dt.DataType, x: str) -> str:
    """``float_to_int``: truncate, saturate, NaN → 0."""
    return f"gt_float_to_int<{ctype(target)}, {ctype(src)}>({x})"


def c_double(x: float) -> str:
    """A float64 constant by its bits."""
    from ..compiler.codegen import c_literal

    return c_literal(float(x), dt.float64)


def emit_f64(a) -> str:
    """``_to_f64``: an argument converted to float64 with one rounding."""
    return emit_to_float(a.dtype, dt.float64, a.v)


# --------------------------------------------------------------------------
# arithmetic  (reference: precompiled/arithmetic_ops.cc)
# --------------------------------------------------------------------------

def _wrap2(f):
    return lambda ctx, args: f(args[0].value, args[1].value)


def _wrap1(f):
    return lambda ctx, args: f(args[0].value)


_R.register_many("add", _same2(NUMERIC), _wrap2(lambda a, b: a + b),
                 emit=emit_call("gt_add"))
_R.register_many("subtract", _same2(NUMERIC), _wrap2(lambda a, b: a - b),
                 emit=emit_call("gt_sub"))
_R.register_many("multiply", _same2(NUMERIC), _wrap2(lambda a, b: a * b),
                 emit=emit_call("gt_mul"))


def rows_evaluated(args):
    """Rows whose inputs are all non-null — the rows whose errors count
    toward Configuration.raise_errors (null rows never execute the
    reference's kernel body, so they cannot raise)."""
    valid = None
    for a in args:
        if a.validity is None:
            continue
        valid = a.validity if valid is None else (valid & a.validity)
    return True if valid is None else valid


def _int_divmod(a, b, t: dt.DataType):
    """Truncating (quotient, remainder) for b ≠ 0 rows; rows with b == 0
    get an arbitrary value that the callers replace."""
    zero = b == 0
    if t.kind is dt.TypeKind.UINT64:
        big = b < 0                                  # divisor ≥ 2^63
        safe = torch.where(zero | big, torch.ones_like(b), b)
        # divisor < 2^63: divide a >>> 1, double, fix up by one
        q = torch.div((a >> 1) & _INT64_MAX, safe,
                      rounding_mode="trunc") << 1
        r = a - q * safe
        fix = ordered(r, t) >= ordered(safe, t)
        q = q + fix.to(q.dtype)
        r = torch.where(fix, r - safe, r)
        # divisor ≥ 2^63: the quotient is 1 where a ≥ b, else 0
        ge = ordered(a, t) >= ordered(b, t)
        q = torch.where(big, ge.to(q.dtype), q)
        r = torch.where(big, torch.where(ge, a - b, a), r)
        return q, r
    if _signed_bits(t):
        q, r = _int_divmod(widen(a, t), widen(b, t), dt.int64)
        return q.to(a.dtype), r.to(a.dtype)
    neg1 = (b == -1) if not t.is_unsigned else torch.zeros_like(zero)
    safe = torch.where(zero | neg1, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    r = torch.fmod(a, safe)
    # MIN / -1 wraps to MIN and MIN % -1 is 0 (C/XLA), without the trap
    q = torch.where(neg1, -a, q)
    r = torch.where(neg1, torch.zeros_like(r), r)
    return q, r


def _divide(ctx, args):
    a, b = args[0].value, args[1].value
    if args[0].dtype.is_float:
        return a / b
    ctx.add_error((b == 0) & rows_evaluated(args), "divide by zero error")
    q, _ = _int_divmod(a, b, args[0].dtype)
    return torch.where(b == 0, torch.zeros_like(q), q)


_R.register_many("divide", _same2(NUMERIC), _divide, aliases=["div"],
                 emit=_emit_divmod("gt_div"))


def _mod(ctx, args):
    a, b = args[0].value, args[1].value
    if args[0].dtype.is_float:
        return torch.fmod(a, b)
    ctx.add_error((b == 0) & rows_evaluated(args), "divide by zero error")
    _, r = _int_divmod(a, b, args[0].dtype)
    return torch.where(b == 0, torch.zeros_like(r), r)


_R.register_many("mod", _same2(INTS + FLOATS), _mod, aliases=["modulo", "%"],
                 emit=_emit_divmod("gt_mod"))

_R.register_many("negative", _un(SIGNED_INT + FLOATS),
                 _wrap1(lambda a: -a), emit=emit_call("gt_neg"))
_R.register_many("positive", _un(NUMERIC), _wrap1(lambda a: a),
                 emit=_emit_identity)
_R.register_many("abs", _un(SIGNED_INT + FLOATS), _wrap1(torch.abs),
                 emit=emit_call("gt_abs"))
_R.register_many("abs", _un([dt.uint8, dt.uint16, dt.uint32, dt.uint64]),
                 _wrap1(lambda a: a), emit=_emit_identity)

_R.register_many("bitwise_and", _same2(INTS), _wrap2(lambda a, b: a & b),
                 emit=emit_op("&"))
_R.register_many("bitwise_or", _same2(INTS), _wrap2(lambda a, b: a | b),
                 emit=emit_op("|"))
_R.register_many("bitwise_xor", _same2(INTS), _wrap2(lambda a, b: a ^ b),
                 emit=emit_op("^"))
_R.register_many("bitwise_not", _un(INTS), _wrap1(lambda a: ~a),
                 emit=emit_op("~"))


def _shift(left: bool):
    """Shifts with the reference's out-of-range rule: an amount outside
    [0, width) (negative amounts read as huge unsigned ones) shifts every
    bit out — 0, or the sign for an arithmetic right shift."""
    def impl(ctx, args):
        a, b = args[0].value, args[1].value
        t = args[0].dtype
        w = t.bit_width
        oob = (b >= w) if t.kind is dt.TypeKind.UINT8 else (b < 0) | (b >= w)
        s = torch.where(oob, torch.zeros_like(b), b)
        if left:
            return torch.where(oob, torch.zeros_like(a), a << s)
        if t.is_unsigned:
            return torch.where(oob, torch.zeros_like(a),
                               _logical_shr(a, s, t))
        return torch.where(oob, a >> (w - 1), a >> s)
    return impl


_R.register_many("shift_left", _same2(INTS), _shift(left=True),
                 emit=emit_call("gt_shl"))
_R.register_many("shift_right", _same2(INTS), _shift(left=False),
                 emit=emit_call("gt_shr"))

def _emit_power(g, args, rt):
    fn = "powf" if rt.kind is dt.TypeKind.FLOAT32 else "pow"
    return f"{fn}({args[0].v}, {args[1].v})"


# pow: gandiva registers power(float64, float64)
_R.register_many("power", _same2(FLOATS), _wrap2(torch.pow),
                 aliases=["pow"], emit=_emit_power)


# --------------------------------------------------------------------------
# comparison  (registry tables: function_registry_arithmetic.cc comparisons)
# --------------------------------------------------------------------------

def _cmp(f):
    def impl(ctx, args):
        t = args[0].dtype
        return f(ordered(args[0].value, t), ordered(args[1].value, t))
    return impl


def _register_cmp(name, f, op, aliases=()):
    # over numeric and date/time types; unsigned ones compare as their C
    # unsigned types, so the emitter needs no sign flip
    _R.register_many(name, _same2(ORDERED, dt.bool_), _cmp(f),
                     aliases=aliases, emit=emit_op(op))
    # bool supports equality only — gandiva exposes equal on bool too
    if name in ("equal", "not_equal"):
        _R.register_many(name, _same2(EQ_ONLY_EXTRA, dt.bool_), _wrap2(f),
                         aliases=aliases, emit=emit_op(op))


_register_cmp("equal", lambda a, b: a == b, "==",
              aliases=["eq", "same", "=="])
_register_cmp("not_equal", lambda a, b: a != b, "!=", aliases=["ne", "!="])
_register_cmp("less_than", lambda a, b: a < b, "<", aliases=["lt", "<"])
_register_cmp("less_than_or_equal_to", lambda a, b: a <= b, "<=",
              aliases=["le", "lte", "<="])
_register_cmp("greater_than", lambda a, b: a > b, ">", aliases=["gt", ">"])
_register_cmp("greater_than_or_equal_to", lambda a, b: a >= b, ">=",
              aliases=["ge", "gte", ">="])


# --------------------------------------------------------------------------
# boolean & null-inspection  (NULL_NEVER kernels)
# --------------------------------------------------------------------------

_R.register(
    "not", [dt.bool_], dt.bool_,
    lambda ctx, args: torch.logical_not(args[0].value), emit=emit_op("!"))


def _ref_arr(v: Val):
    # decimals carry (hi, lo) limb tuples
    return v.value[0] if isinstance(v.value, tuple) else v.value


def _isnull(ctx, args):
    v = args[0]
    if v.validity is None:
        out = torch.zeros_like(_ref_arr(v), dtype=torch.bool)
    else:
        out = torch.logical_not(v.validity)
    return Val(out, None, dt.bool_)


def _isnotnull(ctx, args):
    v = args[0]
    if v.validity is None:
        out = torch.ones_like(_ref_arr(v), dtype=torch.bool)
    else:
        out = v.validity
    return Val(out, None, dt.bool_)


def _istrue(ctx, args):
    v = args[0]
    val = v.value if v.validity is None else \
        torch.logical_and(v.value, v.validity)
    return Val(val, None, dt.bool_)


def _isfalse(ctx, args):
    v = args[0]
    val = torch.logical_not(v.value)
    if v.validity is not None:
        val = torch.logical_and(val, v.validity)
    return Val(val, None, dt.bool_)


def _isnottrue(ctx, args):
    r = _istrue(ctx, args)
    return Val(torch.logical_not(r.value), None, dt.bool_)


def _isnotfalse(ctx, args):
    r = _isfalse(ctx, args)
    return Val(torch.logical_not(r.value), None, dt.bool_)


def emit_null_never(f):
    """A null-never emitter: ``f(value, validity)`` → the C value."""
    return lambda g, args, rt: (f(args[0].v, args[0].m), None)


emit_isnull = emit_null_never(lambda v, m: f"!({m})")
emit_isnotnull = emit_null_never(lambda v, m: f"({m})")

for _t in NUMERIC + TEMPORAL + [dt.bool_, dt.string, dt.binary]:
    _R.register("isnull", [_t], dt.bool_, _isnull,
                nullability=Nullability.NULL_NEVER, emit=emit_isnull)
    _R.register("isnotnull", [_t], dt.bool_, _isnotnull,
                nullability=Nullability.NULL_NEVER, emit=emit_isnotnull)

_R.register("istrue", [dt.bool_], dt.bool_, _istrue,
            nullability=Nullability.NULL_NEVER,
            emit=emit_null_never(lambda v, m: f"({v}) && ({m})"))
_R.register("isfalse", [dt.bool_], dt.bool_, _isfalse,
            nullability=Nullability.NULL_NEVER,
            emit=emit_null_never(lambda v, m: f"!({v}) && ({m})"))
_R.register("isnottrue", [dt.bool_], dt.bool_, _isnottrue,
            nullability=Nullability.NULL_NEVER,
            emit=emit_null_never(lambda v, m: f"!(({v}) && ({m}))"))
_R.register("isnotfalse", [dt.bool_], dt.bool_, _isnotfalse,
            nullability=Nullability.NULL_NEVER,
            emit=emit_null_never(lambda v, m: f"!(!({v}) && ({m}))"))


def _valid_or_ones(v: Val):
    if v.validity is not None:
        return v.validity
    return torch.ones_like(v.value, dtype=torch.bool)


def _is_distinct_from(ctx, args):
    a, b = args[0], args[1]
    av, bv = _valid_or_ones(a), _valid_or_ones(b)
    neq = a.value != b.value
    out = torch.where(av & bv, neq, av != bv)
    return Val(out, None, dt.bool_)


def _is_not_distinct_from(ctx, args):
    r = _is_distinct_from(ctx, args)
    return Val(torch.logical_not(r.value), None, dt.bool_)


def _emit_distinct(negate: bool):
    def emit(g, args, rt):
        a, b = args
        d = f"(({a.m}) && ({b.m})) ? ({a.v} != {b.v}) : (({a.m}) != ({b.m}))"
        return (f"!({d})" if negate else d), None
    return emit


for _t in NUMERIC + TEMPORAL + [dt.bool_]:
    _R.register("is_distinct_from", [_t, _t], dt.bool_, _is_distinct_from,
                nullability=Nullability.NULL_NEVER,
                emit=_emit_distinct(False))
    _R.register("is_not_distinct_from", [_t, _t], dt.bool_,
                _is_not_distinct_from, nullability=Nullability.NULL_NEVER,
                emit=_emit_distinct(True))


def _nvl(ctx, args):
    """nvl(a, b): a if a is not null else b (NULL_INTERNAL)."""
    a, b = args[0], args[1]
    av = _valid_or_ones(a)
    out = torch.where(av, a.value, b.value)
    if b.validity is None:
        outv = None
    else:
        outv = av | b.validity
    return Val(out, outv, a.dtype)


def _emit_nvl(g, args, rt):
    a, b = args
    valid = None if b.m == "true" else f"({a.m}) || ({b.m})"
    return f"({a.m}) ? {a.v} : {b.v}", valid


for _t in NUMERIC + TEMPORAL + [dt.bool_]:
    _R.register("nvl", [_t, _t], _t, _nvl,
                nullability=Nullability.NULL_INTERNAL, aliases=["coalesce2"],
                emit=_emit_nvl)


# --------------------------------------------------------------------------
# math  (reference: precompiled/extended_math_ops.cc)
# --------------------------------------------------------------------------

def _to_f64(v: Val):
    return to_float(v.value, v.dtype, torch.float64)


def _sign(x):
    """Float sign as the reference computes it: ±0 and NaN map to
    themselves (torch.sign gives +0 for both)."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _cbrt(x):
    return _sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _mathfn(f):
    def impl(ctx, args):
        return f(_to_f64(args[0]))
    return impl


_MATH1 = {
    "sqrt": torch.sqrt, "cbrt": _cbrt, "exp": torch.exp,
    "log": torch.log, "log10": torch.log10, "log2": torch.log2,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
}

def _scale_constant(f) -> float:
    """The float64 factor torch's ``f`` multiplies by (rad2deg, deg2rad)."""
    return float(f(torch.ones((), dtype=torch.float64)))


def _emit_math(c):
    """An emitter calling ``c(x)`` on the argument as float64: the CUDA math
    function that torch's own kernel calls for the op (libdevice on the
    card, libm on the host), or torch's own formula."""
    def emit(g, args, rt):
        return c(g.tmp("double", emit_f64(args[0])))
    return emit


_MATH1_EMIT = {
    "cbrt": lambda x: (f"gt_fmul(gt_fsign({x}), pow(fabs({x}), "
                       f"{c_double(1.0 / 3.0)}))"),
    "degrees": lambda x: (f"gt_fmul({x}, "
                          f"{c_double(_scale_constant(torch.rad2deg))})"),
    "radians": lambda x: (f"gt_fmul({x}, "
                          f"{c_double(_scale_constant(torch.deg2rad))})"),
}

for _name, _f in _MATH1.items():
    _R.register_many(_name, _un(NUMERIC, dt.float64), _mathfn(_f),
                     emit=_emit_math(_MATH1_EMIT.get(
                         _name, lambda x, _name=_name: f"{_name}({x})")))

_R.register_many("atan2", _same2(FLOATS, dt.float64),
                 lambda ctx, args: torch.atan2(_to_f64(args[0]),
                                               _to_f64(args[1])),
                 emit=lambda g, args, rt: (f"atan2({emit_f64(args[0])}, "
                                           f"{emit_f64(args[1])})"))

# log(base, x) — gandiva's two-arg log
_R.register_many("log", _same2(FLOATS, dt.float64),
                 lambda ctx, args: torch.log(_to_f64(args[1]))
                 / torch.log(_to_f64(args[0])),
                 emit=lambda g, args, rt: (f"log({emit_f64(args[1])}) / "
                                           f"log({emit_f64(args[0])})"))

_R.register("pi", [], dt.float64,
            lambda ctx, args: torch.tensor(np.pi, dtype=torch.float64,
                                           device=ctx.device),
            emit=lambda g, args, rt: c_double(np.pi))


def round_half_away(x):
    return _sign(x) * torch.floor(torch.abs(x) + 0.5)


def _round1(ctx, args):
    a = args[0].value
    if args[0].dtype.is_integer:
        return a
    return round_half_away(a)


def _emit_float_only(c):
    """Integers as they are; a float through ``c(x, C type)``."""
    def emit(g, args, rt):
        a = args[0]
        return a.v if a.dtype.is_integer else c(a.v, ctype(a.dtype))
    return emit


_R.register_many("round", _un(NUMERIC), _round1, emit=_emit_float_only(
    lambda x, t: f"gt_round_half_away<{t}>({x})"))


def _digits_scale(nd: Val):
    if nd.is_literal:
        return 10.0 ** int(nd.literal)
    return torch.pow(10.0, nd.value.to(torch.float64))


def _back(x, v: Val):
    """float64 result → the argument's type (saturating for integers)."""
    if v.dtype.is_integer:
        return float_to_int(x, v.dtype)
    return x.to(v.value.dtype)


def _round2(ctx, args):
    a, nd = args[0], args[1]
    if a.dtype.is_integer and nd.is_literal and int(nd.literal) >= 0:
        # round to -ndigits positions left of decimal point
        return a.value
    scale = _digits_scale(nd)
    return _back(round_half_away(_to_f64(a) * scale) / scale, a)


def _emit_digits(kind: str):
    """``_round2`` / ``_truncate2``: scaled by 10^d (a literal's Python
    value, else pow(10, d) as torch.pow computes it), rounded, divided back
    and converted to the argument's type."""
    def emit(g, args, rt):
        a, nd = args
        t = a.dtype
        lit = nd.is_literal and nd.literal is not None
        if kind == "round" and t.is_integer and lit and int(nd.literal) >= 0:
            return a.v
        if lit:
            scale = c_double(10.0 ** int(nd.literal))
        else:
            scale = g.tmp("double", f"pow(10.0, (double){nd.v})")
        y = g.tmp("double", f"gt_fmul({emit_f64(a)}, {scale})")
        r = (f"gt_round_half_away<double>({y})" if kind == "round"
             else f"trunc({y})")
        x = f"{r} / {scale}"
        if t.is_integer:
            return emit_float_to_int(dt.float64, t, x)
        return f"({ctype(t)})({x})"
    return emit


for _t in NUMERIC:
    _R.register("round", [_t, dt.int32], _t, _round2,
                emit=_emit_digits("round"))


def _truncate2(ctx, args):
    a, nd = args[0], args[1]
    scale = _digits_scale(nd)
    return _back(torch.trunc(_to_f64(a) * scale) / scale, a)


def _truncate1(ctx, args):
    a = args[0].value
    if args[0].dtype.is_integer:
        return a
    return torch.trunc(a)


_R.register_many("truncate", _un(NUMERIC), _truncate1, aliases=["trunc"],
                 emit=_emit_float_only(lambda x, t: f"gt_trunc<{t}>({x})"))
for _t in NUMERIC:
    _R.register("truncate", [_t, dt.int32], _t, _truncate2, aliases=["trunc"],
                emit=_emit_digits("truncate"))

_R.register_many("ceiling", _un(FLOATS), _wrap1(torch.ceil), aliases=["ceil"],
                 emit=emit_call("gt_ceil"))
_R.register_many("floor", _un(FLOATS), _wrap1(torch.floor),
                 emit=emit_call("gt_floor"))
_R.register_many("sign", _un(SIGNED_INT), _wrap1(torch.sign),
                 emit=lambda g, args, rt: (f"({ctype(rt)})(({args[0].v} > 0) "
                                           f"- ({args[0].v} < 0))"))
_R.register_many("sign", _un(FLOATS), _wrap1(_sign), emit=emit_call("gt_fsign"))


# --------------------------------------------------------------------------
# random  (reference holder: random_generator_holder.cc — stateful per-call)
# --------------------------------------------------------------------------

def _random(ctx, args):
    u = torch.rand(ctx.capacity, generator=ctx.generator(),
                   dtype=torch.float64, device=ctx.device)
    return Val(u, None, dt.float64)


_R.register("random", [], dt.float64, _random,
            nullability=Nullability.NULL_NEVER, aliases=["rand"])
_R.register("random", [dt.int32], dt.float64, _random,
            nullability=Nullability.NULL_NEVER, aliases=["rand"])
