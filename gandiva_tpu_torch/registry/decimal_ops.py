"""Decimal128 kernels with Java-BigDecimal-compatible result-type rules.

The torch counterpart of gandiva_tpu.registry.decimal_ops (gandiva's
decimal_ir.cc, decimal_type_util.cc, precompiled/decimal_ops.cc — SURVEY.md
§2a#12): 128-bit scaled-integer arithmetic whose result precision/scale
follow Java's rules, with scale reduction when precision would exceed 38.

A decimal value is a pair of int64 limb tensors (``Val.value = (hi, lo)``),
all arithmetic through utils/int128. When BOTH multiply operands exceed 18
digits the product is formed at 256 bits before the scale-reduction divide
(``int128.mul256_div_pow10``, the reference's ``decimal_xlarge`` path);
TPC-H-style decimal(15,2) columns stay on the 64×64 product.

Division and scale reduction round half away from zero, as Gandiva does.
Signatures are parameterized by (precision, scale), so they register on
demand (``ensure_registered``, called by the validator and the decomposer).
castVARCHAR(decimal) formats through the string registry
(``string_ops._cast_varchar_numeric``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import dtypes as dt
from ..utils import int128 as i128
from .numeric import (_isnotnull, _isnull, emit_isnotnull, emit_isnull,
                      rows_evaluated)
from .registry import (ExpressionValidationError, Nullability, Val,
                       global_registry)

_R = global_registry()

MAX_PRECISION = 38
MIN_ADJUSTED_SCALE = 6


# ---------------------------------------------------------------------------
# result-type rules (gandiva decimal_type_util.cc)
# ---------------------------------------------------------------------------

def _adjust(precision: int, scale: int) -> Tuple[int, int]:
    if precision <= MAX_PRECISION:
        return precision, scale
    if scale > MIN_ADJUSTED_SCALE:
        drop = precision - MAX_PRECISION
        scale = max(scale - drop, MIN_ADJUSTED_SCALE)
    return MAX_PRECISION, scale


def result_type(op: str, t1: dt.DataType, t2: dt.DataType) -> dt.DataType:
    p1, s1, p2, s2 = t1.precision, t1.scale, t2.precision, t2.scale
    if op in ("add", "subtract"):
        scale = max(s1, s2)
        precision = max(p1 - s1, p2 - s2) + scale + 1
    elif op == "multiply":
        scale = s1 + s2
        precision = p1 + p2 + 1
    elif op == "divide":
        scale = max(MIN_ADJUSTED_SCALE, s1 + p2 + 1)
        precision = p1 - s1 + s2 + scale
    elif op == "mod":
        scale = max(s1, s2)
        precision = min(p1 - s1, p2 - s2) + scale
    else:
        raise ValueError(op)
    precision, scale = _adjust(precision, scale)
    return dt.decimal128(precision, scale)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rescale(hi, lo, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return hi, lo
    if to_scale > from_scale:
        return i128.mul_pow10(hi, lo, to_scale - from_scale)
    return i128.div_pow10_round(hi, lo, from_scale - to_scale)


def _fits_int64(t: dt.DataType) -> bool:
    return t.precision <= 18


def _decimal_val(hi, lo, out_t: dt.DataType) -> Val:
    return Val((hi, lo), None, out_t)


def _zero_div(ctx, args, bh, bl):
    """Rows whose divisor is 0 (recorded as the reference's divide-by-zero
    error), and the low limb with those rows made 1."""
    zero_div = (bh == 0) & (bl == 0)
    ctx.add_error(zero_div & rows_evaluated(args), "divide by zero error")
    return zero_div, torch.where(zero_div, torch.ones_like(bl), bl)


# ---------------------------------------------------------------------------
# emitters: the arithmetic below as C++ on one __int128 a row, for the plan
# compiler (compiler/codegen.py; helpers in csrc/plan_prelude.h), with the
# limb route's bits: products and upscales wrap mod 2^128, downscales and
# divisions round half away from zero as utils/int128 does
# ---------------------------------------------------------------------------

def _emit_rescale(x: str, from_scale: int, to_scale: int) -> str:
    from ..compiler.codegen import pow10

    if to_scale == from_scale:
        return x
    if to_scale > from_scale:
        return f"gt_mul_pow10({x}, {pow10(to_scale - from_scale)})"
    return f"gt_div_pow10_round({x}, {pow10(from_scale - to_scale)})"


def _lo64(x: str) -> str:
    """A decimal's low limb, the int64 its value is when it fits."""
    return f"(int64_t)(uint64_t)(gt_u128)({x})"


def _emit_addsub(sub: bool):
    def emit(g, args, rt):
        a, b = args
        out_t = result_type("subtract" if sub else "add", a.dtype, b.dtype)
        op = "gt_i128_sub" if sub else "gt_i128_add"
        return (f"{op}({_emit_rescale(a.v, a.dtype.scale, out_t.scale)}, "
                f"{_emit_rescale(b.v, b.dtype.scale, out_t.scale)})")

    def low_args(types, j, low):
        # a sum's low word needs only its operands' low words, unless an
        # operand is rounded down to the result's scale
        out_t = result_type("subtract" if sub else "add", *types)
        return low and types[j].scale <= out_t.scale

    emit.low_args = low_args
    return emit


def _emit_multiply(g, args, rt):
    from ..compiler.codegen import pow10

    a, b = args
    out_t = result_type("multiply", a.dtype, b.dtype)
    raw_scale = a.dtype.scale + b.dtype.scale
    if _fits_int64(a.dtype) and _fits_int64(b.dtype):
        p = f"gt_mul_i64({_lo64(a.v)}, {_lo64(b.v)})"
    elif _fits_int64(b.dtype):
        p = f"gt_mul128_i64({a.v}, {_lo64(b.v)})"
    elif _fits_int64(a.dtype):
        p = f"gt_mul128_i64({b.v}, {_lo64(a.v)})"
    else:
        # both operands over 18 digits: the 256-bit product, rounded down
        # to the result's scale (int128.mul256_div_pow10)
        k = raw_scale - out_t.scale
        half = 5 * 10 ** (k - 1) if k > 0 else 0
        words = ", ".join(f"0x{(half >> (64 * j)) & ((1 << 64) - 1):x}ULL"
                          for j in range(4))
        return f"gt_mul256_div_pow10({a.v}, {b.v}, {k}, {words})"
    return _emit_rescale(p, raw_scale, out_t.scale)


# an operand that fits int64 enters the product as its low word only
_emit_multiply.low_args = lambda types, j, low: _fits_int64(types[j])


def _emit_negative(g, args, rt):
    return f"gt_i128_neg({args[0].v})"


_emit_negative.low_args = lambda types, j, low: low


def _emit_divide(g, args, rt):
    a, b = args
    out_t = result_type("divide", a.dtype, b.dtype)
    delta = out_t.scale + b.dtype.scale - a.dtype.scale
    x = _emit_rescale(a.v, 0, max(delta, 0))
    if delta < 0:
        x = _emit_rescale(x, -delta, 0)
    g.error(f"{b.v} == 0", args, "divide by zero error")
    return f"gt_dec_divide({x}, {a.v}, {b.v})"


def _emit_mod(g, args, rt):
    a, b = args
    out_t = result_type("mod", a.dtype, b.dtype)
    ra = g.tmp("gt_i128", _emit_rescale(a.v, a.dtype.scale, out_t.scale))
    rb = g.tmp("gt_i128", _emit_rescale(b.v, b.dtype.scale, out_t.scale))
    g.error(f"{rb} == 0", args, "divide by zero error")
    return f"gt_dec_mod({ra}, {rb})"


def _emit_cast_bigint(g, args, rt):
    a = args[0]
    return _lo64(_emit_rescale(a.v, a.dtype.scale, 0))


def _emit_cast_float8(g, args, rt):
    from .numeric import c_double

    a = args[0]
    return (f"gt_fmul(gt_dec_to_f64({a.v}), "
            f"{c_double(1.0 / 10.0 ** a.dtype.scale)})")


_ROUND_KINDS = {"round": 0, "truncate": 1, "ceiling": 2, "floor": 3}


def _emit_round_family(kind: str):
    """``_round_family``: to scale 0, or to a literal target scale."""
    def emit(g, args, rt):
        a = args[0]
        s = a.dtype.scale
        if len(args) == 2:
            if not args[1].is_literal or args[1].literal is None:
                raise ExpressionValidationError(
                    f"{kind} scale argument must be a literal")
            target = max(int(args[1].literal), 0)
        else:
            target = 0
        if s - target <= 0:
            return _emit_rescale(a.v, s, target)
        from ..compiler.codegen import pow10

        return f"gt_dec_round({a.v}, {pow10(s - target)}, {_ROUND_KINDS[kind]})"
    return emit


def _emit_fits(x: str, digits: int) -> str:
    """``_fits_precision``: |x| < 10^digits, as a signed compare."""
    from ..compiler.codegen import pow10

    return f"gt_dec_fits({x}, {pow10(digits)})"


def _emit_cast_decimal(null_on_overflow: bool):
    """``_cast_decimal_impl``: the value at the target scale, and whether
    it fits the target precision (checked before an upscale too, where a
    wrapped product could pass); out of range rows are null, or an
    Evaluate-time error under raise_errors."""
    def emit(g, args, rt):
        from .numeric import c_double

        a, t = args[0], rt
        fits = []

        def prescale(x: str, delta: int) -> None:
            if delta <= 0:
                return
            p = t.precision - delta
            fits.append(f"({x} == 0)" if p <= 0 else _emit_fits(x, p))

        if a.dtype.is_decimal:
            prescale(a.v, t.scale - a.dtype.scale)
            x = g.tmp("gt_i128", _emit_rescale(a.v, a.dtype.scale, t.scale))
        elif a.dtype.is_integer:
            x0 = g.tmp("gt_i128", f"(gt_i128)(int64_t){a.v}")
            prescale(x0, t.scale)
            x = g.tmp("gt_i128", _emit_rescale(x0, 0, t.scale))
        else:
            xf = g.tmp("double", f"gt_fmul((double){a.v}, "
                                 f"{c_double(10.0 ** t.scale)})")
            y = g.tmp("double", f"trunc(gt_fadd({xf}, {xf} < 0 ? -0.5 : 0.5))")
            over = g.tmp("bool", f"fabs({y}) >= 9223372036854775808.0 || "
                                 f"gt_nonfinite({xf})")
            fits.append(f"!{over}")
            x = g.tmp("gt_i128", f"(gt_i128)({over} ? (int64_t)0 : "
                                 f"(int64_t){y})")
        ok = g.tmp("bool", " && ".join([_emit_fits(x, t.precision)] + fits))
        if null_on_overflow:
            return x, f"({a.m}) && {ok}"
        g.error(f"!{ok}", args, "castDECIMAL: overflow")
        return x
    return emit


def _emit_cmp(op: str):
    def emit(g, args, rt):
        a, b = args
        scale = max(a.dtype.scale, b.dtype.scale)
        return (f"({_emit_rescale(a.v, a.dtype.scale, scale)} {op} "
                f"{_emit_rescale(b.v, b.dtype.scale, scale)})")

    return emit


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _addsub(sub: bool):
    def impl(ctx, args):
        a, b = args
        out_t = result_type("subtract" if sub else "add", a.dtype, b.dtype)
        ah, al = _rescale(*a.value, a.dtype.scale, out_t.scale)
        bh, bl = _rescale(*b.value, b.dtype.scale, out_t.scale)
        op = i128.sub128 if sub else i128.add128
        return _decimal_val(*op(ah, al, bh, bl), out_t)

    return impl


def _multiply(ctx, args):
    a, b = args
    out_t = result_type("multiply", a.dtype, b.dtype)
    raw_scale = a.dtype.scale + b.dtype.scale
    if _fits_int64(a.dtype) and _fits_int64(b.dtype):
        hi, lo = i128.mul_i64(a.value[1], b.value[1])
    elif _fits_int64(b.dtype):
        hi, lo = i128.mul128_i64(*a.value, b.value[1])
    elif _fits_int64(a.dtype):
        hi, lo = i128.mul128_i64(*b.value, a.value[1])
    else:
        # decimal_xlarge path: both operands > 18 digits — full 256-bit
        # product, fused with the scale-reduction divide + round
        hi, lo = i128.mul256_div_pow10(*a.value, *b.value,
                                       raw_scale - out_t.scale)
        return _decimal_val(hi, lo, out_t)
    hi, lo = _rescale(hi, lo, raw_scale, out_t.scale)
    return _decimal_val(hi, lo, out_t)


def _divide(ctx, args):
    a, b = args
    out_t = result_type("divide", a.dtype, b.dtype)
    # scale dividend so quotient lands on out_t.scale:
    # q_scale = s1 + delta - s2 == out.scale  ⇒  delta = out.scale+s2-s1
    delta = out_t.scale + b.dtype.scale - a.dtype.scale
    ah, al = a.value
    bh, bl = b.value
    xh, xl = i128.mul_pow10(ah, al, max(delta, 0))
    if delta < 0:
        xh, xl = i128.div_pow10_round(xh, xl, -delta)
    # divide-by-zero: quotient 0 (Configuration.raise_errors raises)
    zero_div, safe_bl = _zero_div(ctx, args, bh, bl)
    qh, ql, rh, rl = i128.divmod128(xh, xl, bh, safe_bl)
    # round half away from zero: |r|*2 >= |b| → bump toward sign
    r2h, r2l = i128.shl128(*i128.abs128(rh, rl), 1)
    abh, abl = i128.abs128(bh, safe_bl)
    bump = i128.cmp128(r2h, r2l, abh, abl) >= 0
    sign_neg = torch.logical_xor(i128.is_neg(ah, al), i128.is_neg(bh, bl))
    zero = torch.zeros_like(ql)
    inc_lo = bump.to(torch.int64)
    qh2, ql2 = i128.add128(qh, ql, zero, inc_lo)
    qh3, ql3 = i128.sub128(qh, ql, zero, inc_lo)
    qh = torch.where(bump, torch.where(sign_neg, qh3, qh2), qh)
    ql = torch.where(bump, torch.where(sign_neg, ql3, ql2), ql)
    qh = torch.where(zero_div, zero, qh)
    ql = torch.where(zero_div, zero, ql)
    return _decimal_val(qh, ql, out_t)


def _mod(ctx, args):
    a, b = args
    out_t = result_type("mod", a.dtype, b.dtype)
    ah, al = _rescale(*a.value, a.dtype.scale, out_t.scale)
    bh, bl = _rescale(*b.value, b.dtype.scale, out_t.scale)
    zero_div, safe_bl = _zero_div(ctx, args, bh, bl)
    _, _, rh, rl = i128.divmod128(ah, al, bh, safe_bl)
    rh = torch.where(zero_div, torch.zeros_like(rh), rh)
    rl = torch.where(zero_div, torch.zeros_like(rl), rl)
    return _decimal_val(rh, rl, out_t)


def _abs_impl(ctx, args):
    a = args[0]
    return _decimal_val(*i128.abs128(*a.value), a.dtype)


def _negative(ctx, args):
    a = args[0]
    return _decimal_val(*i128.neg128(*a.value), a.dtype)


def _cmp_impl(op):
    def impl(ctx, args):
        a, b = args
        scale = max(a.dtype.scale, b.dtype.scale)
        ah, al = _rescale(*a.value, a.dtype.scale, scale)
        bh, bl = _rescale(*b.value, b.dtype.scale, scale)
        return op(i128.cmp128(ah, al, bh, bl))

    return impl


def _round_family(kind: str):
    """ceil/floor/round/truncate to scale 0, or (round, truncate) to a
    literal target scale."""

    def impl(ctx, args, target_scale=0):
        a = args[0]
        s = a.dtype.scale
        if len(args) == 2:
            if not args[1].is_literal:
                raise ExpressionValidationError(
                    f"{kind} scale argument must be a literal")
            target_scale = int(args[1].literal)
        out_t = dt.decimal128(a.dtype.precision, max(target_scale, 0))
        hi, lo = a.value
        k = s - out_t.scale
        if k <= 0:
            return _decimal_val(*_rescale(hi, lo, s, out_t.scale), out_t)
        if kind == "round":
            return _decimal_val(*i128.div_pow10_round(hi, lo, k), out_t)
        qh, ql, rh, rl = i128.divmod_pow10(hi, lo, k)
        if kind == "truncate":
            return _decimal_val(qh, ql, out_t)
        has_r = (rh != 0) | (rl != 0)
        zero = torch.zeros_like(qh)
        if kind == "ceiling":
            bump = (has_r & ~i128.is_neg(hi, lo)).to(torch.int64)
            return _decimal_val(*i128.add128(qh, ql, zero, bump), out_t)
        bump = (has_r & i128.is_neg(hi, lo)).to(torch.int64)   # floor
        return _decimal_val(*i128.sub128(qh, ql, zero, bump), out_t)

    return impl


def _cast_bigint(ctx, args):
    a = args[0]
    hi, lo = i128.div_pow10_round(*a.value, a.dtype.scale)
    return Val(i128.to_int64(hi, lo), None, dt.int64)


def _cast_float8(ctx, args):
    a = args[0]
    # times the reciprocal, as the reference's compiler divides by a
    # constant: the same bits
    return Val(i128.to_float64(*a.value) * (1.0 / 10.0 ** a.dtype.scale),
               None, dt.float64)


def _fits_precision(hi, lo, precision: int):
    """|x| < 10^precision (so x is representable at that precision)."""
    ph, plo = i128.pow10_128(precision)
    ah, al = i128.abs128(hi, lo)
    return i128.cmp128(ah, al, torch.full_like(ah, ph),
                       torch.full_like(al, plo)) < 0


def _cast_decimal_impl(null_on_overflow: bool):
    """castDECIMAL / castDECIMALNullOnOverflow — target (precision, scale)
    comes from the tree-declared return type (gandiva decimal_ops.cc
    castDECIMAL_decimal128). Rounding on downscale is half-away-from-zero.
    The plain variant wraps on precision overflow (an Evaluate-time error
    under raise_errors); the NullOnOverflow variant nulls those rows."""

    def impl(ctx, args, return_type):
        a = args[0]
        t = return_type
        if t is None or not t.is_decimal:
            raise ExpressionValidationError(
                "castDECIMAL requires the expression to declare a "
                f"decimal return type, got {t}")
        overflow = None

        def prescale_check(hi_in, lo_in, scale_delta: int):
            """Magnitude check BEFORE scaling up: mul_pow10 truncates at 128
            bits, so a wrapped product could spuriously pass _fits_precision.
            A value fits iff |x·10^d| < 10^precision ⟺ |x| < 10^(precision−d);
            when that bound is ≤ 0 digits only x == 0 fits."""
            if scale_delta <= 0:
                return None
            p = t.precision - scale_delta
            if p <= 0:
                return (hi_in == 0) & (lo_in == 0)
            return _fits_precision(hi_in, lo_in, p)

        if a.dtype.is_decimal:
            hi0, lo0 = a.value
            fits_pre = prescale_check(hi0, lo0, t.scale - a.dtype.scale)
            if fits_pre is not None:
                overflow = ~fits_pre
            hi, lo = _rescale(hi0, lo0, a.dtype.scale, t.scale)
        elif a.dtype.is_integer:
            hi, lo = i128.from_int64(a.value.to(torch.int64))
            fits_pre = prescale_check(hi, lo, t.scale)
            if fits_pre is not None:
                overflow = ~fits_pre
            hi, lo = i128.mul_pow10(hi, lo, t.scale)
        elif a.dtype.is_float:
            x = a.value.to(torch.float64) * (10.0 ** t.scale)
            # half-away-from-zero, then via int64 (f64 has 53 mantissa bits,
            # so every exactly-representable input survives). NaN and inf
            # are overflow, as gandiva treats them.
            y = torch.trunc(x + torch.where(x < 0, -0.5, 0.5))
            overflow = ((torch.abs(y) >= 2.0 ** 63) | torch.isnan(x)
                        | torch.isinf(x))
            # plain variant: overflow → 0 (gandiva's overflow value)
            y = torch.where(overflow, torch.zeros_like(y), y)
            hi, lo = i128.from_int64(y.to(torch.int64))
        else:
            raise ExpressionValidationError(
                f"castDECIMAL: unsupported source type {a.dtype}")
        out = _decimal_val(hi, lo, t)
        fits = _fits_precision(hi, lo, t.precision)
        if overflow is not None:
            fits = fits & ~overflow
        if null_on_overflow:
            out.validity = fits if a.validity is None else (a.validity & fits)
        else:
            # Status parity (Configuration.raise_errors): precision overflow
            # is an Evaluate-time error instead of a silent wrap
            ctx.add_error(~fits & rows_evaluated(args),
                          "castDECIMAL: overflow")
        return out

    return impl


def register_cast_decimal_from(t: dt.DataType):
    for name, noo in (("castDECIMAL", False),
                      ("castDECIMALNullOnOverflow", True)):
        if _R.lookup(name, [t]) is None:
            _R.register(name, [t], None, _cast_decimal_impl(noo),
                        nullability=Nullability.NULL_IF_NULL if not noo
                        else Nullability.NULL_INTERNAL,
                        needs_return_type=True,
                        emit=_emit_cast_decimal(noo))


for _t in (dt.int32, dt.int64, dt.float32, dt.float64):
    register_cast_decimal_from(_t)


def register_decimal_for(t1: dt.DataType, t2: dt.DataType):
    """The binary signatures of one concrete (t1, t2) pair."""
    for name, impl, emit in [
            ("add", _addsub(False), _emit_addsub(False)),
            ("subtract", _addsub(True), _emit_addsub(True)),
            ("multiply", _multiply, _emit_multiply),
            ("divide", _divide, _emit_divide), ("mod", _mod, _emit_mod)]:
        if _R.lookup(name, [t1, t2]) is None:
            _R.register(name, [t1, t2], result_type(name, t1, t2), impl,
                        emit=emit)
    for name, op, c in [
        ("equal", lambda c: c == 0, "=="), ("not_equal", lambda c: c != 0,
                                            "!="),
        ("less_than", lambda c: c < 0, "<"),
        ("less_than_or_equal_to", lambda c: c <= 0, "<="),
        ("greater_than", lambda c: c > 0, ">"),
        ("greater_than_or_equal_to", lambda c: c >= 0, ">="),
    ]:
        if _R.lookup(name, [t1, t2]) is None:
            _R.register(name, [t1, t2], dt.bool_, _cmp_impl(op),
                        emit=_emit_cmp(c))


def _cast_varchar_decimal(ctx, args):
    from .string_ops import _cast_varchar_numeric
    return _cast_varchar_numeric(ctx, args)


def register_decimal_unary(t: dt.DataType):
    """The unary signatures of one concrete decimal type."""
    register_cast_decimal_from(t)
    for name, f, emit in (("isnull", _isnull, emit_isnull),
                          ("isnotnull", _isnotnull, emit_isnotnull)):
        if _R.lookup(name, [t]) is None:
            _R.register(name, [t], dt.bool_, f,
                        nullability=Nullability.NULL_NEVER, emit=emit)
    for params in ([t], [t, dt.int64]):
        if _R.lookup("castVARCHAR", params) is None:
            _R.register("castVARCHAR", params, dt.string,
                        _cast_varchar_decimal)
    for name, impl, emit in (
            ("abs", _abs_impl, lambda g, a, rt: f"gt_i128_abs({a[0].v})"),
            ("negative", _negative, _emit_negative)):
        if _R.lookup(name, [t]) is None:
            _R.register(name, [t], t, impl, emit=emit)
    to0 = dt.decimal128(t.precision, 0)
    specs = [("castBIGINT", _cast_bigint, dt.int64, _emit_cast_bigint),
             ("castFLOAT8", _cast_float8, dt.float64, _emit_cast_float8)] + [
        (kind, _round_family(kind), to0, _emit_round_family(kind))
        for kind in ("ceiling", "floor", "round", "truncate")]
    for name, impl, rt, emit in specs:
        if _R.lookup(name, [t]) is None:
            _R.register(name, [t], rt, impl, emit=emit)
    for name in ("round", "truncate"):
        if _R.lookup(name, [t, dt.int32]) is None:
            # target scale given as literal; return type keeps precision
            _R.register(name, [t, dt.int32], t, _round_family(name),
                        emit=_emit_round_family(name))


def ensure_registered(arg_types):
    """On-demand registration: the registry fills in concrete decimal
    entries the first time a type combination is validated."""
    decs = [t for t in arg_types
            if isinstance(t, dt.DataType) and t.is_decimal]
    if not decs:
        return
    for t in decs:
        register_decimal_unary(t)
    if len(arg_types) == 2 and len(decs) == 2:
        register_decimal_for(arg_types[0], arg_types[1])
