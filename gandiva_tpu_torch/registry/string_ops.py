"""String kernels — dictionary-encoded execution.

The torch counterpart of gandiva_tpu.registry.string_ops (Gandiva's
precompiled/string_ops.cc and the LIKE/regex function holders,
like_holder.cc, regex_util.cc — SURVEY.md §2a#6-7). String functions run
once per *distinct* dictionary value on the host and their results are
gathered by code on the device (SURVEY.md §7 "Strings on TPU"): the card
holds int32 codes and small tables, never bytes.

Three lowering shapes:
- string → string: compose a host dictionary transform; device codes pass
  through unchanged (upper, trim, substr-with-literal-args, replace, …).
- string → scalar: host lookup table per distinct value, gathered by code on
  device via a TraceContext table (length, strpos, predicates, hashes).
- string × string comparisons: both dictionaries are merged and ranked on
  host per batch; comparisons run on device over the rank columns.

Host tables go through ``TraceContext.add_table``, which uploads them and
memoizes the dictionary-pure ones per plan. Each entry's host side
(``host``: its tables and its result's dictionary) is one function that
both routes call: the eager ``impl`` gathers its tables by code on whole
columns, and a compiled plan's kernel reads them a row at a time, through
the entry's emitter (compiler/codegen.py): a lookup of the row's code
(string → scalar), the argument's code itself (string → string), or two
lookups and an integer compare (string × string). Two routes read device values
back to the host (a sync each): concat's per-row route (each column's
codes) and castVARCHAR / castVARBINARY of a numeric or decimal value;
they have no emitter and stay eager in a compiled plan. LIKE, ILIKE
and the string hashes run in the native host runtime (``native/``) over the
dictionary's utf8 buffers; a dictionary of another layout (large_string)
takes Python's ``re`` and ``hash_bytes_np``, which give the same results.
"""
from __future__ import annotations

import base64 as _b64
import hashlib as _hashlib
import re
from typing import Callable, List

import numpy as np
import torch

from .. import dtypes as dt
from ..compiler.codegen import table_ctype
from ..compiler.decomposer import at_least_one, gather_by_code
from .registry import ExpressionValidationError, Val, global_registry

_R = global_registry()

MAX_PRODUCT_DICT = 1 << 20  # cap for concat cross-product dictionaries


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _dict_list(arrow_array) -> List:
    return arrow_array.to_pylist()


def _require_dict(val: Val, fname: str):
    if val.dict_thunk is None:
        raise ExpressionValidationError(
            f"{fname}: string input must be dictionary-backed "
            "(non-literal string argument required)")


def _require_literal(val: Val, fname: str, argname: str):
    if not val.is_literal:
        raise ExpressionValidationError(
            f"{fname}: argument {argname} must be a literal")
    return val.literal


def _table(ctx, val: Val, per_value: Callable[[List], np.ndarray], fill,
           fname: str):
    """The host table of ``per_value`` over the input's dictionary."""
    _require_dict(val, fname)
    dthunk = val.dict_thunk

    def thunk(batch, _dt=dthunk, _f=per_value):
        d = _dict_list(_dt(batch))
        return at_least_one(np.asarray(_f(d)), fill)

    return ctx.add_table(thunk, cache_on_dicts=True)


def _register_lookup(name, params, ret, table, out_np, arg=0, aliases=()):
    """A string → scalar entry: ``table(ctx, args)`` builds its one host
    table, of ``out_np`` entries, over ``args[arg]``'s dictionary (its host
    side); its value is the table's entry at the row's code."""
    ct = table_ctype(out_np)

    def host(ctx, args):
        return [table(ctx, args)], None

    def impl(ctx, args):
        return gather_by_code(table(ctx, args), args[arg].value)

    def emit(g, args, rt):
        return g.table(ct, args[arg].v)

    _R.register(name, params, ret, impl, aliases=aliases, emit=emit,
                host=host)


def _emit_codes(j: int):
    """A dictionary transform's emitter: its value is argument ``j``'s
    code."""
    def emit(g, args, rt):
        return args[j].v

    return emit


def _register_transform(name, params, ret, impl, aliases=()):
    """A string → string (or binary) entry whose ``impl`` only composes
    its argument's dictionary (``_transform_dict``): that is its host side
    too, and its value is its argument's code."""
    _R.register(name, params, ret, impl, aliases=aliases,
                emit=_emit_codes(0),
                host=lambda ctx, args: ([], impl(ctx, args)))


def _transform_dict(val: Val, transform: Callable[[List], List],
                    fname: str, out_dtype=dt.string) -> Val:
    """string → string: host dictionary transform, codes unchanged."""
    _require_dict(val, fname)
    dthunk = val.dict_thunk

    def new_thunk(batch, _dt=dthunk, _f=transform):
        import pyarrow as pa
        d = _dict_list(_dt(batch))
        return pa.array(_f(d),
                        type=pa.string() if out_dtype.kind is dt.TypeKind.STRING
                        else pa.binary())

    # codes pass through unchanged, so the result still traces to the same
    # source column (enables the per-row concat fallback downstream)
    return Val(val.value, val.validity, out_dtype, dict_thunk=new_thunk,
               source_field=val.source_field)


def _str_or(v, default=""):
    return default if v is None else v


# ---------------------------------------------------------------------------
# string → string transforms
# ---------------------------------------------------------------------------

def _reg_transform(name, per_value, extra_types=(), aliases=()):
    """Register fn(string [, literals...]) -> string dictionary transform."""

    def impl(ctx, args, _f=per_value, _name=name):
        s = args[0]
        lits = [_require_literal(a, _name, f"#{i + 2}")
                for i, a in enumerate(args[1:])]
        return _transform_dict(
            s, lambda d: [None if v is None else _f(v, *lits) for v in d],
            _name)

    _register_transform(name, [dt.string] + list(extra_types), dt.string,
                        impl, aliases=aliases)


_reg_transform("upper", lambda v: v.upper())
_reg_transform("lower", lambda v: v.lower())
_reg_transform("initcap", lambda v: re.sub(
    r"(^|[^A-Za-z0-9])([a-z])", lambda m: m.group(1) + m.group(2).upper(),
    v.lower()))
_reg_transform("reverse", lambda v: v[::-1])
_reg_transform("ltrim", lambda v: v.lstrip(" "))
_reg_transform("rtrim", lambda v: v.rstrip(" "))
_reg_transform("btrim", lambda v: v.strip(" "), aliases=["trim"])
_reg_transform("ltrim", lambda v, chars: v.lstrip(chars),
               extra_types=[dt.string])
_reg_transform("rtrim", lambda v, chars: v.rstrip(chars),
               extra_types=[dt.string])
_reg_transform("btrim", lambda v, chars: v.strip(chars),
               extra_types=[dt.string], aliases=["trim"])


def _substr_1based(v, start, length=None):
    n = len(v)
    if start > 0:
        i = start - 1
    elif start < 0:
        i = max(0, n + start)
    else:
        i = 0
    if length is None:
        return v[i:]
    if length <= 0:
        return ""
    return v[i:i + length]


for _types, _fn in [
    ([dt.int64], lambda v, s: _substr_1based(v, s)),
    ([dt.int64, dt.int64], lambda v, s, l: _substr_1based(v, s, l)),
    ([dt.int32], lambda v, s: _substr_1based(v, s)),
    ([dt.int32, dt.int32], lambda v, s, l: _substr_1based(v, s, l)),
]:
    _reg_transform("substr", _fn, extra_types=_types,
                   aliases=["substring", "charSubstring"])

_reg_transform("left", lambda v, n: v[:n] if n > 0 else
               (v[:len(v) + n] if n < 0 else ""), extra_types=[dt.int32])
_reg_transform("right", lambda v, n: (v[-n:] if n > 0 else
               (v[-(len(v) + n):] if (len(v) + n) > 0 else "")) if n != 0
               else "", extra_types=[dt.int32])
_reg_transform("repeat", lambda v, n: v * max(0, n), extra_types=[dt.int32])
_reg_transform("lpad", lambda v, n: v[:n] if len(v) >= n else
               " " * (n - len(v)) + v, extra_types=[dt.int32])
_reg_transform("rpad", lambda v, n: v[:n] if len(v) >= n else
               v + " " * (n - len(v)), extra_types=[dt.int32])
_reg_transform("lpad", lambda v, n, p: v[:n] if len(v) >= n else
               ((p * n)[:n - len(v)] + v if p else v),
               extra_types=[dt.int32, dt.string])
_reg_transform("rpad", lambda v, n, p: v[:n] if len(v) >= n else
               (v + (p * n)[:n - len(v)] if p else v),
               extra_types=[dt.int32, dt.string])
_reg_transform("replace", lambda v, pat, rep: v.replace(pat, rep),
               extra_types=[dt.string, dt.string])
_reg_transform("regexp_replace", lambda v, pat, rep: re.sub(pat, rep, v),
               extra_types=[dt.string, dt.string])
_reg_transform("regexp_extract",
               lambda v, pat, g: (lambda m: m.group(g) if m else "")(
                   re.search(pat, v)),
               extra_types=[dt.string, dt.int32])
_reg_transform("split_part",
               lambda v, sep, n: (v.split(sep)[n - 1]
                                  if sep and 1 <= n <= len(v.split(sep))
                                  else ""),
               extra_types=[dt.string, dt.int32])
_reg_transform("translate",
               lambda v, frm, to: v.translate(
                   {ord(f): (to[i] if i < len(to) else None)
                    for i, f in enumerate(frm)}),
               extra_types=[dt.string, dt.string])
_reg_transform("castVARCHAR", lambda v, n: v[:n], extra_types=[dt.int64])
_reg_transform("castVARCHAR", lambda v, n: v[:n], extra_types=[dt.int32])


def _soundex(v):
    if not v:
        return ""
    codes = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
             **{c: "3" for c in "DT"}, "L": "4",
             **{c: "5" for c in "MN"}, "R": "6"}
    s = [c for c in v.upper() if c.isalpha()]
    if not s:
        return ""
    out = s[0]
    prev = codes.get(s[0], "")
    for c in s[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out += code
        if c not in "HW":
            prev = code
    return (out + "000")[:4]


_reg_transform("soundex", _soundex)

_reg_transform("base64", lambda v: _b64.b64encode(v.encode()).decode())
_reg_transform("unbase64", lambda v: _b64.b64decode(v).decode("utf-8",
                                                              "replace"))


def _row_values(batch, field_name: str, dict_thunk):
    """Per-row host strings of a dictionary-backed column: the column's
    device codes copied to the host (a sync) and indexed into the composed
    dictionary."""
    d = [_str_or(v) for v in _dict_list(dict_thunk(batch))]
    codes = batch.column(field_name).data[:batch.length].cpu().numpy()
    codes = np.clip(codes, 0, max(0, len(d) - 1))
    return [d[c] for c in codes]


def _concat_host(ctx, args):
    """concat(s1, s2)'s host side: a literal operand makes it a transform
    of the other's dictionary; two strings make the product dictionary,
    whose codes combine on the device (``a * len(b's dictionary) + b``).

    High-cardinality fallback (VERDICT r3 #5): when the product dictionary
    would exceed MAX_PRODUCT_DICT and both inputs trace back to direct
    columns (source_field — preserved through dictionary transforms), the
    batch's thunks switch to a per-ROW host concat + re-dictionarization:
    the result dictionary is bounded by the row count instead of the
    distinct-value cross product. The device graph carries both code
    formulas and selects by a per-batch flag table. Returns ([len(b's
    dictionary)] and, with the per-row route, [its flag, its per-row
    codes], the result's Val)."""
    a, b = args[0], args[1]
    # literal operands become single-entry dictionaries
    if a.is_literal and b.is_literal:
        raise ExpressionValidationError("concat of two literals unsupported")
    if a.is_literal:
        return [], _transform_dict(
            b, lambda d, _l=a.literal: [None if v is None else _l + v
                                        for v in d], "concat")
    if b.is_literal:
        return [], _transform_dict(
            a, lambda d, _l=b.literal: [None if v is None else v + _l
                                        for v in d], "concat")
    _require_dict(a, "concat")
    _require_dict(b, "concat")
    ta, tb = a.dict_thunk, b.dict_thunk
    can_row = a.source_field is not None and b.source_field is not None
    fa, fb = a.source_field, b.source_field

    def _use_row(batch, _ta=ta, _tb=tb):
        return can_row and len(_ta(batch)) * len(_tb(batch)) \
            > MAX_PRODUCT_DICT

    rows_of = {}    # this evaluation's per-row strings, built once

    def _rows(batch, _ta=ta, _tb=tb, _fa=fa, _fb=fb):
        if id(batch) not in rows_of:
            sa = _row_values(batch, _fa, _ta)
            sb = _row_values(batch, _fb, _tb)
            rows_of[id(batch)] = (batch, np.asarray(
                [x + y for x, y in zip(sa, sb)], dtype=object))
        return rows_of[id(batch)][1]

    def new_thunk(batch, _ta=ta, _tb=tb):
        import pyarrow as pa
        if _use_row(batch):
            uniq = np.unique(_rows(batch))
            return pa.array(uniq.tolist(), type=pa.string())
        da = [_str_or(v) for v in _dict_list(_ta(batch))]
        db = [_str_or(v) for v in _dict_list(_tb(batch))]
        if len(da) * len(db) > MAX_PRODUCT_DICT:
            raise ExpressionValidationError(
                f"concat: product dictionary too large "
                f"({len(da)}×{len(db)}) and inputs are not direct column "
                "references (row-level fallback unavailable)")
        return pa.array([x + y for x in da for y in db], type=pa.string())

    def nb_thunk(batch, _tb=tb):
        return np.array([len(_tb(batch))], dtype=np.int32)

    tables = [ctx.add_table(nb_thunk, cache_on_dicts=True)]
    if can_row:
        def flag_thunk(batch):
            return np.array([1 if _use_row(batch) else 0], dtype=np.int32)

        def row_codes_thunk(batch):
            if not _use_row(batch):
                return np.zeros(1, dtype=np.int32)
            rows = _rows(batch)
            uniq, inv = np.unique(rows, return_inverse=True)
            out = np.zeros(batch.capacity, dtype=np.int32)
            out[:len(inv)] = inv.astype(np.int32)
            return out

        tables += [ctx.add_table(flag_thunk, cache_on_dicts=True),
                   ctx.add_table(row_codes_thunk)]
    return tables, Val(None, None, dt.string, dict_thunk=new_thunk)


def _concat(ctx, args):
    tables, out = _concat_host(ctx, args)
    if not tables:                  # a literal operand: a transform
        return out
    a, b = args
    codes = a.value * tables[0][0] + b.value
    if len(tables) == 3:            # the per-row route, when it is taken
        use_row, rows_t = tables[1][0], tables[2]
        row_codes = rows_t.expand(ctx.capacity) if rows_t.shape[0] == 1 \
            else rows_t
        codes = torch.where(use_row > 0, row_codes, codes)
    if a.validity is None and b.validity is None:
        validity = None
    elif a.validity is None:
        validity = b.validity
    elif b.validity is None:
        validity = a.validity
    else:
        validity = a.validity & b.validity
    return Val(codes, validity, dt.string, dict_thunk=out.dict_thunk)


def _emit_concat(g, args, rt):
    """concat with a literal operand: a transform of the other operand's
    dictionary, whose codes pass on."""
    a, b = args
    return (b if a.is_literal else a).v


# two strings neither of which is a literal may take the per-row route
# (decided per batch, reading their codes back to the host): such a concat
# stays eager, and the product route with it
_emit_concat.eager_if = lambda lits: not any(lits)


_R.register("concat", [dt.string, dt.string], dt.string, _concat,
            aliases=["concatOperator", "||"], emit=_emit_concat,
            host=_concat_host)


# ---------------------------------------------------------------------------
# string → scalar
# ---------------------------------------------------------------------------

def _reg_scalar(name, ret, per_value, fill=0, extra_types=(), aliases=(),
                out_np=np.int32):
    def table(ctx, args, _f=per_value, _name=name):
        lits = [_require_literal(a, _name, f"#{i + 2}")
                for i, a in enumerate(args[1:])]
        return _table(
            ctx, args[0],
            lambda d: np.array([_f(_str_or(v), *lits) for v in d],
                               dtype=out_np),
            fill, _name)

    _register_lookup(name, [dt.string] + list(extra_types), ret, table,
                     out_np, aliases=aliases)


_reg_scalar("length", dt.int32, lambda v: len(v), aliases=["char_length",
                                                           "lengthUtf8"])
_reg_scalar("char_length", dt.int32, lambda v: len(v))
_reg_scalar("octet_length", dt.int32, lambda v: len(v.encode()))
_reg_scalar("bit_length", dt.int32, lambda v: 8 * len(v.encode()))
_reg_scalar("ascii", dt.int32, lambda v: ord(v[0]) if v else 0)
_reg_scalar("strpos", dt.int32, lambda v, sub: v.find(sub) + 1,
            extra_types=[dt.string], aliases=["position"])


def _locate_table(ctx, args):
    # locate(needle_literal, haystack[, start])
    needle = _require_literal(args[0], "locate", "#1")
    hay = args[1]
    start = 1
    if len(args) == 3:
        start = _require_literal(args[2], "locate", "#3")
    return _table(
        ctx, hay,
        lambda d: np.array([_str_or(v).find(needle, max(0, start - 1)) + 1
                            for v in d], dtype=np.int32),
        0, "locate")


_register_lookup("locate", [dt.string, dt.string], dt.int32, _locate_table,
                 np.int32, arg=1)
_register_lookup("locate", [dt.string, dt.string, dt.int32], dt.int32,
                 _locate_table, np.int32, arg=1)
_reg_scalar("levenshtein", dt.int32,
            lambda v, other: _levenshtein(v, other),
            extra_types=[dt.string])


def _levenshtein(a, b):
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# numeric casts from string
def _reg_cast_from_string(name, ret, conv, out_np):
    def per(d):
        out = np.zeros(len(d), dtype=out_np)
        for i, v in enumerate(d):
            try:
                out[i] = conv(v) if v is not None else 0
            except (ValueError, TypeError, OverflowError):
                out[i] = 0
        return out

    _register_lookup(name, [dt.string], ret,
                     lambda ctx, args: _table(ctx, args[0], per, 0, name),
                     out_np)


_reg_cast_from_string("castBIGINT", dt.int64, int, np.int64)
_reg_cast_from_string("castINT", dt.int32, int, np.int32)
_reg_cast_from_string("castFLOAT8", dt.float64, float, np.float64)
_reg_cast_from_string("castFLOAT4", dt.float32, float, np.float32)


# ---------------------------------------------------------------------------
# predicates (like / ilike / starts_with / ends_with / is_substr)
# ---------------------------------------------------------------------------

def sql_like_to_regex(pattern: str, escape: str = "\\") -> str:
    """Translate SQL LIKE pattern (%, _) into an anchored python regex —
    the holder compile step (reference: like_holder.cc builds RE2 from the
    pattern at Make time)."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def _reg_predicate(name, matcher_factory, extra_types=(dt.string,),
                   aliases=()):
    def table(ctx, args, _name=name):
        lits = [_require_literal(a, _name, f"#{i + 2}")
                for i, a in enumerate(args[1:])]
        match = matcher_factory(*lits)
        return _table(
            ctx, args[0],
            lambda d: np.array([bool(match(_str_or(v))) for v in d],
                               dtype=bool),
            False, _name)

    _register_lookup(name, [dt.string] + list(extra_types), dt.bool_, table,
                     bool, aliases=aliases)


def _reg_like(name, ignore_case, with_escape=False):
    """LIKE/ILIKE: native backtracking matcher over the dictionary when the
    host runtime is loaded (the LikeHolder analogue in C++), python regex
    fallback otherwise."""

    def table(ctx, args, _name=name):
        s = args[0]
        pat = _require_literal(args[1], _name, "#2")
        esc = _require_literal(args[2], _name, "#3") if with_escape else None
        _require_dict(s, _name)
        dthunk = s.dict_thunk

        def thunk(batch, _dt=dthunk, _pat=pat, _esc=esc):
            from .. import native

            d = _dt(batch)
            m = native.like_match(d, _pat, escape=_esc,
                                  ignore_case=ignore_case)
            if m is None:     # not a plain utf8 dictionary
                flags = re.DOTALL | (re.IGNORECASE if ignore_case else 0)
                rx = re.compile(sql_like_to_regex(_pat, _esc or "\\"), flags)
                m = np.array([bool(rx.fullmatch(_str_or(v)))
                              for v in _dict_list(d)], dtype=bool)
            return at_least_one(np.asarray(m, dtype=bool), False)

        return ctx.add_table(thunk, cache_on_dicts=True)

    types = [dt.string, dt.string] + ([dt.string] if with_escape else [])
    _register_lookup(name, types, dt.bool_, table, bool)


_reg_like("like", ignore_case=False)
_reg_like("like", ignore_case=False, with_escape=True)
_reg_like("ilike", ignore_case=True)
_reg_predicate("starts_with", lambda pre: lambda v: v.startswith(pre))
_reg_predicate("ends_with", lambda suf: lambda v: v.endswith(suf))
_reg_predicate("is_substr", lambda sub: lambda v: sub in v,
               aliases=["contains"])
_reg_predicate(
    "regexp_matches",
    lambda pat: re.compile(pat).search, aliases=["regexp_like"])


# ---------------------------------------------------------------------------
# string comparisons (rank-based)
# ---------------------------------------------------------------------------

def _rank_tables(ctx, a: Val, b: Val):
    """A string compare's host side: against a literal, one table of the
    compare's sign per distinct value of the column; between two columns,
    the rank of each one's values in their merged, sorted dictionary."""
    if a.is_literal or b.is_literal:
        col, lit = (b, a.literal) if a.is_literal else (a, b.literal)
        return [_table(
            ctx, col,
            lambda d: np.array(
                [0 if v is None else (-1 if v < lit else (1 if v > lit else 0))
                 for v in d], dtype=np.int8),
            0, "string compare")]
    _require_dict(a, "string compare")
    _require_dict(b, "string compare")
    ta, tb = a.dict_thunk, b.dict_thunk

    def rank_thunk(which):
        def thunk(batch, _ta=ta, _tb=tb, _w=which):
            da = [_str_or(v) for v in _dict_list(_ta(batch))]
            db = [_str_or(v) for v in _dict_list(_tb(batch))]
            merged = {v: i for i, v in enumerate(sorted(set(da) | set(db)))}
            src = da if _w == 0 else db
            return at_least_one(
                np.array([merged[v] for v in src], dtype=np.int32), 0)
        return thunk

    return [ctx.add_table(rank_thunk(0), cache_on_dicts=True),
            ctx.add_table(rank_thunk(1), cache_on_dicts=True)]


def _reg_string_cmp(name, op, c_op: str):
    def impl(ctx, args):
        a, b = args
        tables = _rank_tables(ctx, a, b)
        if len(tables) == 2:
            return op(gather_by_code(tables[0], a.value),
                      gather_by_code(tables[1], b.value))
        sign = gather_by_code(tables[0], (b if a.is_literal else a).value)
        if a.is_literal:
            sign = -sign
        return op(sign, torch.zeros_like(sign))

    def emit(g, args, rt):
        a, b = args
        if not (a.is_literal or b.is_literal):
            return (f"{g.table('int32_t', a.v)} {c_op} "
                    f"{g.table('int32_t', b.v)}")
        sign = g.table("int8_t", (b if a.is_literal else a).v)
        return f"{'-' if a.is_literal else ''}(int){sign} {c_op} 0"

    _R.register(name, [dt.string, dt.string], dt.bool_, impl, emit=emit,
                host=lambda ctx, args: (_rank_tables(ctx, *args), None))


_reg_string_cmp("equal", lambda a, b: a == b, "==")
_reg_string_cmp("not_equal", lambda a, b: a != b, "!=")
_reg_string_cmp("less_than", lambda a, b: a < b, "<")
_reg_string_cmp("less_than_or_equal_to", lambda a, b: a <= b, "<=")
_reg_string_cmp("greater_than", lambda a, b: a > b, ">")
_reg_string_cmp("greater_than_or_equal_to", lambda a, b: a >= b, ">=")


# ---------------------------------------------------------------------------
# hashes over strings (device-consistent with utils.hashing byte hashing)
# ---------------------------------------------------------------------------

def hash_bytes_np(values: List, seed: int = 0) -> np.ndarray:
    """FNV-1a 64-bit over utf-8 bytes — the Python form of the native
    ``gt_hash_bytes_many`` (bit-identical), for dictionaries that are not
    plain utf8."""
    out = np.zeros(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        h = np.uint64(0xCBF29CE484222325) ^ np.uint64(
            seed & 0xFFFF_FFFF_FFFF_FFFF)
        if v is not None:
            for byte in (v.encode() if isinstance(v, str) else v):
                h = np.uint64((int(h) ^ byte) * 0x100000001B3 % (1 << 64))
        out[i] = h
    return out


def _hash_table(ctx, args):
    """The string hashes' host side: the 64-bit hash of each distinct
    value."""
    s = args[0]
    seed = 0
    if len(args) == 2:
        seed = _require_literal(args[1], "hash", "#2") or 0
    _require_dict(s, "hash")
    dthunk = s.dict_thunk

    def thunk(batch, _dt=dthunk, _seed=seed):
        from .. import native

        d = _dt(batch)
        h = native.hash_bytes(d, _seed)
        if h is None:     # not a plain utf8 dictionary
            h = hash_bytes_np(_dict_list(d), _seed)
        return at_least_one(h.view(np.int64), 0)

    return ctx.add_table(thunk, cache_on_dicts=True)


def _register_string_hash(params, bits: int, aliases=()):
    def impl(ctx, args):
        t = gather_by_code(_hash_table(ctx, args), args[0].value)
        if bits == 32:
            t = t & 0xFFFFFFFF     # the low 32 bits as int32's bits
            return (t - ((t >> 31) << 32)).to(torch.int32)
        return t

    def emit(g, args, rt):
        h = g.table("int64_t", args[0].v)
        return f"(int32_t)(uint32_t)(uint64_t){h}" if bits == 32 else h

    _R.register(f"hash{bits}", params, dt.int32 if bits == 32 else dt.int64,
                impl, aliases=aliases, emit=emit,
                host=lambda ctx, args: ([_hash_table(ctx, args)], None))


_register_string_hash([dt.string], 32, aliases=["hash"])
_register_string_hash([dt.string], 64)
_register_string_hash([dt.string, dt.int32], 32)
_register_string_hash([dt.string, dt.int64], 64)


# ---------------------------------------------------------------------------
# castVARCHAR / castVARBINARY (numeric or decimal → string) — gandiva
# precompiled/string_ops.cc gdv_fn_castVARCHAR_int64_int64 etc. The output
# dictionary needs the values on the host: the port evaluates eagerly, so
# the argument's values, a column's or a computed subtree's alike, are
# already on the device; they are copied to the host once (a sync), their
# distinct bit patterns formatted, and the per-row codes uploaded. (The
# reference, which traces, re-dictionarizes a direct column reference
# through its own thunks and evaluates a computed subtree again with its
# own projector — its decomposer's prepass.)
# ---------------------------------------------------------------------------

def _fmt_numeric(v, src_t):
    if src_t.is_integer:
        return str(int(v))
    if src_t.kind is dt.TypeKind.FLOAT32:
        # shortest round-trip at f32 (python float(v) would print the f64
        # expansion of the f32 bit pattern)
        return np.format_float_positional(np.float32(v), unique=True,
                                          trim="-")
    # DOCUMENTED DIVERGENCE (the reference's, kept): float64 formats with
    # Python repr (shortest round-trip), so extreme/special values print
    # Python-style ('1e+300', 'nan', 'inf') where gandiva's
    # gdv_fn_castVARCHAR_float64 prints C++-style ('1.0E300', 'NaN',
    # 'Infinity'). Ordinary magnitudes match.
    return repr(float(v))


def _fmt_decimal(unscaled: int, scale: int) -> str:
    """Format a decimal128 unscaled int at the given scale (pure integer
    string math — no float, no context rounding)."""
    neg = unscaled < 0
    digits = str(abs(int(unscaled)))
    if scale <= 0:
        body = digits + "0" * (-scale)
    else:
        digits = digits.rjust(scale + 1, "0")
        body = digits[:-scale] + "." + digits[-scale:]
    return ("-" if neg else "") + body


def _distinct_formatted(a: Val):
    """(per-row int32 codes, formatted distinct values) of a numeric or
    decimal Val. Distinct by bit pattern, so -0.0 and 0.0 each print as
    themselves."""
    t = a.dtype
    if t.is_decimal:
        hi, lo = a.value
        pairs = torch.stack(torch.broadcast_tensors(hi, lo), -1)
        host = pairs.reshape(-1, 2).cpu().numpy()
        uniq, inv = np.unique(host, axis=0, return_inverse=True)
        strs = [_fmt_decimal((int(h) << 64) | (int(lw) & ((1 << 64) - 1)),
                             t.scale) for h, lw in uniq]
        return inv.reshape(hi.shape if hi.dim() else lo.shape), strs
    host = a.value.cpu().numpy()
    bits = host.view(f"i{host.itemsize}")
    uniq, inv = np.unique(bits.reshape(-1), return_inverse=True)
    return inv.reshape(host.shape), [_fmt_numeric(v, t)
                                     for v in uniq.view(host.dtype)]


def _cast_varchar_numeric_impl(out_dtype, fname: str):
    """castVARCHAR / castVARBINARY of a numeric or decimal value, with an
    optional maxlen literal. castVARBINARY formats the same digits and
    carries them as bytes (gandiva string_ops.cc gdv_fn_castVARBINARY_int64
    — same text, binary-tagged output)."""

    def impl(ctx, args):
        import pyarrow as pa

        a = args[0]
        maxlen = None
        if len(args) == 2:
            maxlen = int(_require_literal(args[1], fname, "#2"))
        inv, strs = _distinct_formatted(a)
        if maxlen is not None:
            strs = [s[:maxlen] for s in strs]
        if out_dtype.kind is dt.TypeKind.BINARY:
            dictionary = pa.array([s.encode() for s in strs],
                                  type=pa.binary())
        else:
            dictionary = pa.array(strs, type=pa.string())
        codes = ctx.add_table(lambda batch, _c=inv.astype(np.int32): _c)
        return Val(codes, a.validity, out_dtype,
                   dict_thunk=lambda batch, _d=dictionary: _d)

    return impl


_cast_varchar_numeric = _cast_varchar_numeric_impl(dt.string, "castVARCHAR")
_cast_varbinary_numeric = _cast_varchar_numeric_impl(dt.binary,
                                                     "castVARBINARY")

for _t in (dt.int32, dt.int64, dt.float32, dt.float64):
    _R.register("castVARCHAR", [_t], dt.string, _cast_varchar_numeric)
    _R.register("castVARCHAR", [_t, dt.int64], dt.string,
                _cast_varchar_numeric)
    _R.register("castVARBINARY", [_t, dt.int64], dt.binary,
                _cast_varbinary_numeric)


# ---------------------------------------------------------------------------
# castVARBINARY family (r5 — VERDICT r4 #8; gandiva string_ops.cc
# castVARBINARY_utf8 / castVARBINARY_binary: truncate to maxlen BYTES,
# re-tag as binary; 0 means unlimited)
# ---------------------------------------------------------------------------

def _cast_varbinary_bytes(ctx, args):
    a = args[0]
    maxlen = int(_require_literal(args[1], "castVARBINARY", "#2"))

    def f(d, _m=maxlen):
        out = []
        for v in d:
            if v is None:
                out.append(None)
                continue
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            out.append(b[:_m] if _m > 0 else b)
        return out

    return _transform_dict(a, f, "castVARBINARY", out_dtype=dt.binary)


_register_transform("castVARBINARY", [dt.string, dt.int64], dt.binary,
                    _cast_varbinary_bytes)
_register_transform("castVARBINARY", [dt.binary, dt.int64], dt.binary,
                    _cast_varbinary_bytes)
_register_transform("castBINARY", [dt.string], dt.binary,
            lambda ctx, args: _transform_dict(
                args[0],
                lambda d: [None if v is None else
                           (v.encode("utf-8") if isinstance(v, str)
                            else bytes(v)) for v in d],
                "castBINARY", out_dtype=dt.binary))


# ---------------------------------------------------------------------------
# cryptographic hashes (gandiva precompiled/hash.cc: hashSHA1/hashSHA256/
# hashMD5 return hex strings) — dictionary transforms, one digest per
# distinct value
# ---------------------------------------------------------------------------

def _reg_digest(name, algo):
    _reg_transform(name, lambda v, _a=algo: _hashlib.new(
        _a, v.encode()).hexdigest())


_reg_digest("hashSHA1", "sha1")
_reg_digest("hashSHA256", "sha256")
_reg_digest("hashMD5", "md5")


# ---------------------------------------------------------------------------
# hex codecs + codepoint constructors (gandiva string_ops.cc: to_hex,
# from_hex, chr, space)
# ---------------------------------------------------------------------------

_reg_transform("to_hex", lambda v: v.encode().hex().upper())


def _to_hex_binary(ctx, args):
    return _transform_dict(
        args[0],
        lambda d: [None if v is None else bytes(v).hex().upper() for v in d],
        "to_hex")


_register_transform("to_hex", [dt.binary], dt.string, _to_hex_binary)


# ---------------------------------------------------------------------------
# convert_fromUTF8 / convert_toUTF8 (gandiva function_registry_string.cc:
# Dremio's varbinary ⇄ varchar re-tagging; byte-preserving)
# ---------------------------------------------------------------------------

def _convert_from_utf8(ctx, args):
    def f(d):
        out = []
        for v in d:
            if v is None:
                out.append(None)
            else:
                try:
                    out.append(bytes(v).decode("utf-8"))
                except UnicodeDecodeError:
                    # gandiva raises an execution error on invalid UTF-8;
                    # NULL here (same divergence policy as from_hex)
                    out.append(None)
        return out

    return _transform_dict(args[0], f, "convert_fromUTF8",
                           out_dtype=dt.string)


def _convert_to_utf8(ctx, args):
    return _transform_dict(
        args[0],
        lambda d: [None if v is None else v.encode("utf-8") for v in d],
        "convert_toUTF8", out_dtype=dt.binary)


_register_transform("convert_fromUTF8", [dt.binary], dt.string,
                    _convert_from_utf8, aliases=["convert_fromutf8"])
_register_transform("convert_toUTF8", [dt.string], dt.binary,
                    _convert_to_utf8, aliases=["convert_toutf8"])


def _from_hex(ctx, args):
    def f(d):
        out = []
        for v in d:
            if v is None:
                out.append(None)
            else:
                try:
                    out.append(bytes.fromhex(v))
                except ValueError:
                    # gandiva raises an execution error on invalid hex; we
                    # map to NULL (documented divergence) — unlike b"", a
                    # null row is distinguishable from from_hex('')
                    out.append(None)
        return out

    return _transform_dict(args[0], f, "from_hex", out_dtype=dt.binary)


_register_transform("from_hex", [dt.string], dt.binary, _from_hex,
                    aliases=["unhex"])


def _chr_impl(ctx, args):
    # literal-only, as the reference's (a column of codepoints would be
    # castVARCHAR's route: its values copied to the host)
    n = _require_literal(args[0], "chr", "#1")
    # chr(n % 256) == bytes([n % 256]).decode('latin-1'): the string holds
    # codepoint n%256. Gandiva emits the single raw BYTE n%256; for 128-255
    # a UTF-8 re-encode of this string yields 2 bytes (documented divergence
    # — byte-exact round-trip requires latin-1 encoding downstream).
    return Val(None, None, dt.string, literal=chr(int(n) % 256),
               is_literal=True)


def _space_impl(ctx, args):
    n = _require_literal(args[0], "space", "#1")
    return Val(None, None, dt.string, literal=" " * max(0, int(n)),
               is_literal=True)


def _emit_literal_string(impl, fname: str):
    """chr / space: a literal string made at Make from a literal argument,
    code 0 of its one-entry dictionary in the kernel."""
    from ..compiler.codegen import CArg

    def emit(g, args, rt):
        if not args[0].is_literal:
            raise ExpressionValidationError(
                f"{fname}: argument #1 must be a literal")
        v = impl(None, [Val(None, None, args[0].dtype,
                            literal=args[0].literal, is_literal=True)])
        return CArg("((int32_t)0)", "true", rt, v.literal, True)

    emit.literal = True
    return emit


for _t in (dt.int32, dt.int64):
    for _name, _impl in (("chr", _chr_impl), ("space", _space_impl)):
        _R.register(_name, [_t], dt.string, _impl,
                    emit=_emit_literal_string(_impl, _name),
                    host=lambda ctx, args, _i=_impl: ([], _i(ctx, args)))
