"""The port's string and binary registry (registry/string_ops.py), its
native host runtime (native/) and the string plans against gandiva_tpu on
the CPU: every string and binary signature, aliases included, one case
each over the same codes and dictionaries (carried across by
``from_columns_numpy``), integer, boolean and float results bit for bit and
strings by value; LIKE's wildcards, escapes and multi-byte characters; the
native LIKE and hash routes against the regex and ``hash_bytes_np`` routes;
concat's two routes; castVARCHAR over computed values with nulls; the
per-plan table memo; the bitmap codec; and the TPC-H string scans against
pyarrow's re-evaluation of the same predicates."""
import base64
import itertools
import re
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu.registry import string_ops as g_so
from gandiva_tpu_torch import entrypoints as t_entry
from gandiva_tpu_torch import native
from gandiva_tpu_torch.registry import string_ops as t_so

from chip_smoke import STRING_LITERALS as LITERALS, STRING_TWO_COLUMNS
from torch_differential import (CPU, assert_same_column, batches, column,
                                decoded, dtype_of, text_column)

N = 600

# distinct values: multi-byte UTF-8, empty and padded strings, numbers,
# dates, hex and LIKE's own wildcard characters among them
WORDS = ["apple", "Banana", "café", "日本語テキスト", "", "  padded  ",
         "a_b%c", "ab\\cd", "x", "kitten", "sitting", "hello world", "HELLO",
         "naïve façade", "ab ab ab", "42", "-7", "3.5", "1e10", "nan",
         "notanum", " 12 ", "9223372036854775807", "99999999999999999999",
         "2020-03-01", "6172726F77", "00ff", "zz", "€100", "tab\there",
         "ÄÖÜ äöü", "abc123def", "Ω≈ç√", "mañana", "a", "ab", "ba"]
BYTES = [b"hi", "café".encode(), b"", b"\xff\xfe", b"\x00\x01", b"abc",
         b"ab\x80", "日本".encode()]
def _string_signatures(p):
    reg = p.global_registry()
    out = set()
    for s in p.get_registered_function_signatures():
        fn = reg.lookup(s.name, s.param_types)
        if fn.impl.__module__.endswith("registry.string_ops"):
            out.add((s.name, tuple(map(str, s.param_types)),
                     str(s.return_type)))
    return sorted(out)


SIGNATURES = _string_signatures(gt)


def test_signatures_are_the_reference_ones():
    assert SIGNATURES == _string_signatures(g)
    assert len(SIGNATURES) == 125


def _literal(p, v, t):
    """A literal of package ``p``: a string, or ``v`` of type ``t``."""
    B = p.TreeExprBuilder
    if isinstance(v, str):
        return B.make_string_literal(v)
    return B.make_literal(v, dtype_of(p, t))


def _case(sig, rng):
    """(columns, make_exprs) of one signature's case: the first argument a
    column, the later ones literals (chip_smoke.py phase 20's), but two
    columns for the comparisons and concat, and chr/space (literal-only)
    concatenated to a column."""
    name, params, ret = sig
    cols, lits = {}, LITERALS.get(name, [])
    if name in STRING_TWO_COLUMNS:
        cols["a0"] = ("string", *text_column("string", rng, N, WORDS))
        cols["a1"] = ("string", *text_column("string", rng, N,
                                             WORDS[::-1][:20] + ["zzz"]))
    elif name in ("chr", "space"):
        cols["a0"] = ("string", *text_column("string", rng, N, WORDS))
    elif name == "locate":
        cols["a1"] = ("string", *text_column("string", rng, N, WORDS))
    elif params[0] in ("string", "binary"):
        values = WORDS if params[0] == "string" else BYTES
        if name == "unbase64":
            values = [base64.b64encode(w.encode()).decode() for w in WORDS]
        cols["a0"] = (params[0], *text_column(params[0], rng, N, values))
    else:
        cols["a0"] = (params[0], *column(params[0], rng, N))

    def exprs(p, schema):
        B, dt = p.TreeExprBuilder, p.dtypes
        if name in ("chr", "space"):
            inner = B.make_function(name, [_literal(
                p, 65 if name == "chr" else 3, params[0])], dt.string)
            node = B.make_function("concat", [B.make_field(
                schema.field("a0")), inner], dt.string)
        elif name == "locate":
            args = [B.make_string_literal("ab"),
                    B.make_field(schema.field("a1"))]
            if len(params) == 3:
                args.append(_literal(p, 2, "int32"))
            node = B.make_function(name, args, dtype_of(p, ret))
        else:
            names = {f.name for f in schema}
            args = [B.make_field(schema.field(f"a{i}"))
                    for i in range(len(params)) if f"a{i}" in names]
            for i, t in enumerate(params[len(args):]):
                args.append(_literal(p, lits[i], t))
            node = B.make_function(name, args, dtype_of(p, ret))
        return [B.make_expression(node, dt.Field("out", node.dtype))]

    return cols, exprs


def _project_both(make_exprs, cols, n=N):
    """Both packages' Projector over the same columns → (reference output
    column, port output column)."""
    ref_b, port_b = batches(cols, n)
    outs = []
    for p, b in ((g, ref_b), (gt, port_b)):
        schema = p.dtypes.Schema([p.dtypes.Field(k, dtype_of(p, c[0]))
                                  for k, c in cols.items()])
        kw = {"device": CPU} if p is gt else {}
        proj = p.make_projector(schema, make_exprs(p, schema),
                                use_cache=False, **kw)
        outs.append(proj.evaluate_device(b).column("out"))
    return outs


def _zero_rows(cols):
    """The rows of a float column that hold ±0.0, when -0.0 is among
    them."""
    data = cols["a0"][1] if "a0" in cols else np.zeros(0, bool)
    if data.dtype.kind != "f" or not np.signbit(data[data == 0]).any():
        return np.array([], dtype=np.int64)
    return np.flatnonzero(data == 0)


@pytest.mark.parametrize("sig", SIGNATURES,
                         ids=[f"{n}({','.join(p)})" for n, p, _ in
                              SIGNATURES])
def test_signature_matches_reference(sig):
    rng = np.random.default_rng(zlib.crc32(repr(sig).encode()))
    cols, exprs = _case(sig, rng)
    ref, port = _project_both(exprs, cols)
    zeros = _zero_rows(cols)
    if not zeros.size:
        assert_same_column(ref, port, repr(sig))
        return
    # castVARCHAR/castVARBINARY of floats: the reference shares one code
    # between -0.0 and 0.0 (np.unique by value), so one of them prints the
    # other's text; the port prints each row's own. Off those rows the two
    # agree; on them the port holds the reference's formatting of the row.
    name, params, _ = sig
    got, want = decoded(port), decoded(ref)
    keep = np.setdiff1d(np.arange(N), zeros)
    assert [got[i] for i in keep] == [want[i] for i in keep]
    maxlen = LITERALS[name][0] if len(params) == 2 else None
    t = dtype_of(gt, params[0])
    for i in zeros:
        if cols["a0"][2][i]:
            v = got[i].decode() if isinstance(got[i], bytes) else got[i]
            assert v == t_so._fmt_numeric(cols["a0"][1][i], t)[:maxlen]


@pytest.mark.parametrize("t,maxlen", [("decimal128(10,2)", None),
                                      ("decimal128(38,10)", None),
                                      ("decimal128(18,4)", 6),
                                      ("decimal128(1,0)", 3)])
def test_cast_varchar_decimal_matches_reference(t, maxlen):
    rng = np.random.default_rng(len(t) + (maxlen or 0))
    cols = {"a0": (t, *column(t, rng, N))}

    def exprs(p, schema):
        B = p.TreeExprBuilder
        args = [B.make_field(schema.field("a0"))]
        if maxlen is not None:
            args.append(B.make_int64_literal(maxlen))
        node = B.make_function("castVARCHAR", args, p.dtypes.string)
        return [B.make_expression(node, p.dtypes.Field("out", node.dtype))]

    ref, port = _project_both(exprs, cols)
    assert_same_column(ref, port, t)


# ---------------------------------------------------------------------------
# LIKE
# ---------------------------------------------------------------------------

LIKE_VALUES = ["cat", "cut", "c_t", "coat", "c%t", "ct", "", "cät", "c日t",
               "日本語", "日x語", "%", "_", "a\\b", "ABC", "abc", "aBc",
               "c\\_t", "ccccct", "xyz%", "ÄÖÜ", "äöü"]


@pytest.mark.parametrize("fn,pattern,escape", [
    ("like", "c_t", None), ("like", "c%t", None), ("like", "%", None),
    ("like", "", None), ("like", "_", None), ("like", "%_%", None),
    ("like", "c\\_t", "\\"), ("like", "c\\%t", "\\"), ("like", "%!%", "!"),
    ("like", "日_語", None), ("like", "%語", None), ("like", "c_t%", None),
    ("like", "%c%%t", None), ("like", "a\\\\b", "\\"),
    ("ilike", "abc", None), ("ilike", "%B%", None), ("ilike", "äöü", None),
    ("ilike", "_bc", None)])
def test_like_patterns(fn, pattern, escape):
    """LIKE / ILIKE through Filter in both packages, and against a regex of
    the same pattern in Python (ILIKE folds ASCII only, as the native
    matcher does)."""
    rng = np.random.default_rng(len(pattern))
    cols = {"s": ("string", *text_column("string", rng, 200, LIKE_VALUES))}
    ref_b, port_b = batches(cols, 200)
    sels = []
    for p, b in ((g, ref_b), (gt, port_b)):
        B, dt = p.TreeExprBuilder, p.dtypes
        f = dt.Field("s", dt.string)
        args = [B.make_field(f), B.make_string_literal(pattern)]
        if escape is not None:
            args.append(B.make_string_literal(escape))
        cond = B.make_condition(B.make_function(fn, args, dt.bool_))
        kw = {"device": CPU} if p is gt else {}
        sels.append(p.make_filter(dt.Schema([f]), cond, use_cache=False,
                                  **kw).evaluate(b).to_numpy())
    np.testing.assert_array_equal(sels[1], sels[0])
    rx = re.compile(t_so.sql_like_to_regex(pattern, escape or ""),
                    re.DOTALL)
    values = decoded(port_b.column("s"))

    def fold(v):
        return re.sub("[A-Z]", lambda m: m.group(0).lower(), v)

    want = [i for i, v in enumerate(values) if v is not None and (
        rx.fullmatch(v) if fn == "like" else
        re.fullmatch(t_so.sql_like_to_regex(fold(pattern), ""), fold(v),
                     re.DOTALL))]
    np.testing.assert_array_equal(sels[1], want)


def _random_strings(rng, n):
    alphabet = list("ab_%c\\") + ["é", "日", "語", " "]
    return [None if rng.random() < 0.05 else
            "".join(rng.choice(alphabet, rng.integers(0, 8)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_native_like_equals_regex_route(seed):
    """The native matcher and the regex route (what a non-utf8 dictionary
    takes) agree on random strings and patterns over %, _, an escape and
    multi-byte characters."""
    rng = np.random.default_rng(seed)
    values = _random_strings(rng, 400)
    arr = pa.array(values, type=pa.string())
    large = arr.cast(pa.large_string())
    assert native.like_match(large, "%") is None     # the declined layout
    for pattern in _random_strings(rng, 60):
        pattern = pattern or "%"
        for escape in (None, "\\"):
            got = native.like_match(arr, pattern, escape=escape)
            rx = re.compile(t_so.sql_like_to_regex(pattern, escape or ""),
                            re.DOTALL)
            want = [bool(rx.fullmatch(v or "")) for v in values]
            assert got.tolist() == want, (pattern, escape)


def test_native_hash_equals_hash_bytes_np():
    """gt_hash_bytes_many against the Python FNV-1a-64: nulls, empty and
    multi-byte strings, raw bytes that are not UTF-8, several seeds; and
    the reference's own hash_bytes_np."""
    rng = np.random.default_rng(3)
    values = _random_strings(rng, 300) + ["", None, "日本語", "x" * 300]
    for seed in (0, 1, 7, 2 ** 40 + 3):
        got = native.hash_bytes(pa.array(values, type=pa.string()), seed)
        np.testing.assert_array_equal(got, t_so.hash_bytes_np(values, seed))
        np.testing.assert_array_equal(got, g_so.hash_bytes_np(values, seed))
    # a negative seed is its two's complement bits (the reference's
    # np.uint64(seed) raises for one)
    np.testing.assert_array_equal(
        native.hash_bytes(pa.array(values, type=pa.string()), -5),
        t_so.hash_bytes_np(values, 2 ** 64 - 5))
    raw = [b"\xff\xfe", b"", b"\x00\x01\x80", "é".encode()]
    offsets = np.cumsum([0] + [len(b) for b in raw]).astype(np.int32)
    arr = pa.Array.from_buffers(pa.string(), len(raw), [
        None, pa.py_buffer(offsets.tobytes()), pa.py_buffer(b"".join(raw))])
    np.testing.assert_array_equal(native.hash_bytes(arr, 5),
                                  t_so.hash_bytes_np(raw, 5))


def test_string_hash_takes_the_declined_layout_route():
    """hash64 over a large_string column (its dictionary is not plain
    utf8) equals hash64 over the same values as string."""
    vals = ["a", "日本", None, "", "a"]
    outs = []
    for typ in (pa.string(), pa.large_string()):
        batch = pa.RecordBatch.from_arrays([pa.array(vals, type=typ)],
                                           names=["s"])
        f = gt.dtypes.Field("s", gt.dtypes.string)
        B = gt.TreeExprBuilder
        expr = B.make_expression(B.make_function(
            "hash64", [B.make_field(f)], gt.dtypes.int64),
            gt.dtypes.Field("h", gt.dtypes.int64))
        (h,) = gt.make_projector(gt.dtypes.Schema([f]), [expr],
                                 use_cache=False, device=CPU).evaluate(batch)
        outs.append(h.to_pylist())
    assert outs[0] == outs[1]
    assert outs[0][0] == outs[0][4] and outs[0][2] is None


# ---------------------------------------------------------------------------
# concat's two routes, castVARCHAR over computed values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1 << 20, 64])
@pytest.mark.parametrize("upper", [False, True])
def test_concat_routes(monkeypatch, cap, upper):
    """concat of two columns on the product-dictionary route and, with
    MAX_PRODUCT_DICT lowered in both packages, on the per-row route (also
    through a dictionary transform), against the reference and Python."""
    monkeypatch.setattr(t_so, "MAX_PRODUCT_DICT", cap)
    monkeypatch.setattr(g_so, "MAX_PRODUCT_DICT", cap)
    rng = np.random.default_rng(cap + upper)
    cols = {"a": ("string", *text_column("string", rng, N, WORDS)),
            "b": ("string", *text_column("string", rng, N,
                                         [f"v{i}" for i in range(40)]))}

    def exprs(p, schema):
        B, dt = p.TreeExprBuilder, p.dtypes
        a = B.make_field(schema.field("a"))
        if upper:
            a = B.make_function("upper", [a], dt.string)
        node = B.make_function("concat", [a, B.make_field(schema.field(
            "b"))], dt.string)
        return [B.make_expression(node, dt.Field("out", dt.string))]

    ref, port = _project_both(exprs, cols)
    assert_same_column(ref, port, "concat")
    a, b = (decoded(gt.from_columns_numpy({k: cols[k]}, N, device=CPU)
                    .column(k)) for k in "ab")
    want = [None if x is None or y is None else
            (x.upper() if upper else x) + y for x, y in zip(a, b)]
    assert decoded(port) == want
    # the per-row route's dictionary is bounded by the rows, the product
    # route's is the cross product
    n_dict = len(port.dictionary)
    assert n_dict <= N if cap == 64 else n_dict == len(WORDS) * 40


@pytest.mark.parametrize("src", ["int64", "float64", "int32",
                                 "decimal128(12,3)"])
def test_cast_varchar_computed_value_with_nulls(src):
    """castVARCHAR over a computed value (the reference's prepass; the
    port formats the evaluated tensor) with 5% nulls, against the
    reference and Python's formatting."""
    rng = np.random.default_rng(len(src))
    cols = {"a": (src, *column(src, rng, N)), "b": (src, *column(src, rng,
                                                                 N))}

    def exprs(p, schema):
        B, dt = p.TreeExprBuilder, p.dtypes
        t = dtype_of(p, src)
        name = "subtract" if t.is_decimal else "add"
        if t.is_decimal:
            from importlib import import_module
            dec = import_module(f"{p.__name__}.registry.decimal_ops")
            dec.ensure_registered([t, t])
            t = dec.result_type(name, t, t)
        node = B.make_function(name, [B.make_field(schema.field("a")),
                                      B.make_field(schema.field("b"))], t)
        cast = B.make_function("castVARCHAR", [node], dt.string)
        return [B.make_expression(cast, dt.Field("out", dt.string))]

    ref, port = _project_both(exprs, cols)
    valid = cols["a"][2] & cols["b"][2]
    np.testing.assert_array_equal(port.validity.numpy(), valid)
    assert decoded(port) == decoded(ref)


# ---------------------------------------------------------------------------
# the per-plan table memo, the distinct-ratio counter
# ---------------------------------------------------------------------------

def _like_filter():
    f = gt.dtypes.Field("s", gt.dtypes.string)
    B = gt.TreeExprBuilder
    cond = B.make_condition(B.make_function(
        "like", [B.make_field(f), B.make_string_literal("%a%")],
        gt.dtypes.bool_))
    return gt.make_filter(gt.dtypes.Schema([f]), cond, use_cache=False,
                          device=CPU)


def test_table_memo_keys_on_dictionary_identity():
    """A LIKE table is built once while the dictionary object and the
    capacity stay; an equal dictionary that is another object, or another
    capacity, rebuilds it; the codes may change freely."""
    filt = _like_filter()
    words = pa.array(["banana", "kiwi", "pear", "fig"])
    rng = np.random.default_rng(0)

    def batch(n, dictionary):
        codes = rng.integers(0, 4, n).astype(np.int32)
        return gt.from_columns_numpy({"s": ("string", codes,
                                            np.ones(n, bool), None,
                                            dictionary)}, n, device=CPU)

    builds = []
    for b in [batch(100, words) for _ in range(5)]:
        sel = filt.evaluate(b)
        want = np.flatnonzero(np.isin(b.column("s").data.numpy(), [0, 2]))
        np.testing.assert_array_equal(sel.to_numpy(), want)
        builds.append(filt.stats["table_builds"])
    assert builds == [1] * 5
    filt.evaluate(batch(100, pa.array(words.to_pylist())))  # equal, new
    filt.evaluate(batch(101, words))                         # new capacity
    assert filt.stats["table_builds"] == 3


def test_dict_distinct_ratio_counter():
    """The worst distinct/row ratio seen (the string cliff's signal)."""
    f = gt.dtypes.Field("s", gt.dtypes.string)
    B = gt.TreeExprBuilder
    expr = B.make_expression(B.make_function("upper", [B.make_field(f)],
                                             gt.dtypes.string),
                             gt.dtypes.Field("u", gt.dtypes.string))
    proj = gt.make_projector(gt.dtypes.Schema([f]), [expr], use_cache=False,
                             device=CPU)
    for distinct, rows in ((16, 4096), (4096, 4096), (8, 4096)):
        vals = [f"value_{i % distinct:06d}" for i in range(rows)]
        (r,) = proj.evaluate(pa.RecordBatch.from_arrays([pa.array(vals)],
                                                        names=["s"]))
        assert r.to_pylist() == [v.upper() for v in vals]
    assert proj.stats["dict_distinct_ratio"] == 1.0


def test_stream_fn_refuses_a_string_plan():
    filt = _like_filter()
    fp = gt.make_filter_project(filt.schema, filt.condition, [],
                                use_cache=False, device=CPU)
    run = fp.stream_fn()
    codes = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="host tables"):
        run({"s": (codes, torch.ones((2, 8), dtype=torch.bool))})


def test_filter_project_string_outputs_equal_filter_then_projector():
    """A string output of FilterProject (its codes one K1 payload) equals
    Filter + Projector(selection), and keeps the input's dictionary."""
    rng = np.random.default_rng(11)
    cols = {"s": ("string", *text_column("string", rng, N, WORDS)),
            "t": ("string", *text_column("string", rng, N, WORDS[:9]))}
    _, b = batches(cols, N)
    dt, B = gt.dtypes, gt.TreeExprBuilder
    schema = dt.Schema([dt.Field("s", dt.string), dt.Field("t", dt.string)])
    ns, nt = (B.make_field(f) for f in schema)
    cond = B.make_condition(B.make_function(
        "less_than", [ns, nt], dt.bool_))
    exprs = [B.make_expression(nt, dt.Field("t", dt.string)),
             B.make_expression(B.make_function("lower", [ns], dt.string),
                               dt.Field("ls", dt.string))]
    sel, out = gt.make_filter_project(schema, cond, exprs, use_cache=False,
                                      device=CPU).evaluate_device(b)
    fsel = gt.make_filter(schema, cond, use_cache=False,
                          device=CPU).evaluate(b)
    proj = gt.make_projector(schema, exprs, gt.SelectionMode.UINT32,
                             use_cache=False, device=CPU)
    want = proj.evaluate_device(b, fsel)
    np.testing.assert_array_equal(sel.to_numpy(), fsel.to_numpy())
    assert out.column("t").dictionary is b.column("t").dictionary
    for name in ("t", "ls"):
        assert decoded(out.column(name).slice(0, out.length)) == \
            decoded(want.column(name).slice(0, want.length))


# ---------------------------------------------------------------------------
# the native runtime's bitmap codec and pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,offset", [(0, 0), (1, 0), (8, 0), (37, 3),
                                      (1000, 7), (4096, 13)])
def test_bitmaps_match_numpy(n, offset):
    rng = np.random.default_rng(n + offset)
    bools = rng.random(n + offset) < 0.6
    packed = native.pack_bitmap(bools)
    np.testing.assert_array_equal(packed,
                                  np.packbits(bools, bitorder="little"))
    arr = pa.array(np.where(bools, 1, 0), mask=~bools)[offset:]
    got = native.unpack_bitmap(arr.buffers()[0], arr.offset, len(arr))
    np.testing.assert_array_equal(got, bools[offset:])
    np.testing.assert_array_equal(native.unpack_bitmap(None, 0, n),
                                  np.ones(n, bool))


def test_memory_pool_accounts():
    pool = native.MemoryPool()
    a = pool.allocate(100)
    b = pool.allocate(1000, alignment=128)
    assert a.ctypes.data % 64 == 0 and b.ctypes.data % 128 == 0
    assert pool.bytes_allocated == 128 + 1024 and pool.num_allocations == 2
    pool.free(a)
    assert pool.bytes_allocated == 1024 and pool.peak_bytes == 128 + 1024
    assert native.available() and native.default_pool() is \
        native.default_pool()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a library that cannot be built raises."""
    from gandiva_tpu_torch.ops.kernels import build

    monkeypatch.setattr(native, "_SRC", tmp_path / "missing.cpp")
    (tmp_path / "missing.cpp").write_text("this is not C++")
    monkeypatch.setattr(build, "RUNTIME_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not native.available()


# ---------------------------------------------------------------------------
# the slice as a whole: the TPC-H string scans against pyarrow
# ---------------------------------------------------------------------------

def _arrow_date(days):
    return pa.scalar(days, pa.int32()).cast(pa.date32())


def _lineitem_oracle(arrow, query):
    c = {k: arrow.column(k) for k in arrow.schema.names}
    if query == "Q1":
        return pc.less_equal(c["l_shipdate"], _arrow_date(
            t_entry.Q1_SHIPDATE - t_entry.Q1_DELTA))
    if query == "Q12":
        return pc.and_(pc.and_(pc.and_(
            pc.is_in(c["l_shipmode"], value_set=pa.array(["MAIL", "SHIP"])),
            pc.less(c["l_commitdate"], c["l_receiptdate"])),
            pc.less(c["l_shipdate"], c["l_commitdate"])), pc.and_(
            pc.greater_equal(c["l_receiptdate"],
                             _arrow_date(t_entry.Q12_FROM)),
            pc.less(c["l_receiptdate"], _arrow_date(t_entry.Q12_TO))))
    q = pc.cast(c["l_quantity"], pa.float64())

    def between(lo, hi):
        return pc.and_(pc.greater_equal(q, lo), pc.less_equal(q, hi))

    return pc.and_(pc.and_(
        pc.is_in(c["l_shipmode"], value_set=pa.array(["AIR", "AIR REG"])),
        pc.equal(c["l_shipinstruct"], "DELIVER IN PERSON")),
        pc.or_(pc.or_(between(1, 11), between(10, 20)), between(20, 30)))


@pytest.mark.parametrize("query", ["Q1", "Q12", "Q19"])
def test_lineitem_string_scans_against_pyarrow(query):
    n = 5000
    batch = t_entry.lineitem(n, seed=4, device=CPU)
    plan = {"Q1": t_entry.tpch_q1_scan, "Q12": t_entry.tpch_q12_scan,
            "Q19": t_entry.tpch_q19_scan}[query](CPU)
    arrow = gt.to_arrow(batch)
    keep = _lineitem_oracle(arrow, query)
    sel, outs = plan.evaluate(batch)
    np.testing.assert_array_equal(
        sel.to_numpy(), np.flatnonzero(keep.to_numpy(zero_copy_only=False)))
    assert len(sel.to_numpy()) > 0
    want = pc.filter(arrow, keep)
    for e, got in zip(plan.exprs, outs):
        name = e.result_field.name
        if name in arrow.schema.names:
            assert got.equals(want.column(name)), name
    # the memo holds across calls on the fixed dictionaries
    builds = plan.stats.get("table_builds", 0)
    plan.evaluate_device(t_entry.lineitem(n, seed=5, device=CPU))
    assert plan.stats.get("table_builds", 0) == builds


def test_lineitem_string_columns_follow_the_spec():
    b = t_entry.lineitem(20000, seed=2, device=CPU)
    c = {k: b.column(k).data.long() for k in b.columns}
    assert bool(((c["l_commitdate"] - c["l_shipdate"]) < 90).all())
    recv = c["l_receiptdate"] - c["l_shipdate"]
    assert int(recv.min()) == 1 and int(recv.max()) == 30
    flag = np.array(t_entry.L_RETURNFLAG.to_pylist())[c["l_returnflag"]]
    late = (c["l_receiptdate"] > t_entry.CURRENTDATE).numpy()
    assert set(flag[late]) == {"N"} and set(flag[~late]) == {"R", "A"}
    status = np.array(t_entry.L_LINESTATUS.to_pylist())[c["l_linestatus"]]
    open_ = (c["l_shipdate"] > t_entry.CURRENTDATE).numpy()
    assert set(status[open_]) == {"O"} and set(status[~open_]) == {"F"}
    assert b.column("l_shipmode").dictionary is t_entry.L_SHIPMODE
    # Q1's and Q6's columns are drawn first, in the order they were drawn
    # before the new columns came
    gen = torch.Generator()
    gen.manual_seed(2)

    def uniform(lo, hi):
        return torch.randint(lo, hi + 1, (20000,), generator=gen,
                             dtype=torch.int64)

    qty, _, disc, tax = (uniform(1, 50), uniform(1, 2_000_000),
                         uniform(0, 10), uniform(0, 8))
    ship = uniform(t_entry.ORDERDATE_FIRST, t_entry.ORDERDATE_LAST) \
        + uniform(1, 121)
    for name, want in (("l_quantity", qty * 100), ("l_discount", disc),
                       ("l_tax", tax), ("l_shipdate", ship)):
        assert torch.equal(c[name], want), name


@pytest.mark.parametrize("query", ["Q9", "Q16"])
def test_part_scans_against_pyarrow(query):
    n = 3000
    arrow = t_entry.part_arrow(n, seed=6)
    batch = t_entry.part(n, seed=6, device=CPU)
    names = arrow.column("p_name").to_pylist()
    assert all(len(set(v.split())) == 5 for v in names)
    assert set(arrow.column("p_type").to_pylist()) <= {
        " ".join(t) for t in itertools.product(*t_entry.P_TYPE_SYLLABLES)}
    c = {k: arrow.column(k) for k in arrow.schema.names}
    if query == "Q9":
        plan = t_entry.tpch_q9_part_scan(CPU)
        keep = pc.match_like(c["p_name"], "%green%")
    else:
        plan = t_entry.tpch_q16_part_scan(CPU)
        keep = pc.and_(pc.and_(
            pc.not_equal(c["p_brand"], "Brand#45"),
            pc.invert(pc.match_like(c["p_type"], "MEDIUM POLISHED%"))),
            pc.is_in(c["p_size"], value_set=pa.array(
                t_entry.Q16_SIZES, type=pa.int32())))
    for b in (batch, arrow):     # device batch and the Arrow entry point
        sel, outs = plan.evaluate(b)
        np.testing.assert_array_equal(
            sel.to_numpy(), np.flatnonzero(keep.to_numpy(
                zero_copy_only=False)))
        want = pc.filter(arrow, keep)
        for e, got in zip(plan.exprs, outs):
            assert got.equals(want.column(e.result_field.name))
    assert plan.stats["dict_distinct_ratio"] > 0.9     # p_name, near-unique


@pytest.mark.parametrize("values", [[None, None, None], [], ["", None]],
                         ids=["all-null", "empty", "empty-string"])
def test_all_null_and_empty_dictionaries(values):
    """An all-null column (its dictionary empty: every table is one fill
    entry long and every code clips into it), no rows at all, and the
    empty string: the same results as the reference through the Arrow
    entry point, for a transform, a scalar table, LIKE, a hash, a
    comparison of two columns and IN."""
    batch = pa.RecordBatch.from_arrays(
        [pa.array(values, type=pa.string()),
         pa.array(values[::-1], type=pa.string())], names=["s", "t"])
    results = []
    for p in (g, gt):
        B, dt = p.TreeExprBuilder, p.dtypes
        schema = dt.Schema([dt.Field("s", dt.string),
                            dt.Field("t", dt.string)])
        s, t = (B.make_field(f) for f in schema)
        nodes = [B.make_function("upper", [s], dt.string),
                 B.make_function("length", [s], dt.int32),
                 B.make_function("like", [s, B.make_string_literal("%")],
                                 dt.bool_),
                 B.make_function("hash64", [s], dt.int64),
                 B.make_function("less_than", [s, t], dt.bool_),
                 B.make_function("concat", [s, t], dt.string),
                 B.make_in_expression_string(s, ["", "x"])]
        exprs = [B.make_expression(n, dt.Field(f"o{i}", n.dtype))
                 for i, n in enumerate(nodes)]
        kw = {"device": CPU} if p is gt else {}
        outs = p.make_projector(schema, exprs, use_cache=False,
                                **kw).evaluate(batch)
        results.append([o.to_pylist() for o in outs])
    assert results[1] == results[0]
