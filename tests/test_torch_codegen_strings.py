"""Strings and binaries inside the plan compiler's generated kernel, on the
CPU: the generated source built for the host with g++ (``jit.host_build``)
and held bit for bit against gandiva_tpu (JAX on the CPU with x64) on
dictionary columns made from a numpy seed, with nulls, and with empty
dictionaries (every row null).

A compiled string node reads its host tables in the kernel, at the row's
code clamped into the table: every string and binary signature with an
emitter (all but castVARCHAR / castVARBINARY of a number or a decimal),
if/else of strings, IN over strings, concat's routes; the TPC-H
string scans (Q9, Q12, Q16, Q19 and Q22) as one kernel with nothing eager,
against the reference and pyarrow.compute; the plan's table memo keyed by
the node, over two dictionaries on both routes; and the 256-bit decimal
multiply against the reference's ``int128.mul256_div_pow10``. Strings are
compared by their decoded values, everything else by its bits."""
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax.numpy as jnp

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu.utils import int128 as g_int128
from gandiva_tpu_torch import entrypoints as t_entry
from gandiva_tpu_torch.compiler import jit
from gandiva_tpu_torch.registry import decimal_ops as t_dec

from chip_smoke import STRING_LITERALS, string_scan_arrow
from test_torch_codegen import _reference_batch, hold_compiled
from test_torch_strings import BYTES, WORDS
from torch_differential import (CPU, assert_same_column, batches, decimal_limbs,
                                decoded, dtype_of, random_decimals,
                                text_column, to_reference)

N = 600
PARTS = 6
COMPARES = {"equal", "not_equal", "less_than", "less_than_or_equal_to",
            "greater_than", "greater_than_or_equal_to"}
DATE_WORDS = ["1999-12-31", "2020-02-29", "2020-02-30", "1969-07-20",
              "1999-12-31 23:59:59", "2000-01-01 00:00:00", " 2001-03-04 ",
              "31/12/1999"]
TEXT = {"s0": ("string", WORDS + DATE_WORDS),
        "s1": ("string", WORDS[::-1][:20] + ["zzz"]),
        "b0": ("binary", BYTES),
        "u0": ("string", ["YWJj", "", "4pyT", "bm90IGI2NA==", "aGk="])}


def _per_row(name: str, params) -> bool:
    """castVARCHAR / castVARBINARY of a number or a decimal: the per-row
    routes that stay eager (ROADMAP §1 item 3)."""
    return name in ("castVARCHAR", "castVARBINARY") and \
        params[0] not in ("string", "binary")


def string_signatures():
    """(name, parameter type names, return type name) of every registered
    signature, aliases included, that names a string or binary type and
    has an emitter (isnull / isnotnull left out:
    test_torch_codegen.py's emitter_signatures holds them)."""
    out = set()
    for s in gt.get_registered_function_signatures():
        params = tuple(map(str, s.param_types))
        ret = str(s.return_type)
        if not ({"string", "binary"} & set(params + (ret,))) or \
                s.name in ("isnull", "isnotnull") or \
                any(p.startswith("decimal") for p in params):
            continue
        if not _per_row(s.name, params):
            out.add((s.name, params, ret))
    return sorted(out)


SIGNATURES = string_signatures()


def _columns(kind: str, rng):
    """The string, binary and date columns every case reads: over their
    word lists with 5% nulls (``words``), or over empty dictionaries, every
    row null (``empty``)."""
    cols = {}
    for name, (t, values) in TEXT.items():
        if kind == "words":
            cols[name] = (t, *text_column(t, rng, N, values))
        else:
            typ = pa.string() if t == "string" else pa.binary()
            cols[name] = (t, np.zeros(N, np.int32), np.zeros(N, bool), None,
                          pa.array([], type=typ))
    for t in ("date32", "date64", "timestamp"):
        days = rng.integers(-25000, 25000, N)
        data = days.astype(np.int32) if t == "date32" else (
            days * 86_400_000 + (rng.integers(0, 86_400_000, N)
                                 if t == "timestamp" else 0))
        cols[f"d_{t}"] = (t, data, rng.random(N) >= 0.05, None)
    return cols


def _expr(p, schema, sig, i: int):
    """Signature ``sig`` as output ``o{i}``: the first argument a column
    (two for the compares), later ones phase 20's literals; chr and space
    (literal-only) concatenated to a column; concat of a column and a
    literal (two columns: test_concat_routes)."""
    name, params, ret = sig
    B, dt = p.TreeExprBuilder, p.dtypes

    def field(n):
        return B.make_field(schema.field(n))

    def lit(v, t):
        if isinstance(v, str):
            return B.make_string_literal(v)
        return B.make_literal(v, dtype_of(p, t))

    first = {"binary": "b0"}.get(params[0], "u0" if name == "unbase64"
                                 else "s0")
    if name in ("chr", "space"):
        node = B.make_function("concat", [field("s0"), B.make_function(
            name, [lit(65 if name == "chr" else 3, params[0])],
            dt.string)], dt.string)
    elif name == "locate":
        node = B.make_function(name, [B.make_string_literal("ab"),
                                      field("s0")]
                               + [lit(2, "int32")] * (len(params) == 3),
                               dtype_of(p, ret))
    elif name == "next_day":
        node = B.make_function(name, [field(f"d_{params[0]}"),
                                      B.make_string_literal("tuesday")],
                               dtype_of(p, ret))
    elif name in COMPARES or name in ("==", "!=", "<", "<=", ">", ">=",
                                      "eq", "ne", "lt", "le", "gt", "ge",
                                      "gte", "lte", "same"):
        node = B.make_function(name, [field("s0"), field("s1")],
                               dtype_of(p, ret))
    elif name in ("concat", "concatOperator", "||"):
        node = B.make_function(name, [field("s0"),
                                      B.make_string_literal("-x")],
                               dtype_of(p, ret))
    else:
        lits = STRING_LITERALS.get(name, [])
        args = [field(first)] + [lit(lits[j], t)
                                 for j, t in enumerate(params[1:])]
        node = B.make_function(name, args, dtype_of(p, ret))
    return B.make_expression(node, dt.Field(f"o{i}", node.dtype))


def test_every_string_signature_has_an_emitter():
    """The string and binary entries compile, but the per-row routes; the
    count is the registry's: 125 string signatures with aliases, less the
    12 castVARCHAR / castVARBINARY ones of a number, plus the 9
    string-typed date/time parses and next_day."""
    reg = gt.global_registry()
    for name, params, _ in SIGNATURES:
        fn = reg.lookup(name, [dtype_of(gt, t) for t in params])
        assert fn.emit is not None, name
    names = {s[0] for s in SIGNATURES}
    for name in ("like", "ilike", "starts_with", "equal", "length", "strpos",
                 "hash32", "hash64", "castINT", "castFLOAT8", "castDATE",
                 "to_date", "is_date", "castTIMESTAMP", "next_day", "upper",
                 "substr", "concat", "castVARCHAR", "castVARBINARY",
                 "castBINARY", "hashMD5", "from_hex", "to_hex", "chr",
                 "convert_toUTF8", "levenshtein", "locate"):
        assert name in names, name
    assert len(SIGNATURES) == 122


@pytest.mark.parametrize("kind", ["words", "empty"])
@pytest.mark.parametrize("part", range(PARTS))
def test_string_emitters_match_reference(part, kind):
    """Every string and binary signature with an emitter compiled into one
    kernel (nothing eager) against the reference, over dictionaries with
    nulls and over empty ones."""
    sigs = SIGNATURES[part::PARTS]
    rng = np.random.default_rng(zlib.crc32(f"{part}{kind}".encode()))
    cols = _columns(kind, rng)
    plan = hold_compiled(lambda p, s: [_expr(p, s, sig, i)
                                       for i, sig in enumerate(sigs)],
                         cols, n=N)
    assert plan._program.count("eager") == 0
    assert plan._program.kernels == 1


def _in_tree(p, schema):
    """IN over strings, a computed string and binaries."""
    B, dt = p.TreeExprBuilder, p.dtypes
    f = {n: B.make_field(schema.field(n)) for n in ("s0", "s1", "b0")}
    roots = {
        "in_s": B.make_in_expression_string(f["s0"],
                                            ["apple", "", "x", "nope"]),
        "in_upper": B.make_in_expression_string(
            B.make_function("upper", [f["s1"]], dt.string),
            ["HELLO", "ZZZ"]),
        "in_empty": B.make_in_expression_string(f["s0"], []),
        "in_bin": B.make_in_expression_binary(f["b0"], [b"hi", b""]),
    }
    return [B.make_expression(r, dt.Field(k, r.dtype))
            for k, r in roots.items()]


@pytest.mark.parametrize("kind", ["words", "empty"])
def test_in_over_strings(kind):
    cols = _columns(kind, np.random.default_rng(31))
    plan = hold_compiled(_in_tree, cols, n=N)
    assert plan._program.count("eager") == 0


def _if_tree():
    """if/else of strings: columns, literals, a null literal, a null
    condition, binaries, and a computed branch under length (the
    reference cannot run these: tests/test_torch_if_strings.py). Returns
    the expressions and each plain case's (condition, then, else), a
    branch a column's name or a literal node."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    f = {n: B.make_field(dt.Field(n, t)) for n, t in
         (("c", dt.bool_), ("s0", dt.string), ("s1", dt.string),
          ("b0", dt.binary))}
    lit = B.make_string_literal
    cases = {
        "cols": (f["c"], "s0", "s1"),
        "lit": (f["c"], "s0", lit("zzz")),
        "lit_first": (f["c"], lit("apple"), "s1"),
        "null": (f["c"], B.make_null(dt.string), "s1"),
        "null_cond": (B.make_null(dt.bool_), "s0", "s1"),
        "bin": (f["c"], "b0", "b0"),
    }
    exprs = []
    for name, (cond, th, el) in cases.items():
        t = dt.binary if th == "b0" else dt.string
        node = B.make_if(cond, *(f[x] if isinstance(x, str) else x
                                 for x in (th, el)), t)
        exprs.append(B.make_expression(node, dt.Field(name, t)))
    node = B.make_function("length", [B.make_if(
        f["c"], B.make_function("upper", [f["s0"]], dt.string), f["s1"],
        dt.string)], dt.int32)
    exprs.append(B.make_expression(node, dt.Field("length", dt.int32)))
    return exprs, cases


@pytest.mark.parametrize("kind", ["words", "empty"])
def test_if_over_strings(kind):
    """The compiled route (each branch's code remapped in the kernel)
    equals the eager route, and the values Gandiva's rule gives: the then
    branch where the condition is true and valid, else the else branch."""
    rng = np.random.default_rng(32)
    cols = {k: v for k, v in _columns(kind, rng).items() if k in TEXT}
    cols["c"] = ("bool", rng.random(N) < 0.5, rng.random(N) >= 0.3, None)
    batch = gt.from_columns_numpy(cols, N, device=CPU)
    exprs, cases = _if_tree()
    schema = gt.dtypes.Schema([gt.dtypes.Field(k, dtype_of(gt, c[0]))
                               for k, c in cols.items()])
    eager = gt.make_projector(schema, exprs, use_cache=False, device=CPU)
    plan = jit.host_build(gt.make_projector(schema, exprs, use_cache=False,
                                            device=CPU))
    assert plan._program.count("eager") == 0
    want, got = (x.evaluate_device(batch) for x in (eager, plan))
    c = batch.column("c")
    for e in exprs:
        n = e.result_field.name
        assert_same_column(want.column(n), got.column(n), n)
        if n not in cases:
            continue
        cond, th, el = cases[n]
        take = (c.data & c.validity).numpy() \
            if isinstance(cond, gt.FieldNode) else np.zeros(N, bool)
        side = [decoded(batch.column(x)) if isinstance(x, str)
                else [x.value] * N for x in (th, el)]
        assert decoded(got.column(n)) == [
            side[0][i] if take[i] else side[1][i] for i in range(N)], n


def _concat_tree(p, schema):
    B, dt = p.TreeExprBuilder, p.dtypes
    f = {n: B.make_field(schema.field(n)) for n in ("s0", "s1")}

    def concat(a, b):
        return B.make_function("concat", [a, b], dt.string)

    roots = {
        # no literal operand: the per-row route may be taken, so it stays
        # eager, over columns or over another concat's product
        "product": concat(concat(f["s0"], f["s1"]), f["s1"]),
        "columns": concat(f["s0"], f["s1"]),
        "upper_columns": B.make_function("length", [concat(
            B.make_function("upper", [f["s0"]], dt.string), f["s1"])],
            dt.int32),
        "literal": concat(B.make_string_literal("<"),
                          concat(f["s1"], f["s0"])),
    }
    return [B.make_expression(r, dt.Field(k, r.dtype))
            for k, r in roots.items()]


def test_concat_routes():
    """concat of two non-literal strings stays eager (over columns, over
    another concat's product, or reading a compiled upper's codes and
    dictionary); with a literal operand it compiles, a transform of an
    eager value."""
    cols = _columns("words", np.random.default_rng(33))
    plan = hold_compiled(_concat_tree, cols, n=N)
    prog = plan._program
    kinds = {key: prog.kinds[key] for key, node in prog.nodes.items()
             if isinstance(node, gt.FunctionNode) and node.name == "concat"}
    assert kinds == {(0,): "eager", (0, 0): "eager", (1,): "eager",
                     (2, 0): "eager", (3,): "compiled", (3, 1): "eager"}
    assert prog.kernels == 2          # upper's codes, then length

# ---------------------------------------------------------------------------
# the TPC-H string scans
# ---------------------------------------------------------------------------

ROWS = 10_000
SCANS = {
    "Q9": (t_entry.tpch_q9_part_scan,
           lambda: t_entry.part(ROWS, 15, CPU)),
    "Q12": (t_entry.tpch_q12_scan, lambda: t_entry.lineitem(ROWS, 15, CPU)),
    "Q16": (t_entry.tpch_q16_part_scan,
            lambda: t_entry.part(ROWS, 15, CPU)),
    "Q19": (t_entry.tpch_q19_scan, lambda: t_entry.lineitem(ROWS, 15, CPU)),
    "Q22": (t_entry.tpch_q22_customer_scan,
            lambda: t_entry.customer(ROWS, 15, CPU)),
}


@pytest.mark.parametrize("query", sorted(SCANS))
def test_string_scan_is_one_kernel(query):
    """The scan compiled: one kernel, no eager node, then K1; its
    selection and outputs equal the eager route's, the reference's and
    pyarrow.compute's over the same rows."""
    make, make_batch = SCANS[query]
    plan = jit.host_build(make(CPU))
    assert plan._program.count("eager") == 0
    assert plan._program.kernels == 1
    batch = make_batch()
    sel, out = plan.evaluate_device(batch)
    esel, eout = make(CPU).evaluate_device(batch)
    ref = g.make_filter_project(to_reference(plan.schema),
                                to_reference(plan.condition),
                                to_reference(plan.exprs), use_cache=False)
    rsel, rout = ref.evaluate_device(_reference_batch(batch))
    count = int(sel.count)
    assert count == int(esel.count) == int(rsel.count) and count > 0
    idx = sel.indices[:count].numpy()
    np.testing.assert_array_equal(idx, esel.indices[:count].numpy())
    np.testing.assert_array_equal(idx, np.asarray(rsel.indices)[:count])
    arrow = gt.to_arrow(batch)
    keep = string_scan_arrow(arrow, query).to_numpy(zero_copy_only=False)
    np.testing.assert_array_equal(idx, np.nonzero(keep)[0])
    for name in out.columns:
        got = out.column(name)
        for want in (eout.column(name), rout.column(name)):
            assert got.dtype == eout.column(name).dtype
            if got.dtype.is_varlen:
                assert decoded(got)[:count] == \
                    decoded(want, want.dictionary)[:count], name
                continue
            for x, y in ((got.data, want.data), (got.extra, want.extra),
                         (got.validity, want.validity)):
                if x is not None:
                    np.testing.assert_array_equal(
                        x[:count].numpy(), np.asarray(y)[:count], name)
    if query == "Q22":                     # c_acctbal by value
        want = pc.filter(arrow, pa.array(keep))
        got = gt.to_arrow(out)
        assert got.column("c_acctbal").equals(want.column("c_acctbal"))


# ---------------------------------------------------------------------------
# the table memo
# ---------------------------------------------------------------------------

def _memo_batch(rng, shift: int):
    words = WORDS[shift:] + WORDS[:shift]
    cols = {"s": ("string", *text_column("string", rng, N, words)),
            "t": ("string", *text_column("string", rng, N, words[::-1]))}
    return gt.from_columns_numpy(cols, N, device=CPU)


@pytest.mark.parametrize("compiled", [False, True])
def test_table_memo_over_two_dictionaries(compiled):
    """A plan with four host tables on two nodes and one (like, strpos and
    a two-column compare) evaluated over batch A, batch B (other
    dictionaries), A and A again: every call equals a new plan's, tables
    are rebuilt only when a dictionary changes, and both routes key the
    memo the same, by node."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("s", dt.string), dt.Field("t", dt.string)])
    s, t = (B.make_field(schema.field(n)) for n in ("s", "t"))
    exprs = [B.make_expression(r, dt.Field(n, r.dtype)) for n, r in (
        ("like", B.make_function("like", [s, B.make_string_literal("%a%")],
                                 dt.bool_)),
        ("pos", B.make_function("strpos", [t, B.make_string_literal("e")],
                                dt.int32)),
        ("lt", B.make_function("less_than", [s, t], dt.bool_)))]

    def make():
        plan = gt.make_projector(schema, exprs, use_cache=False, device=CPU)
        return jit.host_build(plan) if compiled else plan

    rng = np.random.default_rng(33)
    a, b = _memo_batch(rng, 0), _memo_batch(rng, 7)
    plan = make()
    builds = []
    for batch in (a, b, a, a):
        got = plan.evaluate_device(batch)
        want = make().evaluate_device(batch)
        for e in exprs:
            n = e.result_field.name
            assert torch.equal(got.column(n).data, want.column(n).data), n
            assert torch.equal(got.column(n).validity,
                               want.column(n).validity), n
        builds.append(plan.stats["table_builds"])
    assert builds == [4, 8, 12, 12]
    keys = sorted(plan._table_memo["vals"])
    assert keys == [((0,), 0), ((1,), 0), ((2,), 0), ((2,), 1)]


# ---------------------------------------------------------------------------
# the 256-bit decimal multiply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t1,t2", [
    ("decimal128(38,6)", "decimal128(32,4)"),
    ("decimal128(19,0)", "decimal128(20,0)"),
    ("decimal128(38,10)", "decimal128(38,10)"),
    ("decimal128(25,5)", "decimal128(30,2)"),
    ("decimal128(38,0)", "decimal128(19,19)")])
def test_mul256_matches_reference(t1, t2):
    """multiply of two operands over 18 digits compiles (gt_mul256_div_pow10)
    and equals the reference's Projector and its int128.mul256_div_pow10 on
    the same limbs: random values of the full precision, ±(10^p - 1), 0,
    ±1 and halves of the dropped digits."""
    rng = np.random.default_rng(zlib.crc32(f"{t1}{t2}".encode()))
    cols = {}
    for side, t in (("x", t1), ("y", t2)):
        prec = dtype_of(gt, t).precision
        values = list(random_decimals(rng, N, prec))
        edge = [10 ** prec - 1, -(10 ** prec - 1), 0, 1, -1,
                5 * 10 ** (prec // 2), -5 * 10 ** (prec - 1)]
        values[:len(edge)] = edge
        lo, hi = decimal_limbs(values)
        cols[f"{side}"] = (t, lo, rng.random(N) >= 0.05, hi)

    def exprs(p, schema):
        B = p.TreeExprBuilder
        x, y = (B.make_field(schema.field(n)) for n in "xy")
        rt = dtype_of(p, str(t_dec.result_type(
            "multiply", dtype_of(gt, t1), dtype_of(gt, t2))))
        return [B.make_expression(B.make_function("multiply", [x, y], rt),
                                  p.dtypes.Field("m", rt))]

    plan = hold_compiled(exprs, cols, n=N)
    assert plan._program.count("eager") == 0
    assert "gt_mul256_div_pow10" in plan.dump_hlo()
    out_t = t_dec.result_type("multiply", dtype_of(gt, t1), dtype_of(gt, t2))
    k = dtype_of(gt, t1).scale + dtype_of(gt, t2).scale - out_t.scale
    rhi, rlo = g_int128.mul256_div_pow10(
        *(jnp.asarray(cols[s][i]) for s in "xy" for i in (3, 1)), k)
    _, port_b = batches(cols, N)
    got = plan.evaluate_device(port_b).column("m")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(got.extra.numpy(), np.asarray(rhi))
