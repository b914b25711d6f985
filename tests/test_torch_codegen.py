"""The plan compiler (compiler/codegen.py, compiler/jit.py) on the CPU.

A compiled plan's generated source is built for the host with g++
(``jit.host_build``: the same source the card's nvcc builds, with
-ffp-contract=off) and held bit for bit against gandiva_tpu (JAX on the
CPU with x64) on inputs made from a numpy seed: every signature that has
an emitter, over columns with hazard rows, batched into eight sources;
Kleene and/or, if and IN under nulls; the compiled regions of the
configs[0], Q1, Q6, Q12 and Q19 plans. The rest holds the compiled route's
contract: both Configuration.optimize settings equal on the CPU, which
nodes stay eager, a deterministic source, the eager route's first error
message under raise_errors, and a failed build raising."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu.batch import Batch as GBatch, Column as GColumn
from gandiva_tpu_torch import entrypoints as t_entry
from gandiva_tpu_torch.compiler import codegen, jit
from gandiva_tpu_torch.compiler import projector as t_projector
from gandiva_tpu_torch.ops.kernels import build
from gandiva_tpu_torch.registry import decimal_ops as t_dec

from torch_differential import (CPU, assert_same_column, batches, column,
                                dtype_of, text_column, to_reference)

N = 4096
BATCHES = 16
DEC_TYPES = ("decimal128(15,2)", "decimal128(16,2)", "decimal128(32,4)",
             "decimal128(38,6)")
INTS = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
        "uint64")
FLOAT_HAZARDS = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, 2.5, -2.5,
                 0.49999999999999994, 2.0 ** 63, -2.0 ** 63, 2.0 ** 64,
                 -1e300, 1e300, 2.0 ** 31, 127.5, -128.5, 255.5, 65535.5,
                 -0.5, 4294967295.5, 9.2e18, -9.3e18, 1.8e19]


def _int_hazards(t: str, side: str) -> np.ndarray:
    """Values that hit the integer hazards: 0, ±1, the type's bounds (MIN /
    -1), and for the right operand every shift amount from -2 to width + 1
    (at and past the width)."""
    info = np.iinfo(np.dtype(t))
    w = info.bits
    if side == "x":
        vals = [0, 1, -1, info.min, info.max, info.min, info.max, 5, -7,
                info.min, 100, 3] + [info.max - k for k in range(w + 4)]
    else:
        vals = [0, 0, -1, -1, -1, 0, 1, 2, 3, info.max, info.min,
                -3] + list(range(-2, w + 2))
    return np.array([v % (1 << w) if info.min == 0 else v for v in vals],
                    dtype=np.dtype(t))


def columns(types, rng):
    """Two columns (x_*, y_*) of every type, 5% nulls, with the hazard
    rows first (all valid)."""
    cols = {}
    for t in types:
        for side in "xy":
            name = f"{side}_{t}"
            if t in ("string", "binary"):
                cols[name] = (t, *text_column(t, rng, N, ["a", "bb", ""]))
                continue
            data, valid, hi = column(t, rng, N)
            if t in INTS:
                h = _int_hazards(t, side)
            elif t in ("float32", "float64"):
                with np.errstate(over="ignore"):
                    h = np.array(FLOAT_HAZARDS[::1 if side == "x" else -1],
                                 dtype=np.dtype(t))
            else:
                h = np.array([], dtype=data.dtype)
            data[:len(h)] = h
            valid[:len(h)] = True
            cols[name] = (t, data, valid, hi)
    return cols


# castDECIMAL's targets (its return type is the tree's): one that int64
# and float values overflow, one that they fit
CAST_DECIMAL_TARGETS = ("decimal128(16,2)", "decimal128(38,6)")
# the math functions: the host's libm and XLA's differ by ulps, so these
# are held bit for bit to libm and to test_math_close_to_reference's
# tolerance against the reference (tests/test_torch_codegen_families.py)
MATH = ("cbrt", "exp", "log", "log10", "log2", "sin", "cos", "tan", "asin",
        "acos", "atan", "sinh", "cosh", "tanh", "atan2", "power")


def held_elsewhere(sig) -> bool:
    """The math functions, and round / truncate to d digits of a number,
    whose division by 10^d the reference rounds differently (ROADMAP §3,
    "round / truncate"): test_torch_codegen_families.py holds them."""
    name, params, _ = sig
    return name in MATH or (name in ("round", "truncate") and len(params) == 2
                            and not params[0].startswith("decimal"))


def emitter_signatures():
    """Every (name, parameter type names, return type name) with an
    emitter that names no string or binary type, but isnull / isnotnull,
    which are held here over string and binary columns too: the numeric,
    cast, math, rounding, hash, date/time, interval and decimal entries
    (decimals at the four test types, every pair for the binary
    functions, the 256-bit multiply among them; castDECIMAL to
    CAST_DECIMAL_TARGETS). The other string and binary emitters, whose
    arguments after the first are literals, are held by
    test_torch_codegen_strings.py."""
    reg = gt.global_registry()
    decs = [dtype_of(gt, t) for t in DEC_TYPES]
    for a in decs:
        for b in decs:
            t_dec.ensure_registered([a, b])
    sigs = set()
    for f in list(reg._table.values()):
        if f.emit is None:
            continue
        params = tuple(str(t) for t in f.signature.param_types)
        if any(p.startswith("decimal") and p not in DEC_TYPES
               for p in params):
            continue
        rt = f.signature.return_type
        if (any(t.is_varlen for t in f.signature.param_types) or (
                rt is not None and rt.is_varlen)) and \
                f.signature.name not in ("isnull", "isnotnull"):
            continue
        for ret in (CAST_DECIMAL_TARGETS if rt is None else (str(rt),)):
            sigs.add((f.signature.name, params, ret))
    return sorted(sigs)


def project(p, schema, sigs):
    """One expression a signature over the columns x_<type>, y_<type>; the
    decimal round and truncate take their scale as a literal (-1 .. 2)."""
    B = p.TreeExprBuilder
    exprs = []
    for i, (name, params, ret) in enumerate(sigs):
        args = [B.make_field(schema.field(f"{'xy'[j]}_{t}"))
                for j, t in enumerate(params)]
        if params[:1] and params[0].startswith("decimal") \
                and params[1:] == ("int32",):
            args[1] = B.make_literal(i % 4 - 1, p.dtypes.int32)
        rt = dtype_of(p, ret)
        exprs.append(B.make_expression(B.make_function(name, args, rt),
                                       p.dtypes.Field(f"o{i}", rt)))
    return exprs


def hold_compiled(make_exprs, cols, n=N, config=None, hold=None):
    """``make_exprs(p, schema)`` through gandiva_tpu and through the port's
    host-built compiled route, held bit for bit (or by ``hold(ref, port,
    name)``); returns the port plan."""
    ref_b, port_b = batches(cols, n)
    plans, outs = {}, {}
    for p, b in ((g, ref_b), (gt, port_b)):
        schema = p.dtypes.Schema([p.dtypes.Field(name, dtype_of(p, c[0]))
                                  for name, c in cols.items()])
        kw = {"device": CPU} if p is gt else {}
        plan = p.make_projector(schema, make_exprs(p, schema), config=config,
                                use_cache=False, **kw)
        if p is gt:
            jit.host_build(plan)
        plans[p] = plan
        outs[p] = plan.evaluate_device(b)
    for name in outs[g].columns:
        (hold or assert_same_column)(outs[g].column(name),
                                     outs[gt].column(name), name)
    return plans[gt]


@pytest.mark.parametrize("part", range(BATCHES))
def test_emitters_match_reference(part):
    """Every emitter signature, compiled (nothing stays eager), against the
    reference, over hazard rows: x/0, MIN / -1, shifts at and past the
    width, NaN, ±inf and ±0.0 through casts and compares, unsigned
    top-bit values, integer wrap, decimals divided and taken mod by 0."""
    sigs = [s for s in emitter_signatures()
            if not held_elsewhere(s)][part::BATCHES]
    types = sorted({t for _, params, _ in sigs for t in params})
    cols = columns(types, np.random.default_rng(100 + part))
    plan = hold_compiled(lambda p, s: project(p, s, sigs), cols)
    assert plan._program.count("eager") == 0
    assert plan._program.kernels == 1


def test_every_emitter_family_is_covered():
    names = {s[0] for s in emitter_signatures()}
    for name in ("add", "subtract", "multiply", "divide", "mod", "negative",
                 "abs", "bitwise_and", "bitwise_not", "shift_left",
                 "shift_right", "less_than", "equal", "not", "isnull",
                 "isnotnull", "istrue", "isnotfalse", "is_distinct_from",
                 "is_not_distinct_from", "nvl", "castINT", "castFLOAT4",
                 "castBIGINT", "castBIT", "sqrt", "extractYear",
                 "date_trunc_Month", "timestampaddDay", "months_between",
                 "round", "floor", "exp", "hash32", "hash64AsDouble",
                 "castDECIMAL"):
        assert name in names, name
    params = {s[1] for s in emitter_signatures()}
    for t in ("date32", "date64", "timestamp", "time32", "time64"):
        assert (t, t) in params, t
    for a in DEC_TYPES:
        for b in DEC_TYPES:
            assert (a, b) in params
    # the 256-bit multiply (both operands over 18 digits) compiles
    assert any(s[:2] == ("multiply", ("decimal128(32,4)",
                                      "decimal128(38,6)"))
               for s in emitter_signatures())
    # isnull / isnotnull over strings and binaries (they read the validity)
    for name in ("isnull", "isnotnull"):
        for t in ("string", "binary"):
            assert (name, (t,), "bool") in emitter_signatures(), (name, t)


def _bool_tree(p, schema):
    """Kleene and/or, if over nulls (null conditions take the else
    branch), null literals, numeric IN with NaN, -0.0 and top-bit
    unsigned values."""
    B, dt = p.TreeExprBuilder, p.dtypes
    f = {n: B.make_field(schema.field(n)) for n in
         ("x_bool", "y_bool", "x_float64", "y_float64", "x_int64",
          "x_uint64", "x_decimal128(15,2)", "y_decimal128(15,2)")}
    null_b = B.make_null(dt.bool_)
    roots = {
        "and3": B.make_and([f["x_bool"], f["y_bool"], null_b]),
        "or3": B.make_or([f["x_bool"], null_b, f["y_bool"]]),
        "and_lit": B.make_and([f["x_bool"], B.make_literal(False, dt.bool_)]),
        "or_lit": B.make_or([f["y_bool"], B.make_literal(True, dt.bool_)]),
        "nested": B.make_or([B.make_and([f["x_bool"], f["y_bool"]]),
                             B.make_function("not", [f["x_bool"]],
                                             dt.bool_)]),
        "if_f64": B.make_if(f["x_bool"], f["x_float64"], f["y_float64"],
                            dt.float64),
        "if_null_cond": B.make_if(null_b, f["x_int64"],
                                  B.make_null(dt.int64), dt.int64),
        "if_dec": B.make_if(B.make_and([f["x_bool"], f["y_bool"]]),
                            f["x_decimal128(15,2)"], f["y_decimal128(15,2)"],
                            dtype_of(p, "decimal128(15,2)")),
        "in_f64": B.make_in_expression(f["x_float64"],
                                       [np.nan, -0.0, 1.5, np.inf],
                                       dt.float64),
        "in_u64": B.make_in_expression(f["x_uint64"],
                                       [0, 2 ** 64 - 1, 2 ** 63, 7],
                                       dt.uint64),
        "in_i64": B.make_in_expression(f["x_int64"],
                                       [-(2 ** 63), 2 ** 63 - 1, 0, -1],
                                       dt.int64),
        "in_empty": B.make_in_expression(f["x_int64"], [], dt.int64),
    }
    return [B.make_expression(r, dt.Field(k, r.dtype))
            for k, r in roots.items()]


def test_kleene_if_and_in_under_nulls():
    rng = np.random.default_rng(3)
    cols = columns(["bool", "float64", "int64", "uint64",
                     "decimal128(15,2)"], rng)
    for name in ("x_bool", "y_bool"):
        t, d, v, hi = cols[name]
        v = rng.random(N) >= 0.3            # many null conditions
        cols[name] = (t, d, v, hi)
    plan = hold_compiled(_bool_tree, cols)
    assert plan._program.count("eager") == 0


# ---------------------------------------------------------------------------
# the compiled regions of the entry points' plans
# ---------------------------------------------------------------------------

def _reference_batch(batch):
    return GBatch({
        name: GColumn(jnp.asarray(c.data.numpy()),
                      jnp.asarray(c.validity.numpy()),
                      dtype_of(g, str(c.dtype)), dictionary=c.dictionary,
                      extra=None if c.extra is None
                      else jnp.asarray(c.extra.numpy()))
        for name, c in batch.columns.items()}, batch.length)


def _flagship_batch():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1000, N)
    b = rng.random(N)
    cols = {"a": ("int64", a, rng.random(N) >= 0.05),
            "b": ("float64", b, np.ones(N, dtype=bool))}
    return gt.from_columns_numpy(cols, N, device=CPU)


PLANS = {
    "configs[0]": (t_entry.flagship_plan, _flagship_batch, 0),
    "q1": (t_entry.tpch_q1_scan, lambda: t_entry.lineitem(N, 1, CPU), 0),
    "q6": (t_entry.tpch_q6_scan, lambda: t_entry.lineitem(N, 1, CPU), 0),
    "q7": (t_entry.tpch_q7_scan, lambda: t_entry.lineitem(N, 1, CPU), 0),
    "q12": (t_entry.tpch_q12_scan, lambda: t_entry.lineitem(N, 1, CPU), 0),
    "q19": (t_entry.tpch_q19_scan, lambda: t_entry.lineitem(N, 1, CPU), 0),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_reference(name):
    """The plan's compiled route (one kernel, nothing eager: Q12's and
    Q19's string predicates read their host tables in it) against
    gandiva_tpu's FilterProject, selection and outputs."""
    make, make_batch, eager = PLANS[name]
    plan = jit.host_build(make(CPU))
    assert plan._program.kernels == 1
    assert plan._program.count("eager") == eager
    batch = make_batch()
    ref = g.make_filter_project(to_reference(plan.schema),
                                to_reference(plan.condition),
                                to_reference(plan.exprs), use_cache=False)
    sel, out = plan.evaluate_device(batch)
    rsel, rout = ref.evaluate_device(_reference_batch(batch))
    count = int(sel.count)
    assert count == int(rsel.count) and count > 0
    np.testing.assert_array_equal(sel.indices[:count].numpy(),
                                  np.asarray(rsel.indices)[:count])
    for col in out.columns:
        pc, rc = out.column(col), rout.column(col)
        for pt, rt in ((pc.data, rc.data), (pc.extra, rc.extra),
                       (pc.validity, rc.validity)):
            if pt is None and rt is None:
                continue
            np.testing.assert_array_equal(pt[:count].numpy(),
                                          np.asarray(rt)[:count], col)


def test_unread_high_limbs():
    """Q1 uses its money columns only mod 2^64 (int64 products, upscaled
    sums), so its kernel reads no high limb (and is passed none); with
    the high limbs overwritten its outputs still equal the eager route's
    (which reads them), and its bytes count none of them."""
    plan = jit.host_build(t_entry.tpch_q1_scan(CPU))
    ports = [pt for pt in plan._program.stages[0].inputs
             if pt.dtype.is_decimal]
    assert ports and not any(pt.hi_read for pt in ports)
    q6 = codegen.generate(t_entry.tpch_q6_scan(CPU)._roots, True)
    assert {pt.ref[1]: pt.hi_read for pt in q6.stages[0].inputs
            if pt.dtype.is_decimal} == {"l_discount": True,
                                        "l_quantity": True,
                                        "l_extendedprice": False}
    batch = t_entry.lineitem(N, 7, CPU)
    for name in t_entry.MONEY_COLUMNS:
        c = batch.column(name)
        c.extra = torch.full_like(c.extra, -12345)
    want = t_entry.tpch_q1_scan(CPU).evaluate_device(batch)
    got = plan.evaluate_device(batch)
    c = int(want[0].count)
    assert int(got[0].count) == c
    for name in ("disc_price", "charge"):
        g_, w_ = got[1].column(name), want[1].column(name)
        assert torch.equal(g_.data[:c], w_.data[:c])
        assert torch.equal(g_.extra[:c], w_.extra[:c])
    cost = plan.cost_analysis(batch)
    # l_shipdate 4 B, one shared validity 1 B and three low limbs 8 B a
    # row read (the date bound compiles from its literals); the mask 1 B,
    # two outputs of 16 + 1 B written
    assert cost["plan bytes read"] == N * (4 + 1 + 3 * 8)
    assert cost["plan bytes written"] == N * (1 + 2 * 17)


def test_configuration_optimize_flag():
    """The counterpart of the reference's test_configuration_optimize_flag:
    on the CPU both settings take the eager route and agree with each
    other, with the host-built compiled route and with the reference."""
    results = []
    for p in (g, gt):
        B, dt = p.TreeExprBuilder, p.dtypes
        fa = dt.Field("a", dt.int32)
        schema = dt.Schema([fa])
        expr = B.make_expression(
            B.make_function("multiply",
                            [B.make_field(fa), B.make_literal(2, dt.int32)],
                            dt.int32), dt.Field("r", dt.int32))
        off = p.ConfigurationBuilder().with_optimize(False).build()
        kw = {"device": CPU} if p is gt else {}
        import pyarrow as pa
        batch = pa.RecordBatch.from_arrays(
            [pa.array([1, None, 3, -(2 ** 31)], type=pa.int32())],
            names=["a"])
        plans = [p.make_projector(schema, [expr], use_cache=False, **kw),
                 p.make_projector(schema, [expr], config=off,
                                  use_cache=False, **kw)]
        if p is gt:
            assert all(pl._program is None for pl in plans)   # CPU: eager
            plans.append(jit.host_build(p.make_projector(
                schema, [expr], use_cache=False, **kw)))
        results += [pl.evaluate(batch)[0] for pl in plans]
    assert all(r.equals(results[0]) for r in results)
    assert results[0].to_pylist() == [2, None, 6, 0]


def test_eager_nodes_of_a_mixed_plan():
    """random and castVARCHAR of a number stay eager (kernel inputs); the
    string functions compile, reading their host tables; castVARCHAR of a
    compiled value runs between two kernels, and the second reads its
    codes and its dictionary's table (length); the compiled route equals
    the eager one, random draws included."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("s", dt.string), dt.Field("x", dt.float64),
                        dt.Field("k", dt.int64)])
    s, x, k = (B.make_field(schema.field(n)) for n in ("s", "x", "k"))
    exprs = {
        "upper_eq": B.make_function("equal", [
            B.make_function("upper", [s], dt.string),
            B.make_string_literal("BB")], dt.bool_),
        "noise": B.make_function("add", [
            x, B.make_function("random", [], dt.float64)], dt.float64),
        "staged": B.make_function("multiply", [
            B.make_function("castFLOAT8", [B.make_function("length", [
                B.make_function("castVARCHAR", [
                    B.make_function("add", [k, B.make_int64_literal(1)],
                                    dt.int64),
                    B.make_int64_literal(20)], dt.string)], dt.int32)],
                dt.float64),
            B.make_function("castFLOAT8", [k], dt.float64)], dt.float64),
        "like": B.make_function("like", [s, B.make_string_literal("b%")],
                                dt.bool_),
        "not_like": B.make_function("not", [B.make_function(
            "like", [s, B.make_string_literal("a%")], dt.bool_)], dt.bool_),
    }
    exprs = [B.make_expression(r, dt.Field(n, r.dtype))
             for n, r in exprs.items()]
    rng = np.random.default_rng(4)
    cols = {"s": ("string", *text_column("string", rng, N, ["a", "bb", "b"])),
            "x": ("float64", rng.standard_normal(N), rng.random(N) >= 0.1),
            "k": ("int64", rng.integers(-50, 50, N), rng.random(N) >= 0.1)}
    batch = gt.from_columns_numpy(cols, N, device=CPU)
    eager = gt.make_projector(schema, exprs, use_cache=False, device=CPU)
    plan = jit.host_build(gt.make_projector(schema, exprs, use_cache=False,
                                            device=CPU))
    prog = plan._program
    by_name = {str(prog.nodes[key].name): kind
               for key, kind in prog.kinds.items()
               if isinstance(prog.nodes[key], gt.FunctionNode)}
    for name in ("random", "castVARCHAR"):
        assert by_name[name] == "eager", name
    for name in ("add", "multiply", "castFLOAT8", "not", "upper", "equal",
                 "length", "like"):                         # equal(utf8)
        assert by_name[name] == "compiled", name
    assert prog.kernels == 2     # castVARCHAR reads a compiled add
    for kind in ("eager", "compiled"):
        assert f" {kind} " in plan.dump_hlo()
    want = eager.evaluate_device(batch)
    got = plan.evaluate_device(batch)
    for e in exprs:
        n = e.result_field.name
        assert_same_column(want.column(n), got.column(n), n)
    cost = plan.cost_analysis(batch)
    assert cost["eager nodes"] == 2 and cost["compiled nodes"] == 11
    assert cost["plan bytes written"] > 0 and cost["plan bytes read"] > 0


def test_source_is_deterministic():
    """The same plan gives the same source, so the same library; a changed
    literal gives another."""
    def source(limit):
        B, dt = gt.TreeExprBuilder, gt.dtypes
        schema = dt.Schema([dt.Field("a", dt.int64)])
        cond = B.make_condition(B.make_function(
            "greater_than", [B.make_field(schema.field("a")),
                             B.make_int64_literal(limit)], dt.bool_))
        return codegen.generate([cond.root], mask_root=True).source

    assert source(500) == source(500)
    assert build.plan_path(source(500)) == build.plan_path(source(500))
    assert build.plan_path(source(500)) != build.plan_path(source(501))
    assert (build.plan_path(source(500), "host")
            != build.plan_path(source(500), "cuda"))
    q1 = [t_entry.tpch_q1_scan(CPU)._roots for _ in range(2)]
    assert codegen.generate(q1[0], True).source == \
        codegen.generate(q1[1], True).source


@pytest.mark.parametrize("order", ["divide_first", "cast_first"])
def test_raise_errors_gives_the_eager_first_message(order):
    """Under raise_errors the compiled route raises the message the eager
    route raises: the first firing site in the decomposer's order, across
    the kernel's sites and the eager nodes'."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("a", dt.int64), dt.Field("b", dt.int64),
                        dt.Field("f", dt.float64)])
    a, b, f = (B.make_field(schema.field(n)) for n in ("a", "b", "f"))
    div = B.make_expression(B.make_function("divide", [a, b], dt.int64),
                            dt.Field("q", dt.int64))
    dec = dt.decimal128(4, 2)
    cast = B.make_expression(B.make_function("castDECIMAL", [f], dec),
                             dt.Field("c", dec))
    exprs = [div, cast] if order == "divide_first" else [cast, div]
    cfg = gt.ConfigurationBuilder().with_raise_errors(True).build()
    cols = {"a": ("int64", np.arange(8), np.ones(8, dtype=bool)),
            "b": ("int64", np.array([1, 2, 0, 1, 1, 1, 1, 1]),
                  np.ones(8, dtype=bool)),
            "f": ("float64", np.array([1.0, 2.0, 3.0, 1e9, 0, 0, 0, 0]),
                  np.ones(8, dtype=bool))}
    batch = gt.from_columns_numpy(cols, 8, device=CPU)
    messages = []
    for compiled in (False, True):
        plan = gt.make_projector(schema, exprs, config=cfg, use_cache=False,
                                 device=CPU)
        if compiled:
            jit.host_build(plan)
            assert plan._program.sites       # the kernel's divide site
        with pytest.raises(gt.EvaluationError) as e:
            plan.evaluate_device(batch)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert messages[0] == ("divide by zero error" if order == "divide_first"
                           else "castDECIMAL: overflow")
    # only the rows within length can raise: a zero divisor past it is ok
    plan = jit.host_build(gt.make_projector(schema, [div], config=cfg,
                                            use_cache=False, device=CPU))
    short = gt.from_columns_numpy(cols, 8, device=CPU)
    short.length = 2
    plan.evaluate_device(short)


def test_selected_and_streamed_routes():
    """A projector over a selection (length a device scalar) and
    stream_fn take the compiled route and equal the eager one; over a
    selection the compiled route gathers only the columns an eager node
    reads."""
    fp_eager = t_entry.flagship_plan(CPU)
    fp = jit.host_build(t_entry.flagship_plan(CPU))
    batch = _flagship_batch()
    cols = {n: (c.data[None], c.validity[None])
            for n, c in batch.columns.items()}
    for want, got in zip(fp_eager.stream_fn()(cols), fp.stream_fn()(cols)):
        assert int(want[1]) == int(got[1])
        assert torch.equal(want[0], got[0])
        for w, v in zip(want[2], got[2]):
            assert torch.equal(w, v)
    filt, proj = t_entry._flagship_plans(CPU)
    sel = filt.evaluate(batch)
    proj_s = gt.make_projector(filt.schema, proj.exprs,
                               gt.SelectionMode.UINT32, use_cache=False,
                               device=CPU)
    with _IndexSelects() as eager_gathers:
        want = proj_s.evaluate(batch, selection=sel)
    jit.host_build(proj_s)
    with _IndexSelects() as gathers:
        got = proj_s.evaluate(batch, selection=sel)
    assert got[0].equals(want[0])
    # the kernel reads a and b at the selected rows: no gather launches
    assert eager_gathers.n == 4 and gathers.n == 0
    # an eager node's field is gathered (data and validity), no other; a
    # string field a compiled node reads is read at the selected rows
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("s", dt.string), dt.Field("x", dt.int64),
                        dt.Field("y", dt.int64)])
    s_, x, y = (B.make_field(schema.field(n)) for n in ("s", "x", "y"))

    def length_of(node):
        return B.make_function("castBIGINT", [B.make_function(
            "length", [node], dt.int32)], dt.int64)

    exprs = [B.make_expression(B.make_function("add", [
        y, length_of(B.make_function("castVARCHAR", [
            x, B.make_int64_literal(20)], dt.string))], dt.int64),
        dt.Field("r", dt.int64)),
        B.make_expression(length_of(s_), dt.Field("u", dt.int64))]
    rng = np.random.default_rng(8)
    cols = {"s": ("string", *text_column("string", rng, N, ["a", "bbb"])),
            "x": ("int64", rng.integers(-9, 9, N), rng.random(N) >= 0.1),
            "y": ("int64", rng.integers(-9, 9, N), rng.random(N) >= 0.1)}
    mixed = gt.from_columns_numpy(cols, N, device=CPU)
    picked = gt.SelectionVector.from_mask(
        torch.from_numpy(rng.random(N) < 0.3), gt.SelectionMode.UINT32)
    plans = [gt.make_projector(schema, exprs, gt.SelectionMode.UINT32,
                               use_cache=False, device=CPU)
             for _ in range(2)]
    jit.host_build(plans[1])
    assert plans[1]._program.eager_fields == ["x"]
    outs = []
    # eager: the three columns' data and validity and the two length
    # tables gather by code; compiled: only x's data and validity
    for plan, n in zip(plans, (8, 2)):
        with _IndexSelects() as gathers:
            outs.append(plan.evaluate(mixed, selection=picked))
        assert gathers.n == n
    assert all(a.equals(b) for a, b in zip(*outs))


class _IndexSelects:
    """Counts the index_select calls torch dispatches inside the block."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += func is torch.ops.aten.index_select.default
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def test_empty_batch():
    """A batch of no rows: the compiled route launches nothing and returns
    empty outputs, as the eager route does."""
    fp = jit.host_build(t_entry.flagship_plan(CPU))
    empty = gt.from_columns_numpy(
        {"a": ("int64", np.zeros(0, dtype=np.int64), np.zeros(0, bool)),
         "b": ("float64", np.zeros(0), np.zeros(0, bool))}, 0, device=CPU)
    sel, out = fp.evaluate_device(empty)
    assert int(sel.count) == 0 and out.column("out").data.numel() == 0


def test_failed_build_raises(monkeypatch):
    """A plan whose build fails raises at Make; nothing runs the eager
    route in its place."""
    monkeypatch.setattr(build, "_PLAN", {"cuda": ("false", [], ".cu"),
                                         "host": ("false", [], ".cpp")})
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("a", dt.int64)])
    cond = B.make_condition(B.make_function(
        "less_than", [B.make_field(schema.field("a")),
                      B.make_int64_literal(987_654_321)], dt.bool_))
    with pytest.raises(RuntimeError, match="false failed for .*libplan"):
        jit.host_build(gt.make_filter(schema, cond, use_cache=False,
                                      device=CPU))
    # on the card's route too: Make builds, and the failure propagates
    monkeypatch.setattr(t_projector, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="false failed for .*libplan"):
        gt.make_filter(schema, cond, use_cache=False)
