"""The port's Projector / Filter / FilterProject and flagship entry points
against gandiva_tpu on the same inputs. Both run on the CPU, in IEEE f64, so
selection indices and outputs are compared bit for bit. Each case builds its
tree once per package from one spec function; the port's batch is carried
over from the reference's with ``from_columns_numpy``."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu import entrypoints as g_entry
from gandiva_tpu_torch import entrypoints as t_entry
from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

CPU = "cpu"


def _kw(p):
    return {"device": CPU} if p is gt else {}


def carry(ref_batch):
    """A gandiva_tpu Batch → the port's Batch, column state and all."""
    cols = {name: (str(c.dtype), np.asarray(c.data), np.asarray(c.validity))
            for name, c in ref_batch.columns.items()}
    return gt.from_columns_numpy(cols, ref_batch.length, device=CPU)


def _np(arr):
    """pyarrow array → (values with nulls zeroed, validity)."""
    valid = np.asarray(arr.is_valid().to_numpy(zero_copy_only=False))
    if pa.types.is_boolean(arr.type):
        vals = np.asarray(arr.fill_null(False).to_numpy(zero_copy_only=False))
    else:
        vals = np.asarray(arr.fill_null(0).to_numpy(zero_copy_only=False))
    return vals, valid


def assert_same(ref, port):
    """Same Arrow type, same nulls, same bits in every valid slot (any NaN
    equals any NaN: libm NaN payloads differ)."""
    assert port.type == ref.type
    rv, rm = _np(ref)
    pv, pm = _np(port)
    np.testing.assert_array_equal(pm, rm)
    rv, pv = rv[rm], pv[pm]
    if rv.dtype.kind == "f":
        nan = np.isnan(rv)
        np.testing.assert_array_equal(np.isnan(pv), nan)
        rv = rv[~nan].view(f"i{rv.itemsize}")
        pv = pv[~nan].view(f"i{pv.itemsize}")
    np.testing.assert_array_equal(pv, rv)


# ---------------------------------------------------------------------------
# the flagship query
# ---------------------------------------------------------------------------

def _flagship(p):
    B, dt = p.TreeExprBuilder, p.dtypes
    schema = dt.Schema([dt.Field("a", dt.int64), dt.Field("b", dt.float64)])
    na, nb = B.make_field(schema.field("a")), B.make_field(schema.field("b"))
    cond = B.make_condition(
        B.make_function("greater_than", [na, B.make_int64_literal(500)],
                        dt.bool_))
    expr = B.make_expression(
        B.make_function(
            "add",
            [B.make_function("multiply", [nb, B.make_double_literal(2.0)],
                             dt.float64),
             B.make_function("castFLOAT8", [na], dt.float64)], dt.float64),
        dt.Field("out", dt.float64))
    return schema, cond, expr


def _flagship_batch(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1000, n)
    bvals = rng.random(n)
    nulls = rng.random(n) < 0.1
    return pa.RecordBatch.from_arrays(
        [pa.array(a, mask=nulls), pa.array(bvals)], names=["a", "b"])


def test_flagship_filter_project_matches_reference():
    batch = _flagship_batch()
    ref_dev = g.from_arrow(batch)
    port_dev = carry(ref_dev)
    res = {}
    for p, dev in ((g, ref_dev), (gt, port_dev)):
        schema, cond, expr = _flagship(p)
        fp = p.make_filter_project(schema, cond, [expr], **_kw(p))
        sel, (out,) = fp.evaluate(dev)
        sel1 = p.make_filter(schema, cond, **_kw(p)).evaluate(dev)
        (out1,) = p.make_projector(schema, [expr], p.SelectionMode.UINT32,
                                   **_kw(p)).evaluate(dev, selection=sel1)
        res[p] = (sel.to_numpy(), out, sel1.to_numpy(), out1, sel.to_array())
    (ri, ro, ri1, ro1, rarr), (pi, po, pi1, po1, parr) = res[g], res[gt]
    assert pi.dtype == ri.dtype == np.uint32
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pi1, ri1)
    assert parr.equals(rarr)
    assert_same(ro, po)
    assert_same(ro1, po1)
    assert_same(ro, po1)


def test_flagship_from_arrow_matches_reference():
    """The port's own Arrow ingest (no padding) gives the same answer."""
    batch = _flagship_batch(n=3001, seed=5)
    outs = []
    for p in (g, gt):
        schema, cond, expr = _flagship(p)
        sel, (out,) = p.make_filter_project(schema, cond, [expr],
                                            **_kw(p)).evaluate(batch)
        outs.append((sel.to_numpy(), out))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert_same(outs[0][1], outs[1][1])


def test_flagship_step_matches_reference():
    ref_fn, ref_args = g_entry.flagship_step()
    port_fn, port_args = t_entry.flagship_step(CPU)
    for r, t in zip(ref_args, port_args):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    ri, rc, rv, rm = ref_fn(*ref_args)
    pi, pc_, pv, pm = port_fn(*port_args)
    c = int(rc)
    assert int(pc_) == c
    np.testing.assert_array_equal(pi.numpy()[:c].astype(np.uint32),
                                  np.asarray(ri)[:c])
    np.testing.assert_array_equal(pv.numpy()[:c].view(np.int64),
                                  np.asarray(rv)[:c].view(np.int64))
    np.testing.assert_array_equal(pm.numpy()[:c], np.asarray(rm)[:c])


def test_flagship_stream_matches_reference_per_batch():
    K, n = 3, 4096
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1000, (K, n))
    b = rng.random((K, n))
    av = rng.random((K, n)) >= 0.05
    ones = np.ones((K, n), dtype=bool)
    ref_cols = {"a": (jnp.asarray(a), jnp.asarray(av)),
                "b": (jnp.asarray(b), jnp.asarray(ones))}
    port_cols = {"a": (torch.from_numpy(a), torch.from_numpy(av)),
                 "b": (torch.from_numpy(b), torch.from_numpy(ones))}

    filt, proj = g_entry._flagship_plans()
    ref_fp = g.FilterProject.make(filt.schema, filt.condition, proj.exprs)
    ri, rc, rp = ref_fp.stream_fn()(ref_cols)
    port = t_entry.flagship_plan(CPU).stream_fn()(port_cols)
    assert len(port) == K
    expected_sum = 0
    for k, (pi, pc_, pp) in enumerate(port):
        c = int(rc[k])
        assert int(pc_) == c
        np.testing.assert_array_equal(pi.numpy()[:c].astype(np.uint32),
                                      np.asarray(ri[k])[:c])
        np.testing.assert_array_equal(pp[0].numpy()[:c].view(np.int64),
                                      np.asarray(rp[0][k])[:c].view(np.int64))
        np.testing.assert_array_equal(pp[1].numpy()[:c],
                                      np.asarray(rp[1][k])[:c])
        # the port's checksum covers [:count]; rebuild it from the
        # reference's outputs (float sums agree only to rounding)
        expected_sum += (c + int(np.asarray(ri[k])[:c].astype(np.int64).sum())
                         + int(np.asarray(rp[0][k])[:c].sum())
                         + int(np.asarray(rp[1][k])[:c].sum()))
    fn, make_inputs = t_entry.flagship_stream(CPU)
    assert abs(int(fn(port_cols)) - expected_sum) <= K
    # the JAX entry point runs on the same inputs too
    ref_fn, _ = g_entry.flagship_stream()
    assert np.isfinite(float(ref_fn(ref_cols)))
    cols = make_inputs(2, 1000, seed=1)
    assert cols["a"][0].shape == (2, 1000)
    assert int(cols["a"][0].min()) >= 0 and int(cols["a"][0].max()) < 1000


# ---------------------------------------------------------------------------
# numeric and cast expressions, bit-exact
# ---------------------------------------------------------------------------

N = 512
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _data(seed):
    rng = np.random.default_rng(seed)
    nulls = lambda: rng.random(N) < 0.15  # noqa: E731
    i64 = rng.integers(-1000, 1000, N)
    i64[:4] = [I64_MIN, I64_MAX, -1, 0]
    d64 = rng.integers(-5, 6, N)
    d64[:4] = [-1, 1, 0, 0]
    f64 = np.round(rng.normal(0, 50, N), 1)
    f64[:12] = [2.5, -2.5, 0.5, -0.5, 0.49999999999999994, np.nan, 1e30,
                -1e30, np.inf, -0.0, 3e9, -3e9]
    f32 = f64.astype(np.float32)
    i32 = rng.integers(-100, 100, N).astype(np.int32)
    sh = rng.integers(-3, 70, N).astype(np.int32)
    u32 = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    u32d = rng.integers(0, 7, N).astype(np.uint32)
    u64 = rng.integers(0, 2**64, N, dtype=np.uint64)
    u64[:3] = [2**64 - 1, 2**63, 2**63 - 1]
    u64d = rng.integers(1, 2**64, N, dtype=np.uint64)
    u64d[:5] = [3, 2**63 + 5, 1, 0, 2**64 - 1]
    u64d[5:N // 2] = rng.integers(0, 9, N // 2 - 5).astype(np.uint64)
    u64s = rng.integers(0, 70, N).astype(np.uint64)
    u16 = rng.integers(0, 2**16, N).astype(np.uint16)
    u8 = rng.integers(0, 256, N).astype(np.uint8)
    bx, by = rng.random(N) < 0.5, rng.random(N) < 0.5
    arrays = {
        "i64": pa.array(i64, mask=nulls()), "d64": pa.array(d64, mask=nulls()),
        "f64": pa.array(f64, mask=nulls()), "f32": pa.array(f32, mask=nulls()),
        "i32": pa.array(i32, mask=nulls()), "sh": pa.array(sh),
        "u32": pa.array(u32, mask=nulls()), "u32d": pa.array(u32d),
        "u64": pa.array(u64, mask=nulls()), "u64d": pa.array(u64d),
        "u64s": pa.array(u64s), "u16": pa.array(u16, mask=nulls()),
        "u8": pa.array(u8, mask=nulls()),
        "bx": pa.array(bx, mask=nulls()), "by": pa.array(by, mask=nulls()),
    }
    return pa.RecordBatch.from_arrays(list(arrays.values()),
                                      names=list(arrays))


def _fn(name, ret, *args):
    return lambda p, F: p.TreeExprBuilder.make_function(
        name, [a(p, F) for a in args], getattr(p.dtypes, ret))


def _f(name):
    return lambda p, F: F[name]


def _lit(kind, v):
    return lambda p, F: getattr(p.TreeExprBuilder, f"make_{kind}_literal")(v)


def _null(t):
    return lambda p, F: p.TreeExprBuilder.make_null(getattr(p.dtypes, t))


def _if(c, a, b, ret):
    return lambda p, F: p.TreeExprBuilder.make_if(
        c(p, F), a(p, F), b(p, F), getattr(p.dtypes, ret))


def _and(*kids):
    return lambda p, F: p.TreeExprBuilder.make_and([k(p, F) for k in kids])


def _or(*kids):
    return lambda p, F: p.TreeExprBuilder.make_or([k(p, F) for k in kids])


def _in(kind, e, values):
    return lambda p, F: getattr(
        p.TreeExprBuilder, f"make_in_expression_{kind}")(e(p, F), values)


EXPRS = {
    # if/else with a null condition (null takes the else branch)
    "if_null_cond": (_if(_fn("greater_than", "bool_", _f("i64"), _f("d64")),
                         _f("i64"), _f("d64"), "int64"), "int64"),
    "if_literal_branch": (_if(_f("bx"), _lit("double", 1.5), _f("f64"),
                              "float64"), "float64"),
    "if_null_literal": (_if(_f("bx"), _null("int64"), _f("i64"), "int64"),
                        "int64"),
    # Kleene and/or
    "kleene_and": (_and(_f("bx"), _f("by")), "bool_"),
    "kleene_or": (_or(_f("bx"), _f("by"),
                      _fn("less_than", "bool_", _f("i32"),
                          _lit("int32", 0))), "bool_"),
    "in_int64": (_in("int64", _f("i64"), [0, -1, 5, 17, I64_MIN]), "bool_"),
    "in_int32": (_in("int32", _f("i32"), {3, -7, 99}), "bool_"),
    # integer x/0 → 0, MIN / -1 wraps, C truncation
    "divide_i64": (_fn("divide", "int64", _f("i64"), _f("d64")), "int64"),
    "mod_i64": (_fn("mod", "int64", _f("i64"), _f("d64")), "int64"),
    "divide_i32_lit0": (_fn("divide", "int32", _f("i32"),
                            _lit("int32", 0)), "int32"),
    "divide_f64": (_fn("divide", "float64", _f("f64"), _f("f64")), "float64"),
    "mod_f64": (_fn("mod", "float64", _f("f64"), _lit("double", 7.0)),
                "float64"),
    # float → int: round half away from zero, NaN → 0, saturate
    "castBIGINT_f64": (_fn("castBIGINT", "int64", _f("f64")), "int64"),
    "castINT_f64": (_fn("castINT", "int32", _f("f64")), "int32"),
    "castSMALLINT_f64": (_fn("castSMALLINT", "int16", _f("f64")), "int16"),
    "castTINYINT_f32": (_fn("castTINYINT", "int8", _f("f32")), "int8"),
    "castINT_f32": (_fn("castINT", "int32", _f("f32")), "int32"),
    "castFLOAT4_i64": (_fn("castFLOAT4", "float32", _f("i64")), "float32"),
    "castINT_i64": (_fn("castINT", "int32", _f("i64")), "int32"),
    "castBIT_f64": (_fn("castBIT", "bool_", _f("f64")), "bool_"),
    "castFLOAT8_bool": (_fn("castFLOAT8", "float64", _f("bx")), "float64"),
    "round_f64": (_fn("round", "float64", _f("f64")), "float64"),
    "round_f32": (_fn("round", "float32", _f("f32")), "float32"),
    "round_i64_m2": (_fn("round", "int64", _f("i64"), _lit("int32", -2)),
                     "int64"),
    "truncate_f32": (_fn("truncate", "float32", _f("f32")), "float32"),
    "ceiling_floor": (_fn("add", "float64", _fn("ceiling", "float64",
                                                _f("f64")),
                          _fn("floor", "float64", _f("f64"))), "float64"),
    "sign_f64": (_fn("sign", "float64", _f("f64")), "float64"),
    "sign_i32": (_fn("sign", "int32", _f("i32")), "int32"),
    "abs_negative": (_fn("abs", "int64", _fn("negative", "int64",
                                             _f("i64"))), "int64"),
    # unsigned columns
    "add_u32": (_fn("add", "uint32", _f("u32"), _f("u32")), "uint32"),
    "lt_u32": (_fn("less_than", "bool_", _f("u32"), _lit("uint32", 2**31)),
               "bool_"),
    "divide_u32": (_fn("divide", "uint32", _f("u32"), _f("u32d")), "uint32"),
    "mod_u32": (_fn("mod", "uint32", _f("u32"), _f("u32d")), "uint32"),
    "add_u64": (_fn("add", "uint64", _f("u64"), _f("u64d")), "uint64"),
    "ge_u64": (_fn("greater_than_or_equal_to", "bool_", _f("u64"),
                   _f("u64d")), "bool_"),
    "divide_u64": (_fn("divide", "uint64", _f("u64"), _f("u64d")), "uint64"),
    "mod_u64": (_fn("mod", "uint64", _f("u64"), _f("u64d")), "uint64"),
    "shift_right_u64": (_fn("shift_right", "uint64", _f("u64"), _f("u64s")),
                        "uint64"),
    "castFLOAT8_u64": (_fn("castFLOAT8", "float64", _f("u64")), "float64"),
    "castFLOAT4_u64": (_fn("castFLOAT4", "float32", _f("u64")), "float32"),
    "castBIGINT_u64": (_fn("castBIGINT", "int64", _f("u64")), "int64"),
    "castINT_u16": (_fn("castINT", "int32", _f("u16")), "int32"),
    "gt_u16": (_fn("greater_than", "bool_", _f("u16"),
                   _lit("uint16", 40000)), "bool_"),
    "multiply_u8": (_fn("multiply", "uint8", _f("u8"), _lit("uint8", 3)),
                    "uint8"),
    "sqrtless_u16": (_fn("degrees", "float64", _f("u16")), "float64"),
    # bitwise and shifts, including out-of-range amounts
    "bitwise": (_fn("bitwise_xor", "int32",
                    _fn("bitwise_and", "int32", _f("i32"), _f("sh")),
                    _fn("bitwise_not", "int32", _f("i32"))), "int32"),
    "shift_left_i32": (_fn("shift_left", "int32", _f("i32"), _f("sh")),
                       "int32"),
    "shift_right_i32": (_fn("shift_right", "int32", _f("i32"), _f("sh")),
                        "int32"),
    # null inspection
    "isnull": (_fn("isnull", "bool_", _f("f64")), "bool_"),
    "isnotnull_lit": (_fn("isnotnull", "bool_", _lit("int64", 3)), "bool_"),
    "istrue": (_fn("istrue", "bool_", _f("bx")), "bool_"),
    "isnotfalse": (_fn("isnotfalse", "bool_", _f("bx")), "bool_"),
    "is_distinct_from": (_fn("is_distinct_from", "bool_", _f("i64"),
                             _f("d64")), "bool_"),
    "nvl": (_fn("nvl", "float64", _f("f64"), _lit("double", -1.0)),
            "float64"),
    "not_equal_bool": (_fn("not_equal", "bool_", _f("bx"), _f("by")),
                       "bool_"),
    # literals only (broadcast), null literal operand
    "literal_only": (_fn("add", "int64", _lit("int64", 2),
                         _lit("int64", 40)), "int64"),
    "null_literal_add": (_fn("add", "int64", _f("i64"), _null("int64")),
                         "int64"),
    "pi": (_fn("multiply", "float64", _fn("pi", "float64"), _f("f64")),
           "float64"),
}


def _schema_of(p, batch):
    return p.dtypes.Schema.from_arrow(batch.schema)


def _fields_of(p, schema):
    return {f.name: p.TreeExprBuilder.make_field(f) for f in schema}


def _evaluate(p, batch, root_fn, ret, dev_batch, config=None):
    schema = _schema_of(p, batch)
    root = root_fn(p, _fields_of(p, schema))
    expr = p.TreeExprBuilder.make_expression(
        root, p.dtypes.Field("r", getattr(p.dtypes, ret)))
    proj = p.make_projector(schema, [expr], config=config, use_cache=False,
                            **_kw(p))
    (out,) = proj.evaluate(dev_batch)
    return out


@pytest.fixture(scope="module")
def data_batch():
    batch = _data(3)
    ref = g.from_arrow(batch)
    return batch, ref, carry(ref)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_reference(name, data_batch):
    batch, ref_dev, port_dev = data_batch
    root_fn, ret = EXPRS[name]
    ref = _evaluate(g, batch, root_fn, ret, ref_dev)
    port = _evaluate(gt, batch, root_fn, ret, port_dev)
    assert_same(ref, port)


# projections of mixed widths (f64, i32, i64, bool, f32, bool); each adds a
# value and a validity payload, so six take two scatter launches on the card
PROJECTIONS = [
    (_fn("add", "float64", _fn("multiply", "float64", _f("f64"),
                               _lit("double", 2.0)),
         _fn("castFLOAT8", "float64", _f("i64"))), "float64"),
    (_fn("add", "int32", _f("i32"), _lit("int32", 7)), "int32"),
    (_fn("add", "int64", _f("i64"), _f("d64")), "int64"),
    (_fn("less_than", "bool_", _f("f64"), _lit("double", 0.5)), "bool_"),
    (_fn("castFLOAT4", "float32", _f("i64")), "float32"),
    (_and(_f("bx"), _f("by")), "bool_"),
]


def _multi_filter_project(p, batch, dev_batch, k):
    schema = _schema_of(p, batch)
    F = _fields_of(p, schema)
    B = p.TreeExprBuilder
    cond = B.make_condition(_fn("greater_than", "bool_", _f("i32"),
                                _lit("int32", -20))(p, F))
    exprs = [B.make_expression(root_fn(p, F),
                               p.dtypes.Field(f"r{i}", getattr(p.dtypes, ret)))
             for i, (root_fn, ret) in enumerate(PROJECTIONS[:k])]
    sel, outs = p.make_filter_project(schema, cond, exprs, use_cache=False,
                                      **_kw(p)).evaluate(dev_batch)
    sel1 = p.make_filter(schema, cond, **_kw(p)).evaluate(dev_batch)
    outs1 = p.make_projector(schema, exprs, p.SelectionMode.UINT32,
                             use_cache=False, **_kw(p)).evaluate(
                                 dev_batch, selection=sel1)
    return sel.to_numpy(), outs, sel1.to_numpy(), outs1


@pytest.mark.parametrize("k", [2, 6])
def test_multi_projection_filter_project_matches_reference(k, data_batch):
    """Several projected columns and their validities packed by one
    compaction, held bit for bit against gandiva_tpu and against the
    port's own Filter + Projector(selection)."""
    batch, ref_dev, port_dev = data_batch
    ri, routs, _, _ = _multi_filter_project(g, batch, ref_dev, k)
    pi, pouts, pi1, pouts1 = _multi_filter_project(gt, batch, port_dev, k)
    assert 0 < len(ri) < N
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pi1, ri)
    assert len(pouts) == len(pouts1) == k
    for ref, port, port1 in zip(routs, pouts, pouts1):
        assert_same(ref, port)
        assert_same(ref, port1)


@pytest.mark.parametrize("fn", ["sqrt", "exp", "log", "log10", "sin", "cos",
                                "tan", "atan", "tanh", "cbrt", "radians"])
def test_math_close_to_reference(fn, data_batch):
    """Math functions go through different libm code in XLA and in torch;
    held to a few ulp, not to the bit."""
    batch, ref_dev, port_dev = data_batch
    root_fn = _fn(fn, "float64", _f("f64"))
    ref = _evaluate(g, batch, root_fn, "float64", ref_dev)
    port = _evaluate(gt, batch, root_fn, "float64", port_dev)
    rv, rm = _np(ref)
    pv, pm = _np(port)
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_allclose(pv[pm], rv[rm], rtol=4e-16 * 8, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("fn,digits", [("round", 2), ("truncate", 1),
                                       ("round", -1)])
def test_round_digits_is_ieee(fn, digits, data_batch):
    """round/truncate(x, d) divide by 10^d. The reference's jit rewrites
    that division into a multiply by the rounded reciprocal, up to 1 ulp
    off; the port divides, as numpy does: bit-exact with numpy, within
    1 ulp of the reference."""
    batch, ref_dev, port_dev = data_batch
    root_fn = _fn(fn, "float64", _f("f64"), _lit("int32", digits))
    ref = _evaluate(g, batch, root_fn, "float64", ref_dev)
    port = _evaluate(gt, batch, root_fn, "float64", port_dev)
    x, valid = _np(batch.column("f64"))
    scale = 10.0 ** digits
    y = x * scale
    y = np.where((y == 0) | np.isnan(y), y, np.sign(y)) * np.floor(
        np.abs(y) + 0.5) if fn == "round" else np.trunc(y)
    ieee = pa.array(y / scale, mask=~valid)
    assert_same(ieee, port)
    rv, pv = _np(ref)[0][valid], _np(port)[0][valid]
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isnan(pv), np.isnan(rv))
    np.testing.assert_array_less(
        np.abs(pv[fin] - rv[fin]), np.spacing(np.abs(rv[fin])) * 1.01 + 1e-300)


@pytest.mark.parametrize("op", ["divide", "mod"])
def test_raise_errors_matches_reference(op, data_batch):
    batch, ref_dev, port_dev = data_batch
    root_fn = _fn(op, "int64", _f("i64"), _f("d64"))
    outcomes = []
    for p, dev in ((g, ref_dev), (gt, port_dev)):
        config = p.ConfigurationBuilder().with_raise_errors(True).build()
        with pytest.raises(p.EvaluationError) as e:
            _evaluate(p, batch, root_fn, "int64", dev, config=config)
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1] == "divide by zero error"


def test_raise_errors_quiet_when_no_row_errs():
    outs = []
    for p in (g, gt):
        B, dt = p.TreeExprBuilder, p.dtypes
        schema = dt.Schema([dt.Field("x", dt.int64), dt.Field("y", dt.int64)])
        expr = B.make_expression(B.make_function(
            "divide", [B.make_field(schema.field("x")),
                       B.make_field(schema.field("y"))], dt.int64),
            dt.Field("q", dt.int64))
        config = p.ConfigurationBuilder().with_raise_errors(True).build()
        # the only zero divisor sits in a null row, which never evaluates
        batch = pa.RecordBatch.from_arrays(
            [pa.array([7, 8, -9]), pa.array([2, None, 4])], names=["x", "y"])
        (out,) = p.make_projector(schema, [expr], config=config,
                                  use_cache=False, **_kw(p)).evaluate(batch)
        outs.append(out)
    assert_same(outs[0], outs[1])


def test_random_range_shape_validity():
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("x", dt.int64)])
    expr = B.make_expression(B.make_function("random", [], dt.float64),
                             dt.Field("r", dt.float64))
    proj = gt.make_projector(schema, [expr], use_cache=False, device=CPU)
    batch = pa.RecordBatch.from_arrays([pa.array(np.arange(1000))],
                                       names=["x"])
    (r1,) = proj.evaluate(batch)
    (r2,) = proj.evaluate(batch)
    v = r1.to_numpy()
    assert len(r1) == 1000 and r1.null_count == 0
    assert v.min() >= 0.0 and v.max() < 1.0 and v.std() > 0.2
    assert not np.array_equal(v, r2.to_numpy())   # a new stream per evaluate


# ---------------------------------------------------------------------------
# selection modes
# ---------------------------------------------------------------------------

def _sel_outcome(p, mode_name, proj_mode_name, n=2000):
    schema, cond, expr = _flagship(p)
    batch = _flagship_batch(n=n, seed=2)
    try:
        sel = p.make_filter(schema, cond, **_kw(p)).evaluate(
            batch, mode=getattr(p.SelectionMode, mode_name))
        proj = p.make_projector(schema, [expr],
                                getattr(p.SelectionMode, proj_mode_name),
                                **_kw(p))
        (out,) = proj.evaluate(batch, selection=sel)
    except ValueError as e:
        return "ValueError", str(e)
    return sel.to_numpy(), sel.to_array().type, out


@pytest.mark.parametrize("mode,proj_mode", [
    ("UINT16", "UINT16"), ("UINT32", "UINT32"), ("UINT64", "UINT64"),
    ("UINT32", "NONE"), ("UINT16", "UINT32")])
def test_selection_modes_match_reference(mode, proj_mode):
    ref = _sel_outcome(g, mode, proj_mode)
    port = _sel_outcome(gt, mode, proj_mode)
    if isinstance(ref[0], str):
        assert port == ref
        return
    assert port[0].dtype == ref[0].dtype
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == ref[1]
    assert_same(ref[2], port[2])


def test_uint16_bound_matches_reference():
    outcomes = []
    for p in (g, gt):
        schema, cond, _ = _flagship(p)
        batch = (p.from_arrow(_flagship_batch(n=70000)) if p is g else
                 carry(g.from_arrow(_flagship_batch(n=70000))))
        try:
            p.make_filter(schema, cond, **_kw(p)).evaluate(
                batch, mode=p.SelectionMode.UINT16)
        except ValueError as e:
            outcomes.append(str(e))
    assert len(outcomes) == 2 and outcomes[0] == outcomes[1]


def test_from_mask_uint16_bound():
    mask = torch.ones(70000, dtype=torch.bool)
    with pytest.raises(ValueError, match="UINT16"):
        gt.SelectionVector.from_mask(mask, gt.SelectionMode.UINT16)
    sel = gt.SelectionVector.from_mask(mask[:10], gt.SelectionMode.UINT64)
    assert sel.to_numpy().dtype == np.uint64 and len(sel) == 10


# ---------------------------------------------------------------------------
# plan object surface
# ---------------------------------------------------------------------------

def test_stats_plan_text_and_cache():
    schema, cond, expr = _flagship(gt)
    fp = gt.make_filter_project(schema, cond, [expr], device=CPU)
    assert gt.make_filter_project(schema, cond, [expr], device=CPU) is fp
    fp = gt.make_filter_project(schema, cond, [expr], device=CPU,
                                use_cache=False)
    batch = _flagship_batch(n=1000)
    reset_launches()
    sel, _ = fp.evaluate(batch)
    fp.evaluate(batch)
    assert LAUNCHES["compact"] == 0        # CPU tensors: the plain version
    assert fp.stats["evaluations"] == 2
    assert fp.stats["rows_in"] == 2000
    assert fp.stats["rows_out"] == 2 * len(sel)
    text = fp.llvm_ir
    assert "float64 castFLOAT8(int64) [null_if_null]" in text
    assert fp.hlo == fp.dump_hlo(None) == text
    with pytest.raises(ValueError, match="plan on"):
        fp.evaluate_device(gt.from_arrow(batch, device="meta"))


def test_stream_fn_refuses_raise_errors():
    outcomes = []
    for p in (g, gt):
        schema, cond, expr = _flagship(p)
        config = p.ConfigurationBuilder().with_raise_errors(True).build()
        fp = p.make_filter_project(schema, cond, [expr], config=config,
                                   **_kw(p))
        with pytest.raises(ValueError) as e:
            fp.stream_fn()
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1]


def test_arrow_round_trip_types():
    batch = pa.RecordBatch.from_arrays(
        [pa.array([1, None, 3], type=pa.int8()),
         pa.array([2**64 - 1, 0, None], type=pa.uint64()),
         pa.array([1.5, None, -0.0], type=pa.float32()),
         pa.array([True, None, False]),
         pa.array([0, 19000, None], type=pa.date32()),
         pa.array([1, None, 3], type=pa.timestamp("us"))],
        names=["i8", "u64", "f32", "b", "d", "ts"])
    port = gt.to_arrow(gt.from_arrow(batch, device=CPU))
    ref = g.to_arrow(g.from_arrow(batch))
    for name in batch.schema.names:
        assert_same(ref.column(name), port.column(name))
    # string, large_string, binary and dictionary columns: dictionary
    # codes on the device, the same values back
    strings = pa.RecordBatch.from_arrays(
        [pa.array(["x", None, "ü€", "", "x"]),
         pa.array(["a", "b", None, "a", "c"], type=pa.large_string()),
         pa.array([b"\x00\xff", None, b"", b"\x00\xff", b"z"]),
         pa.array(["p", "q", None, "q", "p"]).dictionary_encode()],
        names=["s", "ls", "bin", "dict"])
    port_b = gt.from_arrow(strings, device=CPU)
    assert port_b.column("s").data.dtype == torch.int32
    port = gt.to_arrow(port_b)
    ref = g.to_arrow(g.from_arrow(strings))
    for name in strings.schema.names:
        assert port.column(name).equals(ref.column(name)), name
        assert port.column(name).to_pylist() == \
            strings.column(name).to_pylist(), name
