"""The port's decimal128 support against gandiva_tpu on the same inputs: the
int128 limb arithmetic (utils/int128.py) against Python ints and the
reference's functions; every decimal signature of four precisions (9, 18,
28, 38: the 64×64 product, the 128×64 product, the 256-bit product and the
divides all run); decimal literals, if/else and casts; Arrow round trips;
the runtime errors; and the TPC-H Q1 and Q6 lineitem scans. Bit for bit
throughout (castFLOAT8 included)."""
import zlib

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu.batch import Batch as GBatch, Column as GColumn
from gandiva_tpu.registry import decimal_ops as g_dec
from gandiva_tpu.utils import int128 as g_i128
from gandiva_tpu_torch import entrypoints as t_entry
from gandiva_tpu_torch.registry import decimal_ops as t_dec
from gandiva_tpu_torch.utils import int128 as t_i128

from torch_differential import (CPU, batches, column, decimal_limbs,
                                dtype_of, limbs_to_ints, project_both,
                                random_decimals, to_reference)

N = 1000
TYPES = ["decimal128(9,2)", "decimal128(18,4)", "decimal128(28,6)",
         "decimal128(38,10)"]
U128 = (1 << 128) - 1


def _wrap128(v: int) -> int:
    v &= U128
    return v - (1 << 128) if v >= 1 << 127 else v


# ---------------------------------------------------------------------------
# int128 limb arithmetic
# ---------------------------------------------------------------------------

def _operands(seed, n=400):
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 63, (1 << 64) - 1,
             1 << 64, -(1 << 64), (1 << 127) - 1, -(1 << 127),
             10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 18, 5, -5]
    vals = edges + [_wrap128(int.from_bytes(rng.bytes(16), "little"))
                    for _ in range(n)]
    vals += [int(x) for x in rng.integers(-(10 ** 18), 10 ** 18, n)]
    other = list(reversed(vals))
    return vals, other


def _both(vals):
    lo, hi = decimal_limbs(vals)
    return (torch.from_numpy(hi), torch.from_numpy(lo)), \
        (jnp.asarray(hi), jnp.asarray(lo))


def _ints(pair):
    hi, lo = pair
    return limbs_to_ints(np.asarray(lo), np.asarray(hi))


def _same(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(p),
                                      np.asarray(r).astype(np.int64))


def _python_divmod(x, y):
    q = abs(x) // abs(y)
    q = q if (x >= 0) == (y >= 0) else -q
    return q, x - q * y


# case: (function, int128 operands, static count or None, Python result)
_INT128_OPS = {
    "add128": ("add128", 2, None, lambda x, y: x + y),
    "sub128": ("sub128", 2, None, lambda x, y: x - y),
    "neg128": ("neg128", 1, None, lambda x, _: -x),
    "abs128": ("abs128", 1, None, lambda x, _: abs(x)),
    "mul_pow10 7": ("mul_pow10", 1, 7, lambda x, _: x * 10 ** 7),
    "mul_pow10 38": ("mul_pow10", 1, 38, lambda x, _: x * 10 ** 38),
    "shl128 13": ("shl128", 1, 13, lambda x, _: x << 13),
    "shr128u 13": ("shr128u", 1, 13, lambda x, _: (x & U128) >> 13),
}


@pytest.mark.parametrize("op", sorted(_INT128_OPS))
def test_int128_op_against_python_and_reference(op):
    name, arity, k, want = _INT128_OPS[op]
    a, b = _operands(zlib.crc32(op.encode()))
    (tah, tal), (jah, jal) = _both(a)
    (tbh, tbl), (jbh, jbl) = _both(b)
    extra = () if k is None else (k,)
    got = getattr(t_i128, name)(*(tah, tal, tbh, tbl)[:2 * arity], *extra)
    assert _ints(got) == [_wrap128(want(x, y)) for x, y in zip(a, b)]
    _same(got, getattr(g_i128, name)(*(jah, jal, jbh, jbl)[:2 * arity],
                                     *extra))


def test_int128_products_and_compare():
    a, b = _operands(1)
    (tah, tal), (jah, jal) = _both(a)
    (tbh, tbl), (jbh, jbl) = _both(b)
    got = t_i128.mul_i64(tal, tbl)
    assert _ints(got) == [int(x) * int(y) for x, y in
                          zip(tal.numpy(), tbl.numpy())]
    _same(got, g_i128.mul_i64(jal, jbl))
    got = t_i128.mul128_i64(tah, tal, tbl)
    assert _ints(got) == [_wrap128(x * int(m)) for x, m in
                          zip(a, tbl.numpy())]
    _same(got, g_i128.mul128_i64(jah, jal, jbl))
    _same(t_i128.mul_u64(tal, tbl), g_i128.mul_u64(jal, jbl))
    c = t_i128.cmp128(tah, tal, tbh, tbl).numpy()
    np.testing.assert_array_equal(c, [(x > y) - (x < y)
                                      for x, y in zip(a, b)])
    np.testing.assert_array_equal(c, np.asarray(g_i128.cmp128(jah, jal,
                                                              jbh, jbl)))
    np.testing.assert_array_equal(
        t_i128.to_float64(tah, tal).numpy().view(np.int64),
        np.asarray(g_i128.to_float64(jah, jal)).view(np.int64))


def test_int128_divmod():
    a, b = _operands(2, n=200)
    b = [y if y else 7 for y in b]
    (tah, tal), (jah, jal) = _both(a)
    (tbh, tbl), (jbh, jbl) = _both(b)
    got = t_i128.divmod128(tah, tal, tbh, tbl)
    want = [_python_divmod(x, y) for x, y in zip(a, b)]
    assert _ints(got[:2]) == [_wrap128(q) for q, _ in want]
    assert _ints(got[2:]) == [_wrap128(r) for _, r in want]
    _same(got, g_i128.divmod128(jah, jal, jbh, jbl))


@pytest.mark.parametrize("k", [1, 2, 9, 10, 18, 19, 27, 38])
def test_int128_power_of_ten_divisions(k):
    """The port divides by 10^k on 32-bit limbs; the reference runs its
    generic division: the same quotients, remainders and roundings."""
    a, _ = _operands(100 + k)
    (tah, tal), (jah, jal) = _both(a)
    ph, pl = g_i128.pow10_128(k)
    got = t_i128.divmod_pow10(tah, tal, k)
    want = [_wrap128(v) for x in a for v in _python_divmod(x, 10 ** k)]
    assert [v for q, r in zip(_ints(got[:2]), _ints(got[2:]))
            for v in (q, r)] == want
    _same(got, g_i128.divmod128(jah, jal, jnp.full_like(jah, ph),
                                jnp.full_like(jal, pl)))
    _same(t_i128.div_pow10_round(tah, tal, k),
          g_i128.div_pow10_round(jah, jal, k))


@pytest.mark.parametrize("k", [0, 1, 7, 12, 19, 38])
def test_int128_mul256_div_pow10(k):
    a, b = _operands(200 + k)
    (tah, tal), (jah, jal) = _both(a)
    (tbh, tbl), (jbh, jbl) = _both(b)
    got = t_i128.mul256_div_pow10(tah, tal, tbh, tbl, k)
    _same(got, g_i128.mul256_div_pow10(jah, jal, jbh, jbl, k))
    want = []
    for x, y in zip(a, b):
        p, d = abs(x * y), 10 ** k
        q = (p + d // 2) // d
        want.append(_wrap128(q if x * y >= 0 else -q))
    assert _ints(got) == want


# ---------------------------------------------------------------------------
# every decimal signature over four precisions
# ---------------------------------------------------------------------------

def _cases():
    """(name, argument type names, literal, target type name or None)."""
    out = []
    for i, t in enumerate(TYPES):
        for name in ("abs", "negative", "castBIGINT", "castFLOAT8",
                     "ceiling", "floor", "round", "truncate", "isnull",
                     "isnotnull"):
            out.append((name, (t,), None, None))
        for name in ("round", "truncate"):
            out.append((name, (t, "int32"), 1, None))
        for name in ("castDECIMAL", "castDECIMALNullOnOverflow"):
            out.append((name, (t,), None, TYPES[(i + 1) % 4]))
            out.append((name, (t,), None, TYPES[(i + 3) % 4]))
        for u in TYPES:
            for name in ("add", "subtract", "multiply", "divide", "mod",
                         "equal", "not_equal", "less_than",
                         "less_than_or_equal_to", "greater_than",
                         "greater_than_or_equal_to"):
                out.append((name, (t, u), None, None))
    for src in ("int32", "int64", "float32", "float64"):
        for name in ("castDECIMAL", "castDECIMALNullOnOverflow"):
            out.append((name, (src,), None, "decimal128(18,4)"))
    return out


CASES = _cases()


def _case_id(case):
    name, params, lit, target = case
    return f"{name}({','.join(params)})" + (f"->{target}" if target else "")


def _node(p, name, fields, lit, target):
    B = p.TreeExprBuilder
    args = [B.make_field(f) for f in fields]
    if lit is not None:
        args.append(B.make_int32_literal(lit))
    types = [a.dtype for a in args]
    if target is not None:
        return B.make_function(name, args, dtype_of(p, target))
    mod = g_dec if p is g else t_dec
    mod.ensure_registered(types)
    rt = p.global_registry().lookup_or_raise(name, types) \
        .signature.return_type
    return B.make_function(name, args, rt)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_decimal_signature_matches_reference(case):
    name, params, lit, target = case
    rng = np.random.default_rng(zlib.crc32(_case_id(case).encode()))
    cols = {f"a{i}": (t, *column(t, rng, N))
            for i, t in enumerate(params[:1 if lit is not None else None])}
    if name in ("divide", "mod"):
        lo, valid, hi = cols["a1"][1:]
        lo[::50], hi[::50] = 0, 0               # zero divisors

    def exprs(p, schema):
        node = _node(p, name, list(schema), lit, target)
        return [p.TreeExprBuilder.make_expression(
            node, p.dtypes.Field("out", node.dtype))]

    project_both(exprs, cols, N)


# ---------------------------------------------------------------------------
# literals, if/else, Arrow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("literal", ["1.25", "-0.01", "0",
                                     "12345678901234567890123.4567891234",
                                     None])
def test_decimal_literal_and_if_else(literal):
    """A literal (past 2^63 unscaled, negative, zero, null) against a
    column, and if/else choosing between decimal limb pairs."""
    t, lt = "decimal128(38,10)", dtype_of(gt, "decimal128(38,10)")
    rng = np.random.default_rng(3)
    cols = {"d": (t, *column(t, rng, N)), "c": ("bool", *column("bool", rng,
                                                                N))}

    rt = str(t_dec.result_type("add", lt, lt))

    def exprs(p, schema):
        B = p.TreeExprBuilder
        d, c = (B.make_field(f) for f in schema)
        lit = B.make_null(dtype_of(p, t)) if literal is None else \
            B.make_decimal_literal(literal, lt.precision, lt.scale)
        add = B.make_function("add", [d, lit], dtype_of(p, rt))
        return [B.make_expression(add, p.dtypes.Field("s", add.dtype)),
                B.make_expression(B.make_if(c, d, lit, dtype_of(p, t)),
                                  p.dtypes.Field("i", dtype_of(p, t))),
                B.make_expression(lit, p.dtypes.Field("l", dtype_of(p, t)))]

    project_both(exprs, cols, N)


@pytest.mark.parametrize("offset,length", [(0, 1000), (3, 500), (997, 3)])
def test_arrow_round_trip_sliced_with_nulls(offset, length):
    import decimal

    rng = np.random.default_rng(offset)
    vals = random_decimals(rng, 1000, 38)
    arr = pa.array([None if i % 7 == 3 else decimal.Decimal(f"{v}E-10")
                    for i, v in enumerate(vals)],
                   type=pa.decimal128(38, 10)).slice(offset, length)
    batch = pa.RecordBatch.from_arrays([arr], names=["d"])
    port = gt.from_arrow(batch, device=CPU)
    ref = g.from_arrow(batch)
    rc, pc = ref.column("d"), port.column("d")
    np.testing.assert_array_equal(pc.data.numpy(),
                                  np.asarray(rc.data)[:length])
    np.testing.assert_array_equal(pc.extra.numpy(),
                                  np.asarray(rc.extra)[:length])
    np.testing.assert_array_equal(pc.validity.numpy(),
                                  np.asarray(rc.validity)[:length])
    back = gt.to_arrow(port).column(0)
    assert back.equals(arr)
    assert back.type == pa.decimal128(38, 10)
    padded = gt.from_arrow(batch, pad_to=length + 5, device=CPU)
    assert not padded.column("d").validity[length:].any()


def test_from_columns_numpy_carries_decimal_limbs():
    rng = np.random.default_rng(9)
    lo, valid, hi = column("decimal128(28,6)", rng, 100)
    b = gt.from_columns_numpy({"d": ("decimal128(28,6)", lo, valid, hi)},
                              100, device=CPU)
    c = b.column("d")
    assert c.dtype == gt.dtypes.decimal128(28, 6)
    np.testing.assert_array_equal(c.data.numpy(), lo)
    np.testing.assert_array_equal(c.extra.numpy(), hi)
    with pytest.raises(ValueError, match="only decimal"):
        gt.from_columns_numpy({"x": ("int64", lo, valid, hi)}, 100,
                              device=CPU)


# ---------------------------------------------------------------------------
# runtime errors (Configuration.raise_errors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["divide", "mod", "castDECIMAL"])
def test_decimal_errors_raise_like_reference(case):
    rng = np.random.default_rng(4)
    t = "decimal128(18,4)"
    cols = {"a": (t, *column(t, rng, N)), "b": (t, *column(t, rng, N))}
    cols["b"][1][10] = cols["b"][3][10] = 0          # one zero divisor
    cols["a"][2][10] = cols["b"][2][10] = True
    outcomes = []
    for p in (g, gt):
        cfg = p.ConfigurationBuilder().with_raise_errors(True).build()
        schema = p.dtypes.Schema([p.dtypes.Field(n, dtype_of(p, t))
                                  for n in cols])
        fa, fb = list(schema)
        if case == "castDECIMAL":
            node = _node(p, case, [fa], None, "decimal128(9,2)")
        else:
            node = _node(p, case, [fa, fb], None, None)
        proj = p.make_projector(
            schema, [p.TreeExprBuilder.make_expression(
                node, p.dtypes.Field("o", node.dtype))], config=cfg,
            use_cache=False, **({"device": CPU} if p is gt else {}))
        ref_b, port_b = batches(cols, N)
        try:
            proj.evaluate(ref_b if p is g else port_b)
            outcomes.append(None)
        except p.EvaluationError as e:
            outcomes.append(str(e))
    assert outcomes[0] is not None
    assert outcomes[1] == outcomes[0]


# ---------------------------------------------------------------------------
# the slice as a whole: TPC-H Q1 and Q6 lineitem scans
# ---------------------------------------------------------------------------

def _reference_plan(port_plan):
    """The same FilterProject in gandiva_tpu (a plan document cannot carry
    Q1's interval_day literal, so the tree is rebuilt node by node)."""
    return g.make_filter_project(to_reference(port_plan.schema),
                                 to_reference(port_plan.condition),
                                 to_reference(port_plan.exprs),
                                 use_cache=False)


@pytest.mark.parametrize("query", ["q1", "q6", "q7"])
def test_tpch_scan_matches_reference_and_int64(query):
    n = 20_000
    port_plan = {"q1": t_entry.tpch_q1_scan, "q6": t_entry.tpch_q6_scan,
                 "q7": t_entry.tpch_q7_scan}[query](CPU)
    batch = t_entry.lineitem(n, seed=5, device=CPU)
    ref_batch = GBatch({
        name: GColumn(jnp.asarray(c.data.numpy()),
                      jnp.asarray(c.validity.numpy()), dtype_of(g, str(
                          c.dtype)),
                      dictionary=c.dictionary,
                      extra=None if c.extra is None else
                      jnp.asarray(c.extra.numpy()))
        for name, c in batch.columns.items()}, n)
    sel, out = port_plan.evaluate_device(batch)
    rsel, rout = _reference_plan(port_plan).evaluate_device(ref_batch)
    count = int(sel.count)
    assert count == int(rsel.count)
    np.testing.assert_array_equal(sel.indices[:count].numpy(),
                                  np.asarray(rsel.indices)[:count])
    for name in out.columns:
        pc, rc = out.column(name), rout.column(name)
        assert pc.dictionary is rc.dictionary   # the strings' one object
        for pt, rt_ in ((pc.data, rc.data), (pc.extra, rc.extra),
                        (pc.validity, rc.validity)):
            if pt is None and rt_ is None:      # no extra limb
                continue
            np.testing.assert_array_equal(pt[:count].numpy(),
                                          np.asarray(rt_)[:count])
    # a plain int64 reference at each result scale
    cols = {k: batch.column(k).data for k in batch.columns}
    ship, disc = cols["l_shipdate"].long(), cols["l_discount"]
    ep, qty, tax = cols["l_extendedprice"], cols["l_quantity"], cols["l_tax"]
    if query == "q1":
        keep = ship <= t_entry.Q1_SHIPDATE - t_entry.Q1_DELTA
        want = {"l_quantity": qty, "l_extendedprice": ep,
                "disc_price": ep * (100 - disc),
                "charge": ep * (100 - disc) * (100 + tax)}
    elif query == "q6":
        keep = ((ship >= t_entry.Q6_FROM) & (ship < t_entry.Q6_TO)
                & (disc >= 5) & (disc <= 7) & (qty < 2400))
        want = {"revenue": ep * disc}
    else:
        keep = (ship >= t_entry.Q7_FROM) & (ship <= t_entry.Q7_TO)
        want = {"volume": ep * (100 - disc)}
    idx = torch.nonzero(keep).flatten()
    assert count == idx.numel()
    assert torch.equal(sel.indices[:count].long(), idx)
    for name, w in want.items():
        assert torch.equal(out.column(name).data[:count], w[idx])
        assert not out.column(name).extra[:count].any()
    if query == "q7":   # the year of each ship date, by the calendar
        import datetime
        years = [(datetime.date(1970, 1, 1) + datetime.timedelta(days=d)).year
                 for d in ship[idx].tolist()]
        assert out.column("l_year").data[:count].tolist() == years
    if query == "q1":   # the two flags: their codes, under the one dictionary
        for name in ("l_returnflag", "l_linestatus"):
            assert torch.equal(out.column(name).data[:count],
                               cols[name][idx])
            assert out.column(name).dictionary is \
                t_entry.STRING_COLUMNS[name]
