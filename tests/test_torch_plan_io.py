"""The port's hash registry (registry/hash_ops.py), serialized plans
(plan.py) and streaming I/O (io.py) against gandiva_tpu: every hash
signature bit for bit (hash*AsDouble's float64 too), plan documents dumped
identically and loaded into the same trees, plan errors with the same
messages, evaluate_stream's results and error propagation, and a string
plan through a document and a stream."""
import json
import zlib

import numpy as np
import pyarrow as pa
import pytest

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu_torch.registry import hash_ops as t_hash

from gandiva_tpu.io import evaluate_stream as g_evaluate_stream
from torch_differential import (CPU, batches, column, dtype_of,
                                project_both, to_reference)

N = 1000


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

def _hash_signatures():
    reg = gt.global_registry()
    return sorted({(s.name, tuple(map(str, s.param_types)),
                    str(s.return_type))
                   for s in gt.get_registered_function_signatures()
                   if reg.lookup(s.name, s.param_types).impl.__module__
                   == t_hash.__name__})


HASHES = _hash_signatures()


def test_hash_signatures_are_the_reference_ones():
    ref = g.global_registry()
    want = sorted({(s.name, tuple(map(str, s.param_types)),
                    str(s.return_type))
                   for s in g.get_registered_function_signatures()
                   if ref.lookup(s.name, s.param_types).impl.__module__
                   == "gandiva_tpu.registry.hash_ops"})
    assert HASHES == want
    assert len(HASHES) == 128    # 16 types × 6, and hash32's two as "hash"


@pytest.mark.parametrize("sig", HASHES,
                         ids=[f"{n}({','.join(p)})" for n, p, _ in HASHES])
def test_hash_signature_matches_reference(sig):
    name, params, ret = sig
    rng = np.random.default_rng(zlib.crc32(repr(sig).encode()))
    cols = {f"a{i}": (t, *column(t, rng, N)) for i, t in enumerate(params)}

    def exprs(p, schema):
        B = p.TreeExprBuilder
        node = B.make_function(name, [B.make_field(f) for f in schema],
                               dtype_of(p, ret))
        return [B.make_expression(node, p.dtypes.Field("out", node.dtype))]

    project_both(exprs, cols, N)


def test_hash64_as_double_is_unsigned():
    """hash64AsDouble converts the uint64 hash: about half the hashes have
    the top bit set, and none of them may come out negative."""
    out = project_both(
        lambda p, s: [p.TreeExprBuilder.make_expression(
            p.TreeExprBuilder.make_function(
                "hash64AsDouble", [p.TreeExprBuilder.make_field(s.field("a"))],
                p.dtypes.float64), p.dtypes.Field("h", p.dtypes.float64))],
        {"a": ("int64", *column("int64", np.random.default_rng(1), N))}, N)
    h = out.column("h").data.numpy()
    assert (h >= 0).all() and (h >= 2.0 ** 63).sum() > N // 4


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _trees(p):
    """(schema, expressions, condition) trees of package ``p`` covering
    every node kind and the decimal and binary literals."""
    B, dt = p.TreeExprBuilder, p.dtypes
    schema = dt.Schema([dt.Field("x", dt.int64), dt.Field("d",
                                                          dt.decimal128(38, 10)),
                        dt.Field("b", dt.binary), dt.Field("s", dt.string),
                        dt.Field("t", dt.date32, nullable=False)])
    x, d, b, s, t = (B.make_field(f) for f in schema)
    big = B.make_decimal_literal("-1234567890123456789012345678.0123456789",
                                 38, 10)
    out = []
    out.append(([B.make_expression(
        B.make_function("add", [d, big], dt.decimal128(38, 10)),
        dt.Field("r", dt.decimal128(38, 10)))], None))
    out.append(([B.make_expression(
        B.make_if(B.make_function("greater_than", [x, B.make_int64_literal(2)],
                                  dt.bool_),
                  x, B.make_null(dt.int64), dt.int64), dt.Field("o",
                                                                dt.int64))],
                B.make_condition(B.make_or([
                    B.make_function("equal", [b, B.make_binary_literal(
                        b"\x00\xff\x10")], dt.bool_),
                    B.make_in_expression_int64(x, {5, 1, 3}),
                    B.make_in_expression_string(s, {"a", "b"})]))))
    out.append(([], B.make_condition(B.make_and([
        B.make_function("less_than", [t, B.make_literal(9131, dt.date32)],
                        dt.bool_),
        B.make_function("greater_than_or_equal_to",
                        [d, B.make_decimal_literal("0.05", 3, 2)],
                        dt.bool_)]))))
    return [(schema, e, c) for e, c in out]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_dump_plan_matches_reference_and_round_trips(k):
    schema, exprs, cond = _trees(gt)[k]
    ref_schema, ref_exprs, ref_cond = _trees(g)[k]
    doc = json.loads(json.dumps(gt.dump_plan(schema, exprs, cond)))
    assert doc == json.loads(json.dumps(g.dump_plan(ref_schema, ref_exprs,
                                                    ref_cond)))
    plan = gt.load_plan(json.dumps(doc))
    ref = g.load_plan(json.dumps(doc))
    assert plan.schema == schema
    assert [e.to_string() for e in plan.expressions] == \
        [e.to_string() for e in ref.expressions] == \
        [e.to_string() for e in exprs]
    assert (plan.condition is None) == (cond is None)
    if cond is not None:
        assert plan.condition.to_string() == ref.condition.to_string() == \
            cond.to_string()
    assert gt.dump_plan(plan.schema, plan.expressions, plan.condition) == doc
    # the loaded tree is the reference's, node for node
    assert to_reference(tuple(plan.expressions)) == tuple(ref.expressions)


_BAD = [
    "{nope", {"expressions": []},
    {"schema": [{"name": "a", "type": "int64"}],
     "condition": {"root": {"field": "zz"}}},
    {"schema": [{"name": "a", "type": "int64"}],
     "condition": {"root": {"frobnicate": {}}}},
    {"schema": [{"name": "a", "type": "int64"}],
     "expressions": [{"root": {"function": {"args": []}}}]},
    {"schema": [{"name": "a", "type": "int64"}],
     "expressions": [{"root": {"and": {"x": 1}}}]},
    {"schema": [{"name": "a"}]},
    {"schema": [{"name": "a", "type": "int64"}], "expressions": [{}]},
    {"schema": [{"name": "a", "type": "int64"}], "condition": {}},
]


@pytest.mark.parametrize("doc", _BAD, ids=range(len(_BAD)))
def test_plan_errors_match_reference(doc):
    msgs = []
    for p in (g, gt):
        with pytest.raises(p.PlanError) as e:
            p.load_plan(doc)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_plans_compile_on_the_port_and_evaluate_like_the_reference():
    doc = {
        "schema": [{"name": "d", "type": {"name": "decimal128",
                                          "precision": 18, "scale": 4}},
                   {"name": "a", "type": "int64"}],
        "expressions": [{"root": {"function": {
            "name": "multiply",
            "args": [{"field": "d"}, {"literal": {"type": "decimal128(9,2)",
                                                  "value": "-2.50"}}],
            "return_type": "decimal128(28,6)"}},
            "result": {"name": "m", "type": "decimal128(28,6)"}}],
        "condition": {"root": {"function": {
            "name": "greater_than",
            "args": [{"field": "a"}, {"literal": {"type": "int64",
                                                  "value": 0}}],
            "return_type": "bool"}}},
    }
    rng = np.random.default_rng(2)
    cols = {"d": ("decimal128(18,4)", *column("decimal128(18,4)", rng, N)),
            "a": ("int64", *column("int64", rng, N))}
    ref_b, port_b = batches(cols, N)
    proj = gt.make_projector_from_plan(doc, device=CPU)
    assert proj.device.type == "cpu"
    out = proj.evaluate_device(port_b).column("m")
    ref = g.make_projector_from_plan(doc).evaluate_device(ref_b).column("m")
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(out.extra.numpy(), np.asarray(ref.extra))
    sel = gt.make_filter_from_plan(json.dumps(doc), device=CPU) \
        .evaluate(port_b).to_numpy()
    np.testing.assert_array_equal(
        sel, g.make_filter_from_plan(doc).evaluate(ref_b).to_numpy())


# ---------------------------------------------------------------------------
# streaming I/O
# ---------------------------------------------------------------------------

def _stream(n_batches, rows, seed=0):
    import decimal

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        vals = rng.integers(-10 ** 12, 10 ** 12, rows)
        out.append(pa.RecordBatch.from_arrays(
            [pa.array(rng.integers(0, 1000, rows) + i),
             pa.array([None if v % 11 == 0 else decimal.Decimal(int(v))
                       .scaleb(-2) for v in vals],
                      type=pa.decimal128(18, 2))], names=["a", "d"]))
    return out


def _stream_plan(p, kind):
    B, dt = p.TreeExprBuilder, p.dtypes
    schema = dt.Schema([dt.Field("a", dt.int64),
                        dt.Field("d", dt.decimal128(18, 2))])
    a, d = B.make_field(schema.field("a")), B.make_field(schema.field("d"))
    cond = B.make_condition(B.make_function(
        "greater_than", [a, B.make_int64_literal(500)], dt.bool_))
    exprs = [B.make_expression(B.make_function(
        "multiply", [a, B.make_int64_literal(2)], dt.int64),
        dt.Field("r", dt.int64)),
        B.make_expression(B.make_function("negative", [d],
                                          dt.decimal128(18, 2)),
                          dt.Field("n", dt.decimal128(18, 2)))]
    kw = {"device": CPU} if p is gt else {}
    if kind == "projector":
        return p.make_projector(schema, exprs, use_cache=False, **kw)
    if kind == "filter":
        return p.make_filter(schema, cond, use_cache=False, **kw)
    return p.make_filter_project(schema, cond, exprs, use_cache=False, **kw)


@pytest.mark.parametrize("kind", ["projector", "filter", "filter_project"])
def test_evaluate_stream_matches_reference(kind):
    src = _stream(4, 700)
    ref = list(g_evaluate_stream(_stream_plan(g, kind), src))
    plan = _stream_plan(gt, kind)
    got = list(gt.io.evaluate_stream(plan, iter(src), depth=1))
    assert len(got) == len(ref) == 4
    for r, o in zip(ref, got):
        if kind == "filter":
            np.testing.assert_array_equal(o.to_numpy(), r.to_numpy())
            continue
        if kind == "filter_project":
            np.testing.assert_array_equal(o[0].to_numpy(), r[0].to_numpy())
            r, o = r[1], o[1]
        for ra, oa in zip(r, o):
            assert oa.equals(ra)
    assert plan.stats["evaluations"] == 4
    assert plan.stats["rows_in"] == 2800


def test_evaluate_stream_device_only_stays_on_the_device():
    plan = _stream_plan(gt, "projector")
    outs = list(gt.io.evaluate_stream(plan, _stream(3, 100),
                                      device_only=True))
    assert all(isinstance(o, gt.Batch) and o.device.type == "cpu"
               for o in outs)
    assert outs[0].column("n").extra is not None


@pytest.mark.parametrize("where", ["source", "conversion"])
def test_prefetcher_propagates_errors(where):
    def source():
        yield pa.RecordBatch.from_arrays([pa.array([1, 2])], names=["a"])
        if where == "source":
            raise RuntimeError("source failed")
        # a list column has no engine type: its conversion raises
        yield pa.RecordBatch.from_arrays([pa.array([[1], [2]])], names=["a"])

    it = iter(gt.io.BatchPrefetcher(source(), device=CPU))
    first = next(it)
    assert first.column("a").data.tolist() == [1, 2]
    err = RuntimeError if where == "source" else ValueError
    with pytest.raises(err):
        list(it)


def test_string_plan_through_a_document_and_a_stream():
    """A plan over string and binary columns (a transform, LIKE, string
    IN, binary IN, concat with a literal) dumped to a document, loaded,
    and run by evaluate_stream over Arrow batches whose dictionaries
    differ batch to batch: the port's results equal the reference's."""
    rng = np.random.default_rng(8)
    words = ["alpha", "beta", "gamma", "日本", "", "a_b", "delta"]
    arrow_batches = [pa.RecordBatch.from_arrays(
        [pa.array(rng.choice(words[k:] + words[:k], 50).tolist()),
         pa.array([w.encode() for w in rng.choice(words, 50)],
                  type=pa.binary())], names=["s", "b"]) for k in range(3)]
    results = []
    for p in (g, gt):
        B, dt = p.TreeExprBuilder, p.dtypes
        schema = dt.Schema([dt.Field("s", dt.string),
                            dt.Field("b", dt.binary)])
        s, b = (B.make_field(f) for f in schema)
        nodes = [B.make_function("upper", [s], dt.string),
                 B.make_function("like", [s, B.make_string_literal("%a%")],
                                 dt.bool_),
                 B.make_in_expression_string(s, ["beta", "日本"]),
                 B.make_in_expression_binary(b, [b"alpha", b""]),
                 B.make_function("concat", [s, B.make_string_literal("!")],
                                 dt.string)]
        exprs = [B.make_expression(n, dt.Field(f"o{i}", n.dtype))
                 for i, n in enumerate(nodes)]
        doc = p.dump_plan(schema, exprs)
        kw = {"device": CPU} if p is gt else {}
        proj = p.make_projector_from_plan(doc, **kw)
        stream = (g_evaluate_stream if p is g
                  else gt.io.evaluate_stream)(proj, arrow_batches)
        results.append([[o.to_pylist() for o in outs] for outs in stream])
    assert results[1] == results[0]
