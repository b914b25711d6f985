"""if/else with a string or binary result, held to ``pyarrow.compute``.

The reference cannot run these: its ``_if`` selects codes from the two
branches' dictionaries and keeps neither, so a projected output raises in
pyarrow and ``equal`` / ``length`` / ``upper`` over it raise
"string input must be dictionary-backed" (ROADMAP §3). The port merges the
branches' dictionaries (its host tables, ``TraceContext.add_table``) and
selects remapped codes, so these tests hold it to
``pyarrow.compute.if_else`` instead, with Gandiva's rule that a null
condition takes the else branch: literals, null literals, null values and
computed branches included, as a projected output and fed to ``equal``,
``length`` and ``upper``, in a projector, a filter and a fused plan."""
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import gandiva_tpu_torch as gt
from gandiva_tpu_torch import dtypes as dt

B = gt.TreeExprBuilder
N = 500
WORDS = ["apple", "Banana", "café", "", "日本語", "x", "kitten", "zz"]


def _batch(seed, kind):
    rng = np.random.default_rng(seed)

    def col(words, nulls):
        vals = [words[i] for i in rng.integers(0, len(words), N)]
        mask = rng.random(N) < nulls
        if kind == "binary":
            vals = [v.encode() for v in vals]
        return pa.array([None if m else v for v, m in zip(vals, mask)],
                        type=pa.string() if kind == "string"
                        else pa.binary())

    cond = pa.array([None if m else bool(b) for b, m in zip(
        rng.random(N) < 0.5, rng.random(N) < 0.1)])
    return pa.RecordBatch.from_arrays(
        [cond, col(WORDS[:5], 0.1), col(WORDS[3:], 0.2)],
        names=["c", "s", "t"])


def _schema(kind):
    t = dt.string if kind == "string" else dt.binary
    return dt.Schema([dt.Field("c", dt.bool_), dt.Field("s", t),
                      dt.Field("t", t)]), t


def _branch(name, schema, t, kind):
    if name in ("s", "t"):
        return B.make_field(schema.field(name))
    if name == "lit":
        v = "zz" if kind == "string" else b"zz"
        return (B.make_string_literal(v) if kind == "string"
                else B.make_binary_literal(v))
    if name == "null":
        return B.make_null(t)
    # a computed branch: upper(s) (strings only)
    return B.make_function("upper", [B.make_field(schema.field("s"))], t)


def _arrow_branch(name, rb, kind):
    if name in ("s", "t"):
        return rb.column(name)
    typ = pa.string() if kind == "string" else pa.binary()
    if name == "lit":
        return pa.array([("zz" if kind == "string" else b"zz")] * N,
                        type=typ)
    if name == "null":
        return pa.nulls(N, type=typ)
    return pc.utf8_upper(rb.column("s"))


def _expected(rb, then_, else_, kind):
    cond = pc.fill_null(rb.column("c"), False)   # null takes else
    return pc.if_else(cond, _arrow_branch(then_, rb, kind),
                      _arrow_branch(else_, rb, kind))


PAIRS = [("s", "t"), ("s", "lit"), ("lit", "t"), ("null", "t"),
         ("s", "null"), ("lit", "lit"), ("s", "s"), ("upper", "t")]


@pytest.mark.parametrize("kind,then_,else_", [
    (kind, a, b) for kind in ("string", "binary") for a, b in PAIRS
    if kind == "string" or "upper" not in (a, b)])   # upper: strings only
def test_if_else_string_projected(kind, then_, else_):
    schema, t = _schema(kind)
    rb = _batch(1, kind)
    ife = B.make_if(B.make_field(schema.field("c")),
                    _branch(then_, schema, t, kind),
                    _branch(else_, schema, t, kind), t)
    exprs = [B.make_expression(ife, dt.Field("o", t))]
    if kind == "string":
        exprs += [
            B.make_expression(B.make_function("length", [ife], dt.int32),
                              dt.Field("n", dt.int32)),
            B.make_expression(B.make_function("upper", [ife], t),
                              dt.Field("u", t))]
    proj = gt.make_projector(schema, exprs, device="cpu")
    out = proj.evaluate(rb)
    want = _expected(rb, then_, else_, kind)
    assert out[0].to_pylist() == want.to_pylist()
    if kind == "string":
        assert out[1].to_pylist() == pc.utf8_length(want).to_pylist()
        assert out[2].to_pylist() == pc.utf8_upper(want).to_pylist()
    # a second batch with other dictionaries: the remap tables follow
    rb2 = _batch(2, kind)
    assert proj.evaluate(rb2)[0].to_pylist() == \
        _expected(rb2, then_, else_, kind).to_pylist()


@pytest.mark.parametrize("then_,else_", [("s", "t"), ("s", "lit"),
                                         ("null", "t")])
def test_if_else_string_in_a_condition(then_, else_):
    kind = "string"
    schema, t = _schema(kind)
    rb = _batch(3, kind)
    ife = B.make_if(B.make_field(schema.field("c")),
                    _branch(then_, schema, t, kind),
                    _branch(else_, schema, t, kind), t)
    cond = B.make_condition(B.make_function(
        "equal", [ife, B.make_string_literal("kitten")], dt.bool_))
    want = np.nonzero(np.asarray(pc.fill_null(pc.equal(
        _expected(rb, then_, else_, kind), "kitten"), False)))[0]
    sel = gt.make_filter(schema, cond, device="cpu").evaluate(rb)
    np.testing.assert_array_equal(sel.to_numpy(), want)
    fp = gt.make_filter_project(
        schema, cond, [B.make_expression(ife, dt.Field("o", t))],
        device="cpu")
    fsel, (o,) = fp.evaluate(rb)
    np.testing.assert_array_equal(fsel.to_numpy(), want)
    assert o.to_pylist() == ["kitten"] * len(want)
