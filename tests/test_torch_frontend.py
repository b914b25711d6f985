"""The port's front end against gandiva_tpu: builder, validator and registry
error strings, the registered signatures, and a JAX-free import."""
import os
import subprocess
import sys

import pytest

import gandiva_tpu as g
import gandiva_tpu_torch as gt
from gandiva_tpu.registry.registry import global_registry as g_registry
from gandiva_tpu_torch.registry.registry import global_registry as gt_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn):
    try:
        res = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return type(e).__name__, str(e)
    return "ok", str(res)


def _cpu(p):
    return {"device": "cpu"} if p is gt else {}


def _both(case):
    """Run ``case(package)`` on both packages; outcomes must be equal."""
    ref, port = _outcome(lambda: case(g)), _outcome(lambda: case(gt))
    assert port == ref
    return ref


# cases of test_projector_filter.py:185-252, as functions of the package
def _to_string(p):
    B, dt = p.TreeExprBuilder, p.dtypes
    f = dt.Field("x", dt.float64)
    z, y = dt.Field("z", dt.bool_), dt.Field("y", dt.bool_)
    notz = B.make_function("not", [B.make_field(z)], dt.bool_)
    return [B.make_int64_literal(2).to_string(),
            B.make_field(f).to_string(),
            B.make_function("add", [B.make_field(f),
                                    B.make_double_literal(1.0)],
                            dt.float64).to_string(),
            B.make_and([notz, B.make_field(y)]).to_string(),
            B.make_if(B.make_field(z), B.make_field(f), B.make_null(dt.float64),
                      dt.float64).to_string(),
            B.make_in_expression_int64(B.make_field(f), [3, 1, 2]).to_string(),
            B.make_literal(True, dt.bool_).to_string()]


_REJECTS = [
    lambda p: p.TreeExprBuilder.make_field(None),
    lambda p: p.TreeExprBuilder.make_function(
        None, [p.TreeExprBuilder.make_field(p.dtypes.Field("a", p.dtypes.int32))],
        p.dtypes.int32),
    lambda p: p.TreeExprBuilder.make_function("add", None, p.dtypes.int32),
    lambda p: p.TreeExprBuilder.make_if(
        None, p.TreeExprBuilder.make_int32_literal(1),
        p.TreeExprBuilder.make_int32_literal(1), p.dtypes.int32),
    lambda p: p.TreeExprBuilder.make_and(None),
    lambda p: p.TreeExprBuilder.make_condition(None),
    lambda p: p.TreeExprBuilder.make_expression(
        None, p.dtypes.Field("a", p.dtypes.int32)),
    lambda p: p.TreeExprBuilder.make_in_expression_int32(
        p.TreeExprBuilder.make_int32_literal(1), None),
    lambda p: p.TreeExprBuilder.make_boolean_literal("string"),
    lambda p: p.TreeExprBuilder.make_int32_literal(1.5),
    lambda p: p.TreeExprBuilder.make_string_literal(b"bytes"),
    lambda p: p.TreeExprBuilder.make_binary_literal("string"),
    lambda p: p.TreeExprBuilder.make_interval_day_literal(1, -5),
]


def _schema(p):
    dt = p.dtypes
    return dt.Schema([dt.Field("a", dt.int32), dt.Field("b", dt.float64),
                      dt.Field("c", dt.bool_)])


def _fields(p):
    B, s = p.TreeExprBuilder, _schema(p)
    return {n: B.make_field(s.field(n)) for n in "abc"}


def _project(p, root, out_type):
    B, dt = p.TreeExprBuilder, p.dtypes
    expr = B.make_expression(root, dt.Field("r", out_type(dt)))
    return p.make_projector(_schema(p), [expr], use_cache=False, **_cpu(p))


_INVALID = [
    # unknown field
    lambda p: _project(p, p.TreeExprBuilder.make_field(
        p.dtypes.Field("missing", p.dtypes.int32)), lambda dt: dt.int32),
    # field type differs from the schema
    lambda p: _project(p, p.TreeExprBuilder.make_field(
        p.dtypes.Field("a", p.dtypes.int64)), lambda dt: dt.int64),
    # unknown function
    lambda p: _project(p, p.TreeExprBuilder.make_function(
        "no_such_fn", [_fields(p)["a"]], p.dtypes.int32), lambda dt: dt.int32),
    # known function, unregistered argument types (lists signatures)
    lambda p: _project(p, p.TreeExprBuilder.make_function(
        "add", [_fields(p)["a"], _fields(p)["b"]], p.dtypes.float64),
        lambda dt: dt.float64),
    # declared return type differs from the registry's
    lambda p: _project(p, p.TreeExprBuilder.make_function(
        "add", [_fields(p)["a"], _fields(p)["a"]], p.dtypes.int64),
        lambda dt: dt.int64),
    # result field type differs from the expression
    lambda p: _project(p, _fields(p)["a"], lambda dt: dt.int64),
    # if: non-bool condition, mismatched branches, wrong declared type
    lambda p: _project(p, p.TreeExprBuilder.make_if(
        _fields(p)["a"], _fields(p)["a"], _fields(p)["a"], p.dtypes.int32),
        lambda dt: dt.int32),
    lambda p: _project(p, p.TreeExprBuilder.make_if(
        _fields(p)["c"], _fields(p)["a"], _fields(p)["b"], p.dtypes.int32),
        lambda dt: dt.int32),
    lambda p: _project(p, p.TreeExprBuilder.make_if(
        _fields(p)["c"], _fields(p)["a"], _fields(p)["a"], p.dtypes.int64),
        lambda dt: dt.int64),
    # boolean: one child, non-bool child
    lambda p: _project(p, p.TreeExprBuilder.make_and([_fields(p)["c"]]),
                       lambda dt: dt.bool_),
    lambda p: _project(p, p.TreeExprBuilder.make_or(
        [_fields(p)["c"], _fields(p)["a"]]), lambda dt: dt.bool_),
    # IN type mismatch (as a filter)
    lambda p: p.make_filter(_schema(p), p.TreeExprBuilder.make_condition(
        p.TreeExprBuilder.make_in_expression_int64(_fields(p)["a"], [1, 2])),
        use_cache=False, **_cpu(p)),
    # non-boolean filter condition
    lambda p: p.make_filter(_schema(p), p.TreeExprBuilder.make_condition(
        _fields(p)["a"]), use_cache=False, **_cpu(p)),
    # projector without expressions
    lambda p: p.make_projector(_schema(p), [], use_cache=False, **_cpu(p)),
]


def test_to_string_matches_reference():
    status, text = _both(_to_string)
    assert status == "ok"


@pytest.mark.parametrize("case", range(len(_REJECTS)))
def test_builder_errors_match_reference(case):
    status, _ = _both(_REJECTS[case])
    assert status == "TypeError"


@pytest.mark.parametrize("case", range(len(_INVALID)))
def test_validation_errors_match_reference(case):
    status, _ = _both(_INVALID[case])
    assert status == "ExpressionValidationError"


def _table(registry):
    return {key: f.signature.return_type for key, f in registry._table.items()}


_TEXT = ("string", "binary")


def _names_text(key, rt) -> bool:
    return any(str(t) in _TEXT for t in key[1]) or str(rt) in _TEXT


def _plain(table):
    """Entries of a registry table with no decimal parameter, as strings."""
    return {(n, tuple(map(str, pt))): str(rt) for (n, pt), rt in table.items()
            if not any(t.is_decimal for t in pt)}


def _modules(registry, prefix):
    """Each entry's implementing module, named as in the reference."""
    return {(n, tuple(map(str, pt))):
            f.impl.__module__.replace(prefix, "gandiva_tpu.")
            for (n, pt), f in registry._table.items()}


def test_signatures_match_reference():
    """The port's registry is the reference's, string and binary entries
    included. Entries with a decimal parameter register on demand and are
    held in test_decimal_signatures_match_reference."""
    port = _plain(_table(gt_registry()))
    ref = _plain(_table(g_registry()))
    assert port == ref
    assert any(_names_text(k, rt) for k, rt in port.items())
    # every function a port entry names comes from the same module; decimal
    # entries register on demand, so whatever ran earlier in the process may
    # have registered some in one package only: compare the entries both hold
    port_mods = _modules(gt_registry(), "gandiva_tpu_torch.")
    ref_mods = _modules(g_registry(), "gandiva_tpu.")
    shared = port_mods.keys() & ref_mods.keys()
    assert shared >= port.keys()
    assert all(ref_mods[k] == port_mods[k] for k in shared)
    # every alias resolves the same way
    assert gt_registry()._aliases == g_registry()._aliases


def _signatures(p):
    return {(x.name, tuple(map(str, x.param_types)), str(x.return_type))
            for x in p.get_registered_function_signatures()
            if not any(t.is_decimal for t in x.param_types)}


def test_missing_signatures_all_name_a_string_or_binary():
    """No signature is missing any more: the enumerated sets (aliases
    included) are equal, with the 138 that name a string or binary type
    (134 of them came with the string registry; isnull and isnotnull of
    string and binary were there before)."""
    port, ref = _signatures(gt), _signatures(g)
    assert port == ref
    assert sum(_names_text((n, pt), rt) for n, pt, rt in port) == 138


_DECIMALS = [(9, 2), (18, 4), (28, 6), (38, 10), (15, 2), (3, 2), (1, 0)]


def test_decimal_signatures_match_reference():
    """After ``ensure_registered`` over the same decimal argument types,
    both packages hold the same decimal signatures for them,
    castVARCHAR(decimal) included, each implemented in the same module."""
    from gandiva_tpu.registry import decimal_ops as g_dec
    from gandiva_tpu_torch.registry import decimal_ops as t_dec

    for p, mod in ((g, g_dec), (gt, t_dec)):
        types = [p.dtypes.decimal128(*ps) for ps in _DECIMALS]
        for a in types:
            mod.ensure_registered([a])
            for b in types:
                mod.ensure_registered([a, b])
    names = {f"decimal128({p},{s})" for p, s in _DECIMALS}

    def ours(p):
        out = {}
        for (n, pt), rt in _table(p.global_registry()).items():
            decs = [str(t) for t in pt if t.is_decimal]
            if decs and set(decs) <= names:
                out[(n, tuple(map(str, pt)))] = str(rt)
        return out

    port = ours(gt)
    assert port == ours(g)
    assert len(port) == 7 * 16 + 49 * 11
    port_mods = _modules(gt.global_registry(), "gandiva_tpu_torch.")
    ref_mods = _modules(g.global_registry(), "gandiva_tpu.")
    assert all(port_mods[k] == ref_mods[k] for k in port)


def test_get_registered_function_signatures():
    sigs = gt.get_registered_function_signatures()
    s = {(x.name, tuple(map(str, x.param_types)), str(x.return_type))
         for x in sigs}
    assert ("add", ("int32", "int32"), "int32") in s
    assert ("greater_than", ("float64", "float64"), "bool") in s
    assert ("lt", ("uint64", "uint64"), "bool") in s   # alias enumerated


def test_configuration_matches_reference():
    for p in (g, gt):
        c = p.ConfigurationBuilder().with_optimize(False).with_dump_ir(True) \
            .with_raise_errors(True).build()
        assert (c.optimize, c.dump_ir, c.raise_errors) == (False, True, True)
        assert p.ConfigurationBuilder.default_configuration() == \
            p.Configuration()


def test_import_is_jax_free():
    """The package, its entry points, its distribution layer, its native
    runtime (loaded and run) and chip_smoke.py import nothing of JAX or
    gandiva_tpu, and no file of gandiva_tpu is mapped into the process (its
    prebuilt host library among them)."""
    code = ("import sys, gandiva_tpu_torch, gandiva_tpu_torch.entrypoints, "
            "gandiva_tpu_torch.parallel, chip_smoke, pyarrow as pa; "
            "from gandiva_tpu_torch import native; "
            "assert native.like_match(pa.array(['ab']), 'a%').all(); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'gandiva_tpu' or "
            "m.startswith('gandiva_tpu.')]; "
            "bad += [l for l in open('/proc/self/maps') "
            "if '/gandiva_tpu/' in l]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema, cond = _schema(gt), gt.TreeExprBuilder.make_condition(
        _fields(gt)["c"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.make_filter(schema, cond, use_cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.from_numpy({"a": [1, 2]})
    from gandiva_tpu_torch.entrypoints import flagship_stream
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship_stream()
