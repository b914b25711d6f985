"""Serialized-plan ingestion — the planner-facing binding surface.

A copy of gandiva_tpu.plan over the port's builder; the ``make_*_from_plan``
helpers take a ``device`` as the port's other makers do.

Reference parity: Dremio's production entry path serializes expression trees
as protobuf (``types.proto``) and ships them across JNI into
``gandiva::Projector/Filter`` (SURVEY.md §2a#20, §3.5 — apache/arrow
``cpp/src/gandiva/jni/expression_registry_helper.cc`` ⚠, Java
``ExpressionTree``). This package keeps the same shape — a
language-neutral tree serialization an external planner can emit without
importing this package's Python node classes — but uses JSON (no protoc
dependency; the schema below is isomorphic to types.proto's node oneof).

Plan document::

    {"schema": [{"name": "a", "type": "int64", "nullable": true}, ...],
     "expressions": [{"root": <node>,
                      "result": {"name": "out", "type": "float64"}}, ...],
     "condition": {"root": <node>}}          # optional (Filter plans)

Node forms (one key each, mirroring the proto oneof):

- ``{"literal": {"type": "int64", "value": 2}}`` — ``value: null`` is a
  typed NULL; binary literals carry hex strings; decimal literals carry
  ``{"type": {"name": "decimal128", "precision": p, "scale": s},
  "value": "123.45"}``.
- ``{"field": "a"}`` — resolved against the plan's schema.
- ``{"function": {"name": "add", "args": [...], "return_type": "float64"}}``
- ``{"if": {"condition": ..., "then": ..., "else": ...,
  "return_type": "float64"}}``
- ``{"and": [...]}`` / ``{"or": [...]}``
- ``{"in": {"expr": ..., "values": [...], "type": "int64"}}``

``load_plan`` -> ``Plan``; ``make_projector_from_plan`` /
``make_filter_from_plan`` compile directly; ``dump_plan`` serializes a tree
built with TreeExprBuilder back to the document form (round-trip tested
through ``to_string`` equality).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from . import dtypes as dt
from .device import DEFAULT_DEVICE
from .expr.builder import TreeExprBuilder as B
from .expr.nodes import (BooleanNode, Condition, Expression, FieldNode,
                         FunctionNode, IfNode, InNode, LiteralNode, Node)


class PlanError(ValueError):
    """Malformed plan document (Status-style: raised at load time, never
    after compile — SURVEY.md §5.3)."""


def _parse_type(spec) -> dt.DataType:
    if isinstance(spec, str):
        if spec.startswith("decimal128("):
            body = spec[len("decimal128("):].rstrip(")")
            p, s = (int(x) for x in body.split(","))
            return dt.decimal128(p, s)
        return dt.from_name(spec)
    if isinstance(spec, dict):
        name = spec.get("name")
        if name == "decimal128":
            return dt.decimal128(int(spec["precision"]), int(spec["scale"]))
        return dt.from_name(name)
    raise PlanError(f"bad type spec: {spec!r}")


def _type_doc(t: dt.DataType):
    if t.is_decimal:
        return {"name": "decimal128", "precision": t.precision,
                "scale": t.scale}
    return str(t)


def parse_schema(doc: Sequence[dict]) -> dt.Schema:
    fields = []
    for f in doc:
        try:
            fields.append(dt.Field(f["name"], _parse_type(f["type"]),
                                   nullable=f.get("nullable", True)))
        except (KeyError, TypeError) as e:
            raise PlanError(f"bad schema field {f!r}: {e}") from None
    return dt.Schema(fields)


def _literal(doc: dict) -> LiteralNode:
    t = _parse_type(doc.get("type"))
    v = doc.get("value")
    if v is None:
        return B.make_null(t)
    if t.kind is dt.TypeKind.BINARY:
        v = bytes.fromhex(v) if isinstance(v, str) else bytes(v)
    if t.is_decimal:
        from decimal import Decimal
        return B.make_decimal_literal(Decimal(str(v)), t.precision, t.scale)
    return B.make_literal(v, t)


def parse_node(doc: dict, schema: dt.Schema) -> Node:
    """One JSON object -> one expression node (recursive)."""
    if not isinstance(doc, dict) or len(doc) != 1:
        raise PlanError(f"node must be a single-key object, got {doc!r}")
    (kind, body), = doc.items()
    if kind == "literal":
        return _literal(body)
    if kind == "field":
        name = body if isinstance(body, str) else body.get("name")
        try:
            f = schema.field(name)
        except KeyError:
            raise PlanError(f"field {name!r} not in plan schema") from None
        return B.make_field(f)
    # missing required keys surface as PlanError, not raw KeyError — the
    # documented load-time contract (ADVICE r3)
    def _get(b, key):
        if not isinstance(b, dict) or key not in b:
            raise PlanError(f"{kind!r} node missing required key {key!r}")
        return b[key]

    if kind == "function":
        args = [parse_node(a, schema) for a in body.get("args", [])]
        return B.make_function(_get(body, "name"), args,
                               _parse_type(_get(body, "return_type")))
    if kind == "if":
        return B.make_if(parse_node(_get(body, "condition"), schema),
                         parse_node(_get(body, "then"), schema),
                         parse_node(_get(body, "else"), schema),
                         _parse_type(_get(body, "return_type")))
    if kind in ("and", "or"):
        if not isinstance(body, list):
            raise PlanError(f"{kind!r} node body must be a list of nodes, "
                            f"got {type(body).__name__}")
        children = [parse_node(c, schema) for c in body]
        return B.make_and(children) if kind == "and" else B.make_or(children)
    if kind == "in":
        t = _parse_type(_get(body, "type"))
        values = _get(body, "values")
        if t.kind is dt.TypeKind.BINARY:
            values = [bytes.fromhex(v) for v in values]
        return B.make_in_expression(parse_node(_get(body, "expr"), schema),
                                    values, t)
    raise PlanError(f"unknown node kind {kind!r}")


class Plan:
    """A deserialized plan: schema + projector expressions + optional
    filter condition."""

    def __init__(self, schema: dt.Schema,
                 expressions: List[Expression],
                 condition: Optional[Condition] = None):
        self.schema = schema
        self.expressions = expressions
        self.condition = condition


def load_plan(doc) -> Plan:
    """Parse a plan document (JSON string, bytes, or already-parsed dict)."""
    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except json.JSONDecodeError as e:
            raise PlanError(f"invalid JSON: {e}") from None
    if not isinstance(doc, dict) or "schema" not in doc:
        raise PlanError("plan document must be an object with a 'schema'")
    schema = parse_schema(doc["schema"])
    exprs = []
    for e in doc.get("expressions", []):
        if not isinstance(e, dict) or "root" not in e:
            raise PlanError("expression entry must be an object with 'root'")
        root = parse_node(e["root"], schema)
        res = e.get("result", {})
        rtype = (_parse_type(res["type"]) if "type" in res
                 else getattr(root, "dtype", None))
        if rtype is None:
            raise PlanError("expression needs result.type (root type "
                            "unknown before validation)")
        exprs.append(B.make_expression(
            root, dt.Field(res.get("name", "out"), rtype)))
    condition = None
    if doc.get("condition") is not None:
        cond_doc = doc["condition"]
        if not isinstance(cond_doc, dict) or "root" not in cond_doc:
            raise PlanError("condition must be an object with 'root'")
        condition = B.make_condition(parse_node(cond_doc["root"], schema))
    return Plan(schema, exprs, condition)


def make_projector_from_plan(doc, selection_mode=None, configuration=None,
                             device=DEFAULT_DEVICE):
    """Compile a Projector straight from a plan document — the one-call
    equivalent of the reference's JNI ``buildProjector`` entry."""
    from .compiler.projector import make_projector

    plan = load_plan(doc)
    if not plan.expressions:
        raise PlanError("plan has no expressions")
    args = [plan.schema, plan.expressions]
    if selection_mode is not None:
        args.append(selection_mode)
    return make_projector(*args, config=configuration, device=device)


def make_filter_from_plan(doc, configuration=None, device=DEFAULT_DEVICE):
    """Compile a Filter straight from a plan document (JNI ``buildFilter``
    equivalent)."""
    from .compiler.projector import make_filter

    plan = load_plan(doc)
    if plan.condition is None:
        raise PlanError("plan has no condition")
    return make_filter(plan.schema, plan.condition, config=configuration,
                       device=device)


# ---------------------------------------------------------------------------
# Serialization (tree -> document), for round-trips and planner debugging.
# ---------------------------------------------------------------------------

def dump_node(node: Node):
    if isinstance(node, LiteralNode):
        v = node.value
        if v is not None and node.dtype.kind is dt.TypeKind.BINARY:
            v = bytes(v).hex()
        elif v is not None and node.dtype.is_decimal:
            # LiteralNode holds the UNSCALED int; document form carries the
            # human decimal string at the declared scale. The default
            # context is prec=28 and would silently round >28-significant-
            # digit decimal128 values, breaking round-trip (ADVICE r3) —
            # widen it for the scale shift.
            from decimal import Decimal, localcontext
            with localcontext() as ctx:
                ctx.prec = 80
                v = str(Decimal(v).scaleb(-node.dtype.scale))
        elif v is not None and not isinstance(v, (bool, int, float, str)):
            v = str(v)
        return {"literal": {"type": _type_doc(node.dtype), "value": v}}
    if isinstance(node, FieldNode):
        return {"field": node.field.name}
    if isinstance(node, IfNode):
        return {"if": {"condition": dump_node(node.condition),
                       "then": dump_node(node.then_node),
                       "else": dump_node(node.else_node),
                       "return_type": _type_doc(node.dtype)}}
    if isinstance(node, BooleanNode):
        return {node.op: [dump_node(c) for c in node.children]}
    if isinstance(node, InNode):
        values = sorted(node.values, key=lambda v: (str(type(v)), v))
        if node.value_dtype.kind is dt.TypeKind.BINARY:
            values = [bytes(v).hex() for v in values]
        return {"in": {"expr": dump_node(node.eval_expr),
                       "values": list(values),
                       "type": _type_doc(node.value_dtype)}}
    if isinstance(node, FunctionNode):
        return {"function": {"name": node.name,
                             "args": [dump_node(a) for a in node.args],
                             "return_type": _type_doc(node.dtype)}}
    raise PlanError(f"cannot serialize node {node!r}")


def dump_plan(schema: dt.Schema, expressions: Sequence[Expression] = (),
              condition: Optional[Condition] = None) -> dict:
    doc: Dict[str, Any] = {
        "schema": [{"name": f.name, "type": _type_doc(f.dtype),
                    "nullable": f.nullable} for f in schema.fields],
    }
    if expressions:
        doc["expressions"] = [
            {"root": dump_node(e.root),
             "result": {"name": e.result_field.name,
                        "type": _type_doc(e.result_field.dtype)}}
            for e in expressions]
    if condition is not None:
        doc["condition"] = {"root": dump_node(condition.root)}
    return doc
