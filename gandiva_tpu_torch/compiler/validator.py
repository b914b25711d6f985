"""ExprValidator — static validation of expression trees against a schema.

Reference: gandiva's ExprValidator (expr_validator.cc, SURVEY.md §2a#3) runs
at Make time, before any codegen: field existence + type agreement, function
signature resolution, if/boolean/IN well-formedness. Error strings follow the
reference's observable surface (pyarrow test_gandiva.py:159-161).
"""
from __future__ import annotations

from .. import dtypes as dt
from ..expr.nodes import (BooleanNode, FieldNode, FunctionNode, IfNode,
                          InNode, LiteralNode, Node)
from ..registry import decimal_ops
from ..registry.registry import ExpressionValidationError, global_registry


def validate(node: Node, schema: dt.Schema) -> dt.DataType:
    """Type-check ``node`` against ``schema``; returns its result type."""
    if isinstance(node, LiteralNode):
        return node.dtype

    if isinstance(node, FieldNode):
        name = node.field.name
        if name not in schema:
            raise ExpressionValidationError(
                f"Field {name} not in schema {schema}")
        actual = schema.field(name).dtype
        if actual != node.field.dtype:
            raise ExpressionValidationError(
                f"Field definition in schema {schema} different from "
                f"field in expression: schema has {actual}, expression "
                f"has {node.field.dtype} for field {name}")
        return actual

    if isinstance(node, FunctionNode):
        arg_types = [validate(a, schema) for a in node.args]
        decimal_ops.ensure_registered(arg_types)
        fn = global_registry().lookup_or_raise(node.name, arg_types)
        rt = fn.signature.return_type
        if rt is not None and rt != node.dtype:
            raise ExpressionValidationError(
                f"Function {node.name} returns {rt}, "
                f"but the expression declares {node.dtype}")
        return node.dtype

    if isinstance(node, IfNode):
        cond_t = validate(node.condition, schema)
        if cond_t.kind is not dt.TypeKind.BOOL:
            raise ExpressionValidationError(
                f"condition of if expression must be boolean, got {cond_t}")
        then_t = validate(node.then_node, schema)
        else_t = validate(node.else_node, schema)
        if then_t != else_t:
            raise ExpressionValidationError(
                f"if and else branches must return the same type; got "
                f"{then_t} and {else_t}")
        if then_t != node.dtype:
            raise ExpressionValidationError(
                f"if expression declares {node.dtype} but branches return "
                f"{then_t}")
        return node.dtype

    if isinstance(node, BooleanNode):
        if len(node.children) < 2:
            raise ExpressionValidationError(
                f"boolean {node.op} requires at least 2 children")
        for c in node.children:
            t = validate(c, schema)
            if t.kind is not dt.TypeKind.BOOL:
                raise ExpressionValidationError(
                    f"boolean expression has non-boolean child of type {t}")
        return dt.bool_

    if isinstance(node, InNode):
        ev_t = validate(node.eval_expr, schema)
        if ev_t != node.value_dtype:
            raise ExpressionValidationError(
                f"Evaluation expression for IN clause returns {ev_t} "
                f"values are of type {node.value_dtype}")
        return dt.bool_

    raise ExpressionValidationError(
        f"unknown node type {type(node).__name__}")
