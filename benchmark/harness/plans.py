"""What a scan plan reads and writes, as plain data for the roofline
metrics: the columns its condition reads, and for each output its width
and the columns it reads (a bare field reads only itself).

Widths are the least a column takes in Arrow's layouts, so that no design
can move fewer bytes than the benchmark counts: a decimal that fits in 18
digits as one 8-byte word (Arrow's decimal64; the program keeps two int64
limbs), a wider decimal 16 B, a date32 4 B, a string as its 4-byte
dictionary index, a fixed-width number at its size. Validity is counted
only for columns that can hold nulls, as a bitmap of one bit a row."""
from __future__ import annotations

import re

_FIXED = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
          "int32": 4, "uint32": 4, "int64": 8, "uint64": 8, "float32": 4,
          "float64": 8, "date32": 4, "date64": 8, "string": 4, "binary": 4}


def width(type_name: str) -> int:
    """Bytes a value of the type named ``type_name`` (the program's
    ``str(dtype)``) takes at the least."""
    m = re.fullmatch(r"decimal128\((\d+),\s*(\d+)\)", type_name)
    if m:
        return 8 if int(m.group(1)) <= 18 else 16
    if type_name not in _FIXED:
        raise ValueError(f"no width for type {type_name!r}")
    return _FIXED[type_name]


def _children(node):
    """A node's child nodes, for the program's node classes (FieldNode,
    LiteralNode, FunctionNode, IfNode, BooleanNode, InNode)."""
    for attr in ("args", "children"):
        if hasattr(node, attr):
            return list(getattr(node, attr))
    if hasattr(node, "then_node"):
        return [node.condition, node.then_node, node.else_node]
    if hasattr(node, "eval_expr"):
        return [node.eval_expr]
    return []


def reads(node) -> dict:
    """{column: width} of every field under ``node``."""
    out, stack = {}, [node]
    while stack:
        n = stack.pop()
        if hasattr(n, "field"):
            out[n.field.name] = width(str(n.field.dtype))
        stack.extend(_children(n))
    return out


def facts(condition, exprs) -> dict:
    """The plan's condition reads and outputs, as plain data."""
    outputs = []
    for e in exprs:
        root = e.root
        outputs.append({
            "name": e.result_field.name,
            "width": width(str(e.result_field.dtype)),
            "field": root.field.name if hasattr(root, "field") else None,
            "reads": reads(root)})
    return {"condition": reads(condition.root), "outputs": outputs}
