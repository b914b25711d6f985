"""The plan compiler: a plan's expression trees → one generated CUDA C++ source.

The counterpart of the lowering behind the JAX package's
``jax.jit(self._run)`` (gandiva_tpu/compiler/projector.py:70): where XLA
fused the decomposed plan into one program, this module walks the trees as
``ExprDecomposer`` does and writes one kernel that computes, a row per
thread, every compiled node's value and validity in registers, reading each
input column once and writing only what the rest of the plan reads.

Which nodes compile is fixed here, at Make:

- a function node compiles when its registry entry has an emitter
  (``NativeFunction.emit``), which every entry has but ``random`` (its
  draws are the eager route's ``torch.Generator`` stream) and the per-row
  string routes, which read device values back to the host:
  castVARCHAR / castVARBINARY of a number or a decimal, and concat of two
  strings neither of which is a literal (``eager_if``: it may take its
  per-row route, decided per batch on the host);
- if, boolean (Kleene and/or) and IN nodes compile, but IN over a decimal;
- the function nodes that do not compile stay eager: ``ExprDecomposer``
  evaluates them before the kernel, and each value becomes a kernel
  input, as XLA treats a custom call;
- fields and literals are leaves: a field is a kernel input, a literal a
  constant in the source, written by its bits (a string literal is code 0
  of its one-entry dictionary).

Strings and binaries compile as the reference's ``jax.jit(self._run)``
fuses its ``tables`` argument: the dictionary work stays on the host, and
the kernel reads the host tables. A string value in the kernel is its
int32 code. A string → scalar function, a string compare, an IN over a
string and an if/else of strings each declare their tables at Make
(``g.table``), and the kernel reads ``table[clamp(code)]`` a row; a
string → string function passes its argument's code on. At evaluate time
each such node's host side (``NativeFunction.host``; ``merge_dictionaries``
and ``string_in_table`` for if/else and IN) builds its tables through
``TraceContext.add_table``, memoized by the node's key, and each table is
passed to the launch as a pointer and a length. The source holds no
dictionary-dependent value, so one library serves every batch and
dictionary.

Over a selection vector (``Projector.evaluate(selection=...)``, the
counterpart of ``jax.jit(self._run_selected)``) a kernel reads each field
at the selected row ``sel[i]`` itself; only the fields that an eager node
or a root reads (``Program.eager_fields``) are gathered before it.

An eager node that reads a compiled value runs after the kernel that
writes it, so a plan is cut into stages: stage s's eager nodes, then
stage s's kernel. The plans of the entry points have one stage, one
kernel. Every input column's validity pointer may be null, read as
all valid, so a column with no validity costs no pass.

The generated source builds with nvcc (the card) and with g++ (the host
build the tests use): the per-row body is a ``__host__ __device__``
function over the helpers of ``csrc/plan_prelude.h``.

Emitter protocol (``NativeFunction.emit``): ``emit(g, args, return_type)``
with ``args`` a list of ``CArg`` (``v``: the C expression of the value,
``m``: of its validity, ``dtype``); it returns the C expression of the
value (null-if-null: the validity is the AND of the arguments'), or a
``(value, validity)`` pair, validity None meaning always valid (null-never
and null-internal functions), or a ``CArg`` (a literal result: chr,
space). ``g.error(pred, args, message)`` records a runtime-error site
(Configuration.raise_errors); ``g.tmp(ctype, expr)`` names an
intermediate; ``g.table(ctype, code)`` declares the node's next host
table, of C type ``ctype``, in the order its host side builds them, and
returns the C expression of its entry at ``code``, clamped into the table.
An emitter may carry ``literal = True``: its value is a literal; and
``eager_if(lits)``: the node stays eager, given which arguments are
literals.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..expr.nodes import (BooleanNode, FieldNode, FunctionNode, IfNode,
                          InNode, LiteralNode, Node)
from ..registry import decimal_ops
from ..registry.registry import Nullability, global_registry

PRELUDE = Path(__file__).resolve().parents[1] / "csrc" / "plan_prelude.h"
THREADS = 256                    # threads a block of every generated kernel

Key = Tuple[int, ...]            # a node's place: root index, child indices

_CTYPES = {
    dt.TypeKind.BOOL: "bool", dt.TypeKind.INT8: "int8_t",
    dt.TypeKind.INT16: "int16_t", dt.TypeKind.INT32: "int32_t",
    dt.TypeKind.INT64: "int64_t", dt.TypeKind.UINT8: "uint8_t",
    dt.TypeKind.UINT16: "uint16_t", dt.TypeKind.UINT32: "uint32_t",
    dt.TypeKind.UINT64: "uint64_t", dt.TypeKind.FLOAT32: "float",
    dt.TypeKind.FLOAT64: "double", dt.TypeKind.DATE32: "int32_t",
    dt.TypeKind.DATE64: "int64_t", dt.TypeKind.TIME32: "int32_t",
    dt.TypeKind.TIME64: "int64_t", dt.TypeKind.TIMESTAMP: "int64_t",
    dt.TypeKind.INTERVAL_DAY: "int64_t", dt.TypeKind.INTERVAL_YEAR: "int32_t",
    dt.TypeKind.STRING: "int32_t", dt.TypeKind.BINARY: "int32_t",
    dt.TypeKind.DECIMAL128: "gt_i128",
}

# the torch dtype of a host table the kernel reads as each C type
TABLE_DTYPES = {"bool": torch.bool, "int8_t": torch.int8,
                "int32_t": torch.int32, "int64_t": torch.int64,
                "float": torch.float32, "double": torch.float64}


def table_ctype(np_dtype) -> str:
    """The C type the kernel reads a host table of numpy ``np_dtype`` as."""
    t = torch.from_numpy(np.empty(0, np_dtype)).dtype
    return next(c for c, d in TABLE_DTYPES.items() if d == t)


def ctype(t: dt.DataType) -> str:
    """The C type a value of ``t`` is computed in (unsigned types as
    themselves; a decimal as one __int128)."""
    return _CTYPES[t.kind]


def c_int(value: int, t: dt.DataType) -> str:
    """An integer constant of C type ``ctype(t)``, by its bits."""
    bits = int(value) & ((1 << t.bit_width) - 1)
    return f"(({ctype(t)})0x{bits:x}ULL)"


def c_u128(value: int) -> str:
    """A non-negative constant below 2^128 as a ``gt_u128``."""
    return (f"((gt_u128)gt_i128_of(0x{value >> 64:x}ULL, "
            f"0x{value & ((1 << 64) - 1):x}ULL))")


def pow10(k: int) -> str:
    return c_u128(10 ** k)


def c_literal(value, t: dt.DataType) -> str:
    """``value`` as a constant of ``t``, converted as the eager route's
    literals are (``np.asarray(value, dtype=t.np_dtype)``): floats and
    integers by their bits, a decimal's unscaled value as its two words."""
    if t.is_decimal:
        v = int(value) & ((1 << 128) - 1)
        return f"gt_i128_of(0x{v >> 64:x}ULL, 0x{v & ((1 << 64) - 1):x}ULL)"
    if t.is_varlen:
        return "((int32_t)0)"
    x = np.asarray(value, dtype=t.np_dtype)
    if t.kind is dt.TypeKind.BOOL:
        return "true" if bool(x) else "false"
    if t.kind is dt.TypeKind.FLOAT64:
        return f"gt_f64_bits(0x{int(x.view(np.uint64)):x}ULL)"
    if t.kind is dt.TypeKind.FLOAT32:
        return f"gt_f32_bits(0x{int(x.view(np.uint32)):x}u)"
    return c_int(int(x), t)


def children(node: Node) -> Tuple[Node, ...]:
    """A node's operands in the order the decomposer evaluates them."""
    if isinstance(node, FunctionNode):
        return node.args
    if isinstance(node, IfNode):
        return (node.condition, node.then_node, node.else_node)
    if isinstance(node, BooleanNode):
        return node.children
    if isinstance(node, InNode):
        return (node.eval_expr,)
    return ()


def _and(terms: Sequence[str]) -> str:
    terms = [t for t in terms if t != "true"]
    if "false" in terms:
        return "false"
    if len(terms) == 1:
        return terms[0]
    return " && ".join(f"({t})" for t in terms) if terms else "true"


def _is_name(expr: str) -> bool:
    return expr.replace("_", "a").isalnum()


@dataclasses.dataclass(frozen=True)
class CArg:
    """An emitter's operand: C expressions of its value and validity; a
    literal operand also carries its Python value, as the eager route's
    ``Val.literal`` does (round's digits, the decimal rounding scale)."""
    v: str
    m: str
    dtype: dt.DataType
    literal: object = None
    is_literal: bool = False


@dataclasses.dataclass
class Port:
    """A kernel input or output: a field column (``ref`` its name) or a
    node's value (``ref`` its key), from pointer ``first`` on: its limbs
    (a decimal's hi then lo), then its validity; a mask output is one
    pointer. ``hi_read``: an input decimal's high limb is read (False when
    every use needs only the value mod 2^64)."""
    ref: object
    dtype: dt.DataType
    first: int
    mask: bool = False
    hi_read: bool = True

    @property
    def limbs(self) -> int:
        return 2 if self.dtype.is_decimal else 1

    @property
    def pointers(self) -> int:
        return 1 if self.mask else self.limbs + 1


@dataclasses.dataclass
class Stage:
    """Eager nodes (keys, children first), then the host side of the
    compiled nodes that read host tables (``hosts``), then one kernel over
    ``inputs`` and ``tables`` (node key, its table's order within the node,
    C type) writing ``outputs`` (none for the eager nodes after the last
    kernel)."""
    index: int
    eager: List[Key]
    inputs: List[Port]
    outputs: List[Port]
    hosts: List[Key] = dataclasses.field(default_factory=list)
    tables: List[Tuple[Key, int, str]] = dataclasses.field(
        default_factory=list)

    @property
    def launches(self) -> bool:
        return bool(self.outputs)


@dataclasses.dataclass
class Program:
    """What ``generate`` made of a plan: the source, its stages, each
    node's route (``kinds``: "compiled", "eager" or "leaf"), each node's
    place in the decomposer's post-order (``post``), and the runtime-error
    sites, site j at ``sites[j] = (post, order within the node, message)``."""
    source: str
    stages: List[Stage]
    nodes: Dict[Key, Node]
    kinds: Dict[Key, str]
    post: Dict[Key, int]
    sites: List[Tuple[int, int, str]]

    @property
    def kernels(self) -> int:
        return sum(1 for s in self.stages if s.launches)

    def count(self, kind: str) -> int:
        return sum(1 for k in self.kinds.values() if k == kind)

    @property
    def eager_fields(self) -> List[str]:
        """The fields that a root is or an eager node reads: over a
        selection, only these are gathered; the kernels read the rest at
        the selected rows themselves."""
        return sorted({node.field.name for key, node in self.nodes.items()
                       if isinstance(node, FieldNode)
                       and (len(key) == 1 or self.kinds[key[:-1]] == "eager")})


def _route(node: Node, fn, lits) -> str:
    if isinstance(node, (LiteralNode, FieldNode)):
        return "leaf"
    if isinstance(node, FunctionNode):
        eager_if = getattr(fn.emit, "eager_if", None)
        ok = fn.emit is not None and not (eager_if and eager_if(lits))
    elif isinstance(node, InNode):
        ok = not node.value_dtype.is_decimal
    else:
        ok = True
    return "compiled" if ok else "eager"


def needs_host(node: Node, fn) -> bool:
    """A compiled node whose host side runs before its kernel: a string
    entry's (``NativeFunction.host``), an if/else of strings, an IN over a
    string."""
    if isinstance(node, FunctionNode):
        return fn.host is not None
    if isinstance(node, IfNode):
        return node.dtype.is_varlen
    return isinstance(node, InNode) and node.value_dtype.is_varlen


class _Emitter:
    """The C text of one stage's row function."""

    def __init__(self, prog: "_Builder", stage: int):
        self.prog = prog
        self.stage = stage
        self.lines: List[str] = []
        self.inputs: Dict[object, Tuple[Port, str]] = {}
        self.in_ports: List[Port] = []
        self.tables: List[Tuple[Key, int, str]] = []
        self.n = 0
        self._key: Key = ()
        self._sub = 0
        self._tabs = 0

    # -- the emitter protocol ------------------------------------------
    def tmp(self, ct: str, expr: str) -> str:
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"  const {ct} {name} = {expr};")
        return name

    def error(self, pred: str, args: Sequence[CArg], message: str) -> None:
        if not self.prog.check_errors:
            return
        site = len(self.prog.sites)
        self.prog.sites.append((self.prog.post[self._key], self._sub,
                                message))
        self._sub += 1
        cond = _and([pred] + [a.m for a in args] + ["i < len"])
        self.lines.append(f"  if ({cond}) gt_flag(a.flags, {site});")

    def table(self, ct: str, code: str) -> str:
        name = f"tb{len(self.tables)}"
        self.tables.append((self._key, self._tabs, ct))
        self._tabs += 1
        return f"{name}[gt_code({code}, {name}_n)]"

    # -- inputs ----------------------------------------------------------
    def _input(self, ref, t: dt.DataType, key: Key) -> CArg:
        if ref not in self.inputs:
            port = Port(ref, t, 0, hi_read=False)
            j = len(self.in_ports)
            self.in_ports.append(port)
            self.inputs[ref] = (port, f"x{j}")
        port, name = self.inputs[ref]
        port.hi_read |= not self.prog.low.get(key, False)
        return CArg(name, f"{name}m", t)

    # -- nodes -----------------------------------------------------------
    def node(self, key: Key) -> CArg:
        prog = self.prog
        node = prog.nodes[key]
        kind = prog.kinds[key]
        if isinstance(node, FieldNode):
            return self._input(("field", node.field.name), node.dtype, key)
        if isinstance(node, LiteralNode):
            t = node.dtype
            if node.value is None:
                zero = "((gt_i128)0)" if t.is_decimal else f"(({ctype(t)})0)"
                return CArg(zero, "false", t, None, True)
            return CArg(c_literal(node.value, t), "true", t, node.value, True)
        if kind == "eager" or prog.stage[key] < self.stage:
            return self._input(("node", key), node.dtype, key)
        kids = [self.node(key + (j,)) for j in range(len(children(node)))]
        self._key, self._sub, self._tabs = key, 0, 0
        if isinstance(node, FunctionNode):
            out = self._function(key, node, kids)
            if isinstance(out, CArg):
                return out
            value, valid = out
        elif isinstance(node, IfNode):
            c, th, el = kids
            sel = self.tmp("bool", _and([c.v, c.m]))
            if node.dtype.is_varlen:
                # each branch's code remapped into the merged dictionary
                th = dataclasses.replace(th, v=self.table("int32_t", th.v))
                el = dataclasses.replace(el, v=self.table("int32_t", el.v))
            value = f"{sel} ? {th.v} : {el.v}"
            valid = "true" if th.m == el.m == "true" else \
                f"{sel} ? {th.m} : {el.m}"
        elif isinstance(node, BooleanNode):
            value, valid = self._boolean(node.op, kids)
        elif node.value_dtype.is_varlen:
            value, valid = self.table("bool", kids[0].v), kids[0].m
        else:
            value, valid = self._in(node, kids[0])
        v = self.tmp(ctype(node.dtype), value)
        m = valid if _is_name(valid) else self.tmp("bool", valid)
        return CArg(v, m, node.dtype)

    def _function(self, key: Key, node: FunctionNode, kids: List[CArg]):
        fn = self.prog.fns[key]
        out = fn.emit(self, kids, node.dtype)
        if isinstance(out, CArg):
            return out
        if isinstance(out, tuple):
            value, valid = out
            return value, "true" if valid is None else valid
        if fn.nullability is Nullability.NULL_IF_NULL:
            return out, _and([k.m for k in kids])
        return out, "true"

    @staticmethod
    def _boolean(op: str, kids: List[CArg]):
        all_valid = _and([k.m for k in kids])
        if op == "and":
            hit = " || ".join(f"({_and([k.m, '!' + k.v])})" for k in kids)
            return f"!({hit})", f"({hit}) || ({all_valid})"
        hit = " || ".join(f"({_and([k.m, k.v])})" for k in kids)
        return f"{hit}", f"({hit}) || ({all_valid})"

    @staticmethod
    def _in(node: InNode, x: CArg):
        t = node.value_dtype
        vals = np.array(sorted(node.values), dtype=t.np_dtype)
        if not len(vals):
            return "false", x.m
        return " || ".join(f"({x.v} == {c_literal(v, t)})"
                           for v in vals.tolist()), x.m


class _Builder:
    def __init__(self, roots: Sequence[Node], mask_root: bool,
                 check_errors: bool):
        self.roots = tuple(roots)
        self.mask_root = mask_root
        self.check_errors = check_errors
        self.nodes: Dict[Key, Node] = {}
        self.kinds: Dict[Key, str] = {}
        self.post: Dict[Key, int] = {}
        self.fns: Dict[Key, object] = {}
        self.parent: Dict[Key, Optional[Key]] = {}
        self.stage: Dict[Key, int] = {}
        self.avail: Dict[Key, int] = {}
        self.literal: Dict[Key, bool] = {}
        self.sites: List[Tuple[int, int, str]] = []
        reg = global_registry()
        for i, root in enumerate(self.roots):
            self._walk(root, (i,), None, reg)

    def _walk(self, node: Node, key: Key, parent: Optional[Key], reg):
        for j, c in enumerate(children(node)):
            self._walk(c, key + (j,), key, reg)
        fn = None
        if isinstance(node, FunctionNode):
            types = [a.dtype for a in node.args]
            decimal_ops.ensure_registered(types)
            fn = reg.lookup_or_raise(node.name, types)
            self.fns[key] = fn
        self.nodes[key] = node
        self.parent[key] = parent
        self.post[key] = len(self.post)
        lits = [self.literal[key + (j,)]
                for j in range(len(children(node)))]
        kind = _route(node, fn, lits)
        self.kinds[key] = kind
        # a literal value: a literal, or chr / space of one
        self.literal[key] = isinstance(node, LiteralNode) or (
            kind == "compiled" and getattr(getattr(fn, "emit", None),
                                           "literal", False))
        # stage of a compiled node: the first kernel after every eager
        # value it reads; an eager node can run once the kernels of the
        # compiled values it reads have
        after = []
        for j in range(len(children(node))):
            c = key + (j,)
            if self.kinds[c] == "compiled":
                after.append(self.stage[c] + (kind == "eager"))
            elif self.kinds[c] == "eager":
                after.append(self.avail[c])
        if kind == "compiled":
            self.stage[key] = max(after, default=0)
        elif kind == "eager":
            self.avail[key] = max(after, default=0)

    def _schedule_late(self) -> None:
        """Move each compiled node to the last stage that can use it: its
        compiled parent's, or the one before its eager parent runs. A
        compiled value is then written only where a root, an eager node or
        nothing else reads it, never to be read back by a later kernel."""
        for key in sorted(self.post, key=len):         # parents first
            p = self.parent[key]
            if self.kinds[key] != "compiled" or p is None:
                continue
            if self.kinds[p] == "compiled":
                self.stage[key] = self.stage[p]
            else:
                self.stage[key] = self.avail[p] - 1

    def _demand(self) -> None:
        """``low[key]``: a decimal node's value is used only mod 2^64, so
        its inputs' high limbs need not be read. The roots and every
        value another stage or an eager node reads are needed whole; an
        emitter says which arguments it uses mod 2^64 (``low_args``), and
        an if passes its own use on to its branches."""
        self.low: Dict[Key, bool] = {}
        for key in sorted(self.post, key=len):         # parents first
            p = self.parent[key]
            if p is None or self.kinds[p] != "compiled" or \
                    self.stage.get(key, self.stage[p]) != self.stage[p]:
                self.low[key] = False
                continue
            node, j = self.nodes[p], key[-1]
            if isinstance(node, IfNode):
                self.low[key] = j > 0 and self.low[p]
            elif isinstance(node, FunctionNode):
                rule = getattr(self.fns[p].emit, "low_args", None)
                self.low[key] = bool(rule) and rule(
                    [a.dtype for a in node.args], j, self.low[p])
            else:
                self.low[key] = False

    def _materialized(self, key: Key) -> bool:
        """A compiled value some other part of the plan reads."""
        p = self.parent[key]
        return (p is None or self.kinds[p] == "eager"
                or self.stage[p] > self.stage[key])

    def build(self) -> Program:
        self._schedule_late()
        self._demand()
        n_kernels = 1 + max(self.stage.values(), default=-1)
        n_stages = max([n_kernels] + [a + 1 for a in self.avail.values()])
        order = sorted(self.post, key=self.post.get)
        stages, bodies = [], []
        for s in range(n_stages):
            eager = [k for k in order if self.kinds[k] == "eager"
                     and self.avail[k] == s]
            outs = [k for k in order if self.kinds[k] == "compiled"
                    and self.stage[k] == s and self._materialized(k)]
            stage = Stage(s, eager, [], [])
            stage.hosts = [k for k in order if self.kinds[k] == "compiled"
                           and self.stage[k] == s
                           and needs_host(self.nodes[k], self.fns.get(k))]
            if outs:
                bodies.append(self._stage_body(stage, outs))
            stages.append(stage)
        source = self._source(stages, bodies)
        return Program(source, stages, self.nodes, self.kinds, self.post,
                       self.sites)

    def _stage_body(self, stage: Stage, outs: List[Key]) -> str:
        em = _Emitter(self, stage.index)
        writes = []
        for key in outs:
            val = em.node(key)
            t = self.nodes[key].dtype
            mask = self.mask_root and key == (0,)
            writes.append((Port(("node", key), t, 0, mask), val))
        # number the pointers: inputs first, then the tables, then outputs
        k = 0
        for port in em.in_ports:
            port.first = k
            k += port.pointers
        reads = []
        for j, (_, _, ct) in enumerate(em.tables):
            reads += [f"  const {ct}* tb{j} = (const {ct}*)a.p[{k}];",
                      f"  const int64_t tb{j}_n = a.tn[{j}];"]
            k += 1
        if any(port.ref[0] == "field" for port in em.in_ports):
            # a field is read at its selected row r = sel[i] (i itself
            # without a selection); rows i >= len of a selection are null
            reads += ["  const bool in = a.sel == nullptr || i < len;",
                      "  const int64_t r = a.sel == nullptr ? i : in ? "
                      "gt_index(a.sel, a.sel_bytes, i) : 0;"]
        for port in em.in_ports:
            name = em.inputs[port.ref][1]
            f = port.first
            row = "r" if port.ref[0] == "field" else "i"
            if port.dtype.is_decimal and not port.hi_read:
                # used mod 2^64 only: the low limb, sign-extended
                v = f"(gt_i128)GT_IN(int64_t, {f + 1}, {row})"
            elif port.dtype.is_decimal:
                v = (f"gt_i128_of((uint64_t)GT_IN(int64_t, {f}, {row}), "
                     f"(uint64_t)GT_IN(int64_t, {f + 1}, {row}))")
            else:
                v = f"GT_IN({ctype(port.dtype)}, {f}, {row})"
            valid = f"GT_VALID({f + port.limbs}, {row})"
            reads.append(f"  const {ctype(port.dtype)} {name} = {v};")
            reads.append(f"  const bool {name}m = "
                         f"{'in && ' if row == 'r' else ''}{valid};")
        lines = []
        for port, val in writes:
            port.first = k
            k += port.pointers
            f = port.first
            if port.mask:
                lines.append(f"  GT_OUT(bool, {f}) = "
                             f"{_and([val.v, val.m, 'i < len'])};")
                continue
            if port.dtype.is_decimal:
                lines.append(f"  gt_i128_write((int64_t*)a.p[{f}], "
                             f"(int64_t*)a.p[{f + 1}], i, {val.v});")
            else:
                lines.append(f"  GT_OUT({ctype(port.dtype)}, {f}) = "
                             f"{val.v};")
            lines.append(f"  GT_OUT(bool, {f + port.limbs}) = {val.m};")
        stage.inputs = em.in_ports
        stage.tables = em.tables
        stage.outputs = [p for p, _ in writes]
        s = stage.index
        npt = max(1, k)
        ntb = max(1, len(em.tables))
        return "\n".join([
            f"struct gt_args_{s} {{",
            f"  void* p[{npt}];",
            f"  uint64_t sc[{(npt + 63) // 64}];",
            f"  int64_t tn[{ntb}];",
            "  const void* len_ptr;",
            "  const void* sel;",
            "  int64_t len;",
            "  int64_t n;",
            "  unsigned int* flags;",
            "  int len_bytes;",
            "  int sel_bytes;",
            "};",
            "",
            f"GT_HD void gt_row_{s}(const gt_args_{s}& a, int64_t i, "
            "int64_t len) {",
            *reads, *em.lines, *lines,
            "}",
            "",
            "#ifdef __CUDACC__",
            f"__global__ void __launch_bounds__({THREADS}) "
            f"gt_plan_kernel_{s}(const gt_args_{s} a) {{",
            "  const int64_t len = gt_length(a.len_ptr, a.len_bytes, a.len);",
            "  const int64_t step = (int64_t)gridDim.x * blockDim.x;",
            "  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + "
            "threadIdx.x; i < a.n; i += step)",
            f"    gt_row_{s}(a, i, len);",
            "}",
            "#endif",
            "",
            f"extern \"C\" int gt_plan_run_{s}(void* const* p, "
            "const uint64_t* sc, const int64_t* tn, const void* len_ptr, "
            "int len_bytes, int64_t len, int64_t n, const void* sel, "
            "int sel_bytes, unsigned int* flags, int blocks, void* stream) {",
            f"  gt_args_{s} a;",
            f"  for (int k = 0; k < {npt}; ++k) a.p[k] = p[k];",
            f"  for (int k = 0; k < {(npt + 63) // 64}; ++k) a.sc[k] = "
            "sc[k];",
            f"  for (int k = 0; k < {ntb}; ++k) a.tn[k] = tn[k];",
            "  a.len_ptr = len_ptr;",
            "  a.len = len;",
            "  a.n = n;",
            "  a.flags = flags;",
            "  a.len_bytes = len_bytes;",
            "  a.sel = sel;",
            "  a.sel_bytes = sel_bytes;",
            "#ifdef __CUDACC__",
            "  if (n > 0)",
            f"    gt_plan_kernel_{s}<<<blocks, {THREADS}, 0, "
            "(cudaStream_t)stream>>>(a);",
            "  return (int)cudaGetLastError();",
            "#else",
            "  const int64_t l = gt_length(len_ptr, len_bytes, len);",
            f"  for (int64_t i = 0; i < n; ++i) gt_row_{s}(a, i, l);",
            "  return 0;",
            "#endif",
            "}",
        ])

    def _source(self, stages: List[Stage], bodies: List[str]) -> str:
        head = ["// Generated by gandiva_tpu_torch.compiler.codegen: one "
                "kernel per stage,", "// a row per thread. Nodes by route "
                "(compiled / eager / leaf), stage:"]
        for key in sorted(self.post, key=self.post.get):
            node = self.nodes[key]
            kind = self.kinds[key]
            where = (f"stage {self.stage[key]}" if kind == "compiled" else
                     f"before kernel {self.avail[key]}" if kind == "eager"
                     else "")
            what = (str(self.fns[key].signature) if key in self.fns
                    else node.to_string() if kind == "leaf"
                    else type(node).__name__)
            head.append(f"//   {'.'.join(map(str, key)):<12} {kind:<8} "
                        f"{where:<16} {what}")
        return "\n".join(head + [
            "", PRELUDE.read_text().rstrip(), "",
            "#define GT_AT(k, row) (((a.sc[(k) >> 6] >> ((k) & 63)) & 1) "
            "? 0 : (row))",
            "#define GT_IN(T, k, row) (((const T*)a.p[k])[GT_AT(k, row)])",
            "#define GT_OUT(T, k) (((T*)a.p[k])[i])",
            "#define GT_VALID(k, row) (a.p[k] == nullptr || "
            "((const bool*)a.p[k])[GT_AT(k, row)])",
            "",
            "GT_HD int64_t gt_index(const void* sel, int bytes, int64_t i) {",
            "  return bytes == 4 ? (int64_t)((const uint32_t*)sel)[i] "
            ": ((const int64_t*)sel)[i];",
            "}",
            "",
            "GT_HD int64_t gt_length(const void* p, int bytes, int64_t n) {",
            "  if (p == nullptr) return n;",
            "  return bytes == 4 ? (int64_t)*(const int32_t*)p "
            ": *(const int64_t*)p;",
            "}",
            "", *bodies, ""])


def generate(roots: Sequence[Node], mask_root: bool = False,
             check_errors: bool = False) -> Program:
    """Compile ``roots`` (a plan's expression roots; with ``mask_root``
    the first is a condition, written as the row mask value ∧ valid ∧
    row < length) into a Program. ``check_errors`` emits the runtime-error
    sites of Configuration.raise_errors."""
    return _Builder(roots, mask_root, check_errors).build()
