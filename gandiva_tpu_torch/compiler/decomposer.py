"""ExprDecomposer — lowers expression trees to (value, validity) tensor pairs.

The torch counterpart of gandiva_tpu.compiler.decomposer, Gandiva's
null-semantics engine (expr_decomposer.cc, SURVEY.md §2a#4): every node
decomposes into a value tensor and a validity (non-null mask) tensor, with
the reference's rules:

- default (NULL_IF_NULL): output validity = AND of input validities;
- if/else: a NULL condition takes the else branch; result validity follows the
  branch actually taken (pyarrow tests/test_gandiva.py:330-373); string and
  binary branches select codes into one merged dictionary;
- boolean and/or: Kleene short-circuit — ``false AND null = false``,
  ``true OR null = true``, otherwise null if any input null;
- IN: membership over a literal set, validity propagated from the eval subtree.

String work runs once per distinct dictionary value on the host (Gandiva's
function holders, SURVEY.md §2a#7): a registry kernel hands the context a
host-table builder (``TraceContext.add_table``) and gathers the uploaded
table by the column's codes on the device.

Torch runs eagerly, so decomposing a tree *is* evaluating it: each registry
function is called on whole columns as the walk reaches it. Literals are 0-d
tensors of the node's dtype (a decimal's, a pair of 0-d int64 limbs, as
decimal columns carry (hi, lo)); the registry only pairs arguments of one
dtype, so torch's 0-d type promotion never widens a result.
"""
from __future__ import annotations

from functools import reduce
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..expr.nodes import (BooleanNode, FieldNode, FunctionNode, IfNode,
                          InNode, LiteralNode, Node)
from ..registry import decimal_ops
from ..registry.registry import (ExpressionValidationError, Nullability, Val,
                                 global_registry)


class TraceContext:
    """Per-evaluation state handed to registry kernels.

    ``length`` is the logical row count: a Python int, or a 0-d device
    tensor when it comes from a device-side count (a selection vector).
    ``consts`` is a plan-owned cache of literal tensors, so evaluating a plan
    again copies no literal to the device. ``batch`` is the host Batch the
    host-table builders read (its dictionaries, and for the per-row string
    routes its codes), and ``tables`` the plan's memo of the tables that
    are pure functions of its dictionaries (``add_table``).
    """

    def __init__(self, capacity: int, length, columns: Dict[str, Val],
                 device, seed: int = 0, check_errors: bool = False,
                 consts: Optional[Dict[Any, torch.Tensor]] = None,
                 batch=None, tables: Optional[Dict[int, Any]] = None):
        self.capacity = capacity
        self.length = length
        self.columns = columns
        self.device = device
        self.consts = {} if consts is None else consts
        self.batch = batch
        self._tables = tables
        self._table_idx = 0
        self.table_builds = 0
        self._seed = seed
        self._generator: Optional[torch.Generator] = None
        # runtime-error surface (Configuration.raise_errors): kernels record
        # per-row error predicates; the plan reduces them to one device code
        self.check_errors = check_errors
        self.error_flags: List[Any] = []
        self.error_messages: List[str] = []

    def add_table(self, thunk: Callable, cache_on_dicts: bool = False
                  ) -> torch.Tensor:
        """Run a host table builder and return its table on the device.

        ``thunk(batch) -> np.ndarray`` runs on the host at evaluate time
        (the analogue of Gandiva's holders). ``cache_on_dicts=True``
        declares it a pure function of the batch's DICTIONARIES (not codes
        or values): the plan then memoizes the uploaded table, by the
        table's place in the plan, while every dictionary object and the
        capacity stay the same (``_CompiledPlan._table_memo``), and a
        later evaluation neither rebuilds nor uploads it."""
        if self.batch is None:
            raise ValueError("this plan needs host tables (string "
                             "functions), so it evaluates per Batch; "
                             "stream_fn and raw column calls cannot run it")
        i = self._table_idx
        self._table_idx += 1
        memo = self._tables if cache_on_dicts else None
        if memo is not None and i in memo:
            return memo[i]
        table = torch.from_numpy(np.ascontiguousarray(thunk(self.batch)))
        table = table.to(self.device)
        self.table_builds += 1
        if memo is not None:
            memo[i] = table
        return table

    def generator(self) -> torch.Generator:
        """The evaluation's random stream (the reference's rng key): one
        seeded generator per evaluation, drawn from by every random call."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self._seed)
        return self._generator

    def row_mask(self):
        """Rows within ``length``, or None when every row is."""
        if isinstance(self.length, int) and self.length >= self.capacity:
            return None
        return torch.arange(self.capacity, device=self.device) < self.length

    def add_error(self, row_has_error, message: str) -> None:
        """Record a per-row runtime-error predicate (Status parity: the
        reference raises from Evaluate, e.g. "divide by zero error" on
        integer x/0 — SURVEY.md §5.3). A no-op unless the plan's
        Configuration enables ``raise_errors``, so the default path pays
        nothing. Rows past ``length`` never error."""
        if not self.check_errors:
            return
        mask = torch.broadcast_to(torch.as_tensor(row_has_error,
                                                  device=self.device),
                                  (self.capacity,))
        rows = self.row_mask()
        if rows is not None:
            mask = mask & rows
        self.error_messages.append(message)
        self.error_flags.append(torch.any(mask))

    def error_code(self):
        """Reduce recorded error flags to one int32 device scalar: 0 = ok,
        i+1 = index of the FIRST (in registration order) firing error."""
        code = torch.zeros((), dtype=torch.int32, device=self.device)
        for i, f in enumerate(self.error_flags):
            code = torch.where((code == 0) & f, i + 1, code)
        return code


def at_least_one(arr: np.ndarray, fill) -> np.ndarray:
    """A host table at least one entry long (an empty dictionary's table
    holds ``fill``), so every code can be clipped into it."""
    if len(arr):
        return arr
    return np.full(1, fill, dtype=arr.dtype)


def gather_by_code(table: torch.Tensor, codes) -> torch.Tensor:
    """``table[codes]`` with the codes clipped into the table, as the
    reference clips them."""
    idx = torch.clamp(codes, 0, table.shape[0] - 1)
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _and_validity(vals: List[Optional[Any]]):
    vs = [v for v in vals if v is not None]
    if not vs:
        return None
    return reduce(torch.logical_and, vs)


def as_valid_mask(v: Val, capacity: int, device):
    if v.validity is None:
        return torch.ones((capacity,), dtype=torch.bool, device=device)
    return torch.broadcast_to(v.validity, (capacity,))


class ExprDecomposer:
    def __init__(self, ctx: TraceContext):
        self.ctx = ctx
        self.registry = global_registry()

    def decompose(self, node: Node) -> Val:
        if isinstance(node, LiteralNode):
            return self._literal(node)
        if isinstance(node, FieldNode):
            return self._field(node)
        if isinstance(node, FunctionNode):
            return self._function(node)
        if isinstance(node, IfNode):
            return self._if(node)
        if isinstance(node, BooleanNode):
            return self._boolean(node)
        if isinstance(node, InNode):
            return self._in(node)
        raise ExpressionValidationError(f"unknown node type {type(node).__name__}")

    # ------------------------------------------------------------------
    def _const(self, key, make: Callable[[], np.ndarray]) -> torch.Tensor:
        t = self.ctx.consts.get(key)
        if t is None:
            t = torch.from_numpy(make()).to(self.ctx.device)
            self.ctx.consts[key] = t
        return t

    def _literal(self, node: LiteralNode) -> Val:
        d = node.dtype
        if d.is_decimal:
            return self._decimal_literal(node)
        if d.is_varlen and node.value is not None:
            # string and binary literals stay Python values: the registry's
            # kernels fold them into their host tables
            return Val(None, None, d, literal=node.value, is_literal=True)
        if node.value is None:
            cap = self.ctx.capacity
            zero = self._const(("zero", d), lambda: np.zeros(
                (), dtype=d.storage_np_dtype))
            invalid = self._const(("invalid", cap), lambda: np.zeros(
                cap, dtype=bool))
            return Val(zero, invalid, d, literal=None, is_literal=True)
        # keyed by repr: -0.0 == 0.0 would share one tensor
        v = self._const(("lit", d, repr(node.value)), lambda: np.array(
            np.asarray(node.value, dtype=d.np_dtype).view(d.storage_np_dtype)))
        return Val(v, None, d, literal=node.value, is_literal=True)

    def _decimal_literal(self, node: LiteralNode) -> Val:
        """A decimal literal as a pair of 0-d int64 limbs: the unscaled
        value's high 64 bits and its low 64 bits wrapped to int64."""
        d = node.dtype
        if node.value is None:
            z = self._const(("zero", dt.int64), lambda: np.zeros(
                (), dtype=np.int64))
            cap = self.ctx.capacity
            invalid = self._const(("invalid", cap), lambda: np.zeros(
                cap, dtype=bool))
            return Val((z, z), invalid, d, literal=None, is_literal=True)
        unscaled = int(node.value)
        lo = unscaled & 0xFFFF_FFFF_FFFF_FFFF
        limbs = tuple(self._const(("lit", dt.int64, v), lambda v=v: np.array(
            v, dtype=np.int64)) for v in (unscaled >> 64,
                                          lo - (lo >> 63 << 64)))
        return Val(limbs, None, d, literal=node.value, is_literal=True)

    def _field(self, node: FieldNode) -> Val:
        name = node.field.name
        if name not in self.ctx.columns:
            raise ExpressionValidationError(
                f"field {name!r} not found in input batch")
        v = self.ctx.columns[name]
        if v.dtype != node.field.dtype:
            raise ExpressionValidationError(
                f"field {name!r}: schema says {node.field.dtype}, "
                f"batch has {v.dtype}")
        return v

    def _function(self, node: FunctionNode) -> Val:
        args = [self.decompose(a) for a in node.args]
        arg_types = [a.dtype for a in args]
        decimal_ops.ensure_registered(arg_types)
        fn = self.registry.lookup_or_raise(node.name, arg_types)
        rt = fn.signature.return_type
        if rt is not None and rt != node.dtype:
            raise ExpressionValidationError(
                f"function {node.name} returns {rt}, "
                f"tree declares {node.dtype}")
        if fn.needs_return_type:
            out = fn.impl(self.ctx, args, return_type=node.dtype)
        else:
            out = fn.impl(self.ctx, args)
        if isinstance(out, Val):
            if (fn.nullability is Nullability.NULL_IF_NULL
                    and out.validity is None):
                # impls returning a bare-validity Val still obey the default
                # null-if-null rule
                out.validity = _and_validity([a.validity for a in args])
            return out
        if fn.nullability is Nullability.NULL_IF_NULL:
            validity = _and_validity([a.validity for a in args])
        else:
            validity = None
        return Val(out, validity, rt if rt is not None else node.dtype)

    def _if(self, node: IfNode) -> Val:
        cond = self.decompose(node.condition)
        then_v = self.decompose(node.then_node)
        else_v = self.decompose(node.else_node)
        if cond.dtype.kind is not dt.TypeKind.BOOL:
            raise ExpressionValidationError("if condition must be boolean")
        if then_v.dtype != else_v.dtype or then_v.dtype != node.dtype:
            raise ExpressionValidationError(
                f"if branches must both return {node.dtype}; got "
                f"{then_v.dtype} / {else_v.dtype}")
        sel = cond.value
        if cond.validity is not None:
            sel = torch.logical_and(sel, cond.validity)
        dict_thunk = None
        if node.dtype.is_varlen:
            then_codes, else_codes, dict_thunk = self._merge_dictionaries(
                then_v, else_v, node.dtype)
            value = torch.where(sel, then_codes, else_codes)
        elif isinstance(then_v.value, tuple):  # decimal limb pairs
            value = tuple(torch.where(sel, t, e)
                          for t, e in zip(then_v.value, else_v.value))
        else:
            value = torch.where(sel, then_v.value, else_v.value)
        if then_v.validity is None and else_v.validity is None:
            validity = None
        else:
            cap, dev = self.ctx.capacity, self.ctx.device
            validity = torch.where(sel, as_valid_mask(then_v, cap, dev),
                                   as_valid_mask(else_v, cap, dev))
        return Val(value, validity, node.dtype, dict_thunk=dict_thunk)

    def _branch_dictionary(self, v: Val, arrow_type):
        """A string branch's (dictionary thunk, codes): a column's or a
        computed string's own; a literal's one entry at code 0; a null
        literal's empty dictionary."""
        if v.dict_thunk is not None:
            return v.dict_thunk, v.value
        import pyarrow as pa

        entries = pa.array([] if v.literal is None else [v.literal],
                           type=arrow_type)
        zero = self._const(("zero", dt.int32), lambda: np.zeros(
            (), dtype=np.int32))
        return (lambda batch, _d=entries: _d), zero

    def _merge_dictionaries(self, then_v: Val, else_v: Val, dtype):
        """The branches' codes remapped into one dictionary: their
        distinct values, the then-branch's first. Returns (then codes,
        else codes, the merged dictionary's thunk); the two remap tables
        are host tables memoized on the batch's dictionaries."""
        import pyarrow as pa

        arrow_type = pa.string() if dtype.kind is dt.TypeKind.STRING \
            else pa.binary()
        branches = [self._branch_dictionary(v, arrow_type)
                    for v in (then_v, else_v)]

        def merged(batch):
            values = [x for thunk, _ in branches
                      for x in thunk(batch).to_pylist()]
            return pa.array(list(dict.fromkeys(values)), type=arrow_type)

        codes = []
        for thunk, branch_codes in branches:
            def remap(batch, _thunk=thunk):
                at = {x: i for i, x in enumerate(merged(batch).to_pylist())}
                return at_least_one(np.array(
                    [at[x] for x in _thunk(batch).to_pylist()],
                    dtype=np.int32), 0)

            table = self.ctx.add_table(remap, cache_on_dicts=True)
            codes.append(gather_by_code(table, branch_codes))
        return codes[0], codes[1], merged

    def _boolean(self, node: BooleanNode) -> Val:
        kids = [self.decompose(c) for c in node.children]
        for k in kids:
            if k.dtype.kind is not dt.TypeKind.BOOL:
                raise ExpressionValidationError(
                    f"{node.op} child must be boolean, got {k.dtype}")
        cap, dev = self.ctx.capacity, self.ctx.device
        masks = [as_valid_mask(k, cap, dev) for k in kids]
        all_valid = reduce(torch.logical_and, masks)
        if node.op == "and":
            # false AND anything = false (even null)
            any_false = reduce(torch.logical_or,
                               [m & ~torch.broadcast_to(k.value, (cap,))
                                for k, m in zip(kids, masks)])
            value = torch.logical_not(any_false)
            validity = torch.logical_or(any_false, all_valid)
        else:
            any_true = reduce(torch.logical_or,
                              [m & torch.broadcast_to(k.value, (cap,))
                               for k, m in zip(kids, masks)])
            value = any_true
            validity = torch.logical_or(any_true, all_valid)
        if all(k.validity is None for k in kids):
            validity = None
        return Val(value, validity, dt.bool_)

    def _in(self, node: InNode) -> Val:
        ev = self.decompose(node.eval_expr)
        if ev.dtype != node.value_dtype:
            raise ExpressionValidationError(
                f"Evaluation expression for IN clause returns {ev.dtype} "
                f"values are of type {node.value_dtype}")
        if node.value_dtype.is_varlen:
            # membership decided per distinct dictionary value on the host
            dict_thunk = ev.dict_thunk
            if dict_thunk is None:
                raise ExpressionValidationError(
                    "IN on string requires a dictionary-backed input")
            values = {v if isinstance(v, (str, bytes)) else str(v)
                      for v in node.values}

            def thunk(batch, _dt=dict_thunk, _vals=values):
                return at_least_one(np.array(
                    [x in _vals for x in _dt(batch).to_pylist()],
                    dtype=bool), False)

            table = self.ctx.add_table(thunk, cache_on_dicts=True)
            return Val(gather_by_code(table, ev.value), ev.validity,
                       dt.bool_)
        d = node.value_dtype
        vals = self._const(("in", node), lambda: np.array(
            sorted(node.values), dtype=d.np_dtype).view(d.storage_np_dtype))
        return Val(torch.isin(ev.value, vals), ev.validity, dt.bool_)
