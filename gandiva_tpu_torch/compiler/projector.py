"""Projector / Filter / FilterProject — multi-expression evaluators.

Reference surface: gandiva::Projector (projector.h, libgandiva.pxd:214-240)
and gandiva::Filter (filter.h, libgandiva.pxd:242-256): compile once per
(schema, expressions, config) via Make, then Evaluate many record batches
(gandiva.pyx:634-636). The torch counterpart of
gandiva_tpu.compiler.projector:

    validation + signature resolution   at Make time (validator.py)
    evaluation                          eager torch calls on whole columns
                                        (decomposer.py), on the plan's device
    stream compaction                   kernel K1 (ops/kernels/compaction.py)
    function holders (LIKE tables,      host tables built per distinct
    dictionary ranks, string IN sets)   dictionary value at evaluate time,
                                        memoized per plan on the identity of
                                        the batch's dictionaries
    DumpIR                              a text dump of the decomposed plan
                                        (``.hlo`` / ``.llvm_ir``)
    expression cache (cache.h)          the make_* plan cache

Every plan has an explicit ``device`` (default: the card). Arrow input is
converted onto it; a Batch on another device is refused.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import dtypes as dt
from ..batch import Batch, Column, column_to_arrow, from_arrow
from ..device import DEFAULT_DEVICE, resolve_device
from ..expr.nodes import (BooleanNode, Condition, Expression, FunctionNode,
                          IfNode, InNode, Node)
from ..ops.compaction import compact_best
from ..registry.registry import (EvaluationError,
                                 ExpressionValidationError, Val,
                                 global_registry)
from . import validator
from .config import Configuration, ConfigurationBuilder
from .decomposer import ExprDecomposer, TraceContext, as_valid_mask
from .selection import (SelectionMode, SelectionVector,
                        check_uint16_capacity, mode_index_dtype)


def _default_config(config: Optional[Configuration]) -> Configuration:
    return config if config is not None else \
        ConfigurationBuilder.default_configuration()


def _full(x, cap: int):
    """A (cap,) contiguous tensor: literals (0-d) are broadcast; a decimal's
    (hi, lo) limb pair becomes a pair of them."""
    if isinstance(x, tuple):
        return tuple(_full(limb, cap) for limb in x)
    return torch.broadcast_to(x, (cap,)).contiguous()


def _limbs(data):
    """A column's data as a tuple: one tensor, or a decimal's (hi, lo)."""
    return data if isinstance(data, tuple) else (data,)


def _out_column(value, validity, dtype: dt.DataType,
                dictionary=None) -> Column:
    """An output column: a decimal's (hi, lo) becomes data lo, extra hi; a
    string's codes go with their dictionary."""
    if isinstance(value, tuple):
        hi, lo = value
        return Column(lo, validity, dtype, extra=hi)
    return Column(value, validity, dtype, dictionary=dictionary)


def _condition_mask(ctx: TraceContext, v: Val):
    """Boolean condition Val → row mask (true AND valid AND within length)."""
    mask = _full(v.value, ctx.capacity)
    if v.validity is not None:
        mask = torch.logical_and(mask, v.validity)
    rows = ctx.row_mask()
    if rows is not None:
        mask = torch.logical_and(mask, rows)
    return mask


def _children(node: Node):
    if isinstance(node, FunctionNode):
        return node.args
    if isinstance(node, IfNode):
        return (node.condition, node.then_node, node.else_node)
    if isinstance(node, BooleanNode):
        return node.children
    if isinstance(node, InNode):
        return (node.eval_expr,)
    return ()


class _CompiledPlan:
    """Shared evaluate machinery for Projector, Filter and FilterProject."""

    def __init__(self, schema: dt.Schema, roots: Sequence,
                 config: Configuration, device):
        self.schema = schema
        self.config = config
        self.device = resolve_device(device)
        self._roots = tuple(roots)
        self._consts: Dict[Any, torch.Tensor] = {}
        self._table_memo: Dict[str, Any] = {}
        self._error_messages: List[str] = []
        self._seed = 0
        # per-operator observability (SURVEY.md §5.5): host-side counters
        self.stats = {"evaluations": 0, "rows_in": 0, "rows_out": 0}

    # ---- evaluation ----------------------------------------------------
    def _make_vals(self, cols) -> Dict[str, Val]:
        out = {}
        for f in self.schema:
            if f.name not in cols:
                continue
            thunk = None
            if f.dtype.is_varlen:
                def thunk(batch, _n=f.name):
                    return batch.column(_n).dictionary
            out[f.name] = Val(*cols[f.name], f.dtype, dict_thunk=thunk,
                              source_field=f.name)
        return out

    def _tables_for(self, batch: Batch) -> Dict[int, Any]:
        """The plan's memo of dictionary-pure host tables for ``batch``:
        kept while every dictionary OBJECT of the batch and its capacity
        are the ones it was built for, emptied otherwise. Holding the key
        objects pins them, so a reused id cannot alias."""
        dicts = tuple(c.dictionary for c in batch.columns.values()
                      if c.dictionary is not None)
        memo = self._table_memo
        if not (memo and memo["capacity"] == batch.capacity
                and len(memo["key"]) == len(dicts)
                and all(a is b for a, b in zip(memo["key"], dicts))):
            memo = self._table_memo = {"key": dicts,
                                       "capacity": batch.capacity,
                                       "vals": {}}
        # string-cliff observability: string work is per DISTINCT value on
        # the host, so a near-unique dictionary (distinct/row → 1) makes it
        # per-row host work; record the worst ratio seen
        ratio = max((len(d) for d in dicts), default=0) / batch.length \
            if batch.length else 0.0
        if ratio:
            self.stats["dict_distinct_ratio"] = max(
                self.stats.get("dict_distinct_ratio", 0.0), ratio)
        return memo["vals"]

    def _finish(self, ctx: TraceContext, outs: List[Val]):
        """Subclass hook: turn decomposed root Vals into outputs."""
        raise NotImplementedError

    def _with_dicts(self, ctx: TraceContext, outs: List[Val]):
        """The subclass's outputs, and each root's output dictionary (None
        but for strings), built from ``ctx.batch``."""
        return self._finish(ctx, outs), [
            v.dict_thunk(ctx.batch) if v.dtype.is_varlen else None
            for v in outs]

    def _run(self, cols, length, seed: int,
             finish: Optional[Callable] = None,
             batch: Optional[Batch] = None):
        """Evaluate every root over ``cols`` ({name: (data, validity)});
        ``length`` is a Python int or a 0-d device tensor; a decimal
        column's data is its (hi, lo) limb pair. ``batch`` is the Batch the
        host tables are built from (string plans need it)."""
        capacity = int(_limbs(next(iter(cols.values()))[0])[0].shape[0])
        ctx = TraceContext(capacity, length, {}, self.device, seed=seed,
                           check_errors=self.config.raise_errors,
                           consts=self._consts, batch=batch,
                           tables=None if batch is None
                           else self._tables_for(batch))
        ctx.columns = self._make_vals(cols)
        dec = ExprDecomposer(ctx)
        outs = [dec.decompose(r) for r in self._roots]
        res = (finish or self._finish)(ctx, outs)
        if ctx.table_builds:
            self.stats["table_builds"] = (self.stats.get("table_builds", 0)
                                          + ctx.table_builds)
        if not self.config.raise_errors:
            return res
        self._error_messages = list(ctx.error_messages)
        return res, ctx.error_code()

    def _run_selected(self, cols, seed: int, sel_indices, sel_count,
                      finish: Optional[Callable] = None,
                      batch: Optional[Batch] = None):
        """Selection-vector-aware evaluation: gather the selected rows first,
        then evaluate on the gathered batch (reference behavior:
        test_gandiva.py:358-373 — output has len(selection) rows). String
        codes are gathered; their dictionaries stay ``batch``'s."""
        cap = sel_indices.shape[0]
        row_ok = torch.arange(cap, device=self.device) < sel_count
        # the tail past count is unspecified: point it at row 0
        idx = torch.where(row_ok, sel_indices, torch.zeros_like(sel_indices))
        gathered = {}
        for name, (data, validity) in cols.items():
            g = tuple(d.index_select(0, idx) for d in _limbs(data))
            gathered[name] = (g if isinstance(data, tuple) else g[0],
                              validity.index_select(0, idx) & row_ok)
        return self._run(gathered, sel_count, seed, finish, batch)

    def _cols_of(self, batch: Batch):
        if batch.columns and batch.device != self.device:
            raise ValueError(f"batch is on {batch.device}, plan on "
                             f"{self.device}")
        cols = {}
        for f in self.schema:
            if f.name in batch.columns:
                c = batch.column(f.name)
                data = (c.extra, c.data) if f.dtype.is_decimal else c.data
                cols[f.name] = (data, c.validity)
        return cols

    def _as_batch(self, batch) -> Batch:
        import pyarrow as pa

        if isinstance(batch, (pa.RecordBatch, pa.Table)):
            return from_arrow(batch, device=self.device)
        return batch

    def _next_seed(self) -> int:
        self._seed += 1
        return self._seed

    def _unwrap_errors(self, outs):
        """Split the error code off a raise_errors-enabled result and raise
        host-side if any row errored (the reference's Evaluate Status
        surface)."""
        if not self.config.raise_errors:
            return outs
        outs, err = outs
        code = int(err)
        if code:
            raise EvaluationError(self._error_messages[code - 1])
        return outs

    def _count(self, batch: Batch, rows_out: int) -> None:
        self.stats["evaluations"] += 1
        self.stats["rows_in"] += batch.length
        self.stats["rows_out"] += rows_out

    # ---- introspection -------------------------------------------------
    def dump_hlo(self, batch: Optional[Batch] = None) -> str:
        """Text dump of the decomposed plan — the DumpIR analogue: each root
        with the registry signature and null rule every function resolved
        to. ``batch`` is accepted for parity and not needed."""
        reg = global_registry()
        lines = [f"{type(self).__name__} on {self.device}"]
        for i, root in enumerate(self._roots):
            lines.append(f"root {i}: {root.to_string()}")
            stack = [root]
            while stack:
                node = stack.pop()
                if isinstance(node, FunctionNode):
                    fn = reg.lookup(node.name, [a.dtype for a in node.args])
                    if fn is not None:
                        lines.append(f"  {fn.signature} "
                                     f"[{fn.nullability.value}]")
                stack.extend(reversed(_children(node)))
        return "\n".join(lines)

    @property
    def hlo(self) -> str:
        return self.dump_hlo()

    @property
    def llvm_ir(self) -> str:
        """Name-compatible alias for pyarrow's Projector.llvm_ir."""
        return self.dump_hlo()


class Projector(_CompiledPlan):
    """Multi-expression evaluator (gandiva::Projector)."""

    def __init__(self, schema: dt.Schema, exprs: Sequence[Expression],
                 selection_mode: SelectionMode = SelectionMode.NONE,
                 config: Optional[Configuration] = None,
                 device=DEFAULT_DEVICE):
        config = _default_config(config)
        exprs = tuple(exprs)
        if not exprs:
            raise ExpressionValidationError("projector requires expressions")
        for e in exprs:
            rt = validator.validate(e.root, schema)
            if rt != e.result_field.dtype:
                raise ExpressionValidationError(
                    f"expression returns {rt} but result field "
                    f"{e.result_field.name} is {e.result_field.dtype}")
        self.exprs = exprs
        self.selection_mode = selection_mode
        super().__init__(schema, [e.root for e in exprs], config, device)

    @staticmethod
    def make(schema: dt.Schema, exprs: Sequence[Expression],
             selection_mode: SelectionMode = SelectionMode.NONE,
             config: Optional[Configuration] = None,
             device=DEFAULT_DEVICE) -> "Projector":
        return Projector(schema, exprs, selection_mode, config, device)

    def _finish(self, ctx: TraceContext, outs: List[Val]):
        cap = ctx.capacity
        return [(_full(v.value, cap), as_valid_mask(v, cap, ctx.device))
                for v in outs]

    # ---- public API ----------------------------------------------------
    def evaluate_device(self, batch: Batch,
                        selection: Optional[SelectionVector] = None) -> Batch:
        """Evaluate and keep results on the device as a Batch."""
        cols = self._cols_of(batch)
        seed = self._next_seed()
        if selection is None:
            outs, dicts = self._unwrap_errors(self._run(
                cols, batch.length, seed, self._with_dicts, batch))
            length = batch.length
        else:
            # Reference contract (libgandiva.pxd:238, projector.cc): a
            # Projector built with a SelectionMode evaluates only with a
            # matching-mode selection vector; mode NONE takes none.
            if self.selection_mode is SelectionMode.NONE:
                raise ValueError(
                    "projector built with selection_mode=NONE cannot "
                    "evaluate with a selection vector; rebuild with the "
                    "matching SelectionMode")
            if selection.mode is not self.selection_mode:
                raise ValueError(
                    f"selection vector mode {selection.mode.value} does not "
                    f"match projector selection_mode "
                    f"{self.selection_mode.value}")
            idx = selection.indices.to(mode_index_dtype(self.selection_mode))
            outs, dicts = self._unwrap_errors(self._run_selected(
                cols, seed, idx, selection.count, self._with_dicts, batch))
            length = int(selection.count)
        self._count(batch, length)
        return Batch({e.result_field.name: _out_column(
            value, validity, e.result_field.dtype, dictionary)
            for e, (value, validity), dictionary in zip(self.exprs, outs,
                                                        dicts)}, length)

    def evaluate(self, batch, selection: Optional[SelectionVector] = None):
        """Evaluate a batch; returns a list of pyarrow Arrays (mirrors
        gandiva.pyx:199-226)."""
        out = self.evaluate_device(self._as_batch(batch), selection)
        return [column_to_arrow(out.column(e.result_field.name), out.length)
                for e in self.exprs]


class Filter(_CompiledPlan):
    """Condition evaluator producing selection vectors (gandiva::Filter)."""

    def __init__(self, schema: dt.Schema, condition: Condition,
                 config: Optional[Configuration] = None,
                 device=DEFAULT_DEVICE):
        config = _default_config(config)
        ct = validator.validate(condition.root, schema)
        if ct.kind is not dt.TypeKind.BOOL:
            raise ExpressionValidationError(
                f"filter condition must be boolean, got {ct}")
        self.condition = condition
        super().__init__(schema, [condition.root], config, device)

    @staticmethod
    def make(schema: dt.Schema, condition: Condition,
             config: Optional[Configuration] = None,
             device=DEFAULT_DEVICE) -> "Filter":
        return Filter(schema, condition, config, device)

    def _finish(self, ctx: TraceContext, outs: List[Val]):
        idx, count, _ = compact_best(_condition_mask(ctx, outs[0]))
        return idx, count

    def evaluate(self, batch, mode: SelectionMode = SelectionMode.UINT32
                 ) -> SelectionVector:
        """Evaluate the condition; rows where it is true AND valid land in the
        selection (gandiva.pyx:247-280; semantics test_gandiva.py:113-114)."""
        batch = self._as_batch(batch)
        idx, count = self._unwrap_errors(
            self._run(self._cols_of(batch), batch.length,
                      self._next_seed(), batch=batch))
        self.stats["evaluations"] += 1
        self.stats["rows_in"] += batch.length
        if mode is SelectionMode.UINT16:
            check_uint16_capacity(batch.capacity)
        return SelectionVector(idx.to(mode_index_dtype(mode)), count, mode)


class FilterProject(_CompiledPlan):
    """Fused filter→project plan: evaluates the projections densely, then
    ONE compaction (kernel K1) packs the selection indices and every
    projected column together. Produces bit-identical results to the
    unfused Filter + Projector(selection) path."""

    def __init__(self, schema: dt.Schema, condition: Condition,
                 exprs: Sequence[Expression],
                 config: Optional[Configuration] = None,
                 device=DEFAULT_DEVICE):
        config = _default_config(config)
        ct = validator.validate(condition.root, schema)
        if ct.kind is not dt.TypeKind.BOOL:
            raise ExpressionValidationError(
                f"filter condition must be boolean, got {ct}")
        for e in exprs:
            rt = validator.validate(e.root, schema)
            if rt != e.result_field.dtype:
                raise ExpressionValidationError(
                    f"expression returns {rt} but result field "
                    f"{e.result_field.name} is {e.result_field.dtype}")
        self.condition = condition
        self.exprs = tuple(exprs)
        super().__init__(schema, [condition.root] + [e.root for e in exprs],
                         config, device)

    @staticmethod
    def make(schema, condition, exprs, config=None,
             device=DEFAULT_DEVICE) -> "FilterProject":
        return FilterProject(schema, condition, exprs, config, device)

    def _dense(self, ctx: TraceContext, outs: List[Val]):
        """(row mask, [value, validity] per expression, a decimal's value as
        its hi and lo limbs, a string's as its int32 codes) before
        compaction."""
        cap = ctx.capacity
        payload = []
        for v in outs[1:]:
            payload.extend(_limbs(_full(v.value, cap)))
            payload.append(as_valid_mask(v, cap, ctx.device).contiguous())
        return _condition_mask(ctx, outs[0]), payload

    def _finish(self, ctx: TraceContext, outs: List[Val]):
        return compact_best(*self._dense(ctx, outs))

    def evaluate_device(self, batch: Batch):
        """Returns (SelectionVector, Batch of projected columns) — both
        logically ``count`` rows long."""
        (idx, count, packed), dicts = self._unwrap_errors(
            self._run(self._cols_of(batch), batch.length,
                      self._next_seed(), self._with_dicts, batch))
        length = int(count)
        self._count(batch, length)
        out_cols = {}
        pos = 0
        for e, dictionary in zip(self.exprs, dicts[1:]):
            t = e.result_field.dtype
            if t.is_decimal:
                value, pos = (packed[pos], packed[pos + 1]), pos + 2
            else:
                value, pos = packed[pos], pos + 1
            out_cols[e.result_field.name] = _out_column(value, packed[pos], t,
                                                        dictionary)
            pos += 1
        return (SelectionVector(idx, count, SelectionMode.UINT32),
                Batch(out_cols, length))

    def evaluate(self, batch):
        sel, out = self.evaluate_device(self._as_batch(batch))
        return sel, [column_to_arrow(out.column(e.result_field.name),
                                     out.length) for e in self.exprs]

    def stream_fn(self, consume: Optional[Callable] = None) -> Callable:
        """Device-resident multi-batch execution: returns
        ``fn(cols_stacked)`` that runs the plan over a leading batch axis
        with NO host sync between batches. ``cols_stacked``:
        {name: (data[K, N], valid[K, N])}.

        ``consume(idx, count, packed) -> tensor`` reduces each batch's
        outputs on the device; ``fn`` then returns the stacked reductions.
        Without it, ``fn`` returns the list of per-batch
        ``(idx, count, packed)``. Host tables (string holders) are not
        supported on this path — it is for numeric plans: a string plan
        raises (``TraceContext.add_table``).
        """
        if self.config.raise_errors:
            raise ValueError(
                "stream_fn runs batches with no per-batch host boundary, so "
                "Configuration(raise_errors=True) has nowhere to raise; use "
                "evaluate per batch, or a default Configuration")
        base_seed = self._seed

        def run(cols_stacked):
            first = next(iter(cols_stacked.values()))[0]
            outs = []
            for k in range(first.shape[0]):
                cols = {name: (data[k], valid[k])
                        for name, (data, valid) in cols_stacked.items()}
                res = self._run(cols, int(first.shape[1]), base_seed + k + 1)
                outs.append(res if consume is None else consume(*res))
            return outs if consume is None else torch.stack(outs)

        return run


# ---------------------------------------------------------------------------
# module-level factories + plan cache (SURVEY.md §2a#17)
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[Any, Any] = {}


def _cached(key, build: Callable, use_cache: bool):
    if use_cache and key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    plan = build()
    if use_cache:
        _PLAN_CACHE[key] = plan
    return plan


def make_projector(schema: dt.Schema, exprs: Sequence[Expression],
                   selection_mode: SelectionMode = SelectionMode.NONE,
                   config: Optional[Configuration] = None,
                   use_cache: bool = True, pool=None,
                   device=DEFAULT_DEVICE) -> Projector:
    """``pool`` is accepted for signature parity with the reference
    (gandiva.pyx:629 make_projector(schema, children, pool, ...)); device
    memory is torch's caching allocator's."""
    config = _default_config(config)
    dev = resolve_device(device)
    key = ("projector", schema, tuple(exprs), selection_mode, config, dev)
    return _cached(key, lambda: Projector.make(schema, exprs, selection_mode,
                                               config, dev), use_cache)


def make_filter(schema: dt.Schema, condition: Condition,
                config: Optional[Configuration] = None,
                use_cache: bool = True, pool=None,
                device=DEFAULT_DEVICE) -> Filter:
    config = _default_config(config)
    dev = resolve_device(device)
    key = ("filter", schema, condition, config, dev)
    return _cached(key, lambda: Filter.make(schema, condition, config, dev),
                   use_cache)


def make_filter_project(schema: dt.Schema, condition: Condition,
                        exprs: Sequence[Expression],
                        config: Optional[Configuration] = None,
                        use_cache: bool = True,
                        device=DEFAULT_DEVICE) -> FilterProject:
    config = _default_config(config)
    dev = resolve_device(device)
    key = ("filter_project", schema, condition, tuple(exprs), config, dev)
    return _cached(key, lambda: FilterProject.make(schema, condition, exprs,
                                                   config, dev), use_cache)
