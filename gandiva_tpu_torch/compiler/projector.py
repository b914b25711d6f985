"""Projector / Filter / FilterProject — multi-expression evaluators.

Reference surface: gandiva::Projector (projector.h, libgandiva.pxd:214-240)
and gandiva::Filter (filter.h, libgandiva.pxd:242-256): compile once per
(schema, expressions, config) via Make, then Evaluate many record batches
(gandiva.pyx:634-636). The torch counterpart of
gandiva_tpu.compiler.projector:

    validation + signature resolution   at Make time (validator.py)
    LLVMGenerator + Engine (ORC JIT)    with Configuration.optimize on the
                                        card: one generated CUDA kernel for
                                        the plan (codegen.py), built by nvcc
                                        at Make and cached (jit.py)
    precompiled bitcode inlining        the registry's emitters, inlined
                                        into the generated row body
    evaluation                          the generated kernel, with the nodes
                                        that have no emitter evaluated
                                        eagerly around it; otherwise (and on
                                        the CPU) eager torch calls on whole
                                        columns (decomposer.py)
    stream compaction                   kernel K1 (ops/kernels/compaction.py)
    function holders (LIKE tables,      host tables built per distinct
    dictionary ranks, string IN sets)   dictionary value at evaluate time,
                                        memoized per plan on the identity of
                                        the batch's dictionaries
    DumpIR                              the generated source of a compiled
                                        plan, a text dump of the decomposed
                                        plan otherwise (``.hlo`` /
                                        ``.llvm_ir``)
    profiling                           ``profile``: a torch.profiler Chrome
                                        trace of one evaluation;
                                        ``cost_analysis``: the port's own
                                        count of its operations and bytes
    expression cache (cache.h)          the make_* plan cache

Every plan has an explicit ``device`` (default: the card). Arrow input is
converted onto it; a Batch on another device is refused.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import dtypes as dt
from .. import tracing
from ..batch import Batch, Column, column_to_arrow, from_arrow
from ..device import DEFAULT_DEVICE, resolve_device
from ..expr.nodes import (Condition, Expression, FieldNode, FunctionNode,
                          IfNode, LiteralNode, Node)
from ..ops.compaction import compact_best
from ..ops.kernels import LAUNCHES
from ..registry.numeric import torch_dtype
from ..registry.registry import (EvaluationError,
                                 ExpressionValidationError, Val,
                                 global_registry)
from . import codegen, jit, validator
from .codegen import children as _children
from .config import Configuration, ConfigurationBuilder
from .decomposer import (ExprDecomposer, TraceContext, as_valid_mask,
                         merge_dictionaries, string_in_table)
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


class _KeyedDecomposer(ExprDecomposer):
    """The decomposer of a compiled plan's eager nodes: a node whose Val is
    in ``known`` (a kernel's output or an eager node already evaluated),
    by its key, is not evaluated again."""

    def __init__(self, ctx: TraceContext):
        super().__init__(ctx)
        self.known: Dict[codegen.Key, Val] = {}

    def decompose_at(self, key: codegen.Key, node: Node) -> Val:
        saved, self._at = self._at, [key[:-1], key[-1]]
        try:
            return self.decompose(node)
        finally:
            self._at = saved

    def decompose(self, node: Node) -> Val:
        parent, j = self._at
        key = parent + (j,)
        if key in self.known:
            self._at[1] += 1
            return self.known[key]
        return super().decompose(node)

    def host_arg(self, key: codegen.Key, node: Node) -> Val:
        """A compiled node's argument on its host side, which reads no
        value: its Val in ``known`` (an eager node's, a kernel output's or
        an earlier host side's), a field's dictionary, a literal, or else
        its type alone."""
        if key in self.known:
            return self.known[key]
        if isinstance(node, FieldNode):
            return Val(None, None, node.dtype,
                       dict_thunk=_field_dictionary(node.field.name)
                       if node.dtype.is_varlen else None,
                       source_field=node.field.name)
        if isinstance(node, LiteralNode):
            return self._literal(node)
        return Val(None, None, node.dtype)


def _field_dictionary(name: str):
    """A string field's dictionary thunk: the batch's column's."""
    def thunk(batch):
        return batch.column(name).dictionary
    return thunk


def _pointer(t: torch.Tensor, dtype: torch.dtype):
    """A kernel operand's (tensor, is a broadcast scalar): a 0-d or
    stride-0 tensor is read at its first element by every row."""
    if t.dtype != dtype:
        t = t.to(dtype)
    if t.dim() == 0 or t.stride(0) == 0:
        return t, True
    return t.contiguous(), False


class _CompiledPlan:
    """Shared evaluate machinery for Projector, Filter and FilterProject.
    ``mask_root``: the first root is a condition (Filter, FilterProject)."""

    def __init__(self, schema: dt.Schema, roots: Sequence,
                 config: Configuration, device, mask_root: bool = False):
        self.schema = schema
        self.config = config
        self.device = resolve_device(device)
        self._roots = tuple(roots)
        self._mask_root = mask_root
        self._consts: Dict[Any, torch.Tensor] = {}
        self._table_memo: Dict[str, Any] = {}
        self._error_messages: List[str] = []
        self._seed = 0
        self._bytes: Optional[Dict[str, int]] = None
        # per-operator observability (SURVEY.md §5.5): host-side counters
        self.stats = {"evaluations": 0, "rows_in": 0, "rows_out": 0}
        # Configuration.optimize on the card: the generated kernel, built
        # now (jax.jit's counterpart); a failed build raises
        self._program: Optional[codegen.Program] = None
        self._library: Optional[jit.Library] = None
        if config.optimize and self.device.type == "cuda":
            self._compile("cuda")

    def _compile(self, backend: str) -> None:
        self._program = codegen.generate(self._roots, self._mask_root,
                                         self.config.raise_errors)
        self._library = (jit.load(self._program.source, backend)
                         if self._program.kernels else None)

    # ---- the compiled route ------------------------------------------------
    def _run_program(self, ctx: TraceContext, selection=None) -> List[Val]:
        """Evaluate the roots on the compiled route: each stage's eager
        nodes, children first, then its kernel; returns the roots' Vals.
        Error sites, the kernel's and the eager nodes', are put in the
        decomposer's post-order, the order the eager route records them.
        ``selection``: (the batch's columns, the selected rows' indices),
        which the kernels read their fields through."""
        prog = self._program
        dec = _KeyedDecomposer(ctx)
        tables: Dict[codegen.Key, List[torch.Tensor]] = {}
        sites = []
        flags = None
        if ctx.check_errors and prog.sites:
            flags = torch.zeros(-(-len(prog.sites) // 32), dtype=torch.int32,
                                device=ctx.device)
        for stage in prog.stages:
            for key in stage.eager:
                with tracing.span("gt.plan.eager"):
                    n0 = len(ctx.error_flags)
                    dec.known[key] = dec.decompose_at(key, prog.nodes[key])
                    sites += [(prog.post[key], j - n0, ctx.error_flags[j],
                               ctx.error_messages[j])
                              for j in range(n0, len(ctx.error_flags))]
            for key in stage.hosts:
                with tracing.span("gt.plan.host_tables"):
                    tables[key], dec.known[key] = self._host_side(key, ctx,
                                                                  dec)
            if stage.launches:
                with tracing.span("gt.plan.launch"):
                    self._launch(stage, ctx, dec.known, flags, selection,
                                 tables)
        outs = [dec.decompose_at((i,), root)
                for i, root in enumerate(self._roots)]
        if flags is not None:
            sites += [(post, sub, ((flags[j >> 5] >> (j & 31)) & 1).bool(),
                       message)
                      for j, (post, sub, message) in enumerate(prog.sites)]
        sites.sort(key=lambda s: s[:2])
        ctx.error_flags = [s[2] for s in sites]
        ctx.error_messages = [s[3] for s in sites]
        if self._mask_root and prog.kinds[(0,)] == "compiled":
            ctx.length = ctx.capacity      # the kernel applied the length
        return outs

    def _host_side(self, key: codegen.Key, ctx: TraceContext,
                   dec: _KeyedDecomposer):
        """A compiled node's host side, before its kernel: (its tables,
        the Val of its dictionary and literal, value None), which joins
        ``dec.known`` until the kernel writes the node's value."""
        node = self._program.nodes[key]
        args = [dec.host_arg(key + (j,), child)
                for j, child in enumerate(_children(node))]
        ctx.at(key)
        if isinstance(node, FunctionNode):
            types = [a.dtype for a in args]
            tables, out = global_registry().lookup_or_raise(
                node.name, types).host(ctx, args)
        elif isinstance(node, IfNode):
            tables, thunk = merge_dictionaries(ctx, args[1], args[2],
                                               node.dtype)
            out = Val(None, None, node.dtype, dict_thunk=thunk)
        else:
            tables, out = [string_in_table(ctx, args[0], node)], None
        return tables, out or Val(None, None, node.dtype)

    def _launch(self, stage: codegen.Stage, ctx: TraceContext, known,
                flags, selection=None, tables=None) -> None:
        """One stage's kernel over the plan's columns, ``known`` Vals and
        the host ``tables`` of its nodes; its outputs join ``known``, with
        the dictionaries their host sides left there. Over a ``selection``
        the kernel reads each field at the selected rows of the batch's
        column."""
        cap, dev = ctx.capacity, ctx.device
        tables = {} if tables is None else tables
        keep, ptrs, scalar = [], [], []
        sides = {}           # a distinct operand's bytes moved, by side

        def operand(t, dtype, side="read", rows=None):
            if t is None:
                ptrs.append(None)
                scalar.append(False)
                return
            t, s = _pointer(t, dtype)
            if t.device != dev:
                raise ValueError(f"kernel operand on {t.device}, plan on "
                                 f"{dev}")
            keep.append(t)
            ptrs.append(t.data_ptr())
            scalar.append(s)
            n = t.numel() if rows is None else min(rows, t.numel())
            sides.setdefault(t.data_ptr(), (side, n * t.element_size()))

        for port in stage.inputs:
            kind, ref = port.ref
            if kind == "node":
                v = known[ref]
            elif selection is not None:
                v = Val(*selection[0][ref], port.dtype)
            else:
                v = ctx.columns[ref]
            limbs = v.value if isinstance(v.value, tuple) else (v.value,)
            store = torch.int64 if port.dtype.is_decimal else \
                torch_dtype(port.dtype)
            if not port.hi_read:             # a decimal used mod 2^64
                limbs = (None, limbs[1])
            # over a selection a field's cap selected rows are read
            rows = cap if selection is not None and kind == "field" else None
            for limb in limbs:
                operand(limb, store, rows=rows)
            operand(v.validity, torch.bool, rows=rows)
        lengths = []
        for key in stage.hosts:      # the kernel reads what was built
            read = sum(k == key for k, _, _ in stage.tables)
            if len(tables[key]) != read:
                raise RuntimeError(f"node {key}'s host side built "
                                   f"{len(tables[key])} tables, its "
                                   f"kernel reads {read}")
        for key, j, ct in stage.tables:
            table = tables[key][j]
            if table.dtype != codegen.TABLE_DTYPES[ct]:
                raise TypeError(f"host table {j} of node {key} is "
                                f"{table.dtype}, its kernel reads {ct}")
            operand(table, table.dtype)
            lengths.append(int(table.shape[0]))
        for port in stage.outputs:
            if port.mask:
                mask = torch.empty(cap, dtype=torch.bool, device=dev)
                known[port.ref[1]] = Val(mask, None, dt.bool_)
                operand(mask, torch.bool, "written")
                continue
            t = port.dtype
            store = torch.int64 if t.is_decimal else torch_dtype(t)
            limbs = [torch.empty(cap, dtype=store, device=dev)
                     for _ in range(port.limbs)]
            valid = torch.empty(cap, dtype=torch.bool, device=dev)
            h = known.get(port.ref[1], Val(None, None, t))
            known[port.ref[1]] = Val(tuple(limbs) if t.is_decimal
                                     else limbs[0], valid, t,
                                     dict_thunk=h.dict_thunk,
                                     literal=h.literal,
                                     is_literal=h.is_literal,
                                     source_field=h.source_field)
            for limb in limbs:
                operand(limb, store, "written")
            operand(valid, torch.bool, "written")
        length = ctx.length
        len_ptr, len_bytes = None, 8
        if isinstance(length, torch.Tensor):
            if length.dtype not in (torch.int32, torch.int64):
                length = length.to(torch.int64)
            keep.append(length)
            sides.setdefault(length.data_ptr(),
                             ("read", length.element_size()))
            len_ptr, len_bytes, length = (length.data_ptr(),
                                          length.element_size(), 0)
        sel, sel_bytes = None, 0
        if selection is not None:
            index = selection[1].contiguous()
            if index.dtype not in (torch.int32, torch.int64):
                index = index.to(torch.int64)
            keep.append(index)
            sides.setdefault(index.data_ptr(),
                             ("read", index.numel() * index.element_size()))
            sel, sel_bytes = index.data_ptr(), index.element_size()
        cuda = dev.type == "cuda"
        args = (stage.index, ptrs, scalar, lengths, len_ptr, len_bytes,
                int(length), cap, sel, sel_bytes,
                None if flags is None else flags.data_ptr())
        if cuda:
            blocks = min(-(-cap // codegen.THREADS), 16 * torch.cuda
                         .get_device_properties(dev).multi_processor_count)
            with torch.cuda.device(dev):     # the launcher's current card
                self._library.run(*args, blocks,
                                  torch.cuda.current_stream(dev).cuda_stream)
            LAUNCHES["plan"] += int(cap > 0)  # no rows: nothing launched
        else:
            self._library.run(*args, 0, None)
        if self._bytes is not None:         # each distinct operand once
            for side, nbytes in sides.values():
                self._bytes[f"plan bytes {side}"] += nbytes

    # ---- evaluation ----------------------------------------------------
    def _make_vals(self, cols) -> Dict[str, Val]:
        out = {}
        for f in self.schema:
            if f.name not in cols:
                continue
            thunk = _field_dictionary(f.name) if f.dtype.is_varlen \
                else None
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
             batch: Optional[Batch] = None, selection=None):
        """Evaluate every root over ``cols`` ({name: (data, validity)});
        ``length`` is a Python int or a 0-d device tensor; a decimal
        column's data is its (hi, lo) limb pair. ``batch`` is the Batch the
        host tables are built from (string plans need it). ``selection``
        (compiled route only): (the batch's columns, the selected rows'
        indices), which the kernels read their fields through; ``cols``
        then holds the gathered columns the eager nodes read."""
        with tracing.span("gt.plan.prepare"):
            capacity = (int(selection[1].shape[0]) if selection is not None
                        else int(_limbs(next(iter(cols.values()))[0])[0]
                                 .shape[0]))
            ctx = TraceContext(capacity, length, {}, self.device, seed=seed,
                               check_errors=self.config.raise_errors,
                               consts=self._consts, batch=batch,
                               tables=None if batch is None
                               else self._tables_for(batch))
            ctx.columns = self._make_vals(cols)
        if self._program is not None:
            outs = self._run_program(ctx, selection)
        else:
            with tracing.span("gt.plan.eager"):
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
        """Selection-vector-aware evaluation (reference behavior:
        test_gandiva.py:358-373 — output has len(selection) rows): the
        selected rows are gathered, then evaluated; rows past the count
        are null. The compiled route gathers only the columns a root is or
        an eager node reads (as ``jax.jit`` fuses the gather into the
        reference's program); its kernels read the rest at the selected
        rows themselves. String codes are gathered; their dictionaries
        stay ``batch``'s."""
        prog = self._program
        names = cols if prog is None else [n for n in prog.eager_fields
                                          if n in cols]
        gathered = {}
        if names:
            cap = sel_indices.shape[0]
            row_ok = torch.arange(cap, device=self.device) < sel_count
            # the tail past count is unspecified: point it at row 0
            idx = torch.where(row_ok, sel_indices,
                              torch.zeros_like(sel_indices))
            for name in names:
                data, validity = cols[name]
                g = tuple(d.index_select(0, idx) for d in _limbs(data))
                gathered[name] = (g if isinstance(data, tuple) else g[0],
                                  validity.index_select(0, idx) & row_ok)
        return self._run(gathered, sel_count, seed, finish, batch,
                         None if prog is None else (cols, sel_indices))

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
        with tracing.sync("errors"):
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
        """The DumpIR analogue: a compiled plan's generated source (its
        head lists every node's route), as the JAX package returns its
        StableHLO text; otherwise a text dump of the decomposed plan, each
        root with the registry signature and null rule every function
        resolved to. ``batch`` is accepted for parity and not needed."""
        if self._program is not None:
            return self._program.source
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

    def _evaluate_once(self, batch: Batch):
        with tracing.span("gt.plan.evaluate"):
            tracing.add("rows_in", batch.length)
            return self._run(self._cols_of(batch), batch.length,
                             self._next_seed(), batch=batch)

    def profile(self, batch, trace_dir: Optional[str] = None) -> str:
        """Trace one evaluation over ``batch`` with ``torch.profiler`` (the
        host's operators, and the card's kernels when the plan is on one)
        and write it as a Chrome trace, ``trace.json``, into ``trace_dir``
        or a fresh temporary directory; returns the directory. The
        runtime-side sibling of ``dump_hlo``."""
        import os
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        if trace_dir is None:
            trace_dir = tempfile.mkdtemp(prefix="gandiva_tpu_torch_trace_")
        os.makedirs(trace_dir, exist_ok=True)
        batch = self._as_batch(batch)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        tracing.clear()
        with profile(activities=activities) as prof:
            self._evaluate_once(batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        _add_span_track(path, tracing.spans())
        tracing.clear()
        return trace_dir

    def cost_analysis(self, batch) -> Dict[str, int]:
        """The cost of one evaluation over ``batch`` at its shapes, as the
        port counts it — not XLA's cost model, which the reference returns.
        Every torch operation the decomposed plan runs is counted as torch
        dispatches it: ``ops`` (operations that are not views),
        ``bytes read`` / ``bytes written`` (each tensor argument read once,
        each output written once), ``bytes accessed`` (their sum) and
        ``flops`` (one operation an output element of every elementwise
        operation); ``kernel launches`` counts the hand-written kernels'
        launches (``ops.kernels.LAUNCHES``; the generated kernel's under
        ``plan``), whose bytes the byte counts leave out. A compiled plan
        also reports its kernels' own ``plan bytes read`` / ``plan bytes
        written`` (each operand once, a broadcast one as one element) and
        how many of its nodes compiled and stayed eager."""
        batch = self._as_batch(batch)
        before = sum(LAUNCHES.values())
        self._bytes = {"plan bytes read": 0, "plan bytes written": 0}
        try:
            with _op_tally() as tally:
                self._evaluate_once(batch)
        finally:
            kernel_bytes, self._bytes = self._bytes, None
        cost = dict(tally.counts)
        cost["bytes accessed"] = cost["bytes read"] + cost["bytes written"]
        cost["kernel launches"] = sum(LAUNCHES.values()) - before
        if self._program is not None:
            cost.update(kernel_bytes)
            cost["compiled nodes"] = self._program.count("compiled")
            cost["eager nodes"] = self._program.count("eager")
        return cost

    @property
    def llvm_ir(self) -> str:
        """Name-compatible alias for pyarrow's Projector.llvm_ir."""
        return self.dump_hlo()


def _add_span_track(path: str, spans) -> None:
    """Write the program's ``spans`` into the Chrome trace at ``path`` as a
    track of their own, ``gandiva_tpu_torch spans``, beside the profiler's
    (one timeline: both are on the Unix clock)."""
    import json

    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = "gandiva_tpu_torch spans"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for i, s in enumerate(spans):
        args = {"index": i, "parent": s.parent, "request": s.request,
                **s.counters}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "gt_span", "name": s.name,
                       "pid": pid, "tid": 0, "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _op_tally():
    """A torch dispatch mode that tallies the operations run under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpTally(TorchDispatchMode):
        """Counts every dispatched torch operation that is not a view."""

        def __init__(self):
            super().__init__()
            self.counts = {"ops": 0, "flops": 0, "bytes read": 0,
                           "bytes written": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                c = self.counts
                c["ops"] += 1
                c["bytes read"] += _nbytes((args, kwargs))
                c["bytes written"] += _nbytes(out)
                if torch.Tag.pointwise in func.tags:
                    c["flops"] += sum(t.numel() for t in _tensors(out))
            return out

    return OpTally()


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
        with tracing.span("gt.plan.outputs"):
            return [(_full(v.value, cap), as_valid_mask(v, cap, ctx.device))
                    for v in outs]

    # ---- public API ----------------------------------------------------
    def evaluate_device(self, batch: Batch,
                        selection: Optional[SelectionVector] = None) -> Batch:
        """Evaluate and keep results on the device as a Batch."""
        with tracing.span("gt.plan.evaluate"):
            tracing.add("rows_in", batch.length)
            return self._evaluate_device(batch, selection)

    def _evaluate_device(self, batch: Batch,
                         selection: Optional[SelectionVector]) -> Batch:
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
            with tracing.sync("count"):
                length = int(selection.count)
        self._count(batch, length)
        tracing.add("rows_out", length)
        with tracing.span("gt.plan.outputs"):
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
        super().__init__(schema, [condition.root], config, device,
                         mask_root=True)

    @staticmethod
    def make(schema: dt.Schema, condition: Condition,
             config: Optional[Configuration] = None,
             device=DEFAULT_DEVICE) -> "Filter":
        return Filter(schema, condition, config, device)

    def _finish(self, ctx: TraceContext, outs: List[Val]):
        mask = _condition_mask(ctx, outs[0])
        with tracing.span("gt.compact"):
            idx, count, _ = compact_best(mask)
        return idx, count

    def evaluate(self, batch, mode: SelectionMode = SelectionMode.UINT32
                 ) -> SelectionVector:
        """Evaluate the condition; rows where it is true AND valid land in the
        selection (gandiva.pyx:247-280; semantics test_gandiva.py:113-114)."""
        batch = self._as_batch(batch)
        with tracing.span("gt.plan.evaluate"):
            tracing.add("rows_in", batch.length)
            idx, count = self._unwrap_errors(
                self._run(self._cols_of(batch), batch.length,
                          self._next_seed(), batch=batch))
            self.stats["evaluations"] += 1
            self.stats["rows_in"] += batch.length
            if mode is SelectionMode.UINT16:
                check_uint16_capacity(batch.capacity)
            with tracing.span("gt.plan.outputs"):
                return SelectionVector(idx.to(mode_index_dtype(mode)), count,
                                       mode)


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
                         config, device, mask_root=True)

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
        mask, payload = self._dense(ctx, outs)
        with tracing.span("gt.compact"):
            tracing.add("payload_columns", len(payload))
            return compact_best(mask, payload)

    def evaluate_device(self, batch: Batch):
        """Returns (SelectionVector, Batch of projected columns) — both
        logically ``count`` rows long."""
        with tracing.span("gt.plan.evaluate"):
            tracing.add("rows_in", batch.length)
            (idx, count, packed), dicts = self._unwrap_errors(
                self._run(self._cols_of(batch), batch.length,
                          self._next_seed(), self._with_dicts, batch))
            with tracing.sync("count"):
                length = int(count)
            self._count(batch, length)
            tracing.add("rows_out", length)
            with tracing.span("gt.plan.outputs"):
                return self._outputs(idx, count, packed, dicts, length)

    def _outputs(self, idx, count, packed, dicts, length: int):
        """The SelectionVector and the Batch of the projected columns."""
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
