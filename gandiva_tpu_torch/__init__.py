"""gandiva_tpu_torch — the query engine of gandiva_tpu, ported to PyTorch and
CUDA for an NVIDIA H100.

The same public API as gandiva_tpu (TreeExprBuilder, make_projector,
make_filter, make_filter_project, SelectionVector, Configuration(Builder),
get_registered_function_signatures, ops.*), evaluated eagerly with torch,
with the stream compaction (two designs), the one-pass GROUP BY, the block
sort and the merge-path round as hand-written CUDA kernels (ops/kernels);
decimal128 and calendar arithmetic are elementwise torch ops.
Imports neither JAX nor gandiva_tpu.

Entry points run on the card by default (``device="cuda"``) and raise when
there is none; pass ``device="cpu"`` to run on the CPU, where each kernel's
plain torch version stands in for it.

Ported so far: the expression front end, the numeric, cast, date/time and
interval, string and binary, hash and decimal128 registry (dictionary-
encoded string columns with their host tables, decimal columns, literals
and the int128 limb arithmetic), the decomposer, Projector / Filter /
FilterProject and the entry points (the flagship, the TPC-H LINEITEM and
PART scans); the native host runtime (``native``: memory pool, bitmap
codec, LIKE matcher, byte hashing; built with g++ on first use);
serialized plans (``load_plan``, ``dump_plan``, ``make_*_from_plan``) and
streaming I/O (``io``); the hash aggregate with its group-id assignment,
hashes and key normalization, the sort, and the hash join (``ops.join``,
``join_multi``, ``join_stream``, ``build_join_table``, ``probe_chunk``,
``gather_payload``, ``probe_diagnostics``, ``JoinResult``, ``JoinTable``;
ops, utils); the plans' ``profile`` (a torch.profiler Chrome trace) and
``cost_analysis`` (the port's own operation and byte count); and the
distribution layer (``parallel``: the partition mesh, the all-to-all
shuffle, the distributed join / aggregate / sort, the configs[4] pipeline,
``entrypoints.distributed_step``).

Tracing turns on with any ``torch.profiler`` session: while one records,
the program's own spans (``gt.plan.*``, ``gt.compact``, ``gt.pipeline``,
the operators', and ``gt.sync.*`` at every read that waits for the card)
go to an in-memory store on the profiler's clock; ``tracing.spans()``
reads it and ``tracing.clear()`` empties it (``tracing.py``).
"""
from __future__ import annotations

from . import dtypes
from .dtypes import DataType, Field, Schema
from .batch import (Batch, Column, from_arrow, from_columns_numpy,
                    from_numpy, to_arrow)
from .expr.nodes import (BooleanNode, Condition, Expression, FieldNode,
                         FunctionNode, IfNode, InNode, LiteralNode, Node)
from .expr.builder import TreeExprBuilder

# Register the kernel categories (import order defines registry population).
from .registry import numeric as _numeric  # noqa: F401
from .registry import cast as _cast  # noqa: F401
from .registry import datetime_ops as _datetime_ops  # noqa: F401
from .registry import string_ops as _string_ops  # noqa: F401
from .registry import hash_ops as _hash_ops  # noqa: F401
from .registry import decimal_ops as _decimal_ops  # noqa: F401
from .registry.registry import (EvaluationError, ExpressionValidationError,
                                FunctionRegistry, global_registry)
from .registry.signature import FunctionSignature

from .compiler.config import Configuration, ConfigurationBuilder
from .compiler.selection import SelectionMode, SelectionVector
from .compiler.projector import (Filter, FilterProject, Projector,
                                 make_filter, make_filter_project,
                                 make_projector)
from . import io, native, ops, parallel, tracing
from .plan import (Plan, PlanError, dump_plan, load_plan,
                   make_filter_from_plan, make_projector_from_plan)


def get_registered_function_signatures():
    """All registered (name, param types, return type) signatures — the
    planner capability-negotiation surface (gandiva.pyx:748-764,
    libgandiva.pxd:274-277)."""
    return global_registry().all_signatures()


__all__ = [
    "dtypes", "DataType", "Field", "Schema",
    "Batch", "Column", "from_arrow", "from_columns_numpy", "from_numpy",
    "to_arrow",
    "Node", "LiteralNode", "FieldNode", "FunctionNode", "IfNode",
    "BooleanNode", "InNode", "Expression", "Condition",
    "TreeExprBuilder",
    "Configuration", "ConfigurationBuilder",
    "SelectionMode", "SelectionVector",
    "Projector", "Filter", "FilterProject", "make_projector",
    "make_filter", "make_filter_project",
    "FunctionRegistry", "FunctionSignature", "global_registry",
    "get_registered_function_signatures",
    "ExpressionValidationError", "EvaluationError",
    "Plan", "PlanError", "load_plan", "dump_plan",
    "make_projector_from_plan", "make_filter_from_plan",
    "io", "native", "ops", "parallel", "tracing",
]

__version__ = "0.1.0"
