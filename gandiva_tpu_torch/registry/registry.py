"""FunctionRegistry — the typed function table and kernel calling convention.

Reference: Gandiva's FunctionRegistry (function_registry.cc + per-category
tables, SURVEY.md §2a#5) maps (base_name, param types) → a precompiled native
function plus a result-nullability kind:

- ``NULL_IF_NULL``  — output validity = AND of input validities (default);
- ``NULL_NEVER``    — output is always valid (e.g. isnull, isnotnull);
- ``NULL_INTERNAL`` — the function computes its own validity.

Where Gandiva's entries point at LLVM-bitcode scalar kernels that the JIT
inlines into a row loop, ours point at *vectorized torch functions* over whole
columns, run eagerly. The "precompiled/" library (SURVEY.md §2a#6) becomes the
per-category modules registered into this table; "function holders"
(LIKE/IN/to_date, §2a#7) become host-side table builders that feed per-batch
device lookup tensors into the evaluation (see ``TraceContext`` in
compiler/decomposer.py).

Kernel calling convention
-------------------------
``impl(ctx, args) -> Val | torch.Tensor``

- ``args`` is a list of ``Val``; ``Val.value`` is the device tensor (0-d for
  literals; dictionary codes for strings), ``Val.validity`` is a bool device
  tensor or None (None ⇒ statically all-valid).
- For NULL_IF_NULL functions the impl may return a bare value array; the
  decomposer computes the AND-of-validities.
- NULL_NEVER / NULL_INTERNAL impls return a full ``Val``.
- ``Val.literal`` carries the python literal when an argument is a compile-time
  constant — holder-style functions (like, to_date) require it.
- ``ctx`` is the TraceContext: gives access to per-batch host tables
  (``ctx.add_table``) and the row-validity context.

Emitters
--------
An entry may also carry ``emit``: the C++ text of the same function for one
row, which the plan compiler (compiler/codegen.py) inlines into a plan's
generated kernel, as Gandiva's registry points at precompiled bitcode that
its JIT inlines. An entry without one stays eager inside a compiled plan.
``emit`` computes exactly what ``impl`` does, bit for bit (the protocol is
in codegen.py's docstring).

A string or binary entry also carries ``host``: ``host(ctx, args) ->
(tables, out)``, its work on the host. It builds the entry's host tables
through ``ctx.add_table``, in the order its emitter declares them
(``g.table``), and returns them with ``out``, a Val whose value is None
that carries the result's dictionary (``dict_thunk``), literal and source
field. ``impl`` calls it, and so does a compiled plan before its kernel
reads the tables: both routes build every table with the same code.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import dtypes as dt
from .signature import FunctionSignature


class Nullability(enum.Enum):
    NULL_IF_NULL = "null_if_null"
    NULL_NEVER = "null_never"
    NULL_INTERNAL = "null_internal"


@dataclasses.dataclass
class Val:
    """A (value, validity) pair with static metadata."""

    value: Any                      # torch tensor (device) — codes for strings
    validity: Any                   # torch bool tensor or None (=always valid)
    dtype: dt.DataType
    dict_thunk: Optional[Callable] = None  # host: (batch) -> pyarrow Array
    literal: Any = None             # python literal if compile-time constant
    is_literal: bool = False
    # set when this Val is a direct input-column reference: kernels that
    # need the host-side column per batch (castVARCHAR(numeric) formatting)
    # key their evaluate-time thunks by this name
    source_field: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class NativeFunction:
    signature: FunctionSignature
    impl: Callable
    nullability: Nullability = Nullability.NULL_IF_NULL
    # impl wants the tree-declared return type (casts whose target is
    # parameterized, e.g. castDECIMAL → decimal(p, s) of the node)
    needs_return_type: bool = False
    # the row's C++ text for the plan compiler, or None (stays eager)
    emit: Optional[Callable] = None
    # a string entry's host side: (ctx, args) -> (tables, Val)
    host: Optional[Callable] = None

    @property
    def name(self) -> str:
        return self.signature.name


class FunctionRegistry:
    """Global table keyed by (canonical name, param dtypes)."""

    def __init__(self):
        self._table: Dict[Tuple[str, Tuple[dt.DataType, ...]], NativeFunction] = {}
        self._aliases: Dict[str, str] = {}

    # -- registration ------------------------------------------------------
    def register(self, name: str, param_types: Sequence[dt.DataType],
                 return_type, impl: Callable,
                 nullability: Nullability = Nullability.NULL_IF_NULL,
                 aliases: Sequence[str] = (),
                 needs_return_type: bool = False,
                 emit: Optional[Callable] = None,
                 host: Optional[Callable] = None):
        sig = FunctionSignature(name, tuple(param_types), return_type)
        key = (name, sig.param_types)
        if key in self._table:
            raise ValueError(f"duplicate registration: {sig}")
        self._table[key] = NativeFunction(sig, impl, nullability,
                                          needs_return_type, emit, host)
        for a in aliases:
            self._aliases.setdefault(a, name)

    def register_many(self, name: str, type_combos, impl: Callable,
                      nullability: Nullability = Nullability.NULL_IF_NULL,
                      aliases: Sequence[str] = (),
                      emit: Optional[Callable] = None):
        """``type_combos``: iterable of (param_types, return_type)."""
        for param_types, ret in type_combos:
            self.register(name, param_types, ret, impl, nullability, aliases,
                          emit=emit)

    # -- lookup ------------------------------------------------------------
    def canonical_name(self, name: str) -> str:
        return self._aliases.get(name, name)

    def lookup(self, name: str,
               arg_types: Sequence[dt.DataType]) -> Optional[NativeFunction]:
        # primary names always win; the alias map is a fallback only
        hit = self._table.get((name, tuple(arg_types)))
        if hit is not None:
            return hit
        cname = self.canonical_name(name)
        return self._table.get((cname, tuple(arg_types)))

    def lookup_or_raise(self, name: str,
                        arg_types: Sequence[dt.DataType]) -> NativeFunction:
        fn = self.lookup(name, arg_types)
        if fn is None:
            sigs = self.signatures_for(name)
            hint = ""
            if sigs:
                hint = " — registered signatures: " + "; ".join(
                    str(s) for s in sigs[:8])
            raise ExpressionValidationError(
                f"Function {name}({', '.join(str(t) for t in arg_types)}) "
                f"not supported{hint}")
        return fn

    def signatures_for(self, name: str) -> List[FunctionSignature]:
        names = {name, self.canonical_name(name)}
        return [f.signature for (n, _), f in self._table.items() if n in names]

    def all_signatures(self) -> List[FunctionSignature]:
        """The introspection surface — mirrors Gandiva's
        GetRegisteredFunctionSignatures() (libgandiva.pxd:274-277).
        Alias names are enumerated as their own signatures, as the
        reference registry does (e.g. the plain ``hash`` base name)."""
        sigs = [f.signature for f in self._table.values()]
        by_name = {}
        for f in self._table.values():
            by_name.setdefault(f.signature.name, []).append(f.signature)
        for alias, base in self._aliases.items():
            for sig in by_name.get(base, ()):
                sigs.append(FunctionSignature(alias, sig.param_types,
                                              sig.return_type))
        return sigs

    def __len__(self):
        return len(self._table)


class ExpressionValidationError(Exception):
    """Mirrors gandiva's ExpressionValidationError status surface
    (observable in pyarrow test_gandiva.py:159-161)."""


class EvaluationError(Exception):
    """Runtime evaluation error raised at the Evaluate boundary when the
    plan's Configuration enables ``raise_errors`` — the reference's
    Status-from-Evaluate contract (e.g. "divide by zero error"),
    SURVEY.md §5.3."""


# The process-wide registry, populated by the category modules on import
# (gandiva_tpu_torch/__init__.py imports registry.numeric and registry.cast).
_REGISTRY = FunctionRegistry()


def global_registry() -> FunctionRegistry:
    return _REGISTRY
