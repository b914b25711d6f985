"""Configuration — compile-time flags.

Mirrors gandiva::Configuration / ConfigurationBuilder (libgandiva.pxd:279-298;
python surface gandiva.pyx:591-626): ``optimize`` (default True) and
``dump_ir`` (default False), as a small frozen object threaded through the
compile entry points — never global mutable state (SURVEY.md §5.6).

``optimize=True`` (the default) compiles a plan on the card at Make: its
expression trees become one generated CUDA kernel (compiler/codegen.py,
built by compiler/jit.py), launched once per evaluation, as the JAX package
installs ``jax.jit``; the nodes without an emitter stay eager around it.
``optimize=False`` evaluates every node eagerly, a torch call per
registry function. Results are identical either way. On the CPU both run
the eager route. Compiled plans are cached on disk under ``build/plans/``
at the root of the checkout (``ops/kernels/build.py``), the counterpart of
the JAX package's ``enable_persistent_cache``. ``dump_ir`` keeps a text dump
of the plan on the plan object (``.hlo`` / ``.llvm_ir``: the generated
source of a compiled plan, the decomposed signatures of an eager one).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Configuration:
    """``raise_errors`` (engine extension, default False): surface runtime
    evaluation errors — integer divide-by-zero — as Python exceptions at the
    Evaluate boundary, matching the reference's Status-from-Evaluate contract
    (gandiva raises e.g. "divide by zero error" from Projector::Evaluate).
    The plan reduces per-row error predicates to one device error code and
    the host checks it per batch (one extra scalar sync per Evaluate, which
    is why the flag is opt-in; off, integer x/0 yields 0, documented in
    registry/numeric.py)."""
    optimize: bool = True
    dump_ir: bool = False
    raise_errors: bool = False


class ConfigurationBuilder:
    """Builder mirroring the reference API shape."""

    _default = Configuration()

    def __init__(self):
        self._optimize = True
        self._dump_ir = False
        self._raise_errors = False

    def with_optimize(self, v: bool) -> "ConfigurationBuilder":
        self._optimize = bool(v)
        return self

    def with_dump_ir(self, v: bool) -> "ConfigurationBuilder":
        self._dump_ir = bool(v)
        return self

    def with_raise_errors(self, v: bool) -> "ConfigurationBuilder":
        self._raise_errors = bool(v)
        return self

    def build(self) -> Configuration:
        return Configuration(self._optimize, self._dump_ir,
                             self._raise_errors)

    @classmethod
    def default_configuration(cls) -> Configuration:
        return cls._default
