"""Load and launch the plan compiler's generated kernels.

The card's route: a generated source (``codegen.generate``) is compiled by
``nvcc`` (``ops/kernels/build.nvcc()``) for ``sm_90a`` with nvcc's
defaults, as torch's own kernels are: IEEE division and square root (never
``-use_fast_math``) and FMA contraction allowed, so the CUDA math functions
(libdevice) compile as in torch's kernels and give their bits. The row
body's own float products and sums go through the prelude's ``gt_fmul`` /
``gt_fadd`` (round-to-nearest intrinsics nvcc never contracts), so a
compiled ``a*b + c`` rounds the product first, as the eager route does.
The result is a shared library with a plain C interface,
loaded with ``ctypes``. Each stage's launcher takes the column and host
table pointers and the tables' lengths, copies them into one struct and
passes it to the kernel by value, on the current torch stream.

Building, caching and loading are ``ops/kernels/build.py``'s
(``build.load_plan``): a plan's library lives under ``build/plans/``,
named by a hash of the source and the compiler command, with the source
beside it, and is loaded once a process, so a plan made again, in this
process or another, builds nothing.

The host build compiles the same source with ``g++ -ffp-contract=off``
into a library whose launchers loop over the rows on the CPU. Only the
tests use it (``host_build``); no entry point does.

A failed build raises: nothing falls back to the eager route.
"""
from __future__ import annotations

import ctypes
import re
from typing import Optional, Sequence

from ..ops.kernels import build

# a stage's launcher, as codegen writes it
_LAUNCHER = re.compile(r'extern "C" int gt_plan_run_(\d+)\(')
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
# chip_smoke.py builds the plans beside the kernels (phase 2), and drops a
# plan's library from the loaded ones (keyed by its path) to time a load
# from disk (make_times)
build_all = build.build_plans
_MEMO = build._LOADED


class Library:
    """A loaded plan library: ``run(stage, ...)`` calls the stage's
    launcher and raises on a non-zero status (a refused launch)."""

    def __init__(self, source: str, backend: str):
        self.path = build.plan_path(source, backend)
        stages = [int(s) for s in _LAUNCHER.findall(source)]
        lib = build.load_plan(source, backend, {
            f"gt_plan_run_{s}": (ctypes.c_int, _ARGS) for s in stages})
        self._fns = {s: getattr(lib, f"gt_plan_run_{s}") for s in stages}

    def run(self, stage: int, pointers: Sequence[int], scalar: Sequence[bool],
            table_lengths: Sequence[int], len_ptr: Optional[int],
            len_bytes: int, length: int, n: int, sel: Optional[int],
            sel_bytes: int, flags: Optional[int], blocks: int,
            stream: Optional[int]) -> None:
        words = [0] * max(1, -(-len(pointers) // 64))
        for k, s in enumerate(scalar):
            if s:
                words[k >> 6] |= 1 << (k & 63)
        ptrs = (ctypes.c_void_p * max(1, len(pointers)))(*pointers)
        sc = (ctypes.c_uint64 * len(words))(*words)
        tn = (ctypes.c_int64 * max(1, len(table_lengths)))(*table_lengths)
        rc = self._fns[stage](ptrs, sc, tn, len_ptr, len_bytes, length, n,
                              sel, sel_bytes, flags, blocks, stream)
        if rc != 0:
            raise RuntimeError(f"plan kernel {stage} of {self.path.name} "
                               f"failed to launch: CUDA error {rc}")


def load(source: str, backend: str = "cuda") -> Library:
    """The library of ``source`` for ``backend``, built on first use."""
    return Library(source, backend)


def host_build(plan):
    """Give ``plan`` (a Projector, Filter or FilterProject on the CPU) the
    compiled route through the host build of its generated source, in
    place of the eager route; returns the plan. For the tests: it holds
    the generated kernel's arithmetic on the CPU."""
    if plan.device.type != "cpu":
        raise ValueError("the host build runs plans on the CPU")
    plan._compile("host")
    return plan
