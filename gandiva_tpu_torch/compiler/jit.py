"""Build, cache, load and launch the plan compiler's generated kernels.

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

Libraries are cached on disk under ``build/plans/`` at the root of the
checkout (``config.plan_cache_dir``; ``build/`` is in ``.gitignore``),
named by a hash of the source and the flags, with the source beside them,
and in a per-process memo: a plan made again, in this process or another,
builds nothing. The compiler writes a temporary file that is renamed into
place, so processes building one plan at once never see a partial library.

The host build compiles the same source with ``g++ -ffp-contract=off``
into a library whose launchers loop over the rows on the CPU. Only the
tests use it (``host_build``); no entry point does.

A failed build raises: nothing falls back to the eager route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .config import plan_cache_dir

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]
SUFFIX = {"cuda": ".cu", "host": ".cpp"}

_MEMO: Dict[Path, "Library"] = {}
_LOCK = threading.Lock()


def _command(backend: str) -> List[str]:
    if backend == "cuda":
        from ..ops.kernels.build import nvcc

        return [nvcc(), *NVCC_FLAGS]
    if backend == "host":
        return ["g++", *GXX_FLAGS]
    raise ValueError(f"unknown backend {backend!r}")


def _flags(backend: str) -> List[str]:
    return NVCC_FLAGS if backend == "cuda" else GXX_FLAGS


def library_path(source: str, backend: str = "cuda") -> Path:
    """Where the library of ``source`` built for ``backend`` lives: named
    by a hash of the source and the flags."""
    h = hashlib.sha256(source.encode())
    h.update(" ".join([backend, *_flags(backend)]).encode())
    return plan_cache_dir() / f"libplan-{backend}-{h.hexdigest()[:16]}.so"


def _start(source: str, backend: str
           ) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start the compiler on ``source`` into a temporary file, unless its
    library is on disk."""
    out = library_path(source, backend)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(SUFFIX[backend])
    tmp_src = src.with_name(f"{src.stem}.{os.getpid()}."
                            f"{threading.get_ident()}{src.suffix}")
    tmp_src.write_text(source)
    os.replace(tmp_src, src)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*_command(backend), "-o", str(tmp), str(src)]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build plan {out.name}: {e}") from e
    return proc, tmp, out


def _finish(started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"plan build failed ({out.name}):\n{log}")
    out.with_suffix(".log").write_text(log)     # ptxas's register lines
    os.replace(tmp, out)


def build_all(sources: Sequence[str], backend: str = "cuda") -> List[Path]:
    """Build every source not yet on disk, one compiler each, started
    together; returns the libraries' paths."""
    started = [_start(s, backend) for s in sources]
    for s in started:
        _finish(s)
    return [library_path(s, backend) for s in sources]


class Library:
    """A loaded plan library: ``run(stage, ...)`` calls the stage's
    launcher and raises on a non-zero status (a refused launch)."""

    _ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]

    def __init__(self, path: Path, backend: str):
        self.path = path
        self.backend = backend
        try:
            self.lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        self._fns: Dict[int, object] = {}

    def _fn(self, stage: int):
        fn = self._fns.get(stage)
        if fn is None:
            fn = getattr(self.lib, f"gt_plan_run_{stage}")
            fn.restype = ctypes.c_int
            fn.argtypes = self._ARGS
            self._fns[stage] = fn
        return fn

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
        rc = self._fn(stage)(ptrs, sc, tn, len_ptr, len_bytes, length, n,
                             sel, sel_bytes, flags, blocks, stream)
        if rc != 0:
            raise RuntimeError(f"plan kernel {stage} of {self.path.name} "
                               f"failed to launch: CUDA error {rc}")


def load(source: str, backend: str = "cuda") -> Library:
    """The library of ``source`` for ``backend``, built on first use."""
    path = library_path(source, backend)
    lib = _MEMO.get(path)
    if lib is None:
        with _LOCK:
            lib = _MEMO.get(path)
            if lib is None:
                _finish(_start(source, backend))
                lib = _MEMO[path] = Library(path, backend)
    return lib


def host_build(plan):
    """Give ``plan`` (a Projector, Filter or FilterProject on the CPU) the
    compiled route through the host build of its generated source, in
    place of the eager route; returns the plan. For the tests: it holds
    the generated kernel's arithmetic on the CPU."""
    if plan.device.type != "cpu":
        raise ValueError("the host build runs plans on the CPU")
    plan._compile("host")
    return plan
