"""The port's one seam for native code: compile a C++ or CUDA source, cache
its shared library, load it and bind its C functions.

Three kinds of source go through it. Each has its compiler command, a named
constant below, and its directory under ``build/`` at the root of the
checkout (listed in ``.gitignore``):

- the hand-written kernels, ``csrc/<name>.cu``: ``nvcc`` for ``sm_90a``
  (``NVCC_FLAGS``) into ``build/kernels/`` (``load``, ``build_all``);
- the plan compiler's generated sources (``compiler/jit.py``): the same
  nvcc command for the card, or ``g++`` with ``PLAN_HOST_FLAGS`` for the
  host build, into ``build/plans/``, each library with its source beside
  it (``load_plan``, ``build_plans``);
- the host runtime, ``native/host_runtime.cpp``: ``g++`` with
  ``RUNTIME_FLAGS`` into ``build/native/`` (``load_runtime``).

A library is named by a hash of its source, the headers of ``csrc/`` that
a kernel includes in quotes (``headers``) and the compiler command, so an
edited source or header rebuilds only the libraries that include it, and a
library on disk is reused by every later process. The compiler writes a
temporary file named by the process and the thread, renamed into place
once whole, so builds of one library at once, in processes or threads,
never install a partial one; the compiler's log (ptxas's register and
spill lines) is kept beside the library. A failed build raises
``RuntimeError`` naming the compiler and the source, and installs nothing.

A library is loaded once a process and bound from its caller's
declaration, ``{C name: (restype, argtypes)}``: a declared function the
library lacks raises when it is loaded. Once loaded, a library costs its
caller one dict lookup and no lock. Nothing is compiled at import: the
first load builds, and ``build_all`` builds every kernel at once, one nvcc
each, in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
KERNEL_DIR = BUILD / "kernels"
PLAN_DIR = BUILD / "plans"
RUNTIME_DIR = BUILD / "native"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no contraction of a * b + c, so the host build of a plan rounds as the
# card does
PLAN_HOST_FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                   "-fPIC"]
RUNTIME_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# a plan's backend: its compiler, flags and source suffix
_PLAN = {"cuda": ("nvcc", NVCC_FLAGS, ".cu"),
         "host": ("g++", PLAN_HOST_FLAGS, ".cpp")}

VP, LL, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
Functions = Mapping[str, Tuple[Any, Sequence[Any]]]
# every kernel library gives its status codes' text through this one
_ERROR = {"gt_error_string": (ctypes.c_char_p, [INT])}

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)
# loaded libraries: a kernel's under its name (a launch looks it up without
# hashing its source), a plan's under its library path, the host runtime's
# under its source path
_LOADED: Dict[Any, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class _Build(NamedTuple):
    compiler: str                  # "nvcc" or "g++"
    flags: Sequence[str]
    source: Path
    out: Path
    text: Optional[str] = None     # written to ``source`` first, if given


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def headers(name: str) -> List[Path]:
    """The headers of ``csrc/`` that ``csrc/<name>.cu`` includes in quotes,
    directly or through another of them, sorted."""
    found, todo = set(), [CSRC / f"{name}.cu"]
    while todo:
        for include in _INCLUDE.findall(todo.pop().read_bytes()):
            path = CSRC / include.decode()
            if path.is_file() and path not in found:
                found.add(path)
                todo.append(path)
    return sorted(found)


def _named(directory: Path, stem: str, compiler: str,
           flags: Sequence[str], *inputs: bytes) -> Path:
    h = hashlib.sha256()
    for data in inputs:
        h.update(data)
    h.update(" ".join([compiler, *flags]).encode())
    return directory / f"{stem}-{h.hexdigest()[:16]}.so"


def _unique(path: Path, suffix: str) -> Path:
    """``path`` renamed for this process and thread alone."""
    return path.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                            f"{suffix}")


def _kernel(name: str) -> _Build:
    src = CSRC / f"{name}.cu"
    parts = [src.read_bytes()] + [h.read_bytes() for h in headers(name)]
    return _Build("nvcc", NVCC_FLAGS, src,
                  _named(KERNEL_DIR, f"lib{name}", "nvcc", NVCC_FLAGS,
                         *parts))


def _plan(source: str, backend: str) -> _Build:
    if backend not in _PLAN:
        raise ValueError(f"unknown backend {backend!r}")
    compiler, flags, suffix = _PLAN[backend]
    out = _named(PLAN_DIR, f"libplan-{backend}", compiler, flags,
                 source.encode())
    return _Build(compiler, flags, out.with_suffix(suffix), out, source)


def _runtime(source: Path) -> _Build:
    return _Build("g++", RUNTIME_FLAGS, source,
                  _named(RUNTIME_DIR, f"lib{source.stem}", "g++",
                         RUNTIME_FLAGS, source.read_bytes()))


def _start(b: _Build) -> Optional[Tuple[subprocess.Popen, Path]]:
    """Start the compiler on ``b`` into a temporary file, unless its
    library is on disk."""
    if b.out.exists():
        return None
    b.out.parent.mkdir(parents=True, exist_ok=True)
    if b.text is not None:
        tmp_src = _unique(b.source, b.source.suffix)
        tmp_src.write_text(b.text)
        os.replace(tmp_src, b.source)
    tmp = _unique(b.out, ".tmp")
    compiler = nvcc() if b.compiler == "nvcc" else b.compiler
    cmd = [compiler, *b.flags, "-o", str(tmp), str(b.source)]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{b.compiler} cannot run for {b.source}: "
                           f"{e}") from e
    return proc, tmp


def _finish(b: _Build, started) -> str:
    """Wait for the build ``_start`` began and install its library;
    returns the compiler's log."""
    if started is None:
        return f"{b.source.name}: cached {b.out.name}"
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{b.compiler} failed for {b.source}:\n{log}")
    b.out.with_suffix(".log").write_text(log)
    os.replace(tmp, b.out)
    return log


def _bind(path: Path, functions: Functions,
          expect: Optional[Mapping[str, int]]) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    for name, (restype, argtypes) in functions.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise RuntimeError(f"{path.name} has no function {name}") \
                from None
        fn.restype, fn.argtypes = restype, list(argtypes)
    for name, want in (expect or {}).items():
        got = getattr(lib, name)()
        if got != want:
            raise RuntimeError(f"{path.name} disagrees with its wrapper: "
                               f"{name}() is {got}, not {want}")
    return lib


def _load(key, build: Callable[[], _Build], functions: Functions,
          expect: Optional[Mapping[str, int]] = None) -> ctypes.CDLL:
    """The library memoised under ``key``: at first use ``build()`` names
    it, it is built unless on disk, loaded and bound, under the lock."""
    lib = _LOADED.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            b = build()
            _finish(b, _start(b))
            lib = _LOADED[key] = _bind(b.out, functions, expect)
    return lib


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives."""
    return _kernel(name).out


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every kernel source (or ``names``), one nvcc each, started
    together; returns each build's compiler log (the ``-Xptxas -v``
    register and spill lines) by source name."""
    builds = {n: _kernel(n) for n in (sources() if names is None
                                      else names)}
    started = {n: _start(b) for n, b in builds.items()}
    return {n: _finish(b, started[n]) for n, b in builds.items()}


def load(name: str, functions: Functions,
         expect: Optional[Mapping[str, int]] = None) -> ctypes.CDLL:
    """The kernel library of ``csrc/<name>.cu``, built at first use, with
    ``functions`` and ``gt_error_string`` bound. ``expect`` maps functions
    of no argument to the values the wrapper assumes; another value raises
    at load."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _load(name, lambda: _kernel(name), {**_ERROR, **functions},
                    expect)
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise ``RuntimeError`` for a non-zero status ``code`` that ``what``
    of the kernel library ``lib`` returned, with the library's text."""
    if code != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.gt_error_string(code).decode()} ({code})")


def plan_path(source: str, backend: str = "cuda") -> Path:
    """Where the library of the generated ``source`` for ``backend``
    ("cuda" or "host") lives."""
    return _plan(source, backend).out


def build_plans(sources: Sequence[str], backend: str = "cuda") -> List[Path]:
    """Build every generated source not yet on disk, one compiler each,
    started together; returns the libraries' paths."""
    started = [(b, _start(b)) for b in (_plan(s, backend) for s in sources)]
    for b, proc in started:
        _finish(b, proc)
    return [b.out for b, _ in started]


def load_plan(source: str, backend: str,
              functions: Functions) -> ctypes.CDLL:
    """The library of the generated ``source`` for ``backend``, built at
    first use, with ``functions`` bound."""
    b = _plan(source, backend)
    return _load(b.out, lambda: b, functions)


def load_runtime(source: Path, functions: Functions) -> ctypes.CDLL:
    """The library of the C++ file ``source``, built at first use, with
    ``functions`` bound."""
    return _load(source, lambda: _runtime(source), functions)
