"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source, the headers of ``csrc/`` it includes and the
flags, so an edited source or header rebuilds the libraries that include it,
and the others are reused.
Nothing is compiled at import: the first launch of a kernel builds it, and
``build_all`` builds every source at once, one ``nvcc`` each, in parallel.
A source may also be built with preprocessor ``defines`` (nvcc's ``-D``)
into a library of its own, for a measurement of another constant.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


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


def _flags(defines: Sequence[str]) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


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


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in headers(name):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, defines: Sequence[str] = ()
           ) -> Optional[Tuple[subprocess.Popen, Path]]:
    """Start nvcc for ``name`` into a temporary file, unless it is built."""
    out = library_path(name, defines)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, started, defines: Sequence[str] = ()) -> str:
    out = library_path(name, defines)
    if started is None:
        return f"{name}: cached {out.name}"
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"{' '.join(defines)}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Optional[List[str]] = None,
              variants: Sequence[Tuple[str, Tuple[str, ...]]] = ()
              ) -> Dict[str, str]:
    """Compile every source, and each (source, defines) of ``variants``, one
    nvcc each, started together; returns each build's compiler log (the
    ``-Xptxas -v`` register/spill lines), by source name, a variant's with
    its -D flags after it."""
    names = sources() if names is None else names
    builds = [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]
    procs = [(n, d, _start(n, d)) for n, d in builds]
    return {" ".join([n, *(f"-D{x}" for x in d)]): _finish(n, p, d)
            for n, d, p in procs}


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu`` (built with ``defines``),
    built at first use."""
    key = (name, tuple(defines))
    lib = _LOADED.get(key)
    if lib is None:
        _finish(name, _start(name, defines), defines)
        lib = ctypes.CDLL(str(library_path(name, defines)))
        _LOADED[key] = lib
    return lib
