"""The native-code seam, ops/kernels/build.py, on the CPU: a failed build,
two threads loading one new library, and a declared function the library
lacks, for each kind of source it builds. g++ builds the host plan and the
host runtime; a kernel goes through a stand-in for nvcc that compiles the
.cu file as C++ with g++."""
import ctypes
import os
import stat
import threading

import pytest

from gandiva_tpu_torch.ops.kernels import build

KINDS = ("kernel", "plan", "runtime")
SOURCE = """
extern "C" {
const char* gt_error_string(int code) { return code ? "bad" : "ok"; }
int gt_next(int x) { return x + 1; }
}
"""
NEXT = {"gt_next": (ctypes.c_int, [ctypes.c_int])}
# stands in for nvcc: waits a little, so that builds started together
# overlap, then compiles the source (the last argument) with g++
FAKE_NVCC = """#!/bin/sh
while [ $# -gt 1 ]; do
  [ "$1" = "-o" ] && out=$2
  shift
done
sleep 0.3
exec g++ -x c++ -shared -fPIC -o "$out" "$1"
"""


@pytest.fixture
def seam(tmp_path, monkeypatch):
    """Every build directory, the kernel sources and the loaded libraries
    of ``build`` moved into ``tmp_path``; returns the directory the
    libraries go to."""
    out = tmp_path / "out"
    for name in ("KERNEL_DIR", "PLAN_DIR", "RUNTIME_DIR"):
        monkeypatch.setattr(build, name, out)
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    (tmp_path / "csrc").mkdir()
    monkeypatch.setattr(build, "_LOADED", {})
    fake = tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC)
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    return out


def _loader(kind, root, text, functions):
    """A function that loads ``text`` as a source of ``kind``, the compiler
    that builds it, and the source file the compiler reads."""
    if kind == "kernel":
        src = root / "csrc" / "probe.cu"
        src.write_text(text)
        return lambda: build.load("probe", functions), "nvcc", src
    if kind == "plan":
        src = build.plan_path(text, "host").with_suffix(".cpp")
        return (lambda: build.load_plan(text, "host", functions), "g++",
                src)
    src = root / "probe_runtime.cpp"
    src.write_text(text)
    return lambda: build.load_runtime(src, functions), "g++", src


def _left(out):
    return sorted(p.name for p in out.glob("*")
                  if p.suffix in (".so", ".tmp"))


@pytest.mark.parametrize("kind", KINDS)
def test_failed_build_raises_and_installs_nothing(kind, seam, tmp_path):
    """A source that does not compile raises RuntimeError naming the
    compiler and the source, and leaves no library and no temporary file;
    a second load tries again and raises again."""
    load, compiler, src = _loader(kind, tmp_path, "this is not C++", NEXT)
    for _ in range(2):
        with pytest.raises(RuntimeError) as err:
            load()
        assert f"{compiler} failed for {src}" in str(err.value)
        assert _left(seam) == []
    assert build._LOADED == {}


@pytest.mark.parametrize("kind", KINDS)
def test_two_threads_load_one_new_library(kind, seam, tmp_path):
    """Two threads that load one new source at once get one library, the
    same handle, and a function that runs; nothing temporary is left."""
    load, _, _ = _loader(kind, tmp_path, SOURCE, NEXT)
    start = threading.Barrier(2)
    got, errors = [], []

    def worker():
        start.wait()
        try:
            got.append(load())
        except Exception as e:          # reported below, with the other's
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].gt_next(41) == 42
    libraries = _left(seam)
    assert len(libraries) == 1 and libraries[0].endswith(".so")
    assert load() is got[0]


@pytest.mark.parametrize("kind", KINDS)
def test_declared_function_missing_raises_at_load(kind, seam, tmp_path):
    """A declared function the library lacks raises when the library is
    loaded, and the library is not kept as loaded."""
    functions = {**NEXT, "gt_missing": (ctypes.c_int, [])}
    load, _, _ = _loader(kind, tmp_path, SOURCE, functions)
    with pytest.raises(RuntimeError, match="gt_missing"):
        load()
    assert build._LOADED == {}
    assert os.listdir(seam)         # the library itself was built
