"""Build and load the port's native libraries.

``ops/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``native/*.cpp`` (host code) with ``g++``, each into a shared library
with a plain C interface, bound with ``ctypes``. The build runs at first
use, into ``spark_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name that carries a hash of the source, the compiler flags and the
compiler's version, so a change to any of them rebuilds the library and
an unchanged one is loaded as built. A failed build raises with the
compiler's output. Nothing here runs at import time: the CPU tests
import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from spark_tpu_torch import locks

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict = {}
#: one build at a time: the ranks of a mesh reach their first kernel
#: launch from threads of their own
_BUILD_LOCK = locks.named_rlock("ops.build")
#: the compiler's output of each library built by this process, by
#: library name (for nvcc, ``-Xptxas -v``: registers, shared memory,
#: spills)
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _target(name: str, src: Path, compiler: str, flags) -> Path:
    """``lib<name>-<hash>.so``: the hash covers the source, the flags and
    the compiler's version."""
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(flags).encode())
    h.update(version.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, src: Path, compiler: str, flags):
    """Start building ``src`` unless a build of it exists. Returns (target
    path, the compiler's process or None)."""
    out = _target(name, src, compiler, flags)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, src: Path, compiler: str, out: Path,
            proc) -> ctypes.CDLL:
    """Wait for ``proc`` (if any), raise with its output on failure, and
    load the library."""
    if proc is not None:
        build_logs[name] = proc.communicate()[0]
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed for {src}:\n"
                f"{build_logs[name]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib


def _compile(name: str, src: Path, compiler: str, flags) -> ctypes.CDLL:
    """Load ``lib<name>-<hash>.so`` built from ``src``, building it first
    when no build of the current source, flags and compiler exists."""
    out, proc = _start(name, src, compiler, flags)
    return _finish(name, src, compiler, out, proc)


def library(name: str) -> ctypes.CDLL:
    """The CUDA library built from ``ops/csrc/<name>.cu``."""
    return libraries((name,))[0]


def libraries(names) -> list:
    """The CUDA libraries of ``names`` (``ops/csrc/<name>.cu``), their
    builds started together, one ``nvcc`` each."""
    if any(name not in _loaded for name in names):
        with _BUILD_LOCK:
            missing = [name for name in names if name not in _loaded]
            nvcc = _nvcc() if missing else None
            started = {name: _start(name, CSRC / f"{name}.cu", nvcc,
                                    NVCC_FLAGS) for name in missing}
            for name, (out, proc) in started.items():
                _finish(name, CSRC / f"{name}.cu", nvcc, out, proc)
    return [_loaded[name] for name in names]


def host_library(name: str, src: Path) -> ctypes.CDLL:
    """The host library built from the C++ source ``src`` with g++."""
    if name in _loaded:
        return _loaded[name]
    with _BUILD_LOCK:
        if name in _loaded:
            return _loaded[name]
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: cannot build {src}")
        return _compile(name, src, gxx, GXX_FLAGS)
