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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict = {}
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


def _compile(name: str, src: Path, compiler: str, flags) -> ctypes.CDLL:
    """Load ``lib<name>-<hash>.so`` built from ``src``, building it first
    when no build of the current source, flags and compiler exists."""
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(flags).encode())
    h.update(version.encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed for {src}:\n"
                f"{build_logs[name]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The CUDA library built from ``ops/csrc/<name>.cu``."""
    if name in _loaded:
        return _loaded[name]
    return _compile(name, CSRC / f"{name}.cu", _nvcc(), NVCC_FLAGS)


def host_library(name: str, src: Path) -> ctypes.CDLL:
    """The host library built from the C++ source ``src`` with g++."""
    if name in _loaded:
        return _loaded[name]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build {src}")
    return _compile(name, src, gxx, GXX_FLAGS)
