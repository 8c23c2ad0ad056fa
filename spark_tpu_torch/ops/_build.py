"""Build and load the port's CUDA kernels.

``ops/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and bound with ``ctypes``. The build
runs at first use, into ``spark_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source, the
nvcc flags and the nvcc version, so a change to any of them rebuilds
the library and an unchanged one is loaded as built.
Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
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

_loaded: dict = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
#: each library built by this process, by library name
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


def library(name: str) -> ctypes.CDLL:
    """Load ``lib<name>.so`` built from ``csrc/<name>.cu``, building it
    first when no build of the current source exists."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{build_logs[name]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
