"""Build and load the port's native libraries (``leann_torch/csrc/``).

A CUDA kernel (``<name>.cu``) is compiled by ``nvcc`` for ``sm_90a``; a host
library (``<name>.cpp``, the LDG partitioner) by the host C++ compiler with
``csrc/Makefile``'s flags. Each becomes its own shared library with a plain
C interface, loaded with ``ctypes``. Libraries go to ``build/leann_torch/``
beside the package, named by a hash of their sources, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built when this module is
imported: the first call builds its library, and :func:`build` compiles
several at once (one compiler process per source, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "leann_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-std=c++17", "-Wall", "-fPIC", "-shared"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # name -> compiler output (ptxas register / smem report)


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build leann_torch's kernels")
    return exe


def _cxx() -> str:
    exe = shutil.which("c++") or shutil.which("g++")
    if exe is None:
        raise RuntimeError("no host C++ compiler (c++ / g++): it is needed to build leann_torch's host libraries")
    return exe


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _lib_path(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha1()
    for dep in (sorted(CSRC.glob("*.cuh")) if src.suffix == ".cu" else []) + [src]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> float:
    """Compile the named kernels that are not built yet, all in parallel.
    -> wall seconds. Raises with the compiler's output on failure."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = _source(name)
        compiler = [_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu" else [_cxx(), *HOST_FLAGS]
        cmd = [*compiler, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
