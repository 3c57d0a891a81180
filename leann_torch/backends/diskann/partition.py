"""LDG-style balanced graph partitioning, on the host.

Counterpart of the JAX package's ``backends/diskann/partition.py``. Linear
Deterministic Greedy (LDG): stream nodes, place each in the partition
maximizing |neighbors already there| * (1 - size/capacity); refine over
several passes (the reference's default is 10). The partition id is the
device-shard assignment of a multi-card search, and the diskann build
relabels rows so each partition is contiguous.

The sweep runs in ``csrc/ldg_partition.cpp``, a copy of the JAX package's
native core, built with the host compiler at first use
(``ops/cuda_build.py``). There is no Python fallback: the JAX package's
pure-Python sweep assigns nodes differently from its native core, so a
silent switch would partition differently from an index the JAX package
built. A failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ...ops import cuda_build


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ldg_partition")
    lib.ldg_partition.restype = ctypes.c_int
    lib.ldg_partition.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_void_p,
    ]
    return lib


def ldg_partition(neighbors: np.ndarray, n_parts: int, passes: int = 10, seed: int = 0) -> np.ndarray:
    """neighbors i32[N, R] (-1 padded) -> part id i32[N], every part holding
    at least floor(N / n_parts) nodes."""
    n = neighbors.shape[0]
    if n_parts <= 1:
        return np.zeros(n, np.int32)
    if neighbors.ndim != 2 or n == 0 or neighbors.shape[1] == 0:
        raise ValueError(f"ldg_partition needs a non-empty [N, R] neighbor table, got {neighbors.shape}")
    nb = np.ascontiguousarray(neighbors, dtype=np.int32)
    if int(nb.max()) >= n:
        raise ValueError("neighbor ids must be < N")
    out = np.empty(n, np.int32)
    rc = _lib().ldg_partition(nb.ctypes.data, n, nb.shape[1], n_parts, passes, seed, out.ctypes.data)
    if rc < 0:
        raise RuntimeError(f"ldg_partition returned {rc}")
    return out


def edge_locality(neighbors: np.ndarray, assign: np.ndarray) -> float:
    """Fraction of graph edges whose endpoints share a partition."""
    valid = neighbors >= 0
    src = np.repeat(np.arange(neighbors.shape[0]), neighbors.shape[1])[valid.ravel()]
    dst = neighbors.ravel()[valid.ravel()]
    if dst.size == 0:
        return 1.0
    return float(np.mean(assign[src] == assign[dst]))
