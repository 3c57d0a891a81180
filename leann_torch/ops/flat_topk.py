"""Flat exact search: the wrapper of the fused distance + top-k CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_topk.py``. On a CUDA tensor
:func:`flat_topk` launches ``csrc/flat_topk.cu`` (per-slice partial top-k,
then a merge launch) or raises; on a CPU tensor it runs the plain version,
``ops/distance.flat_search``. Nothing on the card's path uses the plain
version. The kernel takes features padded to a multiple of 16
(``distance.pad_features``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .distance import FEATURE_ALIGN, flat_search

MAX_K = 64


def _lib():
    from . import cuda_build

    lib = cuda_build.load("flat_topk")
    fn = lib.flat_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flat_topk(q: torch.Tensor, e: torch.Tensor, en: Optional[torch.Tensor], valid_n: int, k: int,
              metric: str):
    """q f32[B, D], e bf16[N, D], en f32[N] (squared row norms; l2 only) ->
    (ids i32[B, k], dists f32[B, k]), lower distance = closer; -1 where
    fewer than k rows are valid. On the card D is a multiple of 16."""
    if q.device.type == "cpu" and e.device.type == "cpu":
        return flat_search(e, q, valid_n, k, metric, en=en)
    if metric not in ("l2", "mips", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    l2 = metric == "l2"
    if q.device.type != "cuda" or e.device != q.device or (l2 and (en is None or en.device != q.device)):
        raise ValueError("flat_topk: q, e (and en for l2) must lie on one CUDA device")
    if q.dtype != torch.float32 or e.dtype != torch.bfloat16 or (l2 and en.dtype != torch.float32):
        raise TypeError("flat_topk: q must be float32, e bfloat16, en float32")
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1] or (l2 and en.shape != (e.shape[0],)):
        raise ValueError(f"flat_topk: bad shapes q{tuple(q.shape)} e{tuple(e.shape)}")
    if not (q.is_contiguous() and e.is_contiguous() and (not l2 or en.is_contiguous())):
        raise ValueError("flat_topk: inputs must be contiguous")
    if q.shape[1] % FEATURE_ALIGN or e.data_ptr() % 16:
        raise ValueError(f"flat_topk: D={q.shape[1]} must be a multiple of {FEATURE_ALIGN} "
                         "(distance.pad_features) and e 16-byte aligned")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"flat_topk: k={k} outside [1, {MAX_K}]")
    b, d = q.shape
    n = e.shape[0]
    valid_n = max(0, min(int(valid_n), n))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits = max(1, min(sms, -(-valid_n // 64)))
    pv = torch.empty((b, n_splits, k), dtype=torch.float32, device=q.device)
    pi = torch.empty((b, n_splits, k), dtype=torch.int32, device=q.device)
    ov = torch.empty((b, k), dtype=torch.float32, device=q.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), e.data_ptr(), en.data_ptr() if l2 else None, pv.data_ptr(), pi.data_ptr(),
                ov.data_ptr(), oi.data_ptr(), b, n, d, valid_n, k, int(l2), n_splits, stream)
    if rc != 0:
        raise RuntimeError(f"flat_topk kernel launch failed: cudaError {rc}")
    flat_topk.launches += 1
    return oi, ov


flat_topk.launches = 0
