"""Exact k-NN panel of the graph build: the wrapper of the CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_knn.py`` together with the
per-tile top-k and merge its caller does (``ops/graph.py``). For query rows
``q_start .. q_start + q_count`` of the corpus it returns the exact ``k``
nearest corpus rows under squared L2, the row itself and rows at or beyond
``n_real`` excluded. On a CUDA tensor :func:`knn_panel` launches
``csrc/knn_panel.cu`` or raises; on a CPU tensor it runs the plain version,
:func:`knn_panel_plain`. :func:`panel_inputs` makes the operands, with the
features zero-padded to the kernel's multiple of 16.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .distance import FEATURE_ALIGN, INF, pad_features, stable_topk_smallest

MAX_K = 64
# query rows per [rows, N] distance block of the plain version
PLAIN_ROWS = 1024


def panel_inputs(emb: torch.Tensor):
    """f32/f16 embeddings [N, D] -> (bf16 rows zero-padded to a multiple of
    16 features, f32 squared norms of the un-rounded rows): the operands of
    :func:`knn_panel`."""
    e32 = emb.float()
    return pad_features(e32.to(torch.bfloat16)).contiguous(), e32.square().sum(dim=1).contiguous()


def knn_panel_plain(ebf: torch.Tensor, norms: torch.Tensor, k: int, q_start: int, q_count: int,
                    n_real: int):
    """The kernel's function in plain torch, ``PLAIN_ROWS`` query rows at a
    time."""
    c = ebf[:n_real].float()
    out_i, out_d = [], []
    for s in range(q_start, q_start + q_count, PLAIN_ROWS):
        cnt = min(PLAIN_ROWS, q_start + q_count - s)
        d = norms[s : s + cnt, None] + norms[None, :n_real] - 2.0 * (ebf[s : s + cnt].float() @ c.T)
        rows = torch.arange(cnt, device=d.device)
        self_col = rows + s
        in_range = self_col < n_real
        d[rows[in_range], self_col[in_range]] = INF
        if d.shape[1] < k:
            d = torch.cat([d, torch.full((cnt, k - d.shape[1]), INF, device=d.device)], dim=1)
        vals, idx = stable_topk_smallest(d, k)
        out_i.append(torch.where(vals < INF, idx, torch.full_like(idx, -1)).to(torch.int32))
        out_d.append(vals)
    return torch.cat(out_i), torch.cat(out_d)


def _lib():
    from . import cuda_build

    lib = cuda_build.load("knn_panel")
    fn = lib.knn_panel_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def knn_panel(ebf: torch.Tensor, norms: torch.Tensor, k: int, q_start: int = 0,
              q_count: Optional[int] = None, n_real: Optional[int] = None):
    """ebf bf16[N, D], norms f32[N] (from :func:`panel_inputs`) -> (ids
    i32[q_count, k], squared-L2 dists f32[q_count, k]) for query rows
    ``q_start .. q_start + q_count``; ties go to the lower id, and -1 /
    3.4e38 fill rows with fewer than k candidates."""
    n, d = ebf.shape
    q_count = n - q_start if q_count is None else int(q_count)
    n_real = n if n_real is None else min(int(n_real), n)
    if not (0 <= q_start and q_count >= 1 and q_start + q_count <= n):
        raise ValueError(f"knn_panel: query rows [{q_start}, {q_start + q_count}) outside [0, {n})")
    if ebf.device.type == "cpu" and norms.device.type == "cpu":
        return knn_panel_plain(ebf, norms, k, q_start, q_count, n_real)
    if ebf.device.type != "cuda" or norms.device != ebf.device:
        raise ValueError("knn_panel: ebf and norms must lie on one CUDA device")
    if ebf.dtype != torch.bfloat16 or norms.dtype != torch.float32:
        raise TypeError("knn_panel: ebf must be bfloat16 and norms float32")
    if norms.shape != (n,) or not (ebf.is_contiguous() and norms.is_contiguous()):
        raise ValueError("knn_panel: norms must be [N] and both inputs contiguous")
    if d % FEATURE_ALIGN or ebf.data_ptr() % 16:
        raise ValueError(f"knn_panel: D={d} must be a multiple of {FEATURE_ALIGN} "
                         "(panel_inputs) and ebf 16-byte aligned")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_panel: k={k} outside [1, {MAX_K}]")
    ov = torch.empty((q_count, k), dtype=torch.float32, device=ebf.device)
    oi = torch.empty((q_count, k), dtype=torch.int32, device=ebf.device)
    stream = torch.cuda.current_stream(ebf.device).cuda_stream
    rc = _lib()(ebf.data_ptr(), norms.data_ptr(), ov.data_ptr(), oi.data_ptr(), n, d, q_start, q_count,
                n_real, k, stream)
    if rc != 0:
        raise RuntimeError(f"knn_panel kernel launch failed: cudaError {rc}")
    knn_panel.launches += 1
    return oi, ov


knn_panel.launches = 0
