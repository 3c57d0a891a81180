"""Exact k-NN panel of the graph build: the wrapper of the CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_knn.py`` together with the
per-tile top-k and merge its caller does (``ops/graph.py``). For query rows
``q_start .. q_start + q_count`` of the corpus it returns the exact ``k``
nearest corpus rows under squared L2, the row itself and rows at or beyond
``n_real`` excluded. On a CUDA tensor :func:`knn_panel` launches
``csrc/knn_panel.cu`` (the TMA + wgmma tile kernel; the grid comes from
``ops/tile_plan.plan_launch``) or raises; on a CPU tensor it runs the plain version,
:func:`knn_panel_plain`. :func:`panel_inputs` and :func:`upload_panel_inputs`
make the operands, with the features zero-padded to the kernel's multiple of
16.

The column-sharded k-NN (``ops/graph.py exact_knn_sharded``) takes the same
kernel through :func:`knn_panel_ext` (query rows from outside the corpus
operand, a column slab with its global id offset, global ids out) and folds
each shard's lists into its running state with :func:`topk_merge`, the merge
kernel of the same library (plain versions :func:`knn_panel_ext_plain` and
:func:`topk_merge_plain`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .distance import FEATURE_ALIGN, INF, pad_features, stable_topk_smallest
from .tile_plan import check_k, list_entries, merge_entries, multiprocessors, plan_launch, scratch

# query rows per [rows, N] distance block of the plain version
PLAIN_ROWS = 1024
# host rows per upload of upload_panel_inputs (f32: 100 MB at D = 384)
UPLOAD_ROWS = 1 << 16
# fewest rows a norm reduction takes (zero rows pad a smaller block): from
# 16 rows on, torch reduces each row of a [rows, D] tensor the same way on
# the card, whatever the count, so a row's norm does not depend on the
# block it was uploaded in
NORM_MIN_ROWS = 32


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """f32 squared norms of the rows of ``x`` [rows, D]: the one function
    every path that feeds the k-NN kernel uses, so a pair's distance is
    bit-identical whichever path computed it."""
    x32 = x.float()
    n = x32.shape[0]
    if n < NORM_MIN_ROWS:
        x32 = torch.nn.functional.pad(x32, (0, 0, 0, NORM_MIN_ROWS - n))
    return x32.square().sum(dim=1)[:n]


def panel_inputs(emb: torch.Tensor):
    """f32/f16 embeddings [N, D] -> (bf16 rows zero-padded to a multiple of
    16 features, f32 squared norms of the un-rounded rows): the operands of
    :func:`knn_panel`."""
    e32 = emb.float()
    return pad_features(e32.to(torch.bfloat16)).contiguous(), sq_norms(e32).contiguous()


def upload_panel_inputs(emb, dev: torch.device, lo: int = 0, hi: Optional[int] = None, d_pad: int = 0):
    """:func:`panel_inputs` of host rows ``emb[lo:hi]`` (f32 or f16 numpy,
    a memmap allowed), built on ``dev`` ``UPLOAD_ROWS`` rows at a time:
    each block goes up in its own type, is cast to bf16 on the device (numpy
    has no bf16) and its norms taken there, so the device never holds the
    f32 matrix. The features are zero-padded to a multiple of 16, or to
    ``d_pad`` (>= D) when given."""
    hi = emb.shape[0] if hi is None else hi
    d = emb.shape[1]
    width = d_pad or d + (-d % FEATURE_ALIGN)
    ebf = torch.zeros((hi - lo, width), dtype=torch.bfloat16, device=dev)
    norms = torch.empty((hi - lo,), dtype=torch.float32, device=dev)
    for s in range(lo, hi, UPLOAD_ROWS):
        e = min(s + UPLOAD_ROWS, hi)
        blk = torch.from_numpy(np.ascontiguousarray(emb[s:e])).to(dev)
        ebf[s - lo : e - lo, :d] = blk.float().to(torch.bfloat16)
        norms[s - lo : e - lo] = sq_norms(blk)
    return ebf, norms


def knn_panel_ext_plain(q: torch.Tensor, qn: torch.Tensor, c: torch.Tensor, cn: torch.Tensor, k: int,
                        n_real_cols: int, col_id0: int = 0, q_id0: int = -1):
    """:func:`knn_panel_ext`'s function in plain torch, ``PLAIN_ROWS`` query
    rows at a time."""
    cc = c[:n_real_cols].float()
    out_i, out_d = [], []
    for s in range(0, q.shape[0], PLAIN_ROWS):
        cnt = min(PLAIN_ROWS, q.shape[0] - s)
        d = qn[s : s + cnt, None] + cn[None, :n_real_cols] - 2.0 * (q[s : s + cnt].float() @ cc.T)
        if q_id0 >= 0:
            rows = torch.arange(cnt, device=d.device)
            self_col = rows + (q_id0 + s - col_id0)
            mine = (self_col >= 0) & (self_col < n_real_cols)
            d[rows[mine], self_col[mine]] = INF
        if d.shape[1] < k:
            d = torch.cat([d, torch.full((cnt, k - d.shape[1]), INF, device=d.device)], dim=1)
        vals, idx = stable_topk_smallest(d, k)
        out_i.append(torch.where(vals < INF, idx + col_id0, torch.full_like(idx, -1)).to(torch.int32))
        out_d.append(vals)
    return torch.cat(out_i), torch.cat(out_d)


def knn_panel_plain(ebf: torch.Tensor, norms: torch.Tensor, k: int, q_start: int, q_count: int,
                    n_real: int):
    """The kernel's function in plain torch, ``PLAIN_ROWS`` query rows at a
    time."""
    sl = slice(q_start, q_start + q_count)
    return knn_panel_ext_plain(ebf[sl], norms[sl], ebf, norms, k, n_real, 0, q_start)


def topk_merge_plain(vals: torch.Tensor, ids: torch.Tensor):
    """:func:`topk_merge`'s function in plain torch: the k smallest of each
    row's L lists by (distance, id), ids -1 empty."""
    s, l, k = vals.shape
    v, i = vals.reshape(s, l * k), ids.reshape(s, l * k).long()
    v = torch.where(i >= 0, v, torch.full_like(v, INF))
    by_id = torch.sort(torch.where(i >= 0, i, torch.full_like(i, 1 << 62)), dim=1, stable=True).indices
    v, i = v.gather(1, by_id), i.gather(1, by_id)
    v, order = torch.sort(v, dim=1, stable=True)  # ties keep the id order
    v, i = v[:, :k].contiguous(), i.gather(1, order[:, :k])
    return torch.where(v < INF, i, torch.full_like(i, -1)).to(torch.int32), v


_launch = None


def _lib():
    """The library's two launchers, bound once: (panel, merge)."""
    global _launch
    if _launch is None:
        from . import cuda_build

        lib = cuda_build.load("knn_panel")
        panel = lib.knn_panel_launch
        panel.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        panel.restype = ctypes.c_int
        merge = lib.topk_merge_launch
        merge.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        merge.restype = ctypes.c_int
        _launch = (panel, merge)
    return _launch


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _outputs(rows: int, k: int, splits: int, dev):
    """Partial lists (splits > 1, else None) and the [rows, k] outputs."""
    pv = pi = None
    if splits > 1:
        pv = torch.empty((rows, splits, k), dtype=torch.float32, device=dev)
        pi = torch.empty((rows, splits, k), dtype=torch.int32, device=dev)
    return (pv, pi, torch.empty((rows, k), dtype=torch.float32, device=dev),
            torch.empty((rows, k), dtype=torch.int32, device=dev))


def _check_bf16_rows(x: torch.Tensor, xn: torch.Tensor, who: str, what: str) -> None:
    """Raise where the kernel does not take rows ``x`` bf16[rows, D] with
    norms ``xn`` f32[rows]."""
    if x.dtype != torch.bfloat16 or xn.dtype != torch.float32:
        raise TypeError(f"{who}: {what} must be bfloat16 and its norms float32")
    if x.dim() != 2 or xn.shape != (x.shape[0],) or not (x.is_contiguous() and xn.is_contiguous()):
        raise ValueError(f"{who}: {what} must be [rows, D] with [rows] norms, both contiguous")
    if x.shape[1] % FEATURE_ALIGN or x.data_ptr() % 16:
        raise ValueError(f"{who}: D={x.shape[1]} must be a multiple of {FEATURE_ALIGN} and {what} 16-byte aligned")


def _panel_launch(q, qn, c, cn, k: int, n_real_cols: int, col_id0: int, q_id0: int, who: str):
    """Checks the card operands of the k-NN kernel and launches it -> (ids
    i32[S, k], dists f32[S, k]); the callers count their own launches."""
    if q.device.type != "cuda" or any(t.device != q.device for t in (qn, c, cn)):
        raise ValueError(f"{who}: the query rows, the columns and their norms must lie on one CUDA device")
    _check_bf16_rows(q, qn, who, "the query rows")
    _check_bf16_rows(c, cn, who, "the columns")
    check_k(k, who)
    s_rows, m = q.shape[0], c.shape[0]
    if col_id0 < 0 or col_id0 + m >= 1 << 31:
        raise ValueError(f"{who}: column ids [{col_id0}, {col_id0 + m}) outside int32")
    dev = q.device
    plan = plan_launch(s_rows, n_real_cols, k, q.shape[1], multiprocessors(dev))
    pv, pi, ov, oi = _outputs(s_rows, k, plan.col_splits, dev)
    lv, li = scratch(list_entries(plan, s_rows, k), dev)
    mv, mi = scratch(merge_entries(s_rows, k) if plan.col_splits > 1 else 0, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()[0](q.data_ptr(), qn.data_ptr(), c.data_ptr(), cn.data_ptr(), _ptr(pv), _ptr(pi), ov.data_ptr(),
                   oi.data_ptr(), _ptr(lv), _ptr(li), _ptr(mv), _ptr(mi), s_rows, m, q.shape[1], n_real_cols,
                   int(col_id0), int(q_id0), k, plan.row_blocks, plan.col_splits, stream)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {rc}")
    return oi, ov


def knn_panel(ebf: torch.Tensor, norms: torch.Tensor, k: int, q_start: int = 0,
              q_count: Optional[int] = None, n_real: Optional[int] = None):
    """ebf bf16[N, D], norms f32[N] (from :func:`panel_inputs`) -> (ids
    i32[q_count, k], squared-L2 dists f32[q_count, k]) for query rows
    ``q_start .. q_start + q_count``; ties go to the lower id, and -1 /
    3.4e38 fill rows with fewer than k candidates. :func:`knn_panel_ext`
    with the rows sliced from the corpus, counted apart."""
    n = ebf.shape[0]
    q_count = n - q_start if q_count is None else int(q_count)
    n_real = n if n_real is None else max(0, min(int(n_real), n))
    if not (0 <= q_start and q_count >= 1 and q_start + q_count <= n):
        raise ValueError(f"knn_panel: query rows [{q_start}, {q_start + q_count}) outside [0, {n})")
    if ebf.device.type == "cpu" and norms.device.type == "cpu":
        return knn_panel_plain(ebf, norms, k, q_start, q_count, n_real)
    sl = slice(q_start, q_start + q_count)
    out = _panel_launch(ebf[sl], norms[sl], ebf, norms, k, n_real, 0, q_start, "knn_panel")
    knn_panel.launches += 1
    return out


knn_panel.launches = 0


def knn_panel_ext(q: torch.Tensor, qn: torch.Tensor, c: torch.Tensor, cn: torch.Tensor, k: int,
                  n_real_cols: Optional[int] = None, col_id0: int = 0, q_id0: int = -1):
    """Query rows q bf16[S, D] with norms qn f32[S] against the column slab
    c bf16[M, D] with norms cn f32[M], whose column j is corpus row
    ``col_id0 + j`` -> (global ids i32[S, k], squared-L2 dists f32[S, k]).
    Query row r is corpus row ``q_id0 + r`` and never returns itself;
    ``q_id0 < 0`` excludes nothing. Columns at or past ``n_real_cols`` are
    never candidates; -1 / 3.4e38 fill rows with fewer than k. ``q`` may be
    a row slice of ``c``."""
    s_rows, m = q.shape[0], c.shape[0]
    n_real_cols = m if n_real_cols is None else max(0, min(int(n_real_cols), m))
    if s_rows < 1 or q.shape[1:] != c.shape[1:]:
        raise ValueError(f"knn_panel_ext: bad shapes q{tuple(q.shape)} c{tuple(c.shape)}")
    if all(t.device.type == "cpu" for t in (q, qn, c, cn)):
        return knn_panel_ext_plain(q, qn, c, cn, k, n_real_cols, col_id0, q_id0)
    out = _panel_launch(q, qn, c, cn, k, n_real_cols, col_id0, q_id0, "knn_panel_ext")
    knn_panel_ext.launches += 1
    return out


knn_panel_ext.launches = 0


def topk_merge(vals: torch.Tensor, ids: torch.Tensor):
    """Fold L sorted lists per row, vals f32[S, L, k] / ids i32[S, L, k]
    (-1 empty, last), into the k smallest by (distance, id) -> (ids
    i32[S, k], vals f32[S, k]). On the card the merge kernel of the k-NN
    library (up to k = 64 one warp per row, its list in registers; above,
    buffered lists folded by warps of a block, ``topk_common.cuh``)."""
    if vals.shape != ids.shape or vals.dim() != 3:
        raise ValueError(f"topk_merge: bad shapes {tuple(vals.shape)} {tuple(ids.shape)}")
    if vals.device.type == "cpu" and ids.device.type == "cpu":
        return topk_merge_plain(vals, ids)
    if vals.device.type != "cuda" or ids.device != vals.device:
        raise ValueError("topk_merge: vals and ids must lie on one CUDA device")
    if vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("topk_merge: vals must be float32 and ids int32")
    if not (vals.is_contiguous() and ids.is_contiguous()):
        raise ValueError("topk_merge: inputs must be contiguous")
    s_rows, lists, k = vals.shape
    check_k(k, "topk_merge")
    ov = torch.empty((s_rows, k), dtype=torch.float32, device=vals.device)
    oi = torch.empty((s_rows, k), dtype=torch.int32, device=vals.device)
    mv, mi = scratch(merge_entries(s_rows, k), vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = _lib()[1](vals.data_ptr(), ids.data_ptr(), ov.data_ptr(), oi.data_ptr(), _ptr(mv), _ptr(mi), s_rows, lists,
                   k, stream)
    if rc != 0:
        raise RuntimeError(f"topk_merge kernel launch failed: cudaError {rc}")
    topk_merge.launches += 1
    return oi, ov


topk_merge.launches = 0
