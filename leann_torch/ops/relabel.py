"""Locality relabel: renumber graph nodes so that neighbor ids are close.

Counterpart of the JAX package's ``ops/relabel.py``. The packed graph
stores sorted row deltas (``storage.pack_neighbors``), whose entropy is
about log2 of the id window, so ids clustered by geometry shrink it; nearby
rows also share pages during a traversal's gathers. The order: coarse
k-means cells over the corpus geometry (the stored embeddings, or vectors
decoded from PQ codes; for an OPQ index the decode is in the rotated space,
an isometry, so the cells are the same), cells chained by a greedy
nearest-centroid walk, rows numbered cell by cell in their old order. Graph
neighbors are near in space by construction, so they land in the same or
an adjacent cell. The k-means and the assignment are ``ops/graph.py``'s
(bf16 products with f32 sums on the device).

``repack.relabel_index`` applies it to an existing index.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .graph import _assign_clusters, _kmeans_full

logger = logging.getLogger(__name__)


def decoded_source(codes: np.ndarray, codebooks: np.ndarray) -> Callable:
    """Block source of vectors decoded on the host from plain-PQ codes u8
    [N, M] and codebooks [M, K, ds]: an index that stores no embeddings
    still has the coarse geometry the cells need."""
    cb = np.asarray(codebooks, np.float32)
    m, _, ds = cb.shape

    def src(s: int, e: int) -> np.ndarray:
        blk = codes[s:e]
        out = np.empty((e - s, m * ds), np.float32)
        for j in range(m):
            out[:, j * ds : (j + 1) * ds] = cb[j][blk[:, j]]
        return out

    return src


def matrix_source(emb: np.ndarray) -> Callable:
    """Block source of the rows of a stored matrix, as f32."""
    def src(s: int, e: int) -> np.ndarray:
        return np.asarray(emb[s:e], np.float32)

    return src


def chain_rank(cent: np.ndarray) -> np.ndarray:
    """Greedy nearest-centroid chain from centroid 0 -> rank i64[K]:
    consecutive ranks are nearby cells."""
    k = cent.shape[0]
    c = np.asarray(cent, np.float32)
    n2 = (c * c).sum(1)
    visited = np.zeros(k, bool)
    order = np.empty(k, np.int64)
    cur = 0
    for i in range(k):
        order[i] = cur
        visited[cur] = True
        d = n2 - 2.0 * (c @ c[cur])
        d[visited] = np.inf
        cur = int(np.argmin(d)) if i < k - 1 else cur
    rank = np.empty(k, np.int64)
    rank[order] = np.arange(k)
    return rank


def _gather_sample(source: Callable, idx: np.ndarray, n: int) -> np.ndarray:
    """The sorted sample rows ``idx`` through the block source, in runs of
    2^18 rows (one call a row would cost 64K calls)."""
    out = []
    step = 1 << 18
    for s in range(0, n, step):
        e = min(s + step, n)
        sel = idx[(idx >= s) & (idx < e)]
        if sel.size:
            out.append(source(s, e)[sel - s])
    return np.concatenate(out)


def locality_order(source: Callable, n: int, d: int, n_cells: int = 0, sample: int = 65536, seed: int = 0,
                   block: int = 1 << 17, device: "str | torch.device" = "cuda") -> np.ndarray:
    """-> order i64[N]: new row j holds old row ``order[j]``. ``n_cells``
    (0: N / 2048 within [64, 8192]) k-means cells trained for 8 rounds on a
    power-of-two sample of up to ``sample`` rows (the JAX package's draws
    from ``seed``), every row assigned in bf16 ``block`` rows at a time,
    cells in :func:`chain_rank` order, rows stable within a cell. Below 4
    rows a cell the identity."""
    dev = resolve_device(device)
    if n_cells <= 0:
        n_cells = int(np.clip(n // 2048, 64, 8192))
    if n < 4 * n_cells:
        return np.arange(n, dtype=np.int64)  # too small to gain
    rng = np.random.default_rng(seed)
    t0 = time.time()
    s_size = min(n, sample)
    s_size = 1 << (s_size.bit_length() - 1)
    samp = _gather_sample(source, np.sort(rng.choice(n, s_size, replace=False)), n)
    init = samp[rng.choice(samp.shape[0], n_cells, replace=False)]
    cent = _kmeans_full(torch.from_numpy(samp).to(dev), torch.from_numpy(np.ascontiguousarray(init)).to(dev),
                        samp.shape[0], 8)
    logger.info("relabel: %d cells trained on %d samples (%.1fs)", n_cells, samp.shape[0], time.time() - t0)
    assign = np.empty(n, np.int32)
    for bi, s in enumerate(range(0, n, block)):
        e = min(s + block, n)
        rows = torch.from_numpy(source(s, e)).to(dev).to(torch.bfloat16)
        assign[s:e] = _assign_clusters(rows, cent, 8192).cpu().numpy()
        if bi % 16 == 15:
            logger.info("relabel assign: %d/%d rows (%.0fs)", e, n, time.time() - t0)
    order = np.argsort(chain_rank(cent.cpu().numpy())[assign], kind="stable").astype(np.int64)
    logger.info("relabel: %d rows assigned and ordered (%.1fs)", n, time.time() - t0)
    return order


def edge_locality(neighbors: np.ndarray, window: int = 1 << 16) -> float:
    """Fraction of real edges whose |dst - src| < window: the quantity the
    sorted-delta packer's size tracks."""
    n = neighbors.shape[0]
    src = np.repeat(np.arange(n, dtype=np.int64), neighbors.shape[1])
    dst = neighbors.reshape(-1).astype(np.int64)
    valid = dst >= 0
    if not valid.any():
        return 0.0
    return float((np.abs(dst[valid] - src[valid]) < window).mean())
