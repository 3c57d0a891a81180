"""Graph construction: exact k-NN candidates, α-robust prune, reverse fill.

Counterpart of the small-corpus path of the JAX package's ``ops/graph.py``
(the corpus and its candidate lists fit on one card):

  1. candidate k-NN: exact, through the knn_panel CUDA kernel
     (``ops/knn_panel.py``);
  2. Vamana α-robust-prune of each node's candidates to degree R, keeping
     the ``keep_closest`` nearest unconditionally;
  3. reverse-edge fill of the pruned slots and the medoid (host numpy, the
     same ``default_rng(0)`` draws as the JAX package).

Graph layout is fixed-degree ``i32[N, R]`` padded with -1.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .distance import INF
from .knn_panel import knn_panel, panel_inputs

logger = logging.getLogger(__name__)

# query rows per knn_panel call: on the card one launch then covers ~2K
# blocks of 64 rows
KNN_ROWS_PER_LAUNCH = 1 << 17
# bound on the prune's per-block tensors ([B, C, D] candidate rows + [B, C, C])
PRUNE_BLOCK_BYTES = 256 << 20


def exact_knn_max_n(d: int, k: int, device: "str | torch.device") -> int:
    """Largest corpus the exact path takes on ``device``: bf16 rows, f32
    norms and the [N, k] candidate lists must fit in half of the card's free
    memory (re-derived from the card, not the TPU's 16 GB constant). The CPU
    has no such cap."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free // 2 // (2 * d + 4 + 8 * k))


def exact_knn(emb: np.ndarray, k: int,
              device: "str | torch.device" = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN (squared L2) of every row against the corpus, self
    excluded -> (ids i32[N, k], dists f32[N, k]); -1 pads rows with fewer
    than k other rows. One knn_panel call covers up to
    ``KNN_ROWS_PER_LAUNCH`` query rows."""
    dev = resolve_device(device)
    n = emb.shape[0]
    ebf, norms = panel_inputs(torch.from_numpy(np.ascontiguousarray(emb)).to(dev))
    out_i = np.empty((n, k), np.int32)
    out_d = np.empty((n, k), np.float32)
    for qs in range(0, n, KNN_ROWS_PER_LAUNCH):
        cnt = min(KNN_ROWS_PER_LAUNCH, n - qs)
        ids, dists = knn_panel(ebf, norms, k, q_start=qs, q_count=cnt)
        out_i[qs : qs + cnt] = ids.cpu().numpy()
        out_d[qs : qs + cnt] = dists.cpu().numpy()
    return out_i, out_d


def _prune_select(cid: torch.Tensor, d_pc: torch.Tensor, d_cc: torch.Tensor, r: int, alpha: float,
                  keep_closest: int) -> torch.Tensor:
    """Greedy α-occlusion selection: cid i64[B, C] (-1 invalid), d_pc f32[B, C]
    node->candidate distances, d_cc f32[B, C, C] -> selected ids [B, R].
    The first ``keep_closest`` picks skip the occlusion rule."""
    b = cid.shape[0]
    rows = torch.arange(b, device=cid.device)
    alive = cid >= 0
    inf = torch.full_like(d_pc, INF)
    sels = []
    for t in range(r):
        j = torch.where(alive, d_pc, inf).argmin(dim=1)  # first on ties, as jnp.argmin
        ok = alive[rows, j] & (d_pc[rows, j] < INF)
        sels.append(torch.where(ok, cid[rows, j], torch.full_like(j, -1)))
        if t >= keep_closest:  # occlusion: drop x with alpha * d(c, x) <= d(p, x)
            alive = alive & ~(alpha * d_cc[rows, j, :] <= d_pc)
        alive[rows, j] = False
    return torch.stack(sels, dim=1)


def _robust_prune_device(ebf: torch.Tensor, norms: torch.Tensor, cand: torch.Tensor, r: int, alpha: float,
                         keep_closest: int, block: int) -> torch.Tensor:
    """Vamana robust prune of every row -> selected ids i64[N, R]. ebf bf16
    [N, D], norms f32 [N], cand i64 [N, C]. Products take the bf16 rows with
    f32 accumulation, as the JAX package's einsums."""
    n = ebf.shape[0]
    out = []
    for s in range(0, n, block):
        cid = cand[s : s + block]
        pe = ebf[s : s + block].float()
        pn = norms[s : s + block]
        safe = cid.clamp(0, n - 1)
        cemb = ebf[safe].float()  # [B, C, D]
        cn = norms[safe]
        dots = torch.bmm(cemb, pe[:, :, None])[:, :, 0]
        d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
        cc = torch.bmm(cemb, cemb.transpose(1, 2))
        d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * cc
        out.append(_prune_select(cid, d_pc, d_cc, r, alpha, keep_closest))
    return torch.cat(out)


def _reverse_sample(nbrs: np.ndarray, cap: int, rng: np.random.Generator,
                    dst_ranges: int = 16) -> np.ndarray:
    """Sampled reverse edges: for each node up to ``cap`` nodes that list it,
    chosen by a random priority per edge; processed in destination-id bands
    to bound the sort scratch."""
    n, k = nbrs.shape
    out = np.full((n, cap), -1, np.int32)
    if n == 0:
        return out
    dst_flat = np.ascontiguousarray(nbrs, dtype=np.int32).reshape(-1)
    bounds = np.linspace(0, n, min(dst_ranges, n) + 1).astype(np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        idx = np.flatnonzero((dst_flat >= lo) & (dst_flat < hi))  # drops -1 too
        if idx.size == 0:
            continue
        dst_b = dst_flat[idx]
        src_b = (idx // k).astype(np.int32)
        del idx
        order = rng.permutation(dst_b.size)
        dst_b, src_b = dst_b[order], src_b[order]
        del order
        sort_i = np.argsort(dst_b, kind="stable")
        dst_b, src_b = dst_b[sort_i], src_b[sort_i]
        del sort_i
        first = np.r_[True, dst_b[1:] != dst_b[:-1]]
        group_start = np.maximum.accumulate(np.where(first, np.arange(dst_b.size), 0))
        rank = np.arange(dst_b.size) - group_start
        sel = rank < cap
        out[dst_b[sel], rank[sel]] = src_b[sel]
    return out


def _fill_reverse_edges(neighbors: np.ndarray, rng: np.random.Generator,
                        block: int = 1 << 20) -> np.ndarray:
    """Fill pruned (-1) slots with sampled in-edges. Out-edges keep priority;
    reverse edges pack into the remaining slots, deduplicated, self-loops
    dropped."""
    n, r = neighbors.shape
    rev = _reverse_sample(neighbors, r, rng)
    out = np.empty((n, r), np.int32)
    col = np.arange(2 * r, dtype=np.int32)[None, :]
    for s in range(0, n, block):
        e = min(n, s + block)
        cand = np.empty((e - s, 2 * r), np.int32)
        cand[:, :r] = neighbors[s:e]
        cand[:, r:] = rev[s:e]
        cand[cand == np.arange(s, e, dtype=np.int32)[:, None]] = -1  # self-loops
        srt_i = np.argsort(cand, axis=1, kind="stable")
        srt = np.take_along_axis(cand, srt_i, axis=1)
        dup_sorted = np.concatenate(
            [np.zeros((e - s, 1), bool), (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)], axis=1)
        dup = np.empty_like(dup_sorted)
        np.put_along_axis(dup, srt_i, dup_sorted, axis=1)
        cand[dup] = -1
        key = np.where(cand < 0, np.int32(1 << 30), col)
        order = np.argsort(key, axis=1, kind="stable")
        out[s:e] = np.take_along_axis(cand, order, axis=1)[:, :r]
    return out


def _augment_reverse_candidates(knn_ids: np.ndarray, rev_c: int, src_k: int = 16,
                                block: int = 1 << 16) -> np.ndarray:
    """Append up to ``rev_c`` reverse-edge candidates per row before the
    α-prune: node j gains every i that lists j among its ``src_k`` closest
    forward candidates (deduplicated against j's own list, -1 padded)."""
    n, c = knn_ids.shape
    src_k = min(src_k, c)
    dst = np.ascontiguousarray(knn_ids[:, :src_k]).ravel()
    src = np.repeat(np.arange(n, dtype=np.int32), src_k)
    valid = dst >= 0
    dst, src = dst[valid], src[valid]
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    counts = np.bincount(dst, minlength=n)
    starts = np.zeros(n, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(dst.shape[0], dtype=np.int64) - starts[dst]
    sel = pos < rev_c
    rev = np.full((n, rev_c), -1, np.int32)
    rev[dst[sel], pos[sel]] = src[sel]
    for s in range(0, n, block):
        e = min(s + block, n)
        dup = (rev[s:e, :, None] == knn_ids[s:e, None, :]).any(-1)
        blk_rev = rev[s:e]
        blk_rev[dup] = -1
        rev[s:e] = blk_rev
    return np.concatenate([np.asarray(knn_ids), rev], axis=1)


def compute_medoid(emb: np.ndarray, device: "str | torch.device" = "cuda") -> int:
    e = torch.from_numpy(np.ascontiguousarray(emb)).to(resolve_device(device)).float()
    d = (e - e.mean(dim=0, keepdim=True)).square().sum(dim=1)
    return int(d.argmin())


def build_graph(
    emb: np.ndarray,
    r: int = 32,
    candidate_factor: int = 2,
    alpha: float = 1.2,
    keep_closest: int = -1,  # -1 = auto (r // 4)
    reverse_candidates: int = 0,
    device: "str | torch.device" = "cuda",
    phase_seconds: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, int]:
    """Build a fixed-degree navigable graph -> (neighbors i32[N, R], medoid).

    knn(C = r * candidate_factor) -> α-prune to <= R (keeping the closest
    ``keep_closest`` unconditionally) -> reverse-edge fill to R.
    ``phase_seconds``, when given, receives the wall time of each phase."""
    dev = resolve_device(device)
    times = phase_seconds if phase_seconds is not None else {}
    n, d = emb.shape
    r = min(r, max(n - 1, 1))
    c = min(r * candidate_factor, max(n - 1, 1))
    if keep_closest < 0:
        keep_closest = r // 4
    cap = exact_knn_max_n(d, c, dev)
    if n > cap:
        raise NotImplementedError(
            f"N={n} exceeds the exact k-NN capacity of this device ({cap} rows); the sharded "
            "k-NN (exact_knn_sharded) is not ported to leann_torch yet (ROADMAP.md, left for later #4)")

    t0 = time.time()
    knn_ids, _ = exact_knn(emb, c, device=dev)
    times["knn"] = time.time() - t0
    logger.info("build_graph knn phase: %.1fs", times["knn"])
    if reverse_candidates > 0 and n > 1:
        knn_ids = _augment_reverse_candidates(knn_ids, reverse_candidates)
    cw = knn_ids.shape[1]

    t0 = time.time()
    ebf, norms = panel_inputs(torch.from_numpy(np.ascontiguousarray(emb)).to(dev))
    blk = max(8, PRUNE_BLOCK_BYTES // max(cw * (cw + ebf.shape[1]) * 4, 1))
    cand = torch.from_numpy(knn_ids.astype(np.int64)).to(dev)
    neighbors = _robust_prune_device(ebf, norms, cand, r, float(alpha), keep_closest, blk)
    neighbors = neighbors.to(torch.int32).cpu().numpy()
    del ebf, norms, cand
    times["prune"] = time.time() - t0
    logger.info("build_graph prune phase: %.1fs", times["prune"])

    t0 = time.time()
    out = _fill_reverse_edges(neighbors, np.random.default_rng(0))
    medoid = compute_medoid(emb, dev)
    times["reverse_fill"] = time.time() - t0
    logger.info("graph built: N=%d R=%d avg_deg=%.1f medoid=%d", n, r, (out >= 0).mean() * r, medoid)
    return out, medoid
