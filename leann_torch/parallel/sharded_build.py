"""Mesh-sharded graph construction: the ring exact k-NN and a per-shard prune.

Counterpart of the JAX package's ``parallel/sharded_build.py``. The
embedding matrix is block-partitioned over the mesh's ``gp`` axis (shard
``i`` holds rows ``i * s .. i * s + s``, ``s`` the JAX package's row count
per shard), and the build makes the same k-NN -> α-prune -> reverse-fill
graph as ``ops/graph.build_graph`` without any one shard holding the whole
matrix:

* :func:`ring_knn`: each shard keeps its rows as queries and a tile that
  travels around the ring (:func:`~.mesh.ppermute`). At ring step ``t``
  shard ``me`` scores its rows against the tile of shard ``(me - t) % gp``
  with one launch of kernel B2's external entry (``ops/knn_panel.
  knn_panel_ext``: global column ids, its own rows excluded) and folds the
  result into its running lists with one launch of the [S, 2, k] merge
  (``topk_merge``). ``gp`` steps visit the whole corpus; the result is the
  exact k-NN, ties going to the lower id.
* :func:`_gather_local`: a shard's candidate rows, wherever they live, by
  one more turn of the ring.
* :func:`_prune_local`: the α-prune of each shard's rows over those
  candidates (``ops/graph._prune_select``, the JAX package's rule).
* :func:`sharded_build_graph`: the two, then the reverse-edge fill and the
  medoid on the host.

On one card a mesh may hold several shards of it: the shards' rows are then
row slices of one upload, and the rotation moves no data.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import matmul
from ..ops.distance import INF
from ..ops.graph import PRUNE_BLOCK_BYTES, _fill_reverse_edges, _prune_select
from ..ops.knn_panel import knn_panel_ext, topk_merge, upload_panel_inputs
from .mesh import Mesh, place_row_shards, ppermute

logger = logging.getLogger(__name__)


def gp_devices(mesh: Mesh) -> List[torch.device]:
    """The devices along the mesh's ``gp`` axis (the first row of any other
    axis: those replicate it)."""
    gp = mesh.shape["gp"]
    return list(np.moveaxis(mesh.devices, mesh.axis_names.index("gp"), -1).reshape(-1, gp)[0])


def shard_rows(n: int, gp: int, block: int) -> int:
    """Rows per shard: an even split rounded up to a multiple of ``block``
    (the JAX package's padding; a shard past the corpus holds fewer rows,
    or none)."""
    return ((n + gp - 1) // gp + block - 1) // block * block


def place_rows(emb: np.ndarray, devs: List[torch.device], s: int):
    """Shard ``i``'s rows ``emb[i s : (i + 1) s]`` as the k-NN kernel's
    operands on ``devs[i]`` -> (bf16 rows, f32 norms) lists; a device's
    neighbouring shards are row slices of one upload."""
    hosts: Dict[torch.device, List[int]] = {}
    for i, dev in enumerate(devs):
        hosts.setdefault(dev, []).append(i)
    placed = place_row_shards(emb.shape[0], s, hosts, lambda dev, lo, hi: upload_panel_inputs(emb, dev, lo, hi))
    return [placed[(dev, i)][0] for i, dev in enumerate(devs)], [placed[(dev, i)][1] for i, dev in enumerate(devs)]


def _ring_knn_placed(ebf, norms, s: int, k: int, devs) -> List[Optional[torch.Tensor]]:
    """The ring over placed rows -> per shard (ids i32[rows, k], dists
    f32[rows, k]) on its device; None for a shard without rows. A step
    launches nothing for a shard without rows or against an empty tile."""
    gp = len(devs)
    run = [(torch.full((e.shape[0], k), -1, dtype=torch.int32, device=devs[i]),
            torch.full((e.shape[0], k), INF, dtype=torch.float32, device=devs[i]))
           if e.shape[0] else None for i, e in enumerate(ebf)]
    tiles, tile_n = list(ebf), list(norms)
    for t in range(gp):
        for me in range(gp):
            owner = (me - t) % gp  # the shard the tile started on
            if run[me] is None or tiles[me].shape[0] == 0:
                continue
            ids, dists = knn_panel_ext(ebf[me], norms[me], tiles[me], tile_n[me], k, tiles[me].shape[0],
                                       col_id0=owner * s, q_id0=me * s)
            run_i, run_d = run[me]
            run[me] = topk_merge(torch.stack([run_d, dists], dim=1), torch.stack([run_i, ids], dim=1))
        if t + 1 < gp:
            tiles, tile_n = ppermute(tiles, devs), ppermute(tile_n, devs)
    return run


def ring_knn(emb: np.ndarray, k: int, mesh: Mesh, qb: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN (squared L2, self excluded) with the corpus sharded over
    ``mesh``'s ``gp`` axis -> (ids i32[N, k], dists f32[N, k]); -1 / 3.4e38
    fill rows with fewer than k others. ``qb`` rounds the rows per shard,
    as in the JAX package."""
    devs = gp_devices(mesh)
    s = shard_rows(emb.shape[0], len(devs), qb)
    ebf, norms = place_rows(emb, devs, s)
    run = [r for r in _ring_knn_placed(ebf, norms, s, k, devs) if r is not None]
    return (torch.cat([i.cpu() for i, _ in run]).numpy(), torch.cat([d.cpu() for _, d in run]).numpy())


def _gather_local(tiles, ids: List[Optional[torch.Tensor]], s: int, devs):
    """Each shard's candidate rows, by one turn of the ring: ``ids[i]``
    i64[B_i] global ids (-1 allowed) -> per shard bf16[B_i, D] on its
    device (zeros where -1). At step ``t`` shard ``me`` holds the tile of
    shard ``(me - t) % gp`` and takes the rows it owns."""
    gp = len(devs)
    out = [torch.zeros((x.shape[0], tiles[i].shape[1]), dtype=torch.bfloat16, device=devs[i])
           if x is not None else None for i, x in enumerate(ids)]
    for t in range(gp):
        for me in range(gp):
            rows = tiles[me].shape[0]
            if out[me] is None or rows == 0:
                continue
            local = ids[me] - ((me - t) % gp) * s
            owned = (local >= 0) & (local < rows) & (ids[me] >= 0)
            out[me] = torch.where(owned[:, None], tiles[me][local.clamp(0, rows - 1)], out[me])
        if t + 1 < gp:
            tiles = ppermute(tiles, devs)
    return out


def _prune_local(ebf, cand, s: int, r: int, alpha: float, keep_closest: int, block: int,
                 devs) -> List[Optional[torch.Tensor]]:
    """The α-prune of every shard's rows, ``block`` rows of each shard at a
    time, all shards in step (one ring turn gathers a block's candidates):
    ebf bf16 rows and cand i64[rows, C] per shard -> selected ids
    i64[rows, R] per shard. Norms and products of the bf16 rows in f32, as
    the JAX package's."""
    gp = len(devs)
    out: List[list] = [[] for _ in range(gp)]
    for b0 in range(0, s, block):
        cid = [c[b0 : b0 + block] if c is not None and b0 < c.shape[0] else None for c in cand]
        ce = _gather_local(list(ebf), [c.reshape(-1) if c is not None else None for c in cid], s, devs)
        for me in range(gp):
            if cid[me] is None:
                continue
            b, c = cid[me].shape
            pe = ebf[me][b0 : b0 + b]
            cme = ce[me].reshape(b, c, -1)
            pn = pe.float().square().sum(dim=1)
            cn = cme.float().square().sum(dim=-1)
            dots = matmul(cme, pe[:, :, None])[:, :, 0]
            d_pc = torch.where(cid[me] >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
            d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * matmul(cme, cme.transpose(1, 2))
            out[me].append(_prune_select(cid[me], d_pc, d_cc, r, alpha, keep_closest))
    return [torch.cat(o) if o else None for o in out]


def sharded_build_graph(
    emb: np.ndarray, mesh: Mesh, r: int = 32, candidate_factor: int = 2, alpha: float = 1.2,
    keep_closest: int = -1, qb: int = 256, prune_block: int = 0,
    phase_seconds: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, int]:
    """Mesh-sharded build -> (neighbors i32[N, R], medoid): the contract of
    ``ops/graph.build_graph``, with the embedding matrix split over the
    ``gp`` axis. ``prune_block``: rows of a shard the prune takes at once
    (0: as many as ``ops/graph.PRUNE_BLOCK_BYTES`` allows over all
    shards). ``phase_seconds``, when given, receives the wall time of the
    k-NN, the prune and the reverse fill."""
    times = phase_seconds if phase_seconds is not None else {}
    n, d = emb.shape
    devs = gp_devices(mesh)
    gp = len(devs)
    r = min(r, max(n - 1, 1))
    c = min(r * candidate_factor, max(n - 1, 1))
    if keep_closest < 0:
        keep_closest = r // 4

    t0 = time.time()
    s = shard_rows(n, gp, qb)
    ebf, norms = place_rows(emb, devs, s)
    knn = _ring_knn_placed(ebf, norms, s, c, devs)
    times["knn"] = time.time() - t0
    logger.info("sharded build knn phase: %.1fs", times["knn"])

    t0 = time.time()
    d_pad = ebf[0].shape[1]
    blk = prune_block or max(8, PRUNE_BLOCK_BYTES // max(gp * c * (c + d_pad) * 4, 1))
    cand = [x[0].long() if x is not None else None for x in knn]
    del knn
    sel = _prune_local(ebf, cand, s, r, float(alpha), keep_closest, blk, devs)
    neighbors = torch.cat([x.cpu() for x in sel if x is not None]).to(torch.int32).numpy()
    del ebf, norms, cand, sel
    times["prune"] = time.time() - t0
    logger.info("sharded build prune phase: %.1fs", times["prune"])

    t0 = time.time()
    out = _fill_reverse_edges(neighbors, np.random.default_rng(0))
    # the medoid on the host, as the JAX package takes it: [N] distances to
    # the mean are small beside the [N, D] matrix
    mean = emb.mean(axis=0, keepdims=True)
    medoid = int(np.argmin(((emb - mean) ** 2).sum(axis=1)))
    times["reverse_fill"] = time.time() - t0
    logger.info("sharded graph built: N=%d R=%d over %d shards (avg_deg=%.1f)", n, r, gp, (out >= 0).mean() * r)
    return out, medoid
