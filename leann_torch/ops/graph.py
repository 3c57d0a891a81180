"""Graph construction: exact k-NN candidates, α-robust prune, reverse fill.

Counterpart of the JAX package's ``ops/graph.py`` (its exact paths; the
spill and NN-descent candidate passes are not ported):

  1. candidate k-NN, exact, through the knn_panel CUDA kernel
     (``ops/knn_panel.py``): one card-resident pass (:func:`exact_knn`)
     while the bf16 matrix and the lists fit on the card, else
     :func:`exact_knn_sharded`, which keeps the matrix in host RAM and
     streams query chunks with their running top-k through one bf16 column
     slab at a time; :func:`exact_knn_rows` is the sampled oracle;
  2. Vamana α-robust-prune of each node's candidates to degree R, keeping
     the ``keep_closest`` nearest unconditionally, against the bf16 matrix
     on the card or, when that outgrows the card, against candidates
     decoded from PQ codes (:func:`_robust_prune_pq_device`);
  3. reverse-edge fill of the pruned slots and the medoid (host numpy, the
     same ``default_rng(0)`` draws as the JAX package).

``build_graph(checkpoint_dir=...)`` saves each phase's output and resumes
from it, with the JAX package's key strings and file names, so a finished
phase one package wrote resumes in the other. Graph layout is fixed-degree
``i32[N, R]`` padded with -1.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import f32_matmuls, resolve_device
from .distance import INF
from .knn_panel import knn_panel, knn_panel_ext, topk_merge, upload_panel_inputs
from .pq import _bucket_sample, decode_pq, encode_pq, train_pq
from .tile_plan import TILE_COLS

logger = logging.getLogger(__name__)

# query rows per knn_panel call: on the card one launch then covers ~2K
# blocks of 64 rows
KNN_ROWS_PER_LAUNCH = 1 << 17
# bound on the prune's per-block tensors ([B, C, D] candidate rows + [B, C, C])
PRUNE_BLOCK_BYTES = 256 << 20
# candidate rows that go up to the card at once: the [N, C] candidate lists
# stay on the host (int64 on the card would be 15 GB at 30M x 64)
PRUNE_DISPATCH_ROWS = 1 << 17

# Column-sharded k-NN (sizes for an 80 GB card, not the TPU's 16 GB):
# the bf16 slab the card holds at a time. 24 GiB is 33.5M columns at
# D = 384, so the band just past exact_knn_max_n (~30M rows there) takes
# two shards and leaves the card room for the query chunk, its running
# state and the kernel's lists.
EXACT_SHARD_BYTES = 24 << 30
# query rows per (chunk x shard) launch: as KNN_ROWS_PER_LAUNCH
EXACT_QCHUNK = 1 << 17
# seconds between mid-shard checkpoints of the running state
QCKPT_SECS = 300.0
# rows per block of the host-side medoid pass
HOST_BLOCK_ROWS = 1 << 20


def _rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _prune_pq_m(d: int) -> int:
    """Divisor of ``d`` giving a subspace width in [3, 16], closest to 6;
    0 when none exists (the caller zero-pads columns). ``choose_m`` returns
    1 for dims like 385, one global codebook, which occludes everything in
    the prune."""
    best, best_gap = 0, 99
    for m in range(1, d + 1):
        if d % m:
            continue
        ds = d // m
        if 3 <= ds <= 16 and abs(ds - 6) < best_gap:
            best, best_gap = m, abs(ds - 6)
    return best


def _bucket_rows(n: int, block: int) -> int:
    """Smallest block-multiple of {1, 1.25, 1.5, 1.75} x 2^i >= n: the JAX
    package's padded row count, kept so the prune-code checkpoint has the
    rows it expects."""
    if n <= block:
        return block
    v = block
    while v < n:
        for frac in (1.0, 1.25, 1.5, 1.75):
            cand = ((int(v * frac) + block - 1) // block) * block
            if cand >= n:
                return cand
        v *= 2
    return v


def exact_knn_max_n(d: int, k: int, device: "str | torch.device") -> int:
    """Largest corpus the card-resident exact pass takes on ``device``: bf16
    rows, f32 norms and the [N, k] candidate lists must fit in half of the
    card's free memory (re-derived from the card, not the TPU's 16 GB
    constant). Above it build_graph takes :func:`exact_knn_sharded`. The CPU
    has no such cap."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free // 2 // (2 * d + 4 + 8 * k))


def prune_ebf_max_bytes(device: "str | torch.device") -> int:
    """Largest bf16 corpus matrix the prune keeps on ``device``: half of the
    card's free memory (re-derived from the card, not the TPU's 10 GB).
    Above it the prune decodes candidates from PQ codes. The CPU has no
    such cap."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free // 2)


def exact_knn(emb: np.ndarray, k: int,
              device: "str | torch.device" = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN (squared L2) of every row against the corpus, self
    excluded -> (ids i32[N, k], dists f32[N, k]); -1 pads rows with fewer
    than k other rows. One knn_panel call covers up to
    ``KNN_ROWS_PER_LAUNCH`` query rows."""
    dev = resolve_device(device)
    n = emb.shape[0]
    ebf, norms = upload_panel_inputs(emb, dev)
    out_i = np.empty((n, k), np.int32)
    out_d = np.empty((n, k), np.float32)
    for qs in range(0, n, KNN_ROWS_PER_LAUNCH):
        cnt = min(KNN_ROWS_PER_LAUNCH, n - qs)
        ids, dists = knn_panel(ebf, norms, k, q_start=qs, q_count=cnt)
        out_i[qs : qs + cnt] = ids.cpu().numpy()
        out_d[qs : qs + cnt] = dists.cpu().numpy()
    return out_i, out_d


def _exact_knn_shard_device(cshard: torch.Tensor, cnorms: torch.Tensor, qrows: Optional[torch.Tensor],
                            qnorms: Optional[torch.Tensor], run_d: torch.Tensor, run_i: torch.Tensor,
                            q_start: int, col_start: int, n_real_cols: int, k: int, q_in_shard: bool):
    """One (query chunk x column shard) pass: the chunk's k nearest in the
    slab (kernel B2 through :func:`knn_panel_ext`, global ids), folded into
    its running state (the merge kernel over [S, 2, k]) -> (run_d, run_i).
    The caller sweeps the shards; after the last, the state is the exact
    global top-k. ``q_in_shard``: the chunk's rows lie inside ``cshard``
    and are sliced from it on the card instead of uploaded (``qrows`` is
    None then). ``q_start`` is the global id of the chunk's first row (its
    self is never taken); -1 excludes nothing."""
    if q_in_shard:
        lo = q_start - col_start
        qrows, qnorms = cshard[lo : lo + run_d.shape[0]], cnorms[lo : lo + run_d.shape[0]]
    ids, dists = knn_panel_ext(qrows, qnorms, cshard, cnorms, k, n_real_cols, col_start, q_start)
    ids, dists = topk_merge(torch.stack([run_d, dists], dim=1), torch.stack([run_i, ids], dim=1))
    return dists, ids


def _to_host_async(*ts: torch.Tensor):
    """Start copying card tensors into pinned host buffers -> (buffers,
    event to wait on); CPU tensors come back as they are."""
    if ts[0].device.type != "cuda":
        return ts, None
    bufs = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in ts)
    for b, t in zip(bufs, ts):
        b.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return bufs, ev


def _rows_per_shard(shard_bytes: int, d: int) -> int:
    return max(TILE_COLS, (int(shard_bytes // (2 * d)) // TILE_COLS) * TILE_COLS)


def exact_knn_sharded(
    emb: np.ndarray, k: int, query_block: int = 1024, tile: int = 131072,
    qchunk: "int | None" = None, shard_bytes: "int | None" = None,
    approx_recall: "float | None" = None, checkpoint_dir: str = "",
    device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN for corpora whose bf16 matrix outgrows the card: the
    matrix (f32 or f16, a memmap allowed) stays in host RAM; the card holds
    one bf16 column slab of ``shard_bytes`` at a time, cast there from the
    host rows one block at a time, while query chunks of ``qchunk`` rows
    stream through, each carrying its running top-k (ids + dists, merged on
    the card). A chunk whose rows lie inside the slab is sliced from it;
    the others are uploaded. After the last shard the state is the exact
    global answer -> (ids i32[N, k], dists f32[N, k]), the same as
    :func:`exact_knn`'s: both take the norms and the bf16 rows from
    ``upload_panel_inputs``, so a pair's distance is bit-identical.

    ``query_block``, ``tile`` and ``approx_recall`` are accepted for the JAX
    package's signature and ignored: the port is always exact, and its grid
    comes from ``tile_plan.plan_launch``.

    Chunk i + 1 is launched before chunk i's state is copied back (a
    depth-1 pipeline), so the host's write-back hides under the card's
    work. ``checkpoint_dir``: the running state lives in memmaps there and
    is flushed after every shard and every ``QCKPT_SECS`` within one; a
    killed run resumes at the last durable (shard, chunk), after purging
    the unfinished shard's ids from the rows not yet durable. The state
    files go at the end. A state is resumed only at its own geometry
    (``rows_per_shard``, ``qchunk``), as in the JAX package: one the JAX
    package wrote resumes here when ``shard_bytes`` and ``qchunk`` give its
    numbers (its shards are whole tiles, so ``shard_bytes = rows_per_shard
    * 2 * D`` does), else it is discarded with a warning. This package's
    state has N rows where the JAX package wants its padded row count, so
    the JAX package does not resume it."""
    dev = resolve_device(device)
    n, d = emb.shape
    rows_per_shard = _rows_per_shard(shard_bytes or EXACT_SHARD_BYTES, d)
    n_shards = (n + rows_per_shard - 1) // rows_per_shard
    qchunk = max(1, int(qchunk or EXACT_QCHUNK))

    sd_path = os.path.join(checkpoint_dir, "exknn_state_d.npy") if checkpoint_dir else ""
    si_path = os.path.join(checkpoint_dir, "exknn_state_i.npy") if checkpoint_dir else ""
    meta_path = os.path.join(checkpoint_dir, "exknn_state.json") if checkpoint_dir else ""
    key = _ckpt_key(emb, f"k{k}ex") if checkpoint_dir else ""
    shard_done = q_resume = 0
    run_d = run_i = None
    if checkpoint_dir and os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                m = json.load(f)
            m_sh, m_q = m.get("shards_done", 0), m.get("qchunks_done", 0)
            geom_ok = (m.get("rows_per_shard", rows_per_shard) == rows_per_shard
                       and m.get("qchunk", qchunk) == qchunk)
            if m.get("key") == key and not geom_ok:
                logger.warning("exact_knn_sharded: discarding the state of this corpus at rows_per_shard=%s "
                               "qchunk=%s (this run: %d, %d); pass shard_bytes=%s and qchunk=%s to resume it",
                               m.get("rows_per_shard"), m.get("qchunk"), rows_per_shard, qchunk,
                               m.get("rows_per_shard", 0) * 2 * d, m.get("qchunk"))
            if m.get("key") == key and geom_ok and (m_sh > 0 or m_q > 0) and m_sh <= n_shards:
                run_d = np.lib.format.open_memmap(sd_path, mode="r+")
                run_i = np.lib.format.open_memmap(si_path, mode="r+")
                # the JAX package pads its state to its query blocks: rows past n are unused
                if run_d.shape[0] >= n and run_d.shape[1:] == (k,) and run_i.shape == run_d.shape:
                    shard_done, q_resume = m_sh, m_q
                    logger.info("exact_knn_sharded: resumed at shard %d/%d qchunk %d",
                                shard_done, n_shards, q_resume)
                    # the killed run may have written merges of shard
                    # `shard_done` past the last durable chunk; merging that
                    # shard again would list its ids twice, so they go from
                    # the rows not yet durable, and each row is re-sorted
                    if shard_done < n_shards:
                        cs_p = shard_done * rows_per_shard
                        ce_p = min(cs_p + rows_per_shard, n)
                        for s_p in range(q_resume * qchunk, n, HOST_BLOCK_ROWS):
                            e_p = min(s_p + HOST_BLOCK_ROWS, n)
                            di = np.asarray(run_d[s_p:e_p])
                            ii = np.asarray(run_i[s_p:e_p])
                            stale = (ii >= cs_p) & (ii < ce_p)
                            if stale.any():
                                di[stale] = INF
                                ii[stale] = -1
                                o = np.argsort(di, axis=1, kind="stable")
                                run_d[s_p:e_p] = np.take_along_axis(di, o, 1)
                                run_i[s_p:e_p] = np.take_along_axis(ii, o, 1)
                else:
                    run_d = run_i = None
        except Exception as e:  # a corrupt partial state from a killed run
            logger.warning("ignoring unreadable exknn state: %s", e)
            run_d = run_i = None
    if run_d is None:
        shard_done = q_resume = 0
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            # a discarded state goes before the new one is written: a killed
            # run in this process may still map it (the JAX package's queued
            # computations read its slices without a copy), and truncating
            # a mapped file faults its readers (SIGBUS)
            for path in (sd_path, si_path):
                if os.path.exists(path):
                    os.remove(path)
            run_d = np.lib.format.open_memmap(sd_path, mode="w+", dtype=np.float32, shape=(n, k))
            run_i = np.lib.format.open_memmap(si_path, mode="w+", dtype=np.int32, shape=(n, k))
        else:
            run_d = np.empty((n, k), np.float32)
            run_i = np.empty((n, k), np.int32)
        run_d[:] = INF
        run_i[:] = -1

    def save_meta(shards_done: int, qchunks_done: int) -> None:
        run_d.flush()
        run_i.flush()
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"key": key, "shards_done": shards_done, "qchunks_done": qchunks_done,
                       "rows_per_shard": rows_per_shard, "qchunk": qchunk}, f)
        os.replace(tmp, meta_path)

    logger.info("exact_knn_sharded: %d rows, %d shards of %d, chunks of %d", n, n_shards, rows_per_shard, qchunk)
    t_all = time.time()
    for sh in range(shard_done, n_shards):
        cs, ce = sh * rows_per_shard, min((sh + 1) * rows_per_shard, n)
        cshard, cnorms = upload_panel_inputs(emb, dev, cs, ce)
        t0 = t_ckpt = time.time()
        pending = None  # (chunk, qs, qe, host buffers, event) not yet written back

        def drain(p) -> None:
            nonlocal t_ckpt
            pci, pqs, pqe, bufs, ev = p
            if ev is not None:
                ev.synchronize()
            run_d[pqs:pqe] = bufs[0].numpy()
            run_i[pqs:pqe] = bufs[1].numpy()
            if checkpoint_dir and time.time() - t_ckpt > QCKPT_SECS:
                save_meta(sh, pci + 1)  # the written-back chunks are the resume point
                t_ckpt = time.time()

        for ci, qs in enumerate(range(0, n, qchunk)):
            if sh == shard_done and ci < q_resume:
                continue  # durable from the checkpoint; merging again would list ids twice
            qe = min(qs + qchunk, n)
            q_in = qs >= cs and qe <= ce
            qrows = qnorms = None
            if not q_in:
                qrows, qnorms = upload_panel_inputs(emb, dev, qs, qe)
            rd = torch.from_numpy(np.ascontiguousarray(run_d[qs:qe])).to(dev)
            ri = torch.from_numpy(np.ascontiguousarray(run_i[qs:qe])).to(dev)
            rd, ri = _exact_knn_shard_device(cshard, cnorms, qrows, qnorms, rd, ri, qs, cs, ce - cs, k, q_in)
            fetched = _to_host_async(rd, ri)
            if pending is not None:
                drain(pending)
            pending = (ci, qs, qe, *fetched)
        if pending is not None:
            drain(pending)
        del cshard, cnorms
        if checkpoint_dir:
            save_meta(sh + 1, 0)
        logger.info("exact_knn_sharded: shard %d/%d done in %.1fs (host rss %.1f GB)",
                    sh + 1, n_shards, time.time() - t0, _rss_gb())
    logger.info("exact_knn_sharded: %d shards, %.1fs total", n_shards, time.time() - t_all)
    out_i = np.asarray(run_i[:n])
    out_d = np.asarray(run_d[:n])
    out_i[out_d >= INF] = -1
    if checkpoint_dir:  # the open mappings outlive the files
        for p in (sd_path, si_path, meta_path):
            try:
                os.remove(p)
            except OSError:
                pass
    return out_i, out_d


def exact_knn_rows(
    emb: np.ndarray, rows: np.ndarray, k: int, *,
    shard_bytes: "int | None" = None, tile: int = 131072,
    include_self: bool = False, device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN of a SUBSET of rows against the whole corpus, the sampled
    oracle of an approximate candidate pass at any scale: O(S N D) where
    the full pass is O(N^2 D). Column shards stream through the card as in
    :func:`exact_knn_sharded` while the S query rows stay there with their
    running top-k -> (ids i32[S, k], dists f32[S, k]) ascending; the row
    itself is left out unless ``include_self``. ``tile`` is ignored (the
    grid comes from ``tile_plan.plan_launch``)."""
    dev = resolve_device(device)
    n, d = emb.shape
    rows = np.asarray(rows)
    s_n = int(rows.shape[0])
    kk = k if include_self else k + 1
    qrows, qnorms = upload_panel_inputs(np.asarray(emb[rows]), dev)
    run_d = torch.full((s_n, kk), INF, dtype=torch.float32, device=dev)
    run_i = torch.full((s_n, kk), -1, dtype=torch.int32, device=dev)
    rows_per_shard = _rows_per_shard(shard_bytes or EXACT_SHARD_BYTES, d)
    for cs in range(0, n, rows_per_shard):
        ce = min(cs + rows_per_shard, n)
        cshard, cnorms = upload_panel_inputs(emb, dev, cs, ce)
        # q_start -1: the sampled rows are not contiguous, so no self is
        # excluded here; it is dropped below
        run_d, run_i = _exact_knn_shard_device(cshard, cnorms, qrows, qnorms, run_d, run_i, -1, cs, ce - cs,
                                               kk, False)
        logger.info("exact_knn_rows: shard rows %d-%d merged", cs, ce)
    out_d = run_d.cpu().numpy()
    out_i = run_i.cpu().numpy()
    out_i[out_d >= INF] = -1
    if not include_self:
        # a stable sort on the self mask keeps the ascending order and moves
        # the row's own id (where present) past the k kept columns
        mask = out_i == rows[:, None].astype(np.int32)
        order = np.argsort(mask, axis=1, kind="stable")
        out_i = np.take_along_axis(out_i, order, 1)[:, :k]
        out_d = np.take_along_axis(out_d, order, 1)[:, :k]
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
                         keep_closest: int, block: int, row_start: int = 0) -> torch.Tensor:
    """Vamana robust prune of rows ``row_start ..`` -> selected ids i64[rows,
    R]. ebf bf16 [N, D] and norms f32 [N] of the whole corpus, cand i64
    [rows, C] of these rows only. Products take the bf16 rows with f32
    accumulation, as the JAX package's einsums."""
    n = ebf.shape[0]
    out = []
    for s in range(0, cand.shape[0], block):
        cid = cand[s : s + block]
        pe = ebf[row_start + s : row_start + s + block].float()
        pn = norms[row_start + s : row_start + s + block]
        safe = cid.clamp(0, n - 1)
        cemb = ebf[safe].float()  # [B, C, D]
        cn = norms[safe]
        dots = torch.bmm(cemb, pe[:, :, None])[:, :, 0]
        d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
        cc = torch.bmm(cemb, cemb.transpose(1, 2))
        d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * cc
        out.append(_prune_select(cid, d_pc, d_cc, r, alpha, keep_closest))
    return torch.cat(out)


def _robust_prune_pq_device(codes: torch.Tensor, codebooks: torch.Tensor, pe: torch.Tensor, cand: torch.Tensor,
                            r: int, alpha: float, keep_closest: int, block: int) -> torch.Tensor:
    """The prune past the card's memory: the corpus stays on the card as PQ
    codes u8 [N, M] with plain codebooks f32 [M, 256, ds] (M ds = D); the
    rows being pruned arrive exact, pe bf16 [rows, D], with their candidates
    cand i64 [rows, C]; each block decodes its [B, C, D] candidate rows
    from the bf16 codebooks. Node-to-candidate distances mix the exact node
    with the decoded candidate; the occlusion distances are decoded on both
    sides -> selected ids i64[rows, R]. Plain torch, as the JAX package
    computes it outside Pallas."""
    n = codes.shape[0]
    cbf = codebooks.to(torch.bfloat16)
    out = []
    for s in range(0, cand.shape[0], block):
        cid = cand[s : s + block]
        p = pe[s : s + block].float()
        pn = p.square().sum(dim=1)
        cemb = decode_pq(cbf, codes[cid.clamp(0, n - 1)]).float()  # [B, C, D]
        cn = cemb.square().sum(dim=2)
        dots = torch.bmm(cemb, p[:, :, None])[:, :, 0]
        d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
        cc = torch.bmm(cemb, cemb.transpose(1, 2))
        d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * cc
        out.append(_prune_select(cid, d_pc, d_cc, r, alpha, keep_closest))
    return torch.cat(out)


@f32_matmuls()
def robust_prune_explicit(p_emb: torch.Tensor, cand_ids: torch.Tensor, cand_emb: torch.Tensor, r: int,
                          alpha: float, keep_closest: int) -> torch.Tensor:
    """Vamana robust prune over explicit candidate embeddings: p_emb f32
    [B, D] of the nodes, cand_ids [B, C] (-1 invalid), cand_emb f32
    [B, C, D] -> selected ids i64[B, R]. The incremental insert's variant of
    :func:`_robust_prune_device`: its candidates come from a search of the
    live index, whose embeddings may exist only as re-encodes, so the caller
    passes the gathered block. Products of bf16-rounded operands in f32,
    squared norms of the f32 rows, as the JAX package's einsums."""
    pe = p_emb.to(torch.bfloat16).float()
    ce = cand_emb.to(torch.bfloat16).float()
    pn = p_emb.float().square().sum(dim=1)
    cn = cand_emb.float().square().sum(dim=-1)
    dots = torch.bmm(ce, pe[:, :, None])[:, :, 0]
    cid = cand_ids.long()
    d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
    d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * torch.bmm(ce, ce.transpose(1, 2))
    return _prune_select(cid, d_pc, d_cc, r, alpha, keep_closest)


def _prune_pq_mode(emb: np.ndarray, cand_h: np.ndarray, r: int, alpha: float, keep_closest: int, blk: int,
                   dev: torch.device, checkpoint_dir: str, key: Optional[str]) -> np.ndarray:
    """The α-prune when the bf16 matrix outgrows the card: PQ codebooks
    trained on a 64K-row sample (subspace width near 6), every row encoded,
    the codes on the card; each dispatch uploads its own exact rows and
    candidates. The codes and codebooks are checkpointed beside the other
    phases (``ckpt_prune_codes.npy``) -> neighbors i32[N, R]."""
    n, d_emb = emb.shape
    cw = cand_h.shape[1]
    m = _prune_pq_m(d_emb)
    # a width with no divisor in the band (a prime D) is zero-padded: padded
    # centroids train to ~0 and change no distance
    d_pq = d_emb if m else ((d_emb + 5) // 6) * 6
    m = m or d_pq // 6
    codes_ckpt = os.path.join(checkpoint_dir, "ckpt_prune_codes.npy") if checkpoint_dir else ""
    codes_key = f"{key}_prunepq_m{m}"
    codes_h = _ckpt_load(codes_ckpt, codes_key) if codes_ckpt else None
    cb = _ckpt_load(codes_ckpt + ".cb.npy", codes_key) if codes_ckpt else None
    t0 = time.time()
    if codes_h is None or cb is None or codes_h.shape[0] < n:
        samp = np.asarray(_bucket_sample(emb, 65536, np.random.default_rng(0)), np.float32)
        if d_pq != d_emb:
            samp = np.pad(samp, ((0, 0), (0, d_pq - d_emb)))
        cb = train_pq(samp, m=m, n_iters=8, sample=samp.shape[0], device=dev)
        cb_d = torch.from_numpy(cb).to(dev)
        # the JAX package's padded row count, so either package resumes the file
        jax_blk = max(8, (min(512, int((256 << 20) / max(cw * cw * 4, 1))) // 8) * 8)
        codes_h = np.zeros((_bucket_rows(n, jax_blk), m), np.uint8)
        for s in range(0, n, 1 << 16):
            rows = torch.from_numpy(np.ascontiguousarray(emb[s : s + (1 << 16)])).to(dev).float()
            if d_pq != d_emb:
                rows = torch.nn.functional.pad(rows, (0, d_pq - d_emb))
            codes_h[s : s + rows.shape[0]] = encode_pq(rows, cb_d).cpu().numpy()
        if codes_ckpt:
            _ckpt_save(codes_ckpt + ".cb.npy", codes_key, np.asarray(cb))
            _ckpt_save(codes_ckpt, codes_key, codes_h)
    else:
        logger.info("prune pq: resumed %d codes from %s", codes_h.shape[0], codes_ckpt)
    codes_d = torch.from_numpy(np.array(codes_h[:n])).to(dev)  # a copy: a resumed memmap is read-only
    cb_d = torch.from_numpy(np.ascontiguousarray(cb, np.float32)).to(dev)
    del codes_h
    logger.info("prune pq: M=%d ds=%d, codes %.2f GB on the card (%.1fs)", m, d_pq // m,
                codes_d.numel() / 2**30, time.time() - t0)
    neighbors = np.empty((n, r), np.int32)
    for s in range(0, n, PRUNE_DISPATCH_ROWS):
        e = min(n, s + PRUNE_DISPATCH_ROWS)
        pe, _ = upload_panel_inputs(emb, dev, s, e, d_pad=d_pq)
        cand = torch.from_numpy(np.asarray(cand_h[s:e], np.int64)).to(dev)
        sel = _robust_prune_pq_device(codes_d, cb_d, pe, cand, r, float(alpha), keep_closest, blk)
        neighbors[s:e] = sel.to(torch.int32).cpu().numpy()
    return neighbors


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


def _trim_host(label: str = "") -> None:
    """Return freed numpy buffers to the OS at phase boundaries: glibc keeps
    multi-GB arenas resident after the k-NN and prune phases' short-lived
    giant arrays."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:  # not glibc: gc alone is what there is
        pass
    if label:
        logger.info("host trim after %s: rss %.1f GB", label, _rss_gb())


def compute_medoid(emb: np.ndarray, device: "str | torch.device" = "cuda", host: bool = False) -> int:
    """Row closest to the mean. On the card unless ``host`` or the f32
    matrix and its centred copy would take more than half of its free
    memory; then a host pass over blocks of rows."""
    dev = resolve_device(device)
    n, d = emb.shape
    if not host and dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        host = n * d * 8 > free // 2
    if host:
        mean = emb.mean(axis=0, dtype=np.float64).astype(np.float32)
        best_d, best_i = np.inf, 0
        for s in range(0, n, HOST_BLOCK_ROWS):
            dd = ((emb[s : s + HOST_BLOCK_ROWS] - mean) ** 2).sum(axis=1)
            i = int(dd.argmin())
            if dd[i] < best_d:
                best_d, best_i = float(dd[i]), s + i
        return best_i
    e = torch.from_numpy(np.ascontiguousarray(emb)).to(dev).float()
    dd = (e - e.mean(dim=0, keepdim=True)).square().sum(dim=1)
    return int(dd.argmin())


def _ckpt_key(emb: np.ndarray, extra: str) -> str:
    """Cheap content key for build checkpoints: shape, dtype and a blake2b
    of a ~4K-row stride sample plus the head and tail rows (the JAX
    package's key, string for string). Not a full content hash: a corpus
    edited only off the stride matches the old key, so pass a fresh
    checkpoint_dir after partial re-embeddings."""
    import hashlib

    step = max(1, emb.shape[0] // 4096)
    h = hashlib.blake2b(digest_size=8)
    for part in (emb[::step], emb[:256], emb[-256:]):
        h.update(np.ascontiguousarray(part).tobytes())
    return f"{emb.shape[0]}x{emb.shape[1]}_{emb.dtype}_{h.hexdigest()}_{extra}"


def _ckpt_load(path: str, key: str):
    """-> read-only memmap | None. The key rides in a sidecar .json; a stale
    or foreign artifact (another corpus or other parameters) is ignored."""
    if not (os.path.exists(path) and os.path.exists(path + ".json")):
        return None
    try:
        with open(path + ".json") as f:
            if json.load(f)["key"] != key:
                return None
        return np.load(path, mmap_mode="r")
    except Exception as e:  # a corrupt partial write from a killed run
        logger.warning("ignoring unreadable checkpoint %s: %s", path, e)
        return None


def _ckpt_save(path: str, key: str, arr: np.ndarray) -> None:
    """The old key sidecar goes first and the new one is written last (both
    atomically), so a kill at any point leaves no sidecar or a consistent
    pair. A memmap already in the checkpoint directory is renamed into
    place instead of copied."""
    try:
        os.remove(path + ".json")
    except OSError:
        pass
    fname = getattr(arr, "filename", None)
    if isinstance(arr, np.memmap) and fname and \
            os.path.dirname(os.path.abspath(fname)) == os.path.dirname(os.path.abspath(path)):
        arr.flush()
        if os.path.abspath(fname) != os.path.abspath(path):
            os.replace(fname, path)
    else:
        tmp = path + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)
    tmpj = path + ".json.tmp"
    with open(tmpj, "w") as f:
        json.dump({"key": key}, f)
    os.replace(tmpj, path + ".json")


def build_graph(
    emb: np.ndarray,
    r: int = 32,
    candidate_factor: int = 2,
    alpha: float = 1.2,
    keep_closest: int = -1,  # -1 = auto (r // 4)
    checkpoint_dir: str = "",
    reverse_candidates: int = 0,
    device: "str | torch.device" = "cuda",
    phase_seconds: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, int]:
    """Build a fixed-degree navigable graph -> (neighbors i32[N, R], medoid).

    knn(C = r * candidate_factor) -> α-prune to <= R (keeping the closest
    ``keep_closest`` unconditionally) -> reverse-edge fill to R. Above
    :func:`exact_knn_max_n` the k-NN is :func:`exact_knn_sharded`; above
    :func:`prune_ebf_max_bytes` the prune decodes candidates from PQ codes.
    The candidate lists stay on the host and go up ``PRUNE_DISPATCH_ROWS``
    rows at a time.

    ``checkpoint_dir``: each phase's output (k-NN candidates, pruned
    neighbors, the prune's PQ codes) is saved there, keyed on a corpus hash
    and the phase's parameters, and a rerun resumes at the last finished
    phase, also from a directory the JAX package wrote (the sharded k-NN's
    mid-phase state only where its geometry matches: see
    :func:`exact_knn_sharded`). The k-NN grid comes from
    ``tile_plan.plan_launch`` and the prune's block from
    ``PRUNE_BLOCK_BYTES``. ``phase_seconds``, when given, receives the wall
    time of each phase."""
    dev = resolve_device(device)
    times = phase_seconds if phase_seconds is not None else {}
    n, d = emb.shape
    r = min(r, max(n - 1, 1))
    c = min(r * candidate_factor, max(n - 1, 1))
    if keep_closest < 0:
        keep_closest = r // 4
    rc_tag = f"_rc{reverse_candidates}" if reverse_candidates > 0 else ""
    sharded = n > exact_knn_max_n(d, c, dev)  # the bf16 matrix and the lists outgrow the card
    t0 = time.time()
    knn_path = prune_path = key = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        key = _ckpt_key(emb, f"c{c}ex" if sharded else f"c{c}")
        knn_path = os.path.join(checkpoint_dir, "ckpt_knn.npy")
        prune_path = os.path.join(checkpoint_dir, "ckpt_pruned.npy")
        done = _ckpt_load(prune_path, f"{key}_r{r}_a{alpha}_kc{keep_closest}{rc_tag}")
        if done is not None:
            logger.info("build_graph: resumed pruned graph from %s", prune_path)
            times["knn"] = times["prune"] = time.time() - t0
            t0 = time.time()
            out = _fill_reverse_edges(done, np.random.default_rng(0))
            medoid = compute_medoid(emb, dev, host=sharded)
            times["reverse_fill"] = time.time() - t0
            return out, medoid

    knn_ids = _ckpt_load(knn_path, key) if knn_path else None
    knn_resumed = knn_ids is not None
    if knn_resumed:
        logger.info("build_graph: resumed knn candidates from %s", knn_path)
    elif sharded:
        knn_ids, _ = exact_knn_sharded(emb, c, checkpoint_dir=checkpoint_dir or "", device=dev)
    else:
        knn_ids, _ = exact_knn(emb, c, device=dev)
    if knn_path and not knn_resumed:
        _ckpt_save(knn_path, key, knn_ids)
    times["knn"] = time.time() - t0
    logger.info("build_graph knn phase: %.1fs (sharded=%s)", times["knn"], sharded)
    if sharded:
        _trim_host("knn")
    if reverse_candidates > 0 and n > 1:
        knn_ids = _augment_reverse_candidates(np.asarray(knn_ids), reverse_candidates)
    cw = knn_ids.shape[1]

    t0 = time.time()
    d_pad = d + (-d % 16)
    blk = max(8, PRUNE_BLOCK_BYTES // max(cw * (cw + d_pad) * 4, 1))
    pq_mode = n * d * 2 > prune_ebf_max_bytes(dev)
    if pq_mode:
        neighbors = _prune_pq_mode(emb, knn_ids, r, alpha, keep_closest, blk, dev, checkpoint_dir, key)
    else:
        ebf, norms = upload_panel_inputs(emb, dev)
        neighbors = np.empty((n, r), np.int32)
        for s in range(0, n, PRUNE_DISPATCH_ROWS):
            e = min(n, s + PRUNE_DISPATCH_ROWS)
            cand = torch.from_numpy(np.asarray(knn_ids[s:e], np.int64)).to(dev)
            sel = _robust_prune_device(ebf, norms, cand, r, float(alpha), keep_closest, blk, row_start=s)
            neighbors[s:e] = sel.to(torch.int32).cpu().numpy()
        del ebf, norms
    if prune_path:
        _ckpt_save(prune_path, f"{key}_r{r}_a{alpha}_kc{keep_closest}{rc_tag}", neighbors)
    times["prune"] = time.time() - t0
    logger.info("build_graph prune phase: %.1fs (pq=%s)", times["prune"], pq_mode)
    if sharded:
        _trim_host("prune")

    t0 = time.time()
    out = _fill_reverse_edges(neighbors, np.random.default_rng(0))
    medoid = compute_medoid(emb, dev, host=sharded)
    times["reverse_fill"] = time.time() - t0
    logger.info("graph built: N=%d R=%d avg_deg=%.1f medoid=%d", n, r, (out >= 0).mean() * r, medoid)
    return out, medoid
