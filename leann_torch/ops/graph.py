"""Graph construction: exact k-NN candidates, α-robust prune, reverse fill.

Counterpart of the JAX package's ``ops/graph.py``:

  1. candidate k-NN, exact, through the knn_panel CUDA kernel
     (``ops/knn_panel.py``): one card-resident pass (:func:`exact_knn`)
     while the bf16 matrix and the lists fit on the card, else
     :func:`exact_knn_sharded`, which keeps the matrix in host RAM and
     streams query chunks with their running top-k through one bf16 column
     slab at a time; :func:`exact_knn_rows` is the sampled oracle. Past
     the card LEANN_KNN_MODE selects an approximate pass instead, in plain
     torch as the JAX package computes it outside Pallas:
     :func:`spill_knn_streamed` (k-means cells, exact k-NN inside windows
     of the cell order, lists merged over 2 probes) or :func:`nn_descent`
     (cluster bootstrap, then rounds of local joins);
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

from .. import device as _device
from ..device import matmul, resolve_device
from ..embeddings import seeded
from .distance import INF
from .knn_panel import knn_panel, knn_panel_ext, topk_merge, upload_panel_inputs
from .pq import _bucket_sample, decode_pq, encode_pq, train_pq
from .tile_plan import TILE_COLS, list_entries, merge_entries, multiprocessors, plan_launch

logger = logging.getLogger(__name__)

# query rows per knn_panel call: on the card one launch then covers ~1K
# blocks of 128 rows
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
# state and the kernel's lists. LEANN_EXACT_SHARD_BYTES overrides it.
EXACT_SHARD_BYTES = 24 << 30
# query rows per (chunk x shard) launch: as KNN_ROWS_PER_LAUNCH
# (LEANN_EXACT_QCHUNK overrides it)
EXACT_QCHUNK = 1 << 17
# seconds between mid-shard checkpoints of the running state
# (LEANN_EXACT_QCKPT_SECS overrides it)
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


def env_override(name: str, default: "int | float") -> "int | float":
    """The environment variable ``name`` as ``default``'s type where it is
    set, else ``default``: the JAX package's overrides of the build's
    sizes (LEANN_EXACT_SHARD_BYTES, LEANN_EXACT_QCHUNK,
    LEANN_EXACT_QCKPT_SECS, LEANN_PRUNE_EBF_MAX_BYTES,
    LEANN_SPILL_MEMMAP_BYTES, LEANN_DESCENT_HBM_BUDGET), read when the build
    runs, so a variable set before it takes effect."""
    value = os.environ.get(name)
    return default if value is None else type(default)(value)


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


def _exact_row_bytes(d: int, k: int) -> int:
    """Card bytes of one row of the exact pass: its bf16 row, f32 norm and
    list of k candidates (id and distance)."""
    return 2 * (d + (-d % 16)) + 4 + 8 * k


def exact_knn_max_n(d: int, k: int, device: "str | torch.device") -> int:
    """Largest corpus the card-resident exact pass takes on ``device``: its
    rows (:func:`_exact_row_bytes`) must fit in half of the card's total
    memory (re-derived from the card, not the TPU's 16 GB constant). Above
    it build_graph takes :func:`exact_knn_sharded`. The CPU has no such
    cap."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1 << 62
    return int(_device.card_memory(dev)[1] // 2 // _exact_row_bytes(d, k))


def exact_knn_bytes(n: int, d: int, k: int, device: "str | torch.device") -> int:
    """Card bytes :func:`exact_knn` takes over ``n`` rows: every row's share
    as :func:`exact_knn_max_n` counts it, and one launch's partial lists
    and scratch (``tile_plan``'s plan of ``KNN_ROWS_PER_LAUNCH`` rows)."""
    rows = min(n, KNN_ROWS_PER_LAUNCH)
    plan = plan_launch(rows, n, k, d + (-d % 16), multiprocessors(device))
    partial = rows * plan.col_splits * k if plan.col_splits > 1 else 0
    merge = merge_entries(rows, k) if plan.col_splits > 1 else 0
    return n * _exact_row_bytes(d, k) + 8 * (partial + list_entries(plan, rows, k) + merge)


def prune_ebf_max_bytes(device: "str | torch.device") -> int:
    """Largest bf16 corpus matrix the prune keeps on ``device``: half of the
    card's total memory (re-derived from the card, not the TPU's 10 GB).
    Above it the prune decodes candidates from PQ codes. The CPU has no
    such cap. LEANN_PRUNE_EBF_MAX_BYTES, where set, is the cap on either."""
    dev = torch.device(device)
    cap = int(_device.card_memory(dev)[1] // 2) if dev.type == "cuda" else 1 << 62
    return env_override("LEANN_PRUNE_EBF_MAX_BYTES", cap)


def prune_on_pq(n: int, d: int, device: "str | torch.device") -> bool:
    """Whether the prune decodes candidates from PQ codes: the bf16 matrix
    is larger than :func:`prune_ebf_max_bytes`. Where it is not, the card
    must have the room for the matrix and its norms now, else this raises
    (:func:`device.require_room`)."""
    if n * d * 2 > prune_ebf_max_bytes(device):
        return True
    _device.require_room(device, n * (2 * (d + (-d % 16)) + 4), "the prune against the bf16 matrix",
                         "LEANN_PRUNE_EBF_MAX_BYTES=1 (the prune against PQ-decoded rows)")
    return False


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

    ``tile`` and ``approx_recall`` are accepted for the JAX package's
    signature and ignored: the port is always exact, and its grid comes
    from ``tile_plan.plan_launch``. ``query_block`` sets only the state
    files' row count (below). ``shard_bytes``, ``qchunk`` and the
    checkpoint cadence default to ``EXACT_SHARD_BYTES``, ``EXACT_QCHUNK``
    and ``QCKPT_SECS``, or to LEANN_EXACT_SHARD_BYTES, LEANN_EXACT_QCHUNK
    and LEANN_EXACT_QCKPT_SECS where those are set (:func:`env_override`).

    Chunk i + 1 is launched before chunk i's state is copied back (a
    depth-1 pipeline), so the host's write-back hides under the card's
    work. ``checkpoint_dir``: the running state lives in memmaps there and
    is flushed after every shard and every ``QCKPT_SECS`` within one; a
    killed run resumes at the last durable (shard, chunk), after purging
    the unfinished shard's ids from the rows not yet durable. The state
    files go at the end.

    The state files are the JAX package's: ``exknn_state.json`` (the
    corpus key, shards and chunks done, ``rows_per_shard``, ``qchunk``)
    and ``exknn_state_{d,i}.npy`` of ``_bucket_rows(N, qb)`` rows, ``qb =
    max(8, min(query_block, 1024))``, its padded count; the rows past N
    hold INF / -1 and are never read. A state is resumed only at its own
    geometry (``rows_per_shard``, ``qchunk``): one the JAX package wrote
    resumes here when ``shard_bytes`` and ``qchunk`` give its numbers (its
    shards are whole tiles, so ``shard_bytes = rows_per_shard * 2 * D``
    does), else it is discarded with a warning; one this function wrote
    resumes in the JAX package at the same ``shard_bytes`` and ``qchunk`` (a
    multiple of qb) when its ``query_block`` is the one passed here and its
    ``tile`` divides the shard's rows."""
    dev = resolve_device(device)
    n, d = emb.shape
    rows_per_shard = _rows_per_shard(shard_bytes or env_override("LEANN_EXACT_SHARD_BYTES", EXACT_SHARD_BYTES), d)
    n_shards = (n + rows_per_shard - 1) // rows_per_shard
    qchunk = max(1, int(qchunk or env_override("LEANN_EXACT_QCHUNK", EXACT_QCHUNK)))
    qckpt_secs = env_override("LEANN_EXACT_QCKPT_SECS", QCKPT_SECS)
    np_total = _bucket_rows(n, max(8, min(query_block, 1024)))  # the JAX package's state rows

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
                # the state is padded to the JAX package's query blocks: rows past n are unused
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
            run_d = np.lib.format.open_memmap(sd_path, mode="w+", dtype=np.float32, shape=(np_total, k))
            run_i = np.lib.format.open_memmap(si_path, mode="w+", dtype=np.int32, shape=(np_total, k))
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
            if checkpoint_dir and time.time() - t_ckpt > qckpt_secs:
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
    rows_per_shard = _rows_per_shard(shard_bytes or env_override("LEANN_EXACT_SHARD_BYTES", EXACT_SHARD_BYTES), d)
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


# ---------------------------------------------------------------------------
# Approximate k-NN past the card (LEANN_KNN_MODE=spill | descent): the JAX
# package's cluster bootstrap, spill and NN-descent in plain torch (it
# computes them outside Pallas: products, top-k, a scatter)
# ---------------------------------------------------------------------------

# spill scratch arrays larger than this live in memmaps in the checkpoint
# directory (LEANN_SPILL_MEMMAP_BYTES overrides it)
SPILL_MEMMAP_BYTES = 8 << 30
# bound on a k-means step's bf16 one-hot block and its parts ([rows, K])
KMEANS_ONEHOT_BYTES = 256 << 20
# bound on a batch of window products ([W, window, window] f32 and top-k)
WINDOW_BATCH_BYTES = 512 << 20


def _device_budget(dev: torch.device) -> int:
    """Bytes a pass may hold at once on ``dev``: a quarter of the card's
    free memory; on the CPU a fixed 1 GiB. It sizes chunks only (spill's
    uploads, descent's blocks a step), whose size leaves the lists the
    same bit for bit."""
    return int(_device.card_memory(dev)[0] // 4) if dev.type == "cuda" else 1 << 30


def _big_empty(shape, dtype, scratch_dir: str, name: str):
    """np.empty, or a disk-backed w+ memmap in ``scratch_dir`` when the
    array is larger than ``SPILL_MEMMAP_BYTES``."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if scratch_dir and nbytes > env_override("LEANN_SPILL_MEMMAP_BYTES", SPILL_MEMMAP_BYTES):
        os.makedirs(scratch_dir, exist_ok=True)
        path = os.path.join(scratch_dir, name)
        logger.info("spill scratch -> %s (%.1f GB)", path, nbytes / 2**30)
        return np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=tuple(shape))
    return np.empty(shape, dtype)


def _pad_rows(x: np.ndarray, np_total: int, fill=0) -> np.ndarray:
    if x.shape[0] == np_total:
        return x
    pad = np.full((np_total - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def _kmeans_full(x: torch.Tensor, init: torch.Tensor, n_valid: int, n_iters: int,
                 block: int = 4096) -> torch.Tensor:
    """Lloyd's k-means: x f32 [S, D] (rows >= ``n_valid`` are padding),
    init [K, D] -> f32 [K, D]. Assignments per ``block`` rows from bf16
    products with f32 sums; padding rows go to a dropped segment K. The
    cluster sums are one-hot products through ``device.matmul`` (x as three
    bf16 parts), block by block: a float scatter-add would sum in atomic
    order on the card and the centroids would change from run to run, and
    a whole [S, K] one-hot is 8.6 GB at S = K = 65,536. Empty clusters keep
    their centroid."""
    s_total, d = x.shape
    k = init.shape[0]
    dev = x.device
    c = init.float()
    valid = torch.arange(s_total, device=dev) < n_valid
    oh_rows = max(64, KMEANS_ONEHOT_BYTES // (8 * (k + 1)))
    for _ in range(n_iters):
        cn = c.square().sum(dim=1)
        cbf = c.to(torch.bfloat16)
        a = torch.cat([(cn[None, :] - 2.0 * matmul(x[s : s + block].to(torch.bfloat16), cbf.T)).argmin(dim=1)
                       for s in range(0, s_total, block)])
        a = torch.where(valid, a, torch.full_like(a, k))
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        for s in range(0, s_total, oh_rows):
            a_b = a[s : s + oh_rows]
            one_hot = torch.zeros((a_b.shape[0], k + 1), dtype=torch.bfloat16, device=dev)
            one_hot[torch.arange(a_b.shape[0], device=dev), a_b] = 1.0
            one_hot = one_hot[:, :k]
            counts += one_hot.sum(dim=0, dtype=torch.float32)
            sums += matmul(one_hot.T, x[s : s + oh_rows].float())
        c = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c)
    return c


def _centroid_dists(rows: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """|c|^2 - 2 r.c, [rows, K] f32, from the rows and centroids in bf16."""
    cn = cent.float().square().sum(dim=1)
    return cn[None, :] - 2.0 * matmul(rows.to(torch.bfloat16), cent.to(torch.bfloat16).T)


def _assign_clusters(emb: torch.Tensor, cent: torch.Tensor, block: int) -> torch.Tensor:
    """emb [Np, D], cent [K, D] -> nearest centroid, i32 [Np] (blocked)."""
    return torch.cat([_centroid_dists(emb[s : s + block], cent).argmin(dim=1)
                      for s in range(0, emb.shape[0], block)]).to(torch.int32)


def _assign_clusters_topk(emb: torch.Tensor, cent: torch.Tensor, block: int, p: int) -> torch.Tensor:
    """emb [Np, D], cent [K, D] -> the ``p`` nearest centroids, i32 [Np, p]."""
    return torch.cat([torch.topk(-_centroid_dists(emb[s : s + block], cent), p, dim=1).indices
                      for s in range(0, emb.shape[0], block)]).to(torch.int32)


def _window_knn_device(ebf: torch.Tensor, norms: torch.Tensor, n_real: int, k: int,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN inside consecutive windows of ``window`` rows -> (ids
    i32 [Np, k] as row numbers of ``ebf``, -1 where fewer than k, dists f32
    [Np, k]). ebf bf16 [Np, D] (Np a multiple of ``window``), norms f32
    [Np]; rows >= ``n_real`` are padding, never a neighbor; self excluded.
    Windows go through in batches of one bf16 product each, top-k by
    ``torch.topk`` (the JAX package's ``lax.top_k``, outside Pallas)."""
    np_total, d = ebf.shape
    dev = ebf.device
    n_win = np_total // window
    per = max(1, WINDOW_BATCH_BYTES // (12 * window * window))
    loc = torch.arange(window, device=dev)
    self_mask = loc[:, None] == loc[None, :]
    out_i, out_d = [], []
    for w0 in range(0, n_win, per):
        nw = min(per, n_win - w0)
        we = ebf[w0 * window : (w0 + nw) * window].view(nw, window, d)
        wn = norms[w0 * window : (w0 + nw) * window].view(nw, window)
        dmat = wn[:, :, None] + wn[:, None, :] - 2.0 * matmul(we, we.transpose(1, 2))
        start = (w0 + torch.arange(nw, device=dev)) * window
        bad = ((start[:, None] + loc[None, :]) >= n_real)[:, None, :] | self_mask[None]
        dmat = dmat.masked_fill(bad, INF)
        neg, pos = torch.topk(-dmat, k, dim=2)
        dist = -neg
        ids = torch.where(dist < INF, pos + start[:, None, None], torch.full_like(pos, -1))
        out_i.append(ids.reshape(nw * window, k).to(torch.int32))
        out_d.append(dist.reshape(nw * window, k))
    return torch.cat(out_i), torch.cat(out_d)


def _train_cells(sample: np.ndarray, n_clusters: int, rng: np.random.Generator, n_iters: int,
                 dev: torch.device) -> torch.Tensor:
    """k-means centroids of an f32 host sample, initialised at
    ``n_clusters`` of its rows drawn by ``rng`` (the JAX package's draw)."""
    init_c = sample[rng.choice(sample.shape[0], n_clusters, replace=False)]
    return _kmeans_full(torch.from_numpy(np.ascontiguousarray(sample)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(init_c)).to(dev), sample.shape[0], n_iters)


def _window_lists(emb: np.ndarray, exp_orig: np.ndarray, k: int, window: int, chunk_rows: int,
                  norms_of_bf16: bool, dev: torch.device, scratch_dir: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """The window k-NN over the expanded rows ``emb[exp_orig]``, streamed
    through the device ``chunk_rows`` (a multiple of ``window``) at a time
    -> (original node ids i32 [E, k], -1 where none; dists f32 [E, k]). Each
    chunk's rows are gathered on the host by torch's threads, go up in the
    matrix's type and are cast to bf16 there; their norms are those of the
    bf16 rows (``norms_of_bf16``, spill) or of the f32 rows (the cluster
    bootstrap). Windows are chunk-aligned, so the lists do not depend on
    ``chunk_rows``."""
    ne = exp_orig.shape[0]
    ids = _big_empty((ne, k), np.int32, scratch_dir, "spill_exp_ids.npy")
    dists = _big_empty((ne, k), np.float32, scratch_dir, "spill_exp_d.npy")
    src = torch.from_numpy(np.asarray(emb))
    order = torch.from_numpy(np.asarray(exp_orig, np.int64))
    t0 = time.time()
    for ci, s in enumerate(range(0, ne, chunk_rows)):
        if ci % 8 == 7:
            logger.info("spill_knn window: %d/%d rows (%.0fs)", s, ne, time.time() - t0)
        e = min(s + chunk_rows, ne)
        node = order[s:e]
        rows = src.index_select(0, node).to(dev).float()
        pad = -(e - s) % window
        ebf = torch.nn.functional.pad(rows.to(torch.bfloat16), (0, 0, 0, pad))
        norms = torch.nn.functional.pad((ebf.float() if norms_of_bf16 else rows).square().sum(dim=1), (0, pad))
        del rows
        ids_c, dists_c = _window_knn_device(ebf, norms, e - s, k, window)
        del ebf, norms
        # chunk-local row numbers -> expanded positions -> original node ids
        ids_c = ids_c[: e - s].long()
        node = node.to(dev)
        ids[s:e] = torch.where(ids_c >= 0, node[ids_c.clamp_min(0)], ids_c).to(torch.int32).cpu().numpy()
        dists[s:e] = dists_c[: e - s].cpu().numpy()
    logger.info("spill_knn window pass: %.1fs (%d chunks)", time.time() - t0, -(-ne // chunk_rows))
    return ids, dists


def _chunk_rows(d: int, k: int, window: int, dev: torch.device) -> int:
    """Expanded rows per window-pass upload: the f32 rows, their bf16 copy
    and the lists within :func:`_device_budget`, a multiple of ``window``."""
    rows = _device_budget(dev) // (6 * d + 16 * k + 16)
    return max(window, (int(rows) // window) * window)


def cluster_window_init(
    emb: np.ndarray, k: int, window: int = 2048, seed: int = 0,
    points_per_cluster: int = 64, kmeans_sample: int = 65536, kmeans_iters: int = 8,
    n_probe: int = 1, device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """IVF-style k-NN init (NN-descent's cluster bootstrap): k-means on a
    sample -> rows sorted by cluster -> exact k-NN inside fixed windows of
    the sorted order -> (ids i32[N, k], dists f32[N, k], INF / -1 where
    none). ``n_probe > 1``: each row enters the windows of its ``n_probe``
    nearest clusters and its lists are merged and deduplicated
    (:func:`_merge_spill_lists`), so boundary rows see both sides of their
    cluster split. The JAX package's host steps, draw for draw: an unsorted
    sample, the cluster and sample counts, stable sorts; norms of the f32
    rows."""
    dev = resolve_device(device)
    n, d = emb.shape
    rng = np.random.default_rng(seed)
    n_clusters = max(8, min(n // points_per_cluster, 65536))
    # the sample must be able to populate the clusters (>= 8 rows each); a
    # power of two, as the JAX package buckets it
    s_target = min(n, max(kmeans_sample, 8 * n_clusters))
    s_count = 1 << (max(s_target, 2).bit_length() - 1)
    sample = np.asarray(emb[rng.choice(n, min(s_count, n), replace=False)], np.float32)
    cent = _train_cells(sample, n_clusters, rng, kmeans_iters, dev)

    chunk = _chunk_rows(d, max(k, n_probe), window, dev)
    parts = []
    for s in range(0, n, chunk):
        rows = torch.from_numpy(np.asarray(emb[s : s + chunk], np.float32)).to(dev)
        parts.append((_assign_clusters(rows, cent, 8192)[:, None] if n_probe <= 1 else
                      _assign_clusters_topk(rows, cent, 8192, n_probe)).cpu().numpy())
    assign = np.concatenate(parts)
    if n_probe <= 1:
        exp_orig = np.argsort(assign[:, 0], kind="stable").astype(np.int64)  # each row appears once
    else:
        exp_node = np.repeat(np.arange(n, dtype=np.int64), n_probe)
        exp_orig = exp_node[np.argsort(assign.reshape(-1), kind="stable")]  # node of each expanded row
    ids, dists_w = _window_lists(emb, exp_orig, k, window, chunk, False, dev)
    if n_probe <= 1:
        out_ids = np.full((n, k), -1, np.int32)
        out_d = np.full((n, k), np.float32(INF), np.float32)
        out_ids[exp_orig] = ids
        out_d[exp_orig] = dists_w
        return out_ids, out_d
    return _merge_spill_lists(ids, dists_w, exp_orig, n, n_probe, k, device=dev)


def _merge_spill_lists(ids: np.ndarray, dists: np.ndarray, exp_orig: np.ndarray,
                       n: int, n_probe: int, k: int, row_block: int = 1 << 20,
                       scratch_dir: str = "", device: "str | torch.device" = "cpu") -> Tuple[np.ndarray, np.ndarray]:
    """Merge each node's ``n_probe`` window lists -> its k best, deduplicated
    (ids i32[N, k], dists f32[N, k]); ids / dists are host arrays [N
    n_probe, k] in expanded-row order and ``exp_orig`` maps expanded rows to
    nodes. ``row_block`` nodes at a time go to ``device`` and back into the
    host outputs (memmaps in ``scratch_dir`` past ``SPILL_MEMMAP_BYTES``).
    The JAX package's three stable sorts, bit for bit: by distance, then by
    id (the best distance of an id first), repeats blanked, then by
    distance again. The JAX package sorts row by row in host numpy on one
    core, which at 1M nodes takes longer than the rest of the pass; here
    the same stable sorts run on the device."""
    dev = torch.device(device)
    pos_by_node = torch.from_numpy(np.argsort(exp_orig, kind="stable"))  # node-major: [n n_probe]
    src_i, src_d = torch.from_numpy(np.asarray(ids)), torch.from_numpy(np.asarray(dists))
    out_ids = _big_empty((n, k), np.int32, scratch_dir, "spill_out_ids.npy")
    out_d = _big_empty((n, k), np.float32, scratch_dir, "spill_out_d.npy")
    for s in range(0, n, row_block):
        e = min(s + row_block, n)
        pos = pos_by_node[s * n_probe : e * n_probe]  # gathered on the host by torch's threads
        ids_cat = src_i.index_select(0, pos).to(dev).long().reshape(e - s, n_probe * k)
        d_cat = src_d.index_select(0, pos).to(dev).float().reshape(e - s, n_probe * k)
        own = torch.arange(s, e, device=dev)[:, None]
        self_or_pad = (ids_cat == own) | (ids_cat < 0)
        d_cat = d_cat.masked_fill(self_or_pad, INF)
        ids_cat = ids_cat.masked_fill(self_or_pad, -1)
        d1, o1 = torch.sort(d_cat, dim=1, stable=True)
        ids2, o2 = torch.sort(ids_cat.gather(1, o1), dim=1, stable=True)
        d2 = d1.gather(1, o2)
        dup = torch.zeros_like(ids2, dtype=torch.bool)
        dup[:, 1:] = (ids2[:, 1:] == ids2[:, :-1]) & (ids2[:, 1:] >= 0)
        d2 = d2.masked_fill(dup, INF)
        ids2 = ids2.masked_fill(dup, -1)
        bd, o3 = torch.sort(d2, dim=1, stable=True)
        bd = bd[:, :k]
        bi = ids2.gather(1, o3[:, :k]).masked_fill(bd >= INF, -1)
        out_ids[s:e] = bi.to(torch.int32).cpu().numpy()
        out_d[s:e] = bd.cpu().numpy()
    return out_ids, out_d


def spill_knn_streamed(
    emb: np.ndarray, k: int, window: int = 2048, n_probe: int = 2, seed: int = 0,
    points_per_cluster: int = 64, kmeans_sample: int = 65536, kmeans_iters: int = 8,
    chunk_rows: Optional[int] = None, scratch_dir: str = "", device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """``LEANN_KNN_MODE=spill``: :func:`cluster_window_init` at ``n_probe``
    probes for a matrix that stays in host RAM (f32 or f16, a memmap
    allowed); the card sees ``chunk_rows`` rows at a time (default: sized
    from its free memory; a multiple of ``window``) for the assignment and
    for the window pass, which are chunk-local. It differs from
    :func:`cluster_window_init` as the JAX package's does: the k-means
    sample is sorted, and the norms are those of the bf16 rows. Approximate:
    a row's candidates are the rows of its clusters' windows. ``scratch_dir``
    takes the expanded lists and the output as memmaps past
    ``SPILL_MEMMAP_BYTES`` -> (ids i32[N, k], dists f32[N, k])."""
    dev = resolve_device(device)
    n, d = emb.shape
    chunk_rows = chunk_rows or _chunk_rows(d, k, window, dev)
    if chunk_rows % window:
        raise ValueError(f"chunk_rows={chunk_rows} is not a multiple of window={window}")
    rng = np.random.default_rng(seed)
    n_clusters = max(8, min(n // points_per_cluster, 65536))
    s_target = min(n, max(kmeans_sample, 8 * n_clusters))
    s_count = 1 << (max(s_target, 2).bit_length() - 1)
    sample = np.asarray(emb[np.sort(rng.choice(n, min(s_count, n), replace=False))], np.float32)
    cent = _train_cells(sample, n_clusters, rng, kmeans_iters, dev)

    t0 = time.time()
    assign = np.empty((n, n_probe), np.int32)
    for ci, s in enumerate(range(0, n, chunk_rows)):
        e = min(s + chunk_rows, n)
        rows = torch.from_numpy(np.asarray(emb[s:e], np.float32)).to(dev)
        assign[s:e] = _assign_clusters_topk(rows, cent, 8192, n_probe).cpu().numpy()
        if ci % 8 == 7:
            logger.info("spill_knn assign: %d/%d rows (%.0fs)", e, n, time.time() - t0)
    logger.info("spill_knn assign: %.1fs", time.time() - t0)

    exp_node = np.repeat(np.arange(n, dtype=np.int64), n_probe)
    exp_orig = exp_node[np.argsort(assign.reshape(-1), kind="stable")]
    del exp_node, assign
    ids, dists = _window_lists(emb, exp_orig, k, window, chunk_rows, True, dev, scratch_dir)
    out = _merge_spill_lists(ids, dists, exp_orig, n, n_probe, k, scratch_dir=scratch_dir, device=dev)
    if isinstance(ids, np.memmap):  # the expanded lists are dead after the merge
        del ids, dists
        for f in ("spill_exp_ids.npy", "spill_exp_d.npy"):
            try:
                os.remove(os.path.join(scratch_dir, f))
            except OSError:
                pass
    return out


def _reverse_edges_device(nbrs: torch.Tensor, key: np.ndarray, cap: int, rows_per_chunk: int = 0) -> torch.Tensor:
    """Sampled reverse edges: up to ``cap`` in-edges per node -> i32 [Np,
    cap], -1 where empty. Each edge (i -> j) throws i at a random slot of
    row j (``jax.random.randint(key, (Np k,), 0, cap)``'s draws), drawn and
    thrown ``rows_per_chunk`` source rows at a time (all at once for 0): a
    slot's draw hashes its flat index, so every split gives the same slots.
    Where edges collide on a slot, the one with the largest flat index over
    [Np, k] wins, in any order of writes: the JAX package's scatter keeps
    the last write, which on the CPU is the largest index, while a CUDA
    scatter with duplicates keeps any one. A flat index orders by its
    source row first, so the winner is the largest source row:
    ``scatter_reduce`` "amax" of the rows."""
    np_total, k = nbrs.shape
    dev = nbrs.device
    step = rows_per_chunk or np_total
    rev = torch.full((np_total * cap,), -1, dtype=torch.int32, device=dev)
    for s in range(0, np_total, step):
        e = min(s + step, np_total)
        slot = seeded.randint_range(key, s * k, e * k, 0, cap, dev)
        dst = nbrs[s:e].reshape(-1).long()
        ok = dst >= 0
        src = torch.arange(s, e, dtype=torch.int32, device=dev).repeat_interleave(k)
        rev.scatter_reduce_(0, (dst * cap + slot)[ok], src[ok], reduce="amax")
        del slot, dst, ok, src
    return rev.view(np_total, cap)


def _nn_descent_iter(ebf: torch.Tensor, norms: torch.Tensor, nbrs: torch.Tensor, rev: torch.Tensor,
                     old_dists: torch.Tensor, n_real: int, row_start: int, od_base: int, key: np.ndarray,
                     k: int, k2: int, h: int, n_rand: int, block: int,
                     n_blocks: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One NN-descent round over ``n_blocks`` blocks of ``block`` rows from
    ``row_start`` -> (ids i32 [rows, k], dists f32 [rows, k], slots
    improved). Per row: its neighbors, its sampled reverse edges, the
    forward and reverse lists of ``h`` closest-first plus random neighbor
    seeds and ``h`` random reverse seeds (``k2`` each), and ``n_rand``
    random rows (drawn per block with ``fold_in(k_rand, s // block)``);
    self and padding dropped, sorted and deduplicated, scored against the
    row by bf16 products with f32 sums, the k nearest kept. ``old_dists``
    holds the previous distances of rows from ``od_base``. A slot counts as
    improved where its sorted distance fell by more than 0.1%. The JAX
    package's round, candidate for candidate."""
    np_total, d = ebf.shape
    dev = ebf.device
    _, k_hop1, k_hop2, k_rand = seeded.split(key, 4)
    n_close = max(1, h // 2)
    cols1 = torch.from_numpy(np.concatenate([
        np.arange(n_close, dtype=np.int64),
        seeded.permutation(k_hop1, k - n_close)[: h - n_close].astype(np.int64) + n_close])).to(dev)
    cols2 = torch.from_numpy(seeded.permutation(k_hop2, k)[:h].astype(np.int64)).to(dev)
    out_i = torch.empty((n_blocks * block, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((n_blocks * block, k), dtype=torch.float32, device=dev)
    changed = torch.zeros((), dtype=torch.int64, device=dev)
    # several blocks a step (the rows are independent; only the random
    # escapes are drawn per block): the [rows, C, D] gather within half the
    # device budget
    c_width = 2 * k + 4 * h * k2 + n_rand
    per_step = max(1, _device_budget(dev) // 2 // (block * c_width * d * 2))
    first_blk = row_start // block
    for g in range(0, n_blocks, per_step):
        ng = min(per_step, n_blocks - g)
        s, rows = row_start + g * block, ng * block
        keys = seeded.fold_in(k_rand, np.arange(first_blk + g, first_blk + g + ng))
        rand = seeded.randint_many(keys, block * n_rand, 0, max(n_real, 1), dev).reshape(rows, n_rand)
        nb = nbrs[s : s + rows].long()
        rv = rev[s : s + rows].long()
        od = old_dists[s - od_base : s - od_base + rows]
        hop_seed = torch.cat([nb[:, cols1], rv[:, cols2]], dim=1)  # [rows, 2h]
        seed_safe = hop_seed.clamp(0, np_total - 1)
        # both directions through each seed: its neighbors and its reverse edges
        two = torch.cat([nbrs[seed_safe, :k2], rev[seed_safe, :k2]], dim=1).reshape(rows, 4 * h * k2).long()
        # (the JAX package's mask: seed i blanks the 2 k2 columns from i 2 k2)
        two = two.masked_fill((hop_seed < 0).repeat_interleave(2 * k2, dim=1), -1)
        cand = torch.cat([nb, rv, two, rand], dim=1)
        row_ids = torch.arange(s, s + rows, device=dev)[:, None]
        cand = cand.masked_fill((cand == row_ids) | (cand >= n_real), -1)
        cand = cand.sort(dim=1).values
        dup = torch.zeros_like(cand, dtype=torch.bool)
        dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
        cid = cand.masked_fill(dup, -1)
        safe = cid.clamp(0, np_total - 1)
        dots = matmul(ebf[safe], ebf[s : s + rows, :, None])[:, :, 0]
        dist = norms[s : s + rows, None] + norms[safe] - 2.0 * dots
        dist = dist.masked_fill(cid < 0, INF)
        neg, pos = torch.topk(-dist, k, dim=1)
        d_b = -neg
        ids_b = torch.where(d_b < INF, cid.gather(1, pos), torch.full_like(pos, -1))
        real = row_ids < n_real  # padding rows stay neighborless: they emit no reverse edge
        ids_b = ids_b.masked_fill(~real, -1)
        changed += ((d_b < od * (1.0 - 1e-3)) & real).sum()
        out_i[g * block : g * block + rows] = ids_b.to(torch.int32)
        out_d[g * block : g * block + rows] = d_b
    return out_i, out_d, int(changed)


# card bytes a slot holds while its chunk of the reverse-edge draw is drawn
# and thrown: the draw (8), destination, target and their masked copies
# (32), source row and its masked copy (8), mask (1); the hash's own
# temporaries are bounded by its chunk of counters (seeded._CHUNK)
REV_DRAW_SLOT_BYTES = 56


def _rows_within(nbytes: float, row_bytes: int, np_total: int, block: int) -> int:
    """Rows of ``row_bytes`` each within ``nbytes``: a multiple of ``block``
    between one block and ``np_total``."""
    rows = int(min(nbytes / row_bytes, np_total))
    return min(np_total, max(block, rows // block * block))


def descent_budget(device: "str | torch.device", free: bool = False) -> float:
    """Card bytes above which :func:`nn_descent` keeps its distances and
    round outputs in host RAM: half of the card's total memory (re-derived
    from the card, not the TPU's 12.5e9); none on the CPU. With ``free``,
    half of what is free now: the bytes within which it sizes each chunk
    of the reverse-edge draw and of a host-resident round, whose size
    leaves the lists the same bit for bit.
    LEANN_DESCENT_HBM_BUDGET, where set, is either budget on either."""
    dev = torch.device(device)
    budget = float(_device.card_memory(dev)[0 if free else 1] // 2) if dev.type == "cuda" else float("inf")
    return env_override("LEANN_DESCENT_HBM_BUDGET", budget)


def nn_descent(
    emb: np.ndarray, k: int, n_iters: int = 16, block: int = 2048, seed: int = 0,
    min_update_frac: float = 0.03, bootstrap: str = "cluster", checkpoint_dir: str = "",
    device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """``LEANN_KNN_MODE=descent``: an approximate k-NN graph by NN-descent,
    O(N C D) a round -> (ids i32[N, k], dists f32[N, k]). Bootstrap above
    4,096 rows: :func:`cluster_window_init` at 2 probes; below, k random
    other rows. Each round (:func:`_nn_descent_iter`) joins the rows'
    neighbors, sampled reverse edges (:func:`_reverse_edges_device`), 2-hop
    seeds and random escapes; it stops once the improved slots have peaked
    and fallen below ``min_update_frac`` of N k. The round's key is
    ``fold_in(key(seed), it)``, so the candidate stream is the JAX
    package's and a resumed run replays the killed run's.

    The bf16 matrix, the lists and the reverse edges live on the card;
    past :func:`descent_budget` the distances and each round's output stay
    in host RAM and stream through in chunks (the same lists). Each round's
    reverse-edge draw goes in chunks of rows within what the budget leaves
    (the same slots). The [block,
    C, D] gather is capped at 256 MB; the block fixes the random escapes'
    stream. ``checkpoint_dir``: the JAX package's state files
    (``nd_state_{i,d}.npy``, ``nd_state.json`` with the corpus key, the
    next round and the last count), written after the bootstrap and at most
    every LEANN_EXACT_QCKPT_SECS seconds after a round, resumed when the key
    matches, removed at the end; either package resumes the other's."""
    dev = resolve_device(device)
    n, d = emb.shape
    h = min(k, max(4, 512 // max(k, 1)))  # 2-hop seed columns
    k2 = min(k, 32)  # neighbors gathered per seed
    n_rand = max(4, k // 4)
    c_est = 2 * k + 4 * h * k2 + n_rand
    mem_cap = max(64, int((256 << 20) / max(c_est * d * 2, 1)))
    block = max(8, (min(block, mem_cap) // 8) * 8)
    np_total = _bucket_rows(n, block)

    nd_key = ""
    start_it, prev_changed0 = 0, None
    nd_i_path = nd_d_path = nd_meta_path = ""
    nbrs0 = dists0 = None

    def save_state(ids: np.ndarray, dists: np.ndarray, it: int, prev) -> None:
        np.save(nd_i_path + ".tmp.npy", ids)
        np.save(nd_d_path + ".tmp.npy", dists)
        os.replace(nd_i_path + ".tmp.npy", nd_i_path)
        os.replace(nd_d_path + ".tmp.npy", nd_d_path)
        tmp = nd_meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"key": nd_key, "iter": it, "prev_changed": prev}, f)
        os.replace(tmp, nd_meta_path)

    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        nd_key = _ckpt_key(emb, f"k{k}nd_{bootstrap}_s{seed}")
        nd_i_path = os.path.join(checkpoint_dir, "nd_state_i.npy")
        nd_d_path = os.path.join(checkpoint_dir, "nd_state_d.npy")
        nd_meta_path = os.path.join(checkpoint_dir, "nd_state.json")
        if os.path.exists(nd_meta_path):
            try:
                with open(nd_meta_path) as f:
                    m = json.load(f)
            except Exception:
                m = {}
            if m.get("key") == nd_key and os.path.exists(nd_i_path) and os.path.exists(nd_d_path):
                nbrs0 = np.load(nd_i_path)
                dists0 = np.load(nd_d_path)
                start_it = int(m.get("iter", 0))
                prev_changed0 = m.get("prev_changed")
                logger.info("nn_descent: resumed at iter %d from %s", start_it, nd_meta_path)

    if nbrs0 is not None:
        pass
    elif bootstrap == "cluster" and n > 4096:
        t0 = time.time()
        nbrs0, dists0 = cluster_window_init(emb, k, seed=seed, n_probe=2, device=dev)
        logger.info("nn_descent cluster init: %.1fs", time.time() - t0)
        if checkpoint_dir:  # the bootstrap is the longest stretch without a state
            save_state(nbrs0, dists0, 0, None)
    else:
        rng = np.random.default_rng(seed)
        nbrs0 = rng.integers(0, n - 1, size=(n, k)).astype(np.int32)
        nbrs0 = np.where(nbrs0 >= np.arange(n)[:, None], nbrs0 + 1, nbrs0)  # no self
        dists0 = np.full((n, k), np.float32(INF), np.float32)
    # on the card: the bf16 matrix and f32 norms; a slot's list, reverse
    # edge and distance (12 B) and the next round's list and distance (8 B).
    # Host-resident state keeps a slot's list and reverse edge there (8 B)
    matrix = np_total * (2 * d + 4)
    est_dev = matrix + np_total * k * 20
    budget = descent_budget(dev)
    host_state = est_dev > budget
    if host_state:
        logger.info("nn_descent: host-resident state (est %.1f GB on the card > budget %.1f GB)",
                    est_dev / 1e9, budget / 1e9)
        _device.require_room(dev, matrix + np_total * k * 8, "NN-descent's matrix and lists on the card",
                             "LEANN_KNN_MODE=spill (the window pass, a chunk of rows on the card at a time)")
    else:
        _device.require_room(dev, est_dev, "NN-descent's state on the card",
                             "LEANN_DESCENT_HBM_BUDGET=1 (its distances and round outputs in host RAM)")
    state = matrix + np_total * k * (8 if host_state else 20)
    left = max(descent_budget(dev, free=True) - state, 0.0)
    # what is left bounds each reverse-edge draw and, in host RAM, each
    # round's chunk of rows (their distances in, lists and distances out)
    rev_rows = _rows_within(left, k * REV_DRAW_SLOT_BYTES, np_total, block)
    rows_per_dispatch = _rows_within(left, k * 12, np_total, block) if host_state else np_total
    nbrs_h = _pad_rows(np.asarray(nbrs0, np.int32), np_total, fill=-1)
    dists_h = _pad_rows(np.asarray(dists0, np.float32), np_total, fill=np.float32(INF))
    # copies: on the CPU a tensor from numpy shares the host arrays written below
    nbrs = torch.from_numpy(nbrs_h).to(dev, copy=True)
    # bf16 rows cast on the card block by block; f32 norms of the f32 rows
    # from the host, as the JAX package takes them
    ebf = torch.zeros((np_total, d), dtype=torch.bfloat16, device=dev)
    norms_h = np.zeros(np_total, np.float32)
    for s in range(0, n, HOST_BLOCK_ROWS):
        b32 = np.asarray(emb[s : s + HOST_BLOCK_ROWS], dtype=np.float32)
        ebf[s : s + b32.shape[0]] = torch.from_numpy(b32).to(dev).to(torch.bfloat16)
        norms_h[s : s + b32.shape[0]] = np.einsum("ij,ij->i", b32, b32)
    norms = torch.from_numpy(norms_h).to(dev)
    dists = None if host_state else torch.from_numpy(dists_h).to(dev, copy=True)
    base_key = seeded.key(seed)
    qckpt_secs = env_override("LEANN_EXACT_QCKPT_SECS", QCKPT_SECS)
    prev_changed = prev_changed0
    t_ckpt = time.time()
    for it in range(start_it, n_iters):
        t0 = time.time()
        rev_key, it_key = seeded.split(seeded.fold_in(base_key, it), 2)
        rev = _reverse_edges_device(nbrs, rev_key, k, rev_rows)
        if host_state:
            changed = 0
            for s in range(0, np_total, rows_per_dispatch):
                rows = min(rows_per_dispatch, np_total - s)
                od_c = torch.from_numpy(np.ascontiguousarray(dists_h[s : s + rows])).to(dev)
                ids_c, d_c, chg = _nn_descent_iter(ebf, norms, nbrs, rev, od_c, n, s, s, it_key, k, k2, h,
                                                   n_rand, block, rows // block)
                nbrs_h[s : s + rows] = ids_c.cpu().numpy()
                dists_h[s : s + rows] = d_c.cpu().numpy()
                changed += chg
            del nbrs, rev  # the old round's lists go before the new ones come up
            nbrs = torch.from_numpy(nbrs_h).to(dev, copy=True)
        else:
            nbrs, dists, changed = _nn_descent_iter(ebf, norms, nbrs, rev, dists, n, 0, 0, it_key, k, k2, h,
                                                    n_rand, block, np_total // block)
            del rev
        logger.info("nn_descent iter %d: %.3f%% slots improved (%.2fs)", it, 100 * changed / (n * k),
                    time.time() - t0)
        if checkpoint_dir and time.time() - t_ckpt > qckpt_secs:
            save_state(nbrs_h if host_state else nbrs.cpu().numpy(),
                       dists_h if host_state else dists.cpu().numpy(), it + 1, changed)
            t_ckpt = time.time()
        # stop once the join has peaked AND fallen below the floor: on
        # clustered corpora the improved fraction first rises through a
        # connectivity transition
        if changed < min_update_frac * n * k and (prev_changed is None or changed < prev_changed):
            break
        prev_changed = changed
    if checkpoint_dir:  # done: the caller saves ckpt_knn.npy next
        for p in (nd_i_path, nd_d_path, nd_meta_path):
            try:
                os.remove(p)
            except OSError:
                pass
    if host_state:
        return nbrs_h[:n], dists_h[:n]
    return nbrs.cpu().numpy()[:n], dists.cpu().numpy()[:n]


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
        pe = ebf[row_start + s : row_start + s + block]
        pn = norms[row_start + s : row_start + s + block]
        safe = cid.clamp(0, n - 1)
        cemb = ebf[safe]  # [B, C, D]
        cn = norms[safe]
        dots = matmul(cemb, pe[:, :, None])[:, :, 0]
        d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
        cc = matmul(cemb, cemb.transpose(1, 2))
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
        p = pe[s : s + block]
        pn = p.float().square().sum(dim=1)
        cemb = decode_pq(cbf, codes[cid.clamp(0, n - 1)])  # [B, C, D] bf16
        cn = cemb.float().square().sum(dim=2)
        dots = matmul(cemb, p[:, :, None])[:, :, 0]
        d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
        cc = matmul(cemb, cemb.transpose(1, 2))
        d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * cc
        out.append(_prune_select(cid, d_pc, d_cc, r, alpha, keep_closest))
    return torch.cat(out)


def robust_prune_explicit(p_emb: torch.Tensor, cand_ids: torch.Tensor, cand_emb: torch.Tensor, r: int,
                          alpha: float, keep_closest: int) -> torch.Tensor:
    """Vamana robust prune over explicit candidate embeddings: p_emb f32
    [B, D] of the nodes, cand_ids [B, C] (-1 invalid), cand_emb f32
    [B, C, D] -> selected ids i64[B, R]. The incremental insert's variant of
    :func:`_robust_prune_device`: its candidates come from a search of the
    live index, whose embeddings may exist only as re-encodes, so the caller
    passes the gathered block. Products of bf16-rounded operands in f32,
    squared norms of the f32 rows, as the JAX package's einsums."""
    pe = p_emb.to(torch.bfloat16)
    ce = cand_emb.to(torch.bfloat16)
    pn = p_emb.float().square().sum(dim=1)
    cn = cand_emb.float().square().sum(dim=-1)
    dots = matmul(ce, pe[:, :, None])[:, :, 0]
    cid = cand_ids.long()
    d_pc = torch.where(cid >= 0, pn[:, None] + cn - 2.0 * dots, torch.full_like(dots, INF))
    d_cc = cn[:, :, None] + cn[:, None, :] - 2.0 * matmul(ce, ce.transpose(1, 2))
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


def medoid_on_host(n: int, d: int, device: "str | torch.device") -> bool:
    """Whether :func:`compute_medoid` takes its host pass: the f32 matrix
    and its centred copy would take more than half of the card's total
    memory. Where they would not, the card must have the room now, else
    this raises (:func:`device.require_room`)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return False
    if n * d * 8 > _device.card_memory(dev)[1] // 2:
        return True
    _device.require_room(dev, n * d * 8, "the medoid's pass on the card",
                         "compute_medoid(..., host=True), which build_graph takes past exact_knn_max_n")
    return False


def compute_medoid(emb: np.ndarray, device: "str | torch.device" = "cuda", host: bool = False) -> int:
    """Row closest to the mean. On the card unless ``host`` or
    :func:`medoid_on_host`; then a host pass over blocks of rows (the mean
    in f64)."""
    dev = resolve_device(device)
    n, d = emb.shape
    if host or medoid_on_host(n, d, dev):
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
    :func:`exact_knn_max_n` the k-NN is :func:`exact_knn_sharded`, or, as
    LEANN_KNN_MODE says, :func:`spill_knn_streamed` ("spill") or
    :func:`nn_descent` ("descent"); above :func:`prune_ebf_max_bytes` the
    prune decodes candidates from PQ codes.
    The candidate lists stay on the host and go up ``PRUNE_DISPATCH_ROWS``
    rows at a time.

    ``checkpoint_dir``: each phase's output (k-NN candidates, pruned
    neighbors, the prune's PQ codes) is saved there, keyed on a corpus hash
    and the phase's parameters, and a rerun resumes at the last finished
    phase, also from a directory the JAX package wrote (the sharded k-NN's
    mid-phase state only where its geometry matches: see
    :func:`exact_knn_sharded`; NN-descent's state). The k-NN checkpoint's
    key names the pass as the JAX package's does (``c{C}ex`` exact past the
    card, ``c{C}nd`` descent, ``c{C}`` otherwise). The k-NN grid comes from
    ``tile_plan.plan_launch`` and the prune's block from
    ``PRUNE_BLOCK_BYTES``. ``phase_seconds``, when given, receives the wall
    time of each phase."""
    dev = resolve_device(device)
    times = phase_seconds if phase_seconds is not None else {}
    n, d = emb.shape
    r = min(r, max(n - 1, 1))
    c = min(r * candidate_factor, max(n - 1, 1))
    # LEANN_KNN_CANDIDATES pins the candidate width apart from R, as in the
    # JAX package: the k-NN's cost and its checkpoint key depend on c alone,
    # so a degree sweep reuses a saved ckpt_knn.npy
    c_env = int(os.environ.get("LEANN_KNN_CANDIDATES", "0") or 0)
    if c_env > 0:
        if c_env < r:
            logger.warning("LEANN_KNN_CANDIDATES=%d < graph degree R=%d; clamping to R", c_env, r)
        c = min(max(c_env, r), max(n - 1, 1))
    if keep_closest < 0:
        keep_closest = r // 4
    rc_tag = f"_rc{reverse_candidates}" if reverse_candidates > 0 else ""
    sharded = n > exact_knn_max_n(d, c, dev)  # the bf16 matrix and the lists outgrow the card
    # past the card LEANN_KNN_MODE picks the candidate pass, as in the JAX
    # package: "spill" and "descent" the approximate ones, any other value
    # (or none) the exact sharded pass. Below the card it is not read
    knn_mode = os.environ.get("LEANN_KNN_MODE", "exact") if sharded else "small"
    t0 = time.time()
    knn_path = prune_path = key = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        key = _ckpt_key(emb, {"exact": f"c{c}ex", "descent": f"c{c}nd"}.get(knn_mode, f"c{c}"))
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
    elif knn_mode == "spill":
        # window / cluster heuristic over the host-resident matrix: cheap,
        # approximate (13% candidate recall at 10M in the JAX package)
        knn_ids, _ = spill_knn_streamed(emb, c, scratch_dir=checkpoint_dir, device=dev)
    elif knn_mode == "descent":
        # cluster-bootstrapped NN-descent, O(N C D) a round where the exact
        # pass is O(N^2 D); the bf16 matrix stays on the card
        knn_ids, _ = nn_descent(emb, c, checkpoint_dir=checkpoint_dir or "", device=dev)
    elif sharded:
        knn_ids, _ = exact_knn_sharded(emb, c, checkpoint_dir=checkpoint_dir or "", device=dev)
    else:
        if dev.type == "cuda":
            _device.require_room(dev, exact_knn_bytes(n, d, c, dev),
                                 "the exact k-NN on the card (past graph.exact_knn_max_n, from the card's total "
                                 "memory, the sharded pass)", None)
        knn_ids, _ = exact_knn(emb, c, device=dev)
    if knn_path and not knn_resumed:
        _ckpt_save(knn_path, key, knn_ids)  # renames a spill scratch memmap into place
        for f in ("spill_out_ids.npy", "spill_out_d.npy"):  # dead once saved
            try:
                os.remove(os.path.join(checkpoint_dir, f))
            except OSError:
                pass
    times["knn"] = time.time() - t0
    logger.info("build_graph knn phase: %.1fs (mode=%s)", times["knn"], knn_mode)
    if sharded:
        t0 = time.time()
        _trim_host("knn")
        times["host_trim"] = time.time() - t0
    if reverse_candidates > 0 and n > 1:
        knn_ids = _augment_reverse_candidates(np.asarray(knn_ids), reverse_candidates)
    cw = knn_ids.shape[1]

    t0 = time.time()
    d_pad = d + (-d % 16)
    blk = max(8, PRUNE_BLOCK_BYTES // max(cw * (cw + d_pad) * 4, 1))
    pq_mode = prune_on_pq(n, d, dev)
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
        t0 = time.time()
        _trim_host("prune")
        times["host_trim"] += time.time() - t0

    t0 = time.time()
    out = _fill_reverse_edges(neighbors, np.random.default_rng(0))
    medoid = compute_medoid(emb, dev, host=sharded)
    times["reverse_fill"] = time.time() - t0
    logger.info("graph built: N=%d R=%d avg_deg=%.1f medoid=%d", n, r, (out >= 0).mean() * r, medoid)
    return out, medoid
