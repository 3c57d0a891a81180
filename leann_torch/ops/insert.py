"""Incremental index updates: Vamana-style batched insertion.

Counterpart of the JAX package's ``ops/insert.py``. A batch of new nodes is
inserted in three batched steps instead of one node at a time:

  1. discovery: search the live index for each new vector's top-C
     neighborhood (exact distances; the unpruned recompute traversal on
     compact indexes);
  2. robust prune: :func:`~leann_torch.ops.graph.robust_prune_explicit`
     selects each new node's degree-R out-neighborhood from its candidates;
  3. reverse repair: every existing node a new node chose re-prunes {its
     current neighbors} ∪ {the new nodes that chose it} back down to R.

Compact indexes store no embeddings: existing nodes are re-encoded from the
token store on demand, with the encoder the search uses.

The JAX package pads every encode and prune batch to a power of two so that
it compiles few programs. Here the batches keep their real size: each row's
encoding and each node's prune depend on that row alone, so padding rows
would change no real row.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import f32_matmuls
from .graph import robust_prune_explicit

logger = logging.getLogger(__name__)

# token rows re-encoded per encoder call
ENCODE_ROWS = 2048


def _encode_rows(searcher, rows: np.ndarray) -> torch.Tensor:
    """Re-encode the passages of graph rows ``rows`` from the searcher's
    token store (on the device, or in host RAM) -> f32 [len(rows), D] on
    the searcher's device."""
    enc = searcher._encoder()
    dev = searcher.device
    out = torch.empty((rows.shape[0], enc.dim), dtype=torch.float32, device=dev)
    for s in range(0, rows.shape[0], ENCODE_ROWS):
        blk = rows[s : s + ENCODE_ROWS]
        if searcher.tokens is not None:
            idx = torch.from_numpy(blk).to(dev)
            toks, lens = searcher.tokens[idx], searcher.lengths[idx]
        else:
            toks = torch.from_numpy(np.asarray(searcher.tokens_host[blk], np.int32)).to(dev)
            lens = torch.from_numpy(searcher.lengths_host[blk]).to(dev)
        mask = (torch.arange(toks.shape[1], device=dev)[None, :] < lens[:, None]).int()
        out[s : s + blk.shape[0]] = enc.encode_token_batch(toks, mask)
    return out


def node_embeddings(searcher, ids: np.ndarray, new_emb: Optional[torch.Tensor] = None,
                    n_old: int = 0) -> torch.Tensor:
    """Embeddings of node ``ids`` (any shape) -> f32 [..., D] on the
    searcher's device.

    An index with stored embeddings slices its matrix; a compact one
    re-encodes from the token store. Ids >= ``n_old`` (default: the graph's
    rows) address rows of ``new_emb`` (the batch being inserted); -1 rows
    are zeros. Cosine indexes renormalize every row."""
    ids = np.asarray(ids)
    dev = searcher.device
    uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
    if n_old == 0:
        n_old = int(searcher.neighbors.shape[0])
    old_mask = (uniq >= 0) & (uniq < n_old)
    old_ids = uniq[old_mask]
    if searcher.emb is not None:  # stored matrix (widened to f32 at load)
        got = searcher.emb[torch.from_numpy(old_ids).to(dev)]
    else:
        if not searcher.has_tokens:
            raise RuntimeError("compact index without token store: cannot insert")
        got = _encode_rows(searcher, old_ids)
    out = torch.zeros((uniq.shape[0], got.shape[1]), dtype=torch.float32, device=dev)
    out[torch.from_numpy(old_mask).to(dev)] = got
    if new_emb is not None:
        new_mask = uniq >= n_old
        if new_mask.any():
            out[torch.from_numpy(new_mask).to(dev)] = new_emb[torch.from_numpy(uniq[new_mask] - n_old).to(dev)]
    if searcher.metric == "cosine":
        out = out / out.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return out[torch.from_numpy(inv.reshape(-1)).to(dev)].reshape(*ids.shape, out.shape[1])


def _prune_batch(p_emb: torch.Tensor, cand_ids: np.ndarray, cand_emb: torch.Tensor, r: int,
                 alpha: float) -> np.ndarray:
    """robust_prune_explicit on the device -> i32 [B, R] on the host."""
    cid = torch.from_numpy(cand_ids.astype(np.int64)).to(p_emb.device)
    sel = robust_prune_explicit(p_emb, cid, cand_emb, r, float(alpha), max(1, r // 4))
    return sel.cpu().numpy().astype(np.int32)


@torch.no_grad()
@f32_matmuls()
def insert_batch(searcher, new_emb: np.ndarray, ef: int = 64,
                 alpha: float = 1.2) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Insert a batch of new nodes, ``new_emb`` f32 [B, D] (already
    metric-normalized), into the graph held by ``searcher``.

    -> (new_rows i32[B, R], touched_ids i32[A], touched_rows i32[A, R]):
    the new nodes' neighbor rows and the repaired rows of every existing
    node that gained an in-edge."""
    n_old, r = searcher.neighbors.shape
    b_new = new_emb.shape[0]
    c = min(max(2 * r, 16), n_old)
    new_t = torch.from_numpy(np.ascontiguousarray(new_emb, np.float32)).to(searcher.device)

    # 1. discovery: exact top-C through the live search path, unpruned
    out = searcher.search(
        new_emb, c,
        complexity=max(ef, c),
        beam_width=max(4, min(8, ef // 8)),
        recompute_embeddings=bool(searcher.has_tokens),
        prune_ratio=0.0,
    )
    cand = np.asarray(out["labels"], np.int32)  # [B, C]

    # 2. robust prune of each new node's candidates
    valid = torch.from_numpy(cand >= 0).to(searcher.device)[..., None]
    cand_emb = node_embeddings(searcher, np.clip(cand, 0, n_old - 1)) * valid
    new_rows = _prune_batch(new_t, cand, cand_emb, r, alpha)  # [B, R]

    # 3. reverse repair: every existing node a new node chose re-prunes
    # {its current row} ∪ {the new ids that chose it}
    nbrs_np = searcher.neighbors.cpu().numpy().astype(np.int32)
    src = np.repeat(np.arange(b_new, dtype=np.int32), r)
    dst = new_rows.reshape(-1)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    touched = np.unique(dst)
    a = touched.shape[0]
    if a == 0:
        return new_rows, touched, np.zeros((0, r), np.int32)
    # incoming new ids per touched node, at most min(B, 8) of them
    max_in = min(b_new, 8)
    incoming = np.full((a, max_in), -1, np.int32)
    order = np.argsort(dst, kind="stable")
    ds, ss = dst[order], src[order]
    first = np.r_[True, ds[1:] != ds[:-1]]
    group = np.cumsum(first) - 1
    rank = np.arange(ds.size) - np.maximum.accumulate(np.where(first, np.arange(ds.size), 0))
    ok = rank < max_in
    incoming[group[ok], rank[ok]] = n_old + ss[ok]
    cand_j = np.concatenate([nbrs_np[touched], incoming], axis=1)  # [A, R + max_in]
    cand_j[cand_j == touched[:, None]] = -1  # a node never lists itself
    valid_j = torch.from_numpy(cand_j >= 0).to(searcher.device)[..., None]
    cand_j_emb = node_embeddings(searcher, np.clip(cand_j, 0, n_old + b_new - 1), new_emb=new_t,
                                 n_old=n_old) * valid_j
    p_emb = node_embeddings(searcher, touched)
    touched_rows = _prune_batch(p_emb, cand_j, cand_j_emb, r, alpha)
    logger.info("insert_batch: %d new nodes, %d repaired rows", b_new, a)
    return new_rows, touched, touched_rows
