"""Batched graph beam search with PQ-steered traversal and exact rerank.

Counterpart of the JAX package's ``ops/beam_search.py``. There the search is
one ``lax.while_loop`` per query, vmapped over the batch; here it is one
Python loop over hops that advances the whole batch at once. A lane that has
converged is frozen: every state update (pool, flags, visited bitmap) is
masked by a per-lane done flag, which is what ``vmap(while_loop)`` does, and
the loop ends when every lane is done or ``max_steps`` is reached. The stop
rule is the JAX package's: a lane is done when its best unexpanded candidate
is worse than the WORST entry of its L-pool.

Traversal distance modes ported so far:
  * ``stored`` exact distances from a device-resident embedding matrix;
  * ``pq``     PQ-ADC distances, combined with ``rerank`` for the final exact
               pass (the diskann tier), where the rerank re-encodes the pool
               head from the token store (``rerank_source="recompute"``) or
               reads stored embeddings.

Numerics kept on purpose: search distances are f32 (bf16 rounding flips
near-ties); every ordering is a stable sort, so ties go to the lower
position as ``lax.sort`` / ``lax.top_k`` order them; the visited set is a
bitmap of 32-bit words (held in int64) updated by scatter-add of bits that
are provably unset — exact only because ``_dedup_mask`` first removes
duplicate ids within a hop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..embeddings.encoder import EncoderConfig, encode_tokens
from .pq import adc_distances, adc_lut

INF = 3.4e38
BIG = 1e37
# sequences per encoder call in the recompute: bounds its activations (a few
# GB at T = 128, D = 384) whatever the query batch
RECOMPUTE_ROWS = 4096


class GraphData(NamedTuple):
    """Device-resident index state; absent parts are None."""

    neighbors: torch.Tensor  # i64[N, R], -1 padded
    entry_ids: torch.Tensor  # i64[E]
    emb: Optional[torch.Tensor] = None  # f32[N, D]
    tokens: Optional[torch.Tensor] = None  # i32[N, T]
    lengths: Optional[torch.Tensor] = None  # i32[N]
    codes: Optional[torch.Tensor] = None  # u8[N, M]
    codebooks: Optional[torch.Tensor] = None  # f32[M, K, ds|D]
    entry_emb: Optional[torch.Tensor] = None  # bf16[E, D], row-aligned with entry_ids


@dataclass(frozen=True)
class BeamConfig:
    metric: str = "l2"
    k: int = 10
    complexity: int = 64  # candidate pool size L (efSearch parity)
    beam: int = 4  # nodes expanded per hop (beam_width parity)
    max_steps: int = 64
    traversal: str = "stored"  # stored | pq
    rerank: int = 0  # >0: final exact pass over the top-``rerank`` pool entries
    rerank_source: str = "recompute"  # recompute | stored
    n_entries: int = 16  # starting points taken from the entry pool
    normalize: bool = False  # L2-normalize recomputed embeddings (cosine)
    enc_cfg: Optional[EncoderConfig] = None


def _metric_dists(q: torch.Tensor, e: torch.Tensor, metric: str) -> torch.Tensor:
    """q [B, D], e [B, C, D] (or shared [C, D]) -> dists [B, C] f32
    (lower = closer)."""
    q = q.float()
    e = e.float()
    dots = q @ e.T if e.dim() == 2 else torch.bmm(e, q[:, :, None])[:, :, 0]
    if metric in ("mips", "cosine"):
        return -dots
    en = e.square().sum(-1)
    return q.square().sum(-1, keepdim=True) + (en[None, :] if e.dim() == 2 else en) - 2.0 * dots


def _recompute_embeddings(g: GraphData, ids: torch.Tensor, cfg: BeamConfig, enc_params) -> torch.Tensor:
    """Re-encode passages for node ``ids`` [B, C] from the token store ->
    [B, C, D] f32."""
    b, c = ids.shape
    safe = ids.clamp(0, g.tokens.shape[0] - 1).reshape(-1)
    toks = g.tokens[safe]
    t = toks.shape[1]
    mask = (torch.arange(t, device=ids.device)[None, :] < g.lengths[safe][:, None]).to(torch.int32)
    e = torch.cat([encode_tokens(enc_params, toks[s : s + RECOMPUTE_ROWS], mask[s : s + RECOMPUTE_ROWS], cfg.enc_cfg)
                   for s in range(0, safe.shape[0], RECOMPUTE_ROWS)])
    if cfg.normalize and not cfg.enc_cfg.normalize:
        e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return e.reshape(b, c, -1)


def _exact_dists(q, g: GraphData, ids, valid, cfg: BeamConfig, enc_params, source: str):
    if source == "stored":
        e = g.emb[ids.clamp(0, g.emb.shape[0] - 1)]
    else:
        e = _recompute_embeddings(g, ids, cfg, enc_params)
    d = _metric_dists(q, e, cfg.metric)
    return torch.where(valid, d, torch.full_like(d, INF))


def _traversal_dists(q, g: GraphData, ids, valid, lut, cfg: BeamConfig, enc_params):
    """Traversal distances [B, C] for candidate ``ids`` [B, C]."""
    if cfg.traversal == "stored":
        return _exact_dists(q, g, ids, valid, cfg, enc_params, "stored")
    if cfg.traversal == "pq":
        ad = adc_distances(g.codes[ids.clamp(0, g.codes.shape[0] - 1)], lut)
        return torch.where(valid, ad, torch.full_like(ad, INF))
    raise NotImplementedError(
        f"traversal {cfg.traversal!r} is not ported to leann_torch yet (ROADMAP.md, left for "
        "later #1: the recompute traversal with prune_keep that the hnsw backend needs)")


def _merge_pool(ids_a, dist_a, flag_a, ids_b, dist_b, flag_b, l: int):
    ids = torch.cat([ids_a, ids_b], dim=1)
    dist = torch.cat([dist_a, dist_b], dim=1)
    flag = torch.cat([flag_a, flag_b], dim=1)
    dist, order = torch.sort(dist, dim=1, stable=True)
    return ids.gather(1, order)[:, :l], dist[:, :l], flag.gather(1, order)[:, :l]


def _dedup_mask(nbrs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """valid [B, F] with within-row duplicate ids knocked out (first
    occurrence wins, original order kept)."""
    f = nbrs.shape[1]
    earlier = torch.ones((f, f), dtype=torch.bool, device=nbrs.device).tril(diagonal=-1)  # [i, j]: j < i
    dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier & valid[:, None, :]).any(dim=2)
    return valid & ~dup


def _mark_visited(visited: torch.Tensor, ids: torch.Tensor, new: torch.Tensor) -> None:
    """OR the bits of ``ids`` where ``new`` into ``visited`` (i64[B, W] of
    32-bit words). Bits marked new are unset and unique per row, so an add
    is an OR."""
    bit = torch.ones_like(ids) << (ids & 31)
    visited.scatter_add_(1, ids >> 5, torch.where(new, bit, torch.zeros_like(bit)))


def _search_batch(q: torch.Tensor, g: GraphData, cfg: BeamConfig, enc_params):
    """q [B, D] f32 -> (labels i64[B, k], dists f32[B, k])."""
    b = q.shape[0]
    dev = q.device
    n, r = g.neighbors.shape
    l = cfg.complexity
    f = cfg.beam * r
    lut = adc_lut(q, g.codebooks, cfg.metric) if cfg.traversal == "pq" else None

    # ---- init: query-aware entry seeding from the entry pool -------------
    pool = g.entry_ids
    ne = min(cfg.n_entries, pool.shape[0], l)
    if pool.shape[0] > ne:
        if cfg.traversal == "stored":
            pd = _metric_dists(q, g.emb[pool], cfg.metric)
        elif g.entry_emb is not None and g.entry_emb.shape[0] == pool.shape[0]:
            pd = _metric_dists(q, g.entry_emb, cfg.metric)  # exact, one product
        elif g.codes is not None:
            plut = lut if lut is not None else adc_lut(q, g.codebooks, cfg.metric)
            pcodes = g.codes[pool]
            pd = adc_distances(pcodes[None].expand(b, *pcodes.shape), plut)
        else:  # no screen available: the pool head
            pd = torch.arange(pool.shape[0], device=dev, dtype=torch.float32)[None].expand(b, -1)
        pidx = torch.sort(pd, dim=1, stable=True).indices[:, :ne]
        e_ids = pool[pidx]
    else:
        e_ids = pool[:ne][None].expand(b, ne)
    visited = torch.zeros((b, (n + 31) // 32), dtype=torch.int64, device=dev)
    _mark_visited(visited, e_ids, torch.ones_like(e_ids, dtype=torch.bool))  # entry ids are unique
    e_dist = _traversal_dists(q, g, e_ids, torch.ones_like(e_ids, dtype=torch.bool), lut, cfg, enc_params)
    pad = l - ne
    cand_ids = torch.cat([e_ids, torch.full((b, pad), -1, dtype=torch.int64, device=dev)], dim=1)
    cand_dist = torch.cat([e_dist, torch.full((b, pad), INF, device=dev)], dim=1)
    cand_flag = torch.cat([torch.zeros((b, ne), dtype=torch.bool, device=dev),
                           torch.ones((b, pad), dtype=torch.bool, device=dev)], dim=1)
    cand_dist, order = torch.sort(cand_dist, dim=1, stable=True)
    cand_ids, cand_flag = cand_ids.gather(1, order), cand_flag.gather(1, order)

    rows = torch.arange(b, device=dev)[:, None]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for _ in range(cfg.max_steps):
        active = ~done
        # 1. select the `beam` closest unexpanded candidates
        sel_score = torch.where(cand_flag, torch.full_like(cand_dist, INF), cand_dist)
        sel_val, pos = torch.sort(sel_score, dim=1, stable=True)
        sel_val, pos = sel_val[:, : cfg.beam], pos[:, : cfg.beam]
        sel_valid = sel_val < BIG
        sel_ids = torch.where(sel_valid, cand_ids.gather(1, pos), torch.zeros_like(pos))
        flag = cand_flag.clone()
        flag[rows, pos] = True
        # 2. expand: gather fixed-degree neighbor rows
        nbrs = g.neighbors[sel_ids].reshape(b, f)
        valid = (nbrs >= 0) & sel_valid.repeat_interleave(r, dim=1)
        # 3. dedup within the batch
        valid = _dedup_mask(nbrs, valid)
        # 4. visited-bitmap test + mark; frozen lanes change nothing
        safe = nbrs.clamp(0, n - 1)
        bit = torch.ones_like(safe) << (safe & 31)
        is_new = ((visited.gather(1, safe >> 5) & bit) == 0) & valid & active[:, None]
        _mark_visited(visited, safe, is_new)
        # 5. distances for fresh candidates
        new_dist = _traversal_dists(q, g, safe, is_new, lut, cfg, enc_params)
        new_ids = torch.where(is_new, nbrs, torch.full_like(nbrs, -1))
        # 6. merge into the sorted pool
        m_ids, m_dist, m_flag = _merge_pool(cand_ids, cand_dist, flag, new_ids, new_dist, ~is_new, l)
        keep = active[:, None]
        cand_ids = torch.where(keep, m_ids, cand_ids)
        cand_dist = torch.where(keep, m_dist, cand_dist)
        cand_flag = torch.where(keep, m_flag, cand_flag)
        # 7. convergence: the closest unexpanded candidate is farther than
        # the WORST entry of the L-pool (efSearch semantics)
        best_unexp = torch.where(cand_flag, torch.full_like(cand_dist, INF), cand_dist).min(dim=1).values
        stop = (best_unexp > cand_dist[:, l - 1]) | (best_unexp >= BIG)
        done = done | (active & stop)
        if bool(done.all()):
            break

    # ---- exact rerank of the pool head (DiskANN deferred fetch) ----------
    if cfg.rerank:
        rr = min(cfg.rerank, l)
        top_ids = cand_ids[:, :rr]
        top_valid = top_ids >= 0
        exact = _exact_dists(q, g, top_ids.clamp(0, n - 1), top_valid, cfg, enc_params, cfg.rerank_source)
        exact, order = torch.sort(exact, dim=1, stable=True)
        return top_ids.gather(1, order)[:, : cfg.k], exact[:, : cfg.k]
    return cand_ids[:, : cfg.k], cand_dist[:, : cfg.k]


def pack_results(labels: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """labels [B, k] + dists f32[B, k] -> i32[B, 2k] with the distances
    bitcast (exact bits); :func:`unpack_results` inverts it on the host."""
    return torch.cat([labels.to(torch.int32), dists.float().contiguous().view(torch.int32)], dim=1)


def unpack_results(packed) -> tuple:
    """Host-side inverse of :func:`pack_results` -> (labels i32, dists f32)."""
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    k = arr.shape[1] // 2
    return arr[:, :k], np.ascontiguousarray(arr[:, k:]).view(np.float32)


@torch.no_grad()
def beam_search_batch_packed(q: torch.Tensor, g: GraphData, cfg: BeamConfig, enc_params=None) -> torch.Tensor:
    """q [B, D] -> packed i32[B, 2k] (see :func:`pack_results`)."""
    return pack_results(*_search_batch(q, g, cfg, enc_params))


@torch.no_grad()
def beam_search_text_batch_packed(q_ids: torch.Tensor, q_mask: torch.Tensor, g: GraphData, cfg: BeamConfig,
                                  enc_params) -> torch.Tensor:
    """Query encode + search: token ids in, packed i32[B, 2k] out."""
    q = encode_tokens(enc_params, q_ids, q_mask, cfg.enc_cfg)
    if cfg.normalize and not cfg.enc_cfg.normalize:
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return pack_results(*_search_batch(q, g, cfg, enc_params))
