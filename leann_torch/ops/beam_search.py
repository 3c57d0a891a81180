"""Batched graph beam search: stored, PQ-steered and recompute traversals.

Counterpart of the JAX package's ``ops/beam_search.py``. There the search is
one ``lax.while_loop`` per query, vmapped over the batch; here it is one
Python loop over hops that advances the whole batch at once. A lane that has
converged is frozen: every state update (pool, flags, visited bitmap, step
and exact-distance counts) is masked by a per-lane done flag, which is what
``vmap(while_loop)`` does, and the loop ends when every lane is done or
``max_steps`` is reached. The stop rule is the JAX package's: a lane is done
when its best unexpanded candidate is worse than the WORST entry of its
L-pool.

Traversal distance modes:
  * ``stored``    exact distances from a device-resident embedding matrix;
  * ``recompute`` exact distances by re-encoding the candidates' passages
                  from the token store (the hnsw tier). With ``prune_keep``
                  a PQ-ADC screen picks which candidates are re-encoded
                  (``prune_strategy`` global / local / proportional); the
                  others keep their ADC estimate in the same pool;
  * ``pq``        PQ-ADC distances, combined with ``rerank`` for the final
                  exact pass (the diskann tier), where the rerank re-encodes
                  the pool head from the token store
                  (``rerank_source="recompute"``) or reads stored embeddings.
Re-encoding gathers only the rows that need an exact distance (valid, kept
by the screen, in a lane still running) and encodes them in
``RECOMPUTE_ROWS`` chunks; the JAX package pays for every slot of every
lane. Each row's encoding is independent, so the distances are the same.

Numerics kept on purpose: search distances are f32 (bf16 rounding flips
near-ties); every ordering is a stable sort, so ties go to the lower
position as ``lax.sort`` / ``lax.top_k`` / ``jnp.argsort`` order them; the
visited set is a bitmap of 32-bit words (held in int64) updated by
scatter-add of bits that are provably unset — exact only because
``_dedup_mask`` first removes duplicate ids within a hop.
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
    traversal: str = "stored"  # stored | recompute | pq
    prune_keep: int = 0  # recompute: > 0 PQ-screens the candidates, re-encodes at most this many per hop
    # which candidates the screen keeps:
    #   global        the best prune_keep by ADC over the whole expansion set
    #   local         per source node: candidates ranked within their source
    #                 node's neighbour row, best ranks first
    #   proportional  global, with the budget scaled per lane by the share of
    #                 valid (fresh) candidates this hop
    prune_strategy: str = "global"
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


def _encode_rows(toks: torch.Tensor, lens: torch.Tensor, need: torch.Tensor, enc_cfg: EncoderConfig, enc_params,
                 normalize: bool) -> torch.Tensor:
    """Encode the passages toks [..., T] / lens [...] where ``need`` ->
    [..., D] f32 (zeros elsewhere): only the needed rows, flattened in order
    and encoded ``RECOMPUTE_ROWS`` at a time, so a row's embedding does not
    depend on the rows around it in the batch."""
    flat = need.reshape(-1).nonzero()[:, 0]
    t = toks.shape[-1]
    rows = toks.reshape(-1, t)[flat].to(torch.int32)
    mask = (torch.arange(t, device=toks.device)[None, :] < lens.reshape(-1)[flat][:, None]).to(torch.int32)
    parts = [encode_tokens(enc_params, rows[s : s + RECOMPUTE_ROWS], mask[s : s + RECOMPUTE_ROWS], enc_cfg)
             for s in range(0, rows.shape[0], RECOMPUTE_ROWS)]
    dim = parts[0].shape[-1] if parts else enc_cfg.dim
    e = torch.cat(parts) if parts else torch.zeros((0, dim), device=toks.device)
    if normalize and not enc_cfg.normalize:
        e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    out = torch.zeros((need.numel(), dim), dtype=torch.float32, device=toks.device)
    out[flat] = e.float()
    return out.reshape(*need.shape, dim)


def _recompute_embeddings(g: GraphData, ids: torch.Tensor, need: torch.Tensor, cfg: BeamConfig,
                          enc_params) -> torch.Tensor:
    """Re-encode the passages of node ``ids`` [B, C] where ``need`` from the
    token store -> [B, C, D] f32 (zeros where not needed)."""
    sel = ids.clamp(0, g.tokens.shape[0] - 1)
    return _encode_rows(g.tokens[sel], g.lengths[sel], need, cfg.enc_cfg, enc_params, cfg.normalize)


def _exact_dists(q, g: GraphData, ids, valid, cfg: BeamConfig, enc_params, source: str):
    if source == "stored":
        e = g.emb[ids.clamp(0, g.emb.shape[0] - 1)]
    else:
        e = _recompute_embeddings(g, ids, valid, cfg, enc_params)
    d = _metric_dists(q, e, cfg.metric)
    return torch.where(valid, d, torch.full_like(d, INF))


def _adc(g: GraphData, ids, valid, lut):
    ad = adc_distances(g.codes[ids.clamp(0, g.codes.shape[0] - 1)], lut)
    return torch.where(valid, ad, torch.full_like(ad, INF))


def _traversal_dists(q, g: GraphData, ids, valid, lut, cfg: BeamConfig, enc_params, per_source: int = 0):
    """-> (dists [B, C], n_exact i64[B]): traversal distances for candidate
    ``ids`` [B, C] and how many of each lane's received an exact distance.

    ``per_source`` > 0: the ids have [per_source, R] row structure per lane
    (a hop's expansion), which the ``local`` strategy ranks within; 0 (entry
    seeding) selects globally."""
    nv = valid.sum(dim=1)
    if cfg.traversal == "stored":
        return _exact_dists(q, g, ids, valid, cfg, enc_params, "stored"), nv
    if cfg.traversal == "pq":
        return _adc(g, ids, valid, lut), torch.zeros_like(nv)
    if cfg.traversal != "recompute":
        raise ValueError(f"unknown traversal {cfg.traversal!r}")
    b, f = ids.shape
    keep = cfg.prune_keep
    if not (keep and keep < f):
        return _exact_dists(q, g, ids, valid, cfg, enc_params, "recompute"), nv
    ad = _adc(g, ids, valid, lut)
    sel = ad
    if cfg.prune_strategy == "local" and per_source > 0:
        # rank each candidate within its source node's row (double stable
        # argsort): slots go round-robin over the source nodes
        adm = ad.reshape(b, per_source, f // per_source)
        rank = torch.argsort(torch.argsort(adm, dim=2, stable=True), dim=2, stable=True).reshape(b, f)
        sel = torch.where(ad >= BIG, torch.full_like(ad, INF), rank.float())
    keep_pos = torch.sort(sel, dim=1, stable=True).indices[:, :keep]  # lax.top_k(-sel): lower position on ties
    keep_ids = ids.gather(1, keep_pos)
    keep_valid = valid.gather(1, keep_pos)
    if cfg.prune_strategy == "proportional":
        # the budget follows each lane's count of fresh candidates this hop
        budget = ((keep * nv + f - 1) // f).clamp(1, keep)
        keep_valid = keep_valid & (torch.arange(keep, device=ids.device)[None, :] < budget[:, None])
    ed = _exact_dists(q, g, keep_ids, keep_valid, cfg, enc_params, "recompute")
    ed = torch.where(keep_valid, ed, ad.gather(1, keep_pos))  # the others keep their ADC estimate
    return ad.scatter(1, keep_pos, ed), keep_valid.sum(dim=1)


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


@torch.no_grad()
def beam_search_batch(q: torch.Tensor, g: GraphData, cfg: BeamConfig, enc_params=None):
    """q [B, D] f32 -> (labels i64[B, k], dists f32[B, k], steps i64[B],
    n_exact i64[B]): per lane the hops it ran and its exact-distance
    evaluations, the recompute count the pruning strategies trade against
    recall."""
    b = q.shape[0]
    dev = q.device
    n, r = g.neighbors.shape
    l = cfg.complexity
    f = cfg.beam * r
    screened = cfg.traversal == "pq" or (cfg.traversal == "recompute" and cfg.prune_keep)
    lut = adc_lut(q, g.codebooks, cfg.metric) if screened else None

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
    # per_source = 0: the seeds are screened globally whatever the strategy
    e_dist, n_exact = _traversal_dists(q, g, e_ids, torch.ones_like(e_ids, dtype=torch.bool), lut, cfg,
                                       enc_params)
    pad = l - ne
    cand_ids = torch.cat([e_ids, torch.full((b, pad), -1, dtype=torch.int64, device=dev)], dim=1)
    cand_dist = torch.cat([e_dist, torch.full((b, pad), INF, device=dev)], dim=1)
    cand_flag = torch.cat([torch.zeros((b, ne), dtype=torch.bool, device=dev),
                           torch.ones((b, pad), dtype=torch.bool, device=dev)], dim=1)
    cand_dist, order = torch.sort(cand_dist, dim=1, stable=True)
    cand_ids, cand_flag = cand_ids.gather(1, order), cand_flag.gather(1, order)

    rows = torch.arange(b, device=dev)[:, None]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = torch.zeros((b,), dtype=torch.int64, device=dev)
    for _ in range(cfg.max_steps):
        active = ~done
        steps += active
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
        # 5. distances for fresh candidates (none in a frozen lane: it
        # counts no exact distance)
        new_dist, hop_exact = _traversal_dists(q, g, safe, is_new, lut, cfg, enc_params, per_source=cfg.beam)
        n_exact += hop_exact
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
        n_exact = n_exact + top_valid.sum(dim=1)
        return top_ids.gather(1, order)[:, : cfg.k], exact[:, : cfg.k], steps, n_exact
    return cand_ids[:, : cfg.k], cand_dist[:, : cfg.k], steps, n_exact


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
    return pack_results(*beam_search_batch(q, g, cfg, enc_params)[:2])


def pack_results_full(labels: torch.Tensor, dists: torch.Tensor, steps: torch.Tensor,
                      n_exact: torch.Tensor) -> torch.Tensor:
    """:func:`pack_results` with the per-lane telemetry the adaptive search
    decides from: i32[B, 2k + 2] = [labels | bitcast(dists) | steps |
    n_exact]."""
    return torch.cat([pack_results(labels, dists), steps.to(torch.int32)[:, None],
                      n_exact.to(torch.int32)[:, None]], dim=1)


def unpack_results_full(packed) -> tuple:
    """Inverse of :func:`pack_results_full` -> numpy (labels i32[B, k],
    dists f32[B, k], steps i32[B], n_exact i32[B]), always writable (the
    adaptive search writes escalated lanes back in place)."""
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.array(packed)
    k = (arr.shape[1] - 2) // 2
    labels = arr[:, :k]
    dists = np.ascontiguousarray(arr[:, k : 2 * k]).view(np.float32)
    return labels, dists, arr[:, 2 * k], arr[:, 2 * k + 1]


@torch.no_grad()
def beam_search_batch_packed_full(q: torch.Tensor, g: GraphData, cfg: BeamConfig, enc_params=None) -> torch.Tensor:
    """q [B, D] -> packed i32[B, 2k + 2] with per-lane steps and n_exact
    (see :func:`pack_results_full`)."""
    return pack_results_full(*beam_search_batch(q, g, cfg, enc_params))


def beam_search_adaptive(q, g: GraphData, cfg: BeamConfig, enc_params=None, first_steps: int = 0):
    """Two-phase batched search: the whole batch runs with ``max_steps``
    capped at ``first_steps``; only the lanes that reached the cap run
    again, from scratch, at the full budget, in a batch padded to a power
    of two by repeating them cyclically. The batch loop runs until its
    slowest lane converges, so a few hard queries no longer hold the whole
    batch to their step count.

    The result equals the uncapped run: a lane that converged under the cap
    ran the same hops as it would uncapped (each lane's state depends on
    its own query alone), and a capped lane is rerun at full budget.
    ``q`` is a numpy array or a tensor on the graph's device. -> numpy
    (labels i32[B, k], dists f32[B, k], steps i32[B], n_exact i32[B]);
    escalated lanes report their full run's steps and n_exact."""
    import dataclasses

    dev = g.neighbors.device
    qt = q.to(dev).float() if isinstance(q, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(q, dtype=np.float32)).to(dev)
    if first_steps <= 0 or first_steps >= cfg.max_steps:
        return unpack_results_full(beam_search_batch_packed_full(qt, g, cfg, enc_params))
    cfg1 = dataclasses.replace(cfg, max_steps=int(first_steps))
    labels, dists, steps, n_exact = unpack_results_full(beam_search_batch_packed_full(qt, g, cfg1, enc_params))
    # steps == cap means cut short or converged exactly at the cap: both
    # run again (the second is rare and still right)
    esc = np.nonzero(steps >= first_steps)[0]
    if esc.size == 0:
        return labels, dists, steps, n_exact
    b2 = 1 << int(esc.size - 1).bit_length() if esc.size > 1 else 1
    idx = np.resize(esc, b2)  # cyclic repeats: the padding lanes are real queries
    l2, d2, s2, ne2 = unpack_results_full(
        beam_search_batch_packed_full(qt[torch.from_numpy(idx).to(dev)], g, cfg, enc_params))
    m = esc.size
    labels[esc], dists[esc], steps[esc], n_exact[esc] = l2[:m], d2[:m], s2[:m], ne2[:m]
    return labels, dists, steps, n_exact


@torch.no_grad()
def rerank_tokens_batch(q: torch.Tensor, toks: torch.Tensor, lens: torch.Tensor, ids: torch.Tensor, k: int,
                        metric: str, normalize: bool, enc_cfg: EncoderConfig, enc_params) -> torch.Tensor:
    """The deferred exact rerank over host-gathered token rows: q f32[B, D],
    toks [B, RR, T] and lens [B, RR] of the pool heads' passages, gathered
    on the host from its token store, ids [B, RR] (-1 padded) -> packed
    i32[B, 2k] (:func:`pack_results`) of the exact top-k, ties to the lower
    position. Only the valid rows are re-encoded, in ``RECOMPUTE_ROWS``
    chunks, as the device-resident rerank encodes them, so both give the
    same distances."""
    valid = ids >= 0
    d = _metric_dists(q, _encode_rows(toks, lens, valid, enc_cfg, enc_params, normalize), metric)
    d = torch.where(valid, d, torch.full_like(d, INF))
    d, order = torch.sort(d, dim=1, stable=True)
    return pack_results(ids.gather(1, order)[:, :k], d[:, :k])


@torch.no_grad()
def beam_search_text_batch(q_ids: torch.Tensor, q_mask: torch.Tensor, g: GraphData, cfg: BeamConfig,
                           enc_params):
    """Query encode + search: token ids in, the four outputs of
    :func:`beam_search_batch` out."""
    q = encode_tokens(enc_params, q_ids, q_mask, cfg.enc_cfg)
    if cfg.normalize and not cfg.enc_cfg.normalize:
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return beam_search_batch(q, g, cfg, enc_params)


@torch.no_grad()
def beam_search_text_batch_packed(q_ids: torch.Tensor, q_mask: torch.Tensor, g: GraphData, cfg: BeamConfig,
                                  enc_params) -> torch.Tensor:
    """Query encode + search: token ids in, packed i32[B, 2k] out."""
    return pack_results(*beam_search_text_batch(q_ids, q_mask, g, cfg, enc_params)[:2])
