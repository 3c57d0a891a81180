"""Graph beam search over an index sharded on a ``gp`` device mesh.

Counterpart of the JAX package's ``parallel/sharded_search.py``. Node ``i``
lives on shard ``i // s`` (block partition, ``s = ceil(N / gp)``): its graph
row, PQ codes, stored embedding and token row. The candidate pool, the
visited bitmap and the stop rule are held once, on the lead device of the
shards' group, and every hop combines the shards' contributions there with
:func:`~.mesh.psum`:

* the frontier's adjacency: each shard gives the rows it owns, +1, and zeros
  elsewhere; the sum, -1, is the frontier's neighbour ids;
* PQ-ADC distances (``pq``, and the screen of ``recompute``): each shard
  scores the candidates it owns;
* ``recompute``: each shard re-encodes at most ``keep_local`` of the
  candidates it owns, picked by the ADC screen under the strategy
  (``global``: its own best; ``local``: by rank within the candidate's
  source row; ``proportional``: the budget scaled by the hop's share of
  fresh candidates), and contributes exact - ADC at their positions; so the
  mesh's pick is a union of per-shard picks, not the single device's global
  pick;
* the final rerank: each shard re-encodes (or reads, for stored
  embeddings) the pool head rows it owns.

The search is batched over lanes as ``ops/beam_search.beam_search_batch``
is: one Python loop over hops advances the whole batch, and a converged
lane is frozen. A mesh with a ``dp`` axis (``mesh.serving_mesh``) splits the
batch over ``dp``: each group of ``gp`` shards searches its part. The index
is placed once per distinct device: the shards a device holds are row
slices of one tensor, which is the caller's own when it already lies there.
There is no Pallas kernel in the JAX search, so this one is plain torch;
its distances go through ``device.matmul``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..embeddings.encoder import params_to_torch
from ..ops.beam_search import (BIG, INF, BeamConfig, _dedup_mask, _encode_rows, _mark_visited, _merge_pool,
                               _metric_dists)
from ..ops.pq import adc_distances, adc_lut
from .mesh import Mesh, place_row_shards, psum


class ShardedGraph(NamedTuple):
    """Index state over one group of ``gp`` shards. Row-sharded fields are
    lists with one tensor per shard, on its device (rows ``j s .. j s + s``
    of the index, fewer or none at its end); replicated fields map each
    distinct device to its copy. Absent parts are None."""

    neighbors: List[torch.Tensor]  # i64[rows, R]
    entry_ids: Dict[torch.device, torch.Tensor]  # i64[E]
    emb: Optional[List[torch.Tensor]] = None  # f32[rows, D]
    tokens: Optional[List[torch.Tensor]] = None  # i32[rows, T]
    lengths: Optional[List[torch.Tensor]] = None  # i32[rows]
    codes: Optional[List[torch.Tensor]] = None  # u8[rows, M]
    codebooks: Optional[Dict[torch.device, torch.Tensor]] = None  # f32[M, K, ds|D]
    entry_emb: Optional[Dict[torch.device, torch.Tensor]] = None  # bf16[E, D]


def _place_rows(a, hosts: Dict[torch.device, List[int]], s: int, dtype: torch.dtype) -> Dict[tuple, torch.Tensor]:
    """:func:`~.mesh.place_row_shards` of one array, numpy or a tensor (a
    tensor that already lies on a device in ``dtype`` is sliced there, not
    copied) -> {(device, j): shard j's rows}."""

    def upload(dev, lo, hi):
        rows = a[lo:hi] if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a[lo:hi]))
        return (rows.to(dev).to(dtype),)

    return {key: t[0] for key, t in place_row_shards(a.shape[0], s, hosts, upload).items()}


def _replicate(a, devs, dtype: torch.dtype) -> Dict[torch.device, torch.Tensor]:
    """One copy of ``a`` on each distinct device of ``devs``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return {dev: t.to(dev).to(dtype) for dev in dict.fromkeys(devs)}


class ShardedSearcher:
    """Places an index over the ``gp`` axis of ``mesh``, replicated over
    its ``dp`` axis if it has one, and runs the sharded beam search.
    Arrays are numpy or tensors (a tensor that already lies on a shard's
    device in the search's dtype is sliced, not copied)."""

    def __init__(self, mesh: Mesh, neighbors, *, entries, emb=None, tokens=None, lengths=None, codes=None,
                 codebooks=None, entry_emb=None):
        self.mesh = mesh
        self.dp = int(mesh.shape.get("dp", 1))
        self.gp = int(mesh.shape["gp"])
        order = [mesh.axis_names.index(a) for a in ("dp", "gp") if a in mesh.shape]
        grid = np.moveaxis(mesh.devices, order, list(range(len(order)))).reshape(self.dp, self.gp, -1)
        self.groups = [list(row[:, 0]) for row in grid]  # [dp][gp] devices; other axes replicate
        self.n, self.r = int(neighbors.shape[0]), int(neighbors.shape[1])
        self.s = -(-self.n // self.gp)  # rows per shard
        shards_of: Dict[torch.device, set] = {}
        for grp in self.groups:
            for j, dev in enumerate(grp):
                shards_of.setdefault(dev, set()).add(j)
        hosts = {dev: sorted(js) for dev, js in shards_of.items()}
        devs = list(hosts)

        def rows(a, dtype):
            if a is None:
                return [None] * self.dp
            placed = _place_rows(a, hosts, self.s, dtype)
            return [[placed[(dev, j)] for j, dev in enumerate(grp)] for grp in self.groups]

        nb, em, tk, ln, cd = (rows(neighbors, torch.int64), rows(emb, torch.float32), rows(tokens, torch.int32),
                              rows(lengths, torch.int32), rows(codes, torch.uint8))
        ent = _replicate(entries, devs, torch.int64)
        cbs = _replicate(codebooks, devs, torch.float32) if codebooks is not None else None
        ee = _replicate(entry_emb, devs, torch.bfloat16) if entry_emb is not None else None
        self.graphs = [ShardedGraph(nb[i], ent, em[i], tk[i], ln[i], cd[i], cbs, ee) for i in range(self.dp)]
        self._params: Dict[torch.device, tuple] = {}

    def _params_on(self, dev: torch.device, enc_params):
        """The encoder's params on ``dev``: the caller's tree where it lies
        there, else one copy per device, kept while the caller passes the
        same tree."""
        if enc_params is None:
            return None
        lead = enc_params["tok_emb"].device if isinstance(enc_params.get("tok_emb"), torch.Tensor) else None
        if lead == dev:
            return enc_params
        cached = self._params.get(dev)
        if cached is None or cached[0] is not enc_params:
            cached = self._params[dev] = (enc_params, params_to_torch(enc_params, dev))
        return cached[1]

    @torch.no_grad()
    def search(self, q, cfg: BeamConfig, enc_params=None, keep_local: int = 0):
        """q [B, D] (numpy or a tensor) -> numpy (labels i32[B, k], dists
        f32[B, k]); ids at or past N come back as -1. A ``recompute`` search
        always screens by PQ; ``keep_local`` <= 0 gives each shard an even
        share of the hop's candidates."""
        if cfg.traversal == "recompute" and keep_local <= 0:
            keep_local = max(1, cfg.beam * self.r // self.gp)
        q = q.detach().float() if isinstance(q, torch.Tensor) else torch.from_numpy(np.array(q, np.float32))
        real_b = q.shape[0]
        per = -(-real_b // self.dp)  # dp splits the batch evenly: zero rows pad it
        q = torch.cat([q, q.new_zeros((per * self.dp - real_b, q.shape[1]))])
        labels, dists = [], []
        for i, grp in enumerate(self.groups):
            qi = q[i * per : (i + 1) * per].to(grp[0])
            li, di = _search_group(qi, self.graphs[i], grp, self.s, self.n, cfg,
                                   [self._params_on(dev, enc_params) for dev in grp], keep_local)
            labels.append(li.cpu())
            dists.append(di.cpu())
        labels = torch.cat(labels)[:real_b].to(torch.int32).numpy()
        dists = torch.cat(dists)[:real_b].float().numpy()
        return np.where(labels >= self.n, -1, labels).astype(np.int32), dists


def _search_group(q: torch.Tensor, g: ShardedGraph, devs: List[torch.device], s: int, n: int, cfg: BeamConfig,
                  params: list, keep_local: int):
    """The search of one group of ``gp`` shards: q f32[B, D] on the lead
    device ``devs[0]``, which holds the pool -> (labels i64[B, k], dists
    f32[B, k]) there."""
    lead = devs[0]
    b = q.shape[0]
    gp = len(devs)
    shards = [j for j in range(gp) if g.neighbors[j].shape[0]]  # shards past the index hold no rows
    r = g.neighbors[shards[0]].shape[1]
    l = cfg.complexity
    f = cfg.beam * r
    metric = cfg.metric
    on: Dict[tuple, torch.Tensor] = {}

    def at(name: str, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """A replicated per-search tensor on ``dev``, copied once."""
        if t.device == dev:
            return t
        if (name, dev) not in on:
            on[(name, dev)] = t.to(dev)
        return on[(name, dev)]

    screened = cfg.traversal == "pq" or cfg.traversal == "recompute"
    lut = adc_lut(q, g.codebooks[lead], metric) if screened and g.codes is not None else None

    def local_ids(ids: torch.Tensor, j: int):
        """Global ids (any shape, on the lead device) -> (row in shard j,
        owned by shard j), on shard j's device."""
        x = ids.to(devs[j])
        owned = (x >= j * s) & (x < j * s + g.neighbors[j].shape[0])
        return torch.where(owned, x - j * s, torch.zeros_like(x)), owned

    def approx_dists(ids, valid):
        if g.codes is None:  # no codes: every candidate ties, the screen keeps positions
            return torch.where(valid, torch.zeros(ids.shape, device=lead), torch.full(ids.shape, INF, device=lead))
        parts = []
        for j in shards:
            li, owned = local_ids(ids, j)
            ad = adc_distances(g.codes[j][li], at("lut", lut, devs[j]))
            parts.append(torch.where(owned & valid.to(devs[j]), ad, torch.zeros_like(ad)))
        full = psum(parts, lead)
        return torch.where(valid, full, torch.full_like(full, INF))

    def stored_dists(ids, valid):
        """Exact distances from the stored rows: ids [B, C], or the [E]
        pool shared by every lane -> [B, C | E]."""
        parts = []
        for j in shards:
            li, owned = local_ids(ids, j)
            d = _metric_dists(at("q", q, devs[j]), g.emb[j][li], metric)
            parts.append(torch.where(owned & valid.to(devs[j]), d, torch.zeros_like(d)))
        full = psum(parts, lead)
        return torch.where(valid, full, torch.full_like(full, INF))

    def recompute_local(j: int, ids, sel_mask, per_source: int, approx):
        """Shard j re-encodes at most ``keep_local`` owned candidates picked
        by the screen -> exact - ADC at their positions, zeros elsewhere
        ([B, C] on shard j's device)."""
        dev = devs[j]
        c = ids.shape[1]
        kl = min(keep_local, c)
        li, owned = local_ids(ids, j)
        sel_mask, approx = sel_mask.to(dev), approx.to(dev)
        base = approx
        if cfg.prune_strategy == "local" and per_source > 0:
            adm = approx.reshape(b, per_source, c // per_source)
            rank = torch.argsort(torch.argsort(adm, dim=2, stable=True), dim=2, stable=True).reshape(b, c)
            base = torch.where(approx >= BIG, torch.full_like(approx, INF), rank.float())
        score = torch.where(owned & sel_mask, base, torch.full_like(base, INF))
        val, pos = torch.sort(score, dim=1, stable=True)  # lax.top_k(-score): lower position on ties
        val, pos = val[:, :kl], pos[:, :kl]
        ok = val < BIG
        if cfg.prune_strategy == "proportional" and per_source > 0:
            nv = sel_mask.sum(dim=1)
            budget = ((kl * nv + c - 1) // c).clamp(1, kl)
            ok = ok & (torch.arange(kl, device=dev)[None, :] < budget[:, None])
        kept = torch.where(ok, li.gather(1, pos), torch.zeros_like(pos))
        e = _encode_rows(g.tokens[j][kept], g.lengths[j][kept], ok, cfg.enc_cfg, params[j], cfg.normalize)
        exact = _metric_dists(at("q", q, dev), e, metric)
        delta = torch.where(ok, exact - approx.gather(1, pos), torch.zeros_like(exact))
        return torch.zeros_like(approx).scatter_add(1, pos, delta)

    def traversal_dists(ids, valid, per_source: int = 0):
        if cfg.traversal == "stored":
            return stored_dists(ids, valid)
        if cfg.traversal not in ("pq", "recompute"):
            raise ValueError(f"unknown traversal {cfg.traversal!r}")
        ad = approx_dists(ids, valid)
        if cfg.traversal == "pq":
            return ad
        return ad + psum([recompute_local(j, ids, valid, per_source, ad) for j in shards], lead)

    # ---- init: query-aware entry seeding from the entry pool -------------
    pool = g.entry_ids[lead]
    ne = min(cfg.n_entries, pool.shape[0], l)
    if pool.shape[0] > ne:
        ee = g.entry_emb[lead] if g.entry_emb is not None else None
        if cfg.traversal == "stored":
            pd = stored_dists(pool, torch.ones_like(pool, dtype=torch.bool))
        elif ee is not None and ee.shape[0] == pool.shape[0] and ee.shape[1] == q.shape[1]:
            pd = _metric_dists(q, ee, metric)  # exact, replicated
        elif g.codes is not None:
            plut = lut if lut is not None else adc_lut(q, g.codebooks[lead], metric)
            parts = []
            for j in shards:
                li, owned = local_ids(pool, j)
                pc = g.codes[j][li]
                ad = adc_distances(pc[None].expand(b, *pc.shape), at("plut", plut, devs[j]))
                parts.append(torch.where(owned, ad, torch.zeros_like(ad)))
            pd = psum(parts, lead)
        else:  # no screen: the pool head
            pd = torch.arange(pool.shape[0], device=lead, dtype=torch.float32)[None].expand(b, -1)
        e_ids = pool[torch.sort(pd, dim=1, stable=True).indices[:, :ne]]
    else:
        e_ids = pool[:ne][None].expand(b, ne)
    visited = torch.zeros((b, (n + 31) // 32), dtype=torch.int64, device=lead)
    _mark_visited(visited, e_ids, torch.ones_like(e_ids, dtype=torch.bool))  # entry ids are unique
    e_dist = traversal_dists(e_ids, torch.ones_like(e_ids, dtype=torch.bool))
    pad = l - ne
    cand_ids = torch.cat([e_ids, torch.full((b, pad), -1, dtype=torch.int64, device=lead)], dim=1)
    cand_dist = torch.cat([e_dist, torch.full((b, pad), INF, device=lead)], dim=1)
    cand_flag = torch.cat([torch.zeros((b, ne), dtype=torch.bool, device=lead),
                           torch.ones((b, pad), dtype=torch.bool, device=lead)], dim=1)
    cand_dist, order = torch.sort(cand_dist, dim=1, stable=True)
    cand_ids, cand_flag = cand_ids.gather(1, order), cand_flag.gather(1, order)

    rows = torch.arange(b, device=lead)[:, None]
    done = torch.zeros((b,), dtype=torch.bool, device=lead)
    for _ in range(cfg.max_steps):
        active = ~done
        sel_score = torch.where(cand_flag, torch.full_like(cand_dist, INF), cand_dist)
        sel_val, pos = torch.sort(sel_score, dim=1, stable=True)
        sel_val, pos = sel_val[:, : cfg.beam], pos[:, : cfg.beam]
        sel_valid = sel_val < BIG
        sel_ids = torch.where(sel_valid, cand_ids.gather(1, pos), torch.zeros_like(pos))
        flag = cand_flag.clone()
        flag[rows, pos] = True
        # the frontier's adjacency: each shard gives the rows it owns, +1
        parts = []
        for j in shards:
            li, owned = local_ids(sel_ids, j)
            nb = g.neighbors[j][li]  # [B, beam, R]
            parts.append(torch.where(owned[:, :, None], nb + 1, torch.zeros_like(nb)))
        nbrs = (psum(parts, lead) - 1).reshape(b, f)
        valid = (nbrs >= 0) & sel_valid.repeat_interleave(r, dim=1)
        valid = _dedup_mask(nbrs, valid)
        safe = nbrs.clamp(0, n - 1)
        bit = torch.ones_like(safe) << (safe & 31)
        is_new = ((visited.gather(1, safe >> 5) & bit) == 0) & valid & active[:, None]
        _mark_visited(visited, safe, is_new)
        new_dist = traversal_dists(safe, is_new, per_source=cfg.beam)
        new_ids = torch.where(is_new, nbrs, torch.full_like(nbrs, -1))
        m_ids, m_dist, m_flag = _merge_pool(cand_ids, cand_dist, flag, new_ids, new_dist, ~is_new, l)
        keep = active[:, None]
        cand_ids = torch.where(keep, m_ids, cand_ids)
        cand_dist = torch.where(keep, m_dist, cand_dist)
        cand_flag = torch.where(keep, m_flag, cand_flag)
        best_unexp = torch.where(cand_flag, torch.full_like(cand_dist, INF), cand_dist).min(dim=1).values
        stop = (best_unexp > cand_dist[:, l - 1]) | (best_unexp >= BIG)
        done = done | (active & stop)
        if bool(done.all()):
            break

    if not cfg.rerank:
        return cand_ids[:, : cfg.k], cand_dist[:, : cfg.k]
    # ---- the exact rerank of the pool head: each shard its own rows -----
    rr = min(cfg.rerank, l)
    top_ids = cand_ids[:, :rr]
    top_valid = top_ids >= 0
    safe = top_ids.clamp(0, n - 1)
    if cfg.rerank_source == "stored":
        exact = stored_dists(safe, top_valid)
    else:
        parts = []
        for j in shards:
            li, owned = local_ids(safe, j)
            need = owned & top_valid.to(devs[j])
            e = _encode_rows(g.tokens[j][li], g.lengths[j][li], need, cfg.enc_cfg, params[j], cfg.normalize)
            d = _metric_dists(at("q", q, devs[j]), e, metric)
            parts.append(torch.where(need, d, torch.zeros_like(d)))
        full = psum(parts, lead)
        exact = torch.where(top_valid, full, torch.full_like(full, INF))
    exact, order = torch.sort(exact, dim=1, stable=True)
    return top_ids.gather(1, order)[:, : cfg.k], exact[:, : cfg.k]
