"""HNSW-class backend: fixed-degree graph + recompute traversal.

Counterpart of the JAX package's ``backends/hnsw/backend.py`` for one card,
writing and reading the same ``<prefix>.hnsw.npz``:

  * build: exact k-NN candidates (kernel B2 at C = candidate_factor x M) +
    α-prune + reverse fill (``ops/graph.py``); OPQ/PQ codes when the index
    recomputes; the embedding matrix stored only when the index is not
    compact; the entry pool, with its f16 embeddings in the npz (mips) or in
    the ``.entries.cache.npy`` sidecar (l2 / cosine).
  * search: the ``recompute`` traversal (``ops/beam_search.py``) re-encodes
    the visited candidates' passages from the device-resident token store,
    PQ-screened to ``prune_keep`` per hop when a prune ratio applies, or the
    ``stored`` traversal on a non-compact index. ``prune_ratio=None``
    screens automatically on large indexes or searches (auto-prune guard);
    an explicit 0.0 stays unpruned.
  * insert (:func:`insert_hnsw`): batched Vamana insertion of new rows
    (``ops/insert.py``) into the stored graph, with their PQ codes, stored
    embeddings and entry-pool seeds appended.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Dict

import numpy as np

from ...device import resolve_device
from ...interface import (
    LeannBackendBuilderInterface,
    LeannBackendFactoryInterface,
    LeannBackendSearcherInterface,
)
from ...ops.beam_search import BeamConfig
from ...ops.graph import build_graph
from ...ops.insert import insert_batch
from ...ops.pq import choose_m, encode_pq_blocked, lift_codebooks, train_opq, train_pq
from ...registry import register_backend
from ...storage import pack_neighbors, unpack_neighbors
from ..common import (ENTRY_POOL_SIZE, N_ENTRY_POINTS, GraphSearcher, _entry_pool, _pool_cap, mips_augment,
                      save_ids, sharded_neighbors)

logger = logging.getLogger(__name__)

# auto-prune guard (prune_ratio=None): an unpruned recompute re-encodes all
# beam x R candidates every hop; when the caller did not choose and the index
# or the search is large, the PQ screen keeps a quarter of them. An explicit
# prune_ratio=0.0 still means unpruned.
AUTO_PRUNE_RATIO = 0.75
AUTO_PRUNE_MIN_N = 50_000
AUTO_PRUNE_MIN_COMPLEXITY = 256


class HnswBuilder(LeannBackendBuilderInterface):
    def __init__(
        self,
        distance_metric: str = "mips",
        is_compact: bool = True,
        is_recompute: bool = True,
        M: int = 32,  # graph degree
        efConstruction: int = 128,  # build candidate budget
        alpha: float = 1.2,
        pq_subspaces: int = 0,  # 0 = auto (~D/8)
        pq_rotate: bool = True,  # OPQ rotation
        build_sharded: bool = False,  # the gp-mesh build (parallel/sharded_build.py)
        build_checkpoint_dir: str = "",
        reverse_candidates: int = 0,  # reverse-KNN prune candidates (ops/graph.py)
        device: str = "cuda",
        **kwargs,
    ):
        self.device = resolve_device(device)
        self.build_sharded = build_sharded
        self.distance_metric = distance_metric
        self.is_compact = is_compact
        self.is_recompute = is_recompute
        self.m = M
        self.ef_construction = efConstruction
        self.alpha = alpha
        self.pq_subspaces = pq_subspaces
        self.pq_rotate = pq_rotate
        self.reverse_candidates = reverse_candidates
        self.build_checkpoint_dir = build_checkpoint_dir
        self.phase_seconds: Dict[str, float] = {}

    def build(self, data: np.ndarray, ids: list, index_path: str, **kwargs) -> None:
        if data.dtype != np.float16:
            data = np.ascontiguousarray(data, dtype=np.float32)
        else:
            data = np.ascontiguousarray(data)
        n, d = data.shape
        times = self.phase_seconds
        graph_data = mips_augment(data) if self.distance_metric == "mips" else data
        cand_factor = max(2, min(8, self.ef_construction // max(self.m, 1)))
        if self.build_sharded:
            neighbors, medoid = sharded_neighbors(self, graph_data, self.m, cand_factor)
        else:
            neighbors, medoid = build_graph(
                graph_data, r=self.m, candidate_factor=cand_factor, alpha=self.alpha,
                checkpoint_dir=self.build_checkpoint_dir, reverse_candidates=self.reverse_candidates,
                device=self.device, phase_seconds=times,
            )
        payload: Dict[str, Any] = {
            **pack_neighbors(neighbors),
            "medoid": np.int32(medoid),
            "metric": self.distance_metric,
            "is_compact": self.is_compact,
            "is_recompute": self.is_recompute,
            "dim": np.int32(d),
        }
        # PQ codes steer the pruned recompute
        if self.is_recompute and n >= 4:
            t0 = time.time()
            m = choose_m(d, self.pq_subspaces)
            if self.pq_rotate:
                # factorized on disk (rotation + plain codebooks); lifted at load
                rotation, cb_plain = train_opq(data, m=m, factorized=True, device=self.device)
                codebooks = lift_codebooks(rotation, cb_plain)
                payload["pq_rotation"] = rotation
            else:
                codebooks = cb_plain = train_pq(data, m=m, device=self.device)
            payload["codebooks"] = cb_plain
            times["pq_train"] = time.time() - t0
            t0 = time.time()
            payload["codes"] = encode_pq_blocked(data, codebooks, device=self.device)
            times["pq_encode"] = time.time() - t0

        t0 = time.time()
        if not self.is_compact:
            payload["embeddings"] = data
        has_screen = (not self.is_compact) or ("codes" in payload)
        payload["entries"] = _entry_pool(medoid, n, has_screen)
        if self.is_compact and payload["entries"].shape[0] > N_ENTRY_POINTS:
            # pool embeddings (f16) for the exact seed screen: l2/cosine pools
            # are derivable from the token store and go to a cache sidecar;
            # mips pools live in the augmented space and stay here
            ee = data[payload["entries"]].astype(np.float16)
            if self.distance_metric in ("l2", "cosine"):
                np.save(f"{index_path}.entries.cache.npy", ee)
            else:
                payload["entry_emb"] = ee
        np.savez(f"{index_path}.hnsw.npz", **payload)
        save_ids(index_path, ids)
        times["persist"] = time.time() - t0
        logger.info("hnsw build: N=%d D=%d R=%d compact=%s", n, d, self.m, self.is_compact)


class HnswSearcher(GraphSearcher, LeannBackendSearcherInterface):
    """Graph, codes, stored embeddings (non-compact indexes), entry pool and
    token store all live on the searcher's device."""

    def __init__(self, index_path: str, sharded: "bool | str" = False, **kwargs):
        """``sharded`` (True, or "auto" on a machine with more than one
        card) searches over a ``gp`` mesh of one shard per card; a pruned
        recompute then re-encodes at most ``prune_keep
        // gp`` candidates per shard and hop."""
        super().__init__(index_path, **kwargs)
        z = np.load(f"{index_path}.hnsw.npz", allow_pickle=False)
        self.is_compact = bool(z["is_compact"])
        self.has_pq = "codes" in z
        self._load(z)
        if self._want_sharded(sharded, self.device):
            self._shard()

    def _make_cfg(
        self,
        top_k: int,
        complexity: int = 64,
        beam_width: int = 4,
        prune_ratio: "float | None" = None,
        recompute_embeddings: bool = True,
        pruning_strategy: str = "global",
        batch_size: int = 0,
        n_entries: int = 16,
        need_encoder: bool = False,
        **kwargs,
    ):
        l = max(complexity, top_k, beam_width)
        if prune_ratio is None:
            prune_ratio = 0.0
            if recompute_embeddings and self.has_pq and (
                self.n >= AUTO_PRUNE_MIN_N or l >= AUTO_PRUNE_MIN_COMPLEXITY
            ):
                prune_ratio = AUTO_PRUNE_RATIO
                logger.info("hnsw auto-prune: prune_ratio=%.2f (N=%d, L=%d; pass prune_ratio=0.0 "
                            "explicitly for an unpruned recompute)", prune_ratio, self.n, l)
        beam = max(1, min(beam_width, l))
        f = beam * int(self.neighbors.shape[1])
        if recompute_embeddings and not self.has_tokens:
            if self.is_compact:
                raise RuntimeError("compact index has no embeddings and no token store; cannot search")
            recompute_embeddings = False
        if not recompute_embeddings and self.emb is None:
            raise RuntimeError("recompute_embeddings=False requires a non-compact index")
        enc_params = enc_cfg = None
        if recompute_embeddings or need_encoder:
            enc = self._encoder()
            enc_params, enc_cfg = enc.params, enc.cfg
        if pruning_strategy not in ("global", "local", "proportional"):
            raise ValueError(f"unknown pruning_strategy {pruning_strategy!r}")
        prune_keep = 0
        if recompute_embeddings and prune_ratio > 0 and self.has_pq:
            prune_keep = max(1, min(f, math.ceil(f * (1.0 - prune_ratio))))
            if batch_size:  # caps the re-encodes per hop
                prune_keep = min(prune_keep, batch_size)
        cfg = BeamConfig(
            metric=self.metric,
            k=top_k,
            complexity=l,
            beam=beam,
            max_steps=max(8, l),
            traversal="recompute" if recompute_embeddings else "stored",
            prune_keep=prune_keep,
            prune_strategy=pruning_strategy,
            n_entries=max(1, n_entries),
            normalize=(self.metric == "cosine"),
            enc_cfg=enc_cfg,
        )
        return cfg, enc_params


def insert_hnsw(index_path: str, new_emb: np.ndarray, ef: int = 64, alpha: float = 1.2,
                device: str = "cuda") -> int:
    """Insert ``new_emb`` [B, D] (already metric-normalized) into an existing
    hnsw index by batched Vamana insertion (``ops/insert.py``) -> the new N.
    The API layer appends the passages and tokens first, so that a compact
    index can re-encode the new rows."""
    path = f"{index_path}.hnsw.npz"
    z = dict(np.load(path, allow_pickle=False))
    old_rows = unpack_neighbors(z)
    for k in ("neighbors", "neighbors_packed", "neighbors_n", "neighbors_r"):
        z.pop(k, None)
    searcher = HnswSearcher(index_path, device=device)
    new_emb = np.ascontiguousarray(new_emb, dtype=np.float32)
    n_old = int(old_rows.shape[0])

    new_rows, touched, touched_rows = insert_batch(searcher, new_emb, ef=ef, alpha=alpha)
    neighbors = np.concatenate([old_rows, new_rows.astype(old_rows.dtype)])
    if touched.size:
        neighbors[touched] = touched_rows
    z.update(pack_neighbors(neighbors))
    if "codes" in z:
        cb = z["codebooks"]
        if "pq_rotation" in z:
            cb = lift_codebooks(z["pq_rotation"], cb)
        z["codes"] = np.concatenate([z["codes"], encode_pq_blocked(new_emb, cb, device=device)])
    if "embeddings" in z:  # in the stored dtype (an f16 store stays f16)
        z["embeddings"] = np.concatenate([z["embeddings"], new_emb.astype(z["embeddings"].dtype)])
    # the entry pool keeps covering the appended rows: the builder's cap at
    # the new N, or up to min(N, ENTRY_POOL_SIZE) on small indexes, whose
    # inserted rows are reachable only through local repair; without a
    # screen the small fixed set
    n_new = int(neighbors.shape[0])
    if ("codes" in z) or ("embeddings" in z):
        pool_cap = max(_pool_cap(n_new), min(n_new, ENTRY_POOL_SIZE))
    else:
        pool_cap = N_ENTRY_POINTS
    room = pool_cap - z["entries"].shape[0]
    if room > 0:
        step = max(1, new_emb.shape[0] // max(room, 1))
        extra = np.arange(n_old, n_old + new_emb.shape[0], step, dtype=np.int32)[:room]
        z["entries"] = np.concatenate([z["entries"], extra])
        if "entry_emb" in z:  # row-aligned with the entries
            z["entry_emb"] = np.concatenate([z["entry_emb"], new_emb[extra - n_old].astype(z["entry_emb"].dtype)])
        cache = f"{index_path}.entries.cache.npy"  # stale: the next load derives it again
        if os.path.exists(cache):
            os.remove(cache)
    np.savez(path, **z)
    logger.info("hnsw insert: %d -> %d nodes (%d rows repaired)", n_old, n_new, touched.size)
    return n_new


@register_backend("hnsw")
class HnswBackendFactory(LeannBackendFactoryInterface):
    @staticmethod
    def builder(**kwargs) -> HnswBuilder:
        return HnswBuilder(**kwargs)

    @staticmethod
    def searcher(index_path: str, **kwargs) -> HnswSearcher:
        return HnswSearcher(index_path, **kwargs)

    @staticmethod
    def insert(index_path: str, embeddings: np.ndarray, **kwargs) -> int:
        return insert_hnsw(index_path, embeddings, **kwargs)
