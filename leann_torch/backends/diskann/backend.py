"""DiskANN-class backend: PQ-steered traversal + deferred exact rerank.

Counterpart of the JAX package's ``backends/diskann/backend.py`` for one
card, writing and reading the same on-disk index:

  * build: exact k-NN candidates + α-prune + reverse fill (``ops/graph.py``),
    then, with more than one partition, the LDG partition (``partition.py``,
    on the host) and the relayout: rows are relabeled so that each
    partition is contiguous (graph, data, ids, medoid and the token store);
    then OPQ/PQ codebooks and codes (``ops/pq.py``), the graph packed by
    ``storage.pack_neighbors`` into ``<prefix>.diskann.npz`` and the
    partition counts into ``<prefix>.partition.npz``. ``num_partitions=0``
    means one partition per card (one on the CPU), where the relayout is
    the identity.
  * search: PQ-ADC traversal of the graph, then one exact pass over the
    pool head that re-encodes its passages from the token store
    (``ops/beam_search.py``). The store lives on the device, or, when it
    would take too much of the card (``token_residency``), in host RAM: the
    traversal then returns the pool head, the host gathers those rows'
    tokens, and a second call re-encodes them for the exact rerank
    (``rerank_tokens_batch``), the counterpart of DiskANN's deferred fetch.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...device import f32_matmuls, resolve_device
from ...interface import (
    LeannBackendBuilderInterface,
    LeannBackendFactoryInterface,
    LeannBackendSearcherInterface,
)
from ...ops.beam_search import BeamConfig, rerank_tokens_batch, unpack_results
from ...ops.graph import build_graph
from ...ops.pq import choose_m, encode_pq_blocked, lift_codebooks, train_opq, train_pq
from ...registry import register_backend
from ...storage import pack_neighbors, save_partition, token_cache_paths
from ..common import GraphSearcher, _entry_pool, mips_augment, not_ported, save_ids
from .partition import edge_locality, ldg_partition

logger = logging.getLogger(__name__)


class DiskannBuilder(LeannBackendBuilderInterface):
    def __init__(
        self,
        distance_metric: str = "mips",
        is_compact: bool = True,
        is_recompute: bool = True,
        graph_degree: int = 32,
        complexity: int = 64,
        alpha: float = 1.2,
        pq_subspaces: int = 0,
        pq_rotate: bool = True,
        num_partitions: int = 0,  # 0 = auto: one partition per card
        partition_passes: int = 10,  # LDG refinement sweeps (the reference's gp_times)
        build_sharded: bool = False,
        build_checkpoint_dir: str = "",
        reverse_candidates: int = 0,
        device: str = "cuda",
        **kwargs,
    ):
        if build_sharded:
            raise not_ported("the mesh-sharded build", "ROADMAP.md, left for later #10")
        self.device = resolve_device(device)
        self.distance_metric = distance_metric
        self.is_recompute = is_recompute
        self.graph_degree = graph_degree
        self.complexity = complexity
        self.alpha = alpha
        self.pq_subspaces = pq_subspaces
        self.pq_rotate = pq_rotate
        if num_partitions <= 0:
            num_partitions = torch.cuda.device_count() if self.device.type == "cuda" else 1
        self.num_partitions = num_partitions
        self.partition_passes = partition_passes
        self.reverse_candidates = reverse_candidates
        self.build_checkpoint_dir = build_checkpoint_dir
        self.phase_seconds: Dict[str, float] = {}

    @f32_matmuls()
    def build(self, data: np.ndarray, ids: list, index_path: str, **kwargs) -> None:
        if data.dtype != np.float16:
            data = np.ascontiguousarray(data, dtype=np.float32)
        else:
            data = np.ascontiguousarray(data)
        n, d = data.shape
        times = self.phase_seconds
        graph_data = mips_augment(data) if self.distance_metric == "mips" else data
        r = self.graph_degree
        cand_factor = max(2, min(8, self.complexity // max(r, 1)))
        neighbors, medoid = build_graph(
            graph_data, r=r, candidate_factor=cand_factor, alpha=self.alpha,
            checkpoint_dir=self.build_checkpoint_dir, reverse_candidates=self.reverse_candidates,
            device=self.device, phase_seconds=times,
        )
        n_parts = self.num_partitions
        if n_parts > 1:
            t0 = time.time()
            assign = ldg_partition(neighbors, n_parts, passes=self.partition_passes)
            times["ldg"] = time.time() - t0
            # relayout: relabel nodes so each partition is contiguous
            t0 = time.time()
            order = np.argsort(assign, kind="stable").astype(np.int64)
            new_of_old = np.empty(n, np.int64)
            new_of_old[order] = np.arange(n)
            neighbors = np.where(neighbors >= 0, new_of_old[np.clip(neighbors, 0, n - 1)], -1)[order].astype(np.int32)
            data = data[order]
            ids = [ids[i] for i in order]
            medoid = int(new_of_old[medoid])
            assign = assign[order]
            self._permute_tokens(index_path, order)
            times["relayout"] = time.time() - t0
        else:
            # one partition: the relayout is the identity (no copy of the matrix)
            assign = np.zeros(n, np.int32)

        t0 = time.time()
        m = choose_m(d, self.pq_subspaces)
        rotation = None
        if self.pq_rotate:
            # factorized on disk (rotation + plain codebooks); lifted at load
            rotation, cb_plain = train_opq(data, m=m, factorized=True, device=self.device)
            codebooks = lift_codebooks(rotation, cb_plain)
        else:
            codebooks = cb_plain = train_pq(data, m=m, device=self.device)
        times["pq_train"] = time.time() - t0
        t0 = time.time()
        codes = encode_pq_blocked(data, codebooks, device=self.device)
        times["pq_encode"] = time.time() - t0
        logger.info("diskann build: pq M=%d trained %.1fs, %d rows encoded %.1fs", m,
                    times["pq_train"], n, times["pq_encode"])

        t0 = time.time()
        payload = {
            **pack_neighbors(neighbors),
            "medoid": np.int32(medoid),
            "entries": _entry_pool(medoid, n, has_screen=True),  # codes always exist
            "metric": self.distance_metric,
            "dim": np.int32(d),
            "codebooks": cb_plain,
            "codes": codes,
            "is_recompute": self.is_recompute,
        }
        if rotation is not None:
            payload["pq_rotation"] = rotation
        if not self.is_recompute:
            payload["embeddings"] = data
        else:
            # entry-pool embeddings (f16) for the exact seed screen: l2/cosine
            # pools are derivable from the token store and go to a cache
            # sidecar; mips pools live in the augmented space and stay here
            ee = data[payload["entries"]].astype(np.float16)
            if self.distance_metric in ("l2", "cosine"):
                np.save(f"{index_path}.entries.cache.npy", ee)
            else:
                payload["entry_emb"] = ee
        np.savez(f"{index_path}.diskann.npz", **payload)
        save_partition(index_path, assign)  # counts: the relayout makes the assignment a step function
        save_ids(index_path, ids)
        times["persist"] = time.time() - t0
        logger.info("diskann build: N=%d R=%d M(pq)=%d parts=%d locality=%.2f", n, r, m, n_parts,
                    edge_locality(neighbors, assign))

    @staticmethod
    def _permute_tokens(index_path: str, order: np.ndarray) -> None:
        """The API layer writes the token store in the passages' order
        before the backend builds; the relayout permutes it to the relabeled
        rows. Its resume sidecar goes, so a later build into the same prefix
        writes the store anew instead of permuting it twice."""
        p = token_cache_paths(index_path)
        for raw, lenp in ((p["raw"], p["raw_len"]), (p["legacy_raw"], p["legacy_raw_len"])):
            if os.path.exists(raw):
                np.save(raw, np.load(raw, mmap_mode="r")[order])
                np.save(lenp, np.load(lenp)[order])
                break
        else:
            for path in (p["npz"], p["legacy_npz"]):
                if os.path.exists(path):
                    z = np.load(path)
                    np.savez_compressed(path, tokens=z["tokens"][order], lengths=z["lengths"][order])
                    break
        done = f"{index_path}.tokens.cache.done.json"
        if os.path.exists(done):
            os.remove(done)


class DiskannSearcher(GraphSearcher, LeannBackendSearcherInterface):
    """Graph, codes, codebooks and entry pool live on the searcher's device;
    the token store too, or in host RAM with the deferred rerank."""

    # share of the card's free memory (at load) the token store may take
    # before ``token_residency="auto"`` keeps it on the host (the card's
    # own figure, not the TPU's fixed 4 GB)
    HOST_TOKEN_SHARE = 0.25

    def __init__(self, index_path: str, sharded: "bool | str" = False, token_residency: str = "auto",
                 **kwargs):
        """``token_residency``: "device" uploads the token store, "host"
        keeps it in host RAM (a raw store stays memmapped) and defers the
        exact rerank to a second call over host-gathered rows, "auto" keeps
        it on the host when its i32 form would take more than
        ``HOST_TOKEN_SHARE`` of the card's free memory."""
        super().__init__(index_path, **kwargs)
        if sharded is True:
            raise not_ported("the sharded searcher", "ROADMAP.md, left for later #10")
        if token_residency not in ("host", "device", "auto"):
            raise ValueError(f"unknown token_residency {token_residency!r}")
        host = token_residency == "host"
        if token_residency == "auto" and self.device.type == "cuda":
            tok_bytes = 4 * self.meta.get("num_chunks", 0) * self.max_length  # i32 on the card
            host = tok_bytes > self.HOST_TOKEN_SHARE * torch.cuda.mem_get_info(self.device)[0]
        self._load(np.load(f"{index_path}.diskann.npz", allow_pickle=False), tokens_on_device=not host)
        if self.tokens_host is not None:
            logger.info("diskann tokens host-resident (%.2f GB); deferred rerank",
                        self.tokens_host.nbytes / 2**30)

    @torch.no_grad()
    @f32_matmuls()
    def search(self, query: np.ndarray, top_k: int, adaptive_steps: int = 0, **kwargs) -> Dict[str, np.ndarray]:
        if self.tokens_host is not None and kwargs.get("recompute_embeddings", True):
            return self._search_host_rerank(*self._query_batch(query), top_k,
                                            adaptive_steps=int(adaptive_steps or 0), **kwargs)
        return super().search(query, top_k, adaptive_steps=adaptive_steps, **kwargs)

    @torch.no_grad()
    @f32_matmuls()
    def search_text(self, query: "str | list", top_k: int, adaptive_steps: int = 0,
                    **kwargs) -> Dict[str, np.ndarray]:
        if self.tokens_host is not None and kwargs.get("recompute_embeddings", True):
            queries = [query] if isinstance(query, str) else list(query)
            cfg, enc_params = self._make_cfg(top_k, need_encoder=True, **kwargs)
            return self._search_host_rerank(*self._encode_text(queries, cfg, enc_params), top_k,
                                            adaptive_steps=int(adaptive_steps or 0), **kwargs)
        return super().search_text(query, top_k, adaptive_steps=adaptive_steps, **kwargs)

    def _search_host_rerank(self, real_b: int, qp: torch.Tensor, top_k: int, *, complexity: int = 64,
                            beam_width: int = 4, rerank_size: int = 0, adaptive_steps: int = 0,
                            **kwargs) -> Dict[str, np.ndarray]:
        """Search with the token store in host RAM: the PQ traversal returns
        the pool head of RR rows (call 1), the host gathers those rows'
        tokens, and :func:`rerank_tokens_batch` re-encodes them for the
        exact top-k (call 2). The card holds the graph, the codes and RR
        token rows per query. ``qp`` is the padded batch of ``real_b``
        queries on the device."""
        l = max(complexity, top_k, beam_width)
        rr = max(min(l, rerank_size) if rerank_size else l, top_k)
        kwargs.pop("recompute_embeddings", None)
        cfg, _ = self._make_cfg(rr, complexity=complexity, beam_width=beam_width, recompute_embeddings=False,
                                **kwargs)
        ids = self._run(qp.shape[0], qp, cfg, None, adaptive_steps)["labels"]
        safe = np.clip(ids, 0, self.n - 1)
        toks = np.asarray(self.tokens_host[safe.reshape(-1)], np.int32).reshape(*safe.shape, -1)
        lens = self.lengths_host[safe]
        enc = self._encoder()
        dev = self.device
        packed = rerank_tokens_batch(qp, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                                     torch.from_numpy(np.ascontiguousarray(ids)).to(dev), top_k, self.metric,
                                     self.metric == "cosine", enc.cfg, enc.params)
        labels, dists = unpack_results(packed)
        return {"labels": labels[:real_b], "distances": dists[:real_b]}

    def _make_cfg(
        self,
        top_k: int,
        *,
        complexity: int = 64,
        beam_width: int = 4,
        prune_ratio: float = 0.0,
        recompute_embeddings: bool = True,
        pruning_strategy: str = "global",
        batch_size: int = 0,
        rerank_size: int = 0,  # 0 = rerank the full L-pool (reference default)
        n_entries: int = 16,  # query-aware seeds screened from the entry pool
        zmq_port: Optional[int] = None,
        need_encoder: bool = False,
        **kwargs,
    ):
        if pruning_strategy == "proportional":
            raise ValueError("pruning_strategy='proportional' is not supported by the diskann backend")
        l = max(complexity, top_k, beam_width)
        beam = max(1, min(beam_width, l))
        enc_params = enc_cfg = None
        rerank = 0
        rerank_source = "recompute"
        rr = min(l, rerank_size) if rerank_size else l
        rr = max(rr, top_k)
        if recompute_embeddings:
            if self.has_tokens:
                enc = self._encoder()
                enc_params, enc_cfg = enc.params, enc.cfg
                rerank = rr  # deferred fetch: one exact pass over the pool head
            elif self.emb is not None:
                rerank = rr
                rerank_source = "stored"
            else:
                raise RuntimeError("recompute requested but index has no token store")
        if need_encoder and enc_cfg is None:
            enc = self._encoder()
            enc_params, enc_cfg = enc.params, enc.cfg
        cfg = BeamConfig(
            metric=self.metric,
            k=top_k,
            complexity=l,
            beam=beam,
            max_steps=max(8, l),
            traversal="pq",
            rerank=rerank,
            rerank_source=rerank_source,
            n_entries=max(1, n_entries),
            normalize=(self.metric == "cosine"),
            enc_cfg=enc_cfg,
        )
        return cfg, enc_params


@register_backend("diskann")
class DiskannBackendFactory(LeannBackendFactoryInterface):
    @staticmethod
    def builder(**kwargs) -> DiskannBuilder:
        return DiskannBuilder(**kwargs)

    @staticmethod
    def searcher(index_path: str, **kwargs) -> DiskannSearcher:
        return DiskannSearcher(index_path, **kwargs)
