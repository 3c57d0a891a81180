"""DiskANN-class backend: PQ-steered traversal + deferred exact rerank.

Counterpart of the JAX package's ``backends/diskann/backend.py`` for one
card, writing and reading the same on-disk index:

  * build: exact k-NN candidates + α-prune + reverse fill (``ops/graph.py``),
    OPQ/PQ codebooks and codes (``ops/pq.py``), the graph packed by
    ``storage.pack_neighbors`` into ``<prefix>.diskann.npz``. On one card
    there is one partition and the relayout is the identity.
  * search: PQ-ADC traversal of the graph, then one exact pass over the
    pool head that re-encodes its passages from the device-resident token
    store (``ops/beam_search.py``).
"""

from __future__ import annotations

import logging
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
from ...ops.beam_search import (
    BeamConfig,
    GraphData,
    beam_search_batch_packed,
    beam_search_text_batch_packed,
    unpack_results,
)
from ...ops.graph import build_graph
from ...ops.pq import choose_m, encode_pq_blocked, lift_codebooks, train_opq, train_pq
from ...registry import register_backend
from ...storage import pack_neighbors, save_partition, unpack_neighbors
from ..common import BaseSearcher, _entry_pool, mips_augment, pad_batch_rows, save_ids

logger = logging.getLogger(__name__)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to leann_torch yet ({item})")


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
        build_sharded: bool = False,
        build_checkpoint_dir: str = "",
        reverse_candidates: int = 0,
        device: str = "cuda",
        **kwargs,
    ):
        if build_sharded:
            raise _not_ported("the mesh-sharded build", "ROADMAP.md, left for later #10")
        if build_checkpoint_dir:
            raise _not_ported("the checkpointed build", "ROADMAP.md, left for later #4")
        if num_partitions > 1:
            raise _not_ported("LDG partitioning and relayout", "ROADMAP.md, left for later #6")
        self.device = resolve_device(device)
        self.distance_metric = distance_metric
        self.is_recompute = is_recompute
        self.graph_degree = graph_degree
        self.complexity = complexity
        self.alpha = alpha
        self.pq_subspaces = pq_subspaces
        self.pq_rotate = pq_rotate
        self.reverse_candidates = reverse_candidates
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
            reverse_candidates=self.reverse_candidates, device=self.device, phase_seconds=times,
        )
        assign = np.zeros(n, np.int32)  # one partition: the relayout is the identity

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
        save_partition(index_path, assign)
        save_ids(index_path, ids)
        times["persist"] = time.time() - t0
        logger.info("diskann build: N=%d R=%d M(pq)=%d", n, r, m)


class DiskannSearcher(BaseSearcher, LeannBackendSearcherInterface):
    """Graph, codes, codebooks, entry pool and token store all live on the
    searcher's device."""

    def __init__(self, index_path: str, sharded: "bool | str" = False, token_residency: str = "auto",
                 **kwargs):
        super().__init__(index_path, **kwargs)
        if sharded is True:
            raise _not_ported("the sharded searcher", "ROADMAP.md, left for later #10")
        if token_residency == "host":
            raise _not_ported("host token residency", "ROADMAP.md, left for later #2")
        dev = self.device
        z = np.load(f"{index_path}.diskann.npz", allow_pickle=False)
        self.neighbors = torch.from_numpy(unpack_neighbors(z).astype(np.int64)).to(dev)
        self.entries = np.asarray(z["entries"])
        self.metric = str(z["metric"])
        self.n = int(self.neighbors.shape[0])
        self.codes = torch.from_numpy(np.asarray(z["codes"])).to(dev)
        cb = np.asarray(z["codebooks"])
        if "pq_rotation" in z:  # factorized OPQ: lift to the runtime form
            cb = lift_codebooks(np.asarray(z["pq_rotation"]), cb)
        self.codebooks = torch.from_numpy(np.ascontiguousarray(cb, np.float32)).to(dev)
        self.emb = (torch.from_numpy(np.asarray(z["embeddings"], np.float32)).to(dev)
                    if "embeddings" in z else None)
        ee = self.load_entry_emb(z)
        self.entry_emb = (torch.from_numpy(np.asarray(ee, np.float32)).to(dev).to(torch.bfloat16)
                          if ee is not None else None)
        tok = self.load_tokens()
        self.has_tokens = tok is not None
        self.tokens = self.lengths = None
        if tok is not None:
            # u16 stores widen to i32 on load (the gather indexes an embedding table)
            self.tokens = torch.from_numpy(np.array(tok[0], np.int32)).to(dev)
            self.lengths = torch.from_numpy(np.array(tok[1], np.int32)).to(dev)
        self._enc = None

    def _encoder(self):
        if self._enc is None:
            self._enc = self.get_encoder()
        return self._enc

    @f32_matmuls()
    def search(self, query: np.ndarray, top_k: int, **kwargs) -> Dict[str, np.ndarray]:
        if int(kwargs.pop("adaptive_steps", 0) or 0):
            raise _not_ported("beam_search_adaptive", "ROADMAP.md, left for later #2")
        cfg, enc_params = self._make_cfg(top_k, **kwargs)
        real_b, (qp,) = pad_batch_rows(np.ascontiguousarray(query, dtype=np.float32))
        packed = beam_search_batch_packed(torch.from_numpy(qp).to(self.device), self._graph_data(), cfg,
                                          enc_params)
        labels, dists = unpack_results(packed)
        return {"labels": labels[:real_b], "distances": dists[:real_b]}

    @f32_matmuls()
    def search_text(self, query: "str | list", top_k: int, **kwargs) -> Dict[str, np.ndarray]:
        """Encode the query batch on the device and search it."""
        if int(kwargs.pop("adaptive_steps", 0) or 0):
            raise _not_ported("beam_search_adaptive", "ROADMAP.md, left for later #2")
        queries = [query] if isinstance(query, str) else list(query)
        cfg, enc_params = self._make_cfg(top_k, need_encoder=True, **kwargs)
        q_ids, q_mask = self._encoder().tokenize(queries)
        real_b, (q_ids, q_mask) = pad_batch_rows(q_ids, q_mask)
        packed = beam_search_text_batch_packed(
            torch.from_numpy(q_ids).to(self.device), torch.from_numpy(q_mask).to(self.device),
            self._graph_data(), cfg, enc_params)
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

    def _graph_data(self) -> GraphData:
        return GraphData(
            neighbors=self.neighbors,
            entry_ids=torch.from_numpy(self.entries.astype(np.int64)).to(self.device),
            emb=self.emb,
            tokens=self.tokens,
            lengths=self.lengths,
            codes=self.codes,
            codebooks=self.codebooks,
            entry_emb=self.entry_emb,
        )


@register_backend("diskann")
class DiskannBackendFactory(LeannBackendFactoryInterface):
    @staticmethod
    def builder(**kwargs) -> DiskannBuilder:
        return DiskannBuilder(**kwargs)

    @staticmethod
    def searcher(index_path: str, **kwargs) -> DiskannSearcher:
        return DiskannSearcher(index_path, **kwargs)
