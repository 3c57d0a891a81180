"""Shared backend plumbing: padding helpers, the base searchers, the entry pool.

Counterpart of the JAX package's ``backends/common.py`` plus the entry-pool
rules of its ``backends/hnsw/backend.py``, which both graph builders use,
and the state and search calls its hnsw and diskann searchers share
(:class:`GraphSearcher`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..embeddings.compute import IN_PROCESS_MODES, compute_embeddings
from ..embeddings.encoder import encode_tokens
from ..ops.beam_search import (GraphData, beam_search_adaptive, beam_search_batch_packed,
                               beam_search_text_batch_packed, unpack_results)
from ..ops.pq import lift_codebooks
from ..parallel.mesh import graph_mesh, shard_devices
from ..parallel.sharded_build import sharded_build_graph
from ..parallel.sharded_search import ShardedSearcher
from ..storage import derive_token_cache, load_ids, load_token_cache, save_ids, unpack_neighbors  # noqa: F401

logger = logging.getLogger(__name__)

N_ENTRY_POINTS = 16
ENTRY_POOL_SIZE = 4096


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def bucket_batch(n: int) -> int:
    """Round a query-batch size up to a power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def pad_batch_rows(*arrays: np.ndarray) -> "tuple[int, list]":
    """Pad [B, ...] arrays to a pow2 batch by repeating row 0 -> (real_b,
    [padded arrays]). Kept so a batch searches the same rows as in the JAX
    package; the padded rows repeat a real query and are sliced off."""
    real_b = arrays[0].shape[0]
    b = bucket_batch(real_b)
    if b == real_b:
        return real_b, list(arrays)
    out = []
    for a in arrays:
        reps = np.repeat(a[:1], b - real_b, axis=0)
        out.append(np.concatenate([a, reps], axis=0))
    return real_b, out


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to leann_torch yet ({item})")


def _entry_points(medoid: int, n: int, count: int = N_ENTRY_POINTS) -> np.ndarray:
    """Medoid + strided sample of starting points."""
    pts = [medoid] + [int(i * n / count) for i in range(count)]
    uniq = list(dict.fromkeys(p for p in pts if 0 <= p < n))
    return np.asarray(uniq[:count], np.int32)


def _pool_cap(n: int) -> int:
    """Entry-pool size: n/16 (capped 32K), floored at ENTRY_POOL_SIZE and
    capped at n/4 so the pool stays a genuine subset on small corpora."""
    return min(max(ENTRY_POOL_SIZE, min(n // 16, 32768)), max(n // 4, N_ENTRY_POINTS))


def _entry_pool(medoid: int, n: int, has_screen: bool) -> np.ndarray:
    """Entry pool: with a per-query screen (stored embeddings or PQ codes), a
    large strided pool from which each query picks its best seeds; otherwise
    a small fixed set."""
    if not has_screen:
        return _entry_points(medoid, n, N_ENTRY_POINTS)
    return _entry_points(medoid, n, min(_pool_cap(n), n))


class BaseSearcher:
    """Loads common index state: meta, id list, optional token store."""

    def __init__(self, index_path: str, meta: Optional[Dict[str, Any]] = None, device: str = "cuda", **kwargs):
        self.device = resolve_device(device)
        self.index_path = index_path
        if meta is None:
            with open(f"{index_path}.meta.json") as f:
                meta = json.load(f)
        self.meta = meta
        self.embedding_model = meta.get("embedding_model", "hash-minilm")
        self.embedding_mode = meta.get("embedding_mode", "tpu")
        self.distance_metric = meta.get("distance_metric", "mips")
        self.max_length = meta.get("max_length", 256)
        self.dim = meta.get("dimensions")
        self.id_list: List[str] = load_ids(index_path)

    def get_encoder(self):
        """The index's query/recompute encoder, with its corpus calibration
        (``<prefix>.calib.npz``) applied to a copy when one exists."""
        if getattr(self, "_calibrated_enc", None) is not None:
            return self._calibrated_enc
        from ..embeddings.encoder import get_encoder

        enc = get_encoder(self.embedding_model, max_length=self.max_length, device=self.device)
        calib_path = f"{self.index_path}.calib.npz"
        if os.path.exists(calib_path):
            z = np.load(calib_path)
            enc = enc.with_calibration({"out_center": z["out_center"], "out_pc": z["out_pc"]})
        self._calibrated_enc = enc
        return enc

    def compute_query_embedding(self, query: str, **kwargs) -> np.ndarray:
        if self.embedding_mode in IN_PROCESS_MODES:
            return self.get_encoder().encode([query])
        return compute_embeddings(
            [query], self.embedding_model, mode=self.embedding_mode, max_length=self.max_length,
            device=self.device,
            **({"dim": self.dim} if (self.dim and self.embedding_mode == "simulated") else {}),
        )

    def load_tokens(self) -> "tuple[np.ndarray, np.ndarray] | None":
        """Token matrix -> (tokens [N, T] u16|i32, lengths [N]); regenerated
        from the passages when the cache is absent (it is derivable state)."""
        tok = load_token_cache(self.index_path)
        if tok is not None:
            return tok
        if not self.meta.get("is_recompute", True):
            return None
        return derive_token_cache(self.index_path, self.embedding_model, self.max_length, device=self.device)

    def load_entry_emb(self, z) -> "np.ndarray | None":
        """Entry-pool f16 embeddings for the exact entry screen: from the
        backend npz, else ``<prefix>.entries.cache.npy``, else derived by
        re-encoding the entry rows' tokens (the recompute pipeline's own
        numerics) and cached."""
        if "entry_emb" in z:
            return np.asarray(z["entry_emb"])
        cache = f"{self.index_path}.entries.cache.npy"
        if os.path.exists(cache):
            return np.load(cache)
        metric = str(z["metric"]) if "metric" in z else self.distance_metric
        if metric not in ("l2", "cosine") or "entries" not in z:
            return None  # mips pools live in the augmented build space
        tok = self.load_tokens()
        if tok is None:
            return None
        entries = np.asarray(z["entries"])
        toks = np.asarray(tok[0][entries], np.int32)
        lens = np.asarray(tok[1])[entries]
        mask = (np.arange(toks.shape[1])[None, :] < lens[:, None]).astype(np.int32)
        enc = self.get_encoder()
        out = np.empty((toks.shape[0], enc.cfg.dim), np.float16)
        step = 4096
        with torch.no_grad():
            for s in range(0, toks.shape[0], step):
                e = encode_tokens(enc.params, torch.from_numpy(toks[s : s + step]).to(self.device),
                                  torch.from_numpy(mask[s : s + step]).to(self.device), enc.cfg)
                if metric == "cosine" and not enc.cfg.normalize:
                    e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
                out[s : s + e.shape[0]] = e.cpu().numpy().astype(np.float16)
        tmp = cache + ".tmp.npy"
        np.save(tmp, out)
        os.replace(tmp, cache)
        logger.info("entry pool derived from tokens: %s rows", out.shape[0])
        return out

    def cleanup(self) -> None:
        pass


class GraphSearcher(BaseSearcher):
    """A graph backend's searcher: the graph, PQ codes and codebooks, stored
    embeddings, the entry pool with its embeddings and the token store, all
    on the searcher's device (absent parts None), and the search calls. A
    subclass loads its npz with :meth:`_load` and gives ``_make_cfg(top_k,
    **search_kwargs) -> (BeamConfig, encoder params)``. Both searches take
    ``adaptive_steps`` > 0 for the two-phase batched search
    (``ops/beam_search.beam_search_adaptive``): the batch runs with the step
    budget capped there, then only the lanes that reached the cap run again
    at full budget. The results are the same."""

    @staticmethod
    def _want_sharded(sharded: "bool | str", device: torch.device) -> bool:
        """``sharded``: True, False, or "auto": sharded when the searcher
        runs on a card and the machine has more than one."""
        if sharded == "auto":
            return device.type == "cuda" and torch.cuda.device_count() > 1
        return sharded is True

    def _shard(self) -> None:
        """Place the loaded index over a ``gp`` mesh of
        ``mesh.shard_devices(device)`` (one shard per card): the sharded
        searcher slices the device tensors where a shard lies on the
        searcher's device, so a card holds its rows once."""
        mesh = graph_mesh(devices=shard_devices(self.device))
        self._sharded = ShardedSearcher(mesh, self.neighbors, entries=self.entries, emb=self.emb,
                                        tokens=self.tokens, lengths=self.lengths, codes=self.codes,
                                        codebooks=self.codebooks, entry_emb=self.entry_emb)
        logger.info("%s searcher sharded over %d shards", type(self).__name__, mesh.size)

    def _load(self, z, tokens_on_device: bool = True) -> None:
        """State of the backend npz ``z`` onto the device; the token store
        stays on the host as ``tokens_host`` / ``lengths_host`` (a raw
        store memmapped, as loaded) unless ``tokens_on_device``."""
        dev = self.device
        self.neighbors = torch.from_numpy(unpack_neighbors(z).astype(np.int64)).to(dev)
        self.entries = np.asarray(z["entries"])
        self.metric = str(z["metric"])
        self.n = int(self.neighbors.shape[0])
        self.codes = torch.from_numpy(np.asarray(z["codes"])).to(dev) if "codes" in z else None
        self.codebooks = None
        if "codebooks" in z:
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
        self.tokens = self.lengths = self.tokens_host = self.lengths_host = None
        if tok is not None and tokens_on_device:
            # u16 stores widen to i32 on load (the gather indexes an embedding table)
            self.tokens = torch.from_numpy(np.array(tok[0], np.int32)).to(dev)
            self.lengths = torch.from_numpy(np.array(tok[1], np.int32)).to(dev)
        elif tok is not None:
            self.tokens_host = tok[0]
            self.lengths_host = np.asarray(tok[1], np.int32)
        self._enc = None
        self._sharded: Optional[ShardedSearcher] = None

    def _encoder(self):
        if self._enc is None:
            self._enc = self.get_encoder()
        return self._enc

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

    def _query_batch(self, query: np.ndarray) -> "tuple[int, torch.Tensor]":
        """Query rows -> (real rows, the batch padded to a power of two on
        the device)."""
        real_b, (qp,) = pad_batch_rows(np.ascontiguousarray(query, dtype=np.float32))
        return real_b, torch.from_numpy(qp).to(self.device)

    def _encode_text(self, queries: list, cfg, enc_params) -> "tuple[int, torch.Tensor]":
        """Query strings -> (real rows, padded batch encoded on the device),
        with the same calls as the fused text search, so both search the
        same query vectors."""
        q_ids, q_mask = self._encoder().tokenize(queries)
        real_b, (q_ids, q_mask) = pad_batch_rows(q_ids, q_mask)
        q = encode_tokens(enc_params, torch.from_numpy(q_ids).to(self.device),
                          torch.from_numpy(q_mask).to(self.device), cfg.enc_cfg)
        if cfg.normalize and not cfg.enc_cfg.normalize:
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return real_b, q

    def _run(self, real_b: int, qp: torch.Tensor, cfg, enc_params, adaptive_steps: int) -> Dict[str, np.ndarray]:
        """Search the padded batch ``qp`` -> the first ``real_b`` rows'
        results. A sharded searcher runs the mesh search (which has no
        adaptive pass, as in the JAX package), each shard re-encoding at
        most ``prune_keep // gp`` candidates a hop."""
        if self._sharded is not None:
            keep_local = max(1, cfg.prune_keep // self._sharded.gp) if cfg.prune_keep else 0
            labels, dists = self._sharded.search(qp, cfg, enc_params, keep_local=keep_local)
        elif adaptive_steps:
            labels, dists, _, _ = beam_search_adaptive(qp, self._graph_data(), cfg, enc_params,
                                                       first_steps=adaptive_steps)
        else:
            labels, dists = unpack_results(beam_search_batch_packed(qp, self._graph_data(), cfg, enc_params))
        return {"labels": labels[:real_b], "distances": dists[:real_b]}

    @torch.no_grad()
    def search(self, query: np.ndarray, top_k: int, adaptive_steps: int = 0, **kwargs) -> Dict[str, np.ndarray]:
        cfg, enc_params = self._make_cfg(top_k, **kwargs)
        return self._run(*self._query_batch(query), cfg, enc_params, int(adaptive_steps or 0))

    @torch.no_grad()
    def search_text(self, query: "str | list", top_k: int, adaptive_steps: int = 0,
                    **kwargs) -> Dict[str, np.ndarray]:
        """Encode the query batch on the device and search it: one fused
        program, or with ``adaptive_steps`` the two-phase search over the
        same encoded queries."""
        queries = [query] if isinstance(query, str) else list(query)
        cfg, enc_params = self._make_cfg(top_k, need_encoder=True, **kwargs)
        if adaptive_steps or self._sharded is not None:
            return self._run(*self._encode_text(queries, cfg, enc_params), cfg, enc_params, int(adaptive_steps))
        q_ids, q_mask = self._encoder().tokenize(queries)
        real_b, (q_ids, q_mask) = pad_batch_rows(q_ids, q_mask)
        packed = beam_search_text_batch_packed(
            torch.from_numpy(q_ids).to(self.device), torch.from_numpy(q_mask).to(self.device),
            self._graph_data(), cfg, enc_params)
        labels, dists = unpack_results(packed)
        return {"labels": labels[:real_b], "distances": dists[:real_b]}


def sharded_neighbors(builder, graph_data: np.ndarray, r: int, candidate_factor: int) -> "tuple[np.ndarray, int]":
    """A graph builder's ``build_sharded`` graph -> (neighbors i32[N, R],
    medoid): the gp-mesh build (``parallel/sharded_build.py``) over
    ``mesh.shard_devices(builder.device)`` (one shard per card), which, as
    in the JAX package, keeps no checkpoints and takes no reverse
    candidates. Phase seconds go to ``builder.phase_seconds``."""
    if builder.build_checkpoint_dir:
        logger.warning("build_checkpoint_dir is not supported by the mesh-sharded build; phases will not checkpoint")
    mesh = graph_mesh(devices=shard_devices(builder.device))
    return sharded_build_graph(graph_data, mesh, r=r, candidate_factor=candidate_factor, alpha=builder.alpha,
                               phase_seconds=builder.phase_seconds)


def mips_augment(data):
    """MIPS -> L2 reduction for graph construction: append
    sqrt(max||x||^2 - ||x||^2) so L2 neighborhoods in the augmented space
    order like inner products. Build only."""
    norms2 = np.einsum("ij,ij->i", data, data, dtype=np.float32)
    aug = np.sqrt(np.maximum(norms2.max() - norms2, 0.0)).astype(data.dtype)
    return np.concatenate([data, aug[:, None]], axis=1)
