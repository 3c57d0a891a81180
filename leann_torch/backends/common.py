"""Shared backend plumbing: padding helpers, the base searcher, the entry pool.

Counterpart of the JAX package's ``backends/common.py`` plus the entry-pool
rules of its ``backends/hnsw/backend.py``, which the diskann builder uses.
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
from ..storage import derive_token_cache, load_ids, load_token_cache, save_ids  # noqa: F401 (re-export)

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
        from ..embeddings.encoder import encode_tokens

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


def mips_augment(data):
    """MIPS -> L2 reduction for graph construction: append
    sqrt(max||x||^2 - ||x||^2) so L2 neighborhoods in the augmented space
    order like inner products. Build only."""
    norms2 = np.einsum("ij,ij->i", data, data, dtype=np.float32)
    aug = np.sqrt(np.maximum(norms2.max() - norms2, 0.0)).astype(data.dtype)
    return np.concatenate([data, aug[:, None]], axis=1)
