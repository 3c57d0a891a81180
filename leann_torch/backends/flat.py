"""Flat (exact brute-force) backend — the exact oracle of every recall check.

Counterpart of the JAX package's ``backends/flat.py``. The corpus is held on
the device in bf16 with f32 row norms, its features zero-padded to the
kernel's multiple of 16; a search is one call of the flat top-k kernel
(``ops/flat_topk.py``), at any corpus size. CPU tensors take the kernel's
plain version.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..interface import (
    LeannBackendBuilderInterface,
    LeannBackendFactoryInterface,
    LeannBackendSearcherInterface,
)
from ..ops.distance import pad_features
from ..ops.flat_topk import flat_topk
from ..registry import register_backend
from .common import BaseSearcher, pad_batch_rows, save_ids

logger = logging.getLogger(__name__)


class FlatBuilder(LeannBackendBuilderInterface):
    def __init__(self, distance_metric: str = "mips", device: str = "cuda", **kwargs):
        resolve_device(device)  # the index is searched on this device; no CPU fallback
        self.distance_metric = distance_metric

    def build(self, data: np.ndarray, ids: list, index_path: str, **kwargs) -> None:
        data = np.ascontiguousarray(data, dtype=np.float32)
        np.savez(f"{index_path}.flat.npz", embeddings=data, metric=self.distance_metric)
        save_ids(index_path, ids)


class FlatSearcher(BaseSearcher, LeannBackendSearcherInterface):
    def __init__(self, index_path: str, **kwargs):
        super().__init__(index_path, **kwargs)
        z = np.load(f"{index_path}.flat.npz")
        emb = torch.from_numpy(np.ascontiguousarray(z["embeddings"], np.float32)).to(self.device)
        self.metric = str(z["metric"])
        self.n = emb.shape[0]
        self._emb = pad_features(emb.to(torch.bfloat16)).contiguous()
        self._en = emb.square().sum(dim=1).contiguous()  # f32 norms keep l2 exact

    def search(self, query: np.ndarray, top_k: int, **kwargs) -> Dict[str, np.ndarray]:
        real_b, (qn,) = pad_batch_rows(np.ascontiguousarray(query, dtype=np.float32))
        q = pad_features(torch.from_numpy(qn).to(self.device))
        k = min(top_k, self.n)
        ids, dists = flat_topk(q, self._emb, self._en, self.n, k, self.metric)
        return {"labels": ids[:real_b].cpu().numpy(), "distances": dists[:real_b].cpu().numpy()}


@register_backend("flat")
class FlatBackendFactory(LeannBackendFactoryInterface):
    @staticmethod
    def builder(**kwargs) -> FlatBuilder:
        return FlatBuilder(**kwargs)

    @staticmethod
    def searcher(index_path: str, **kwargs) -> FlatSearcher:
        return FlatSearcher(index_path, **kwargs)
