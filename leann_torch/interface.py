"""Backend abstract interfaces.

Parity with the reference ABCs (leann-core/src/leann/interface.py:7-107):
``build(data, ids, index_path, **kw)``, ``search(query, top_k, ...)`` returning
``{"labels", "distances"}``, ``compute_query_embedding``, and a factory with
static ``builder()`` / ``searcher()``.

Deltas from the reference:
  * no ``zmq_port`` plumbing — recomputation is an in-process encoder call,
    not an IPC round-trip to an embedding-server subprocess. The kwarg is
    still accepted (and ignored) so reference call sites keep working.
  * searchers may accept pre-tokenized passages for on-device recompute.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict

import numpy as np


class LeannBackendBuilderInterface(ABC):
    @abstractmethod
    def build(self, data: np.ndarray, ids: list, index_path: str, **kwargs) -> None:
        """Build an index from ``data`` ([N, D] float32) with string ``ids``
        and persist it under ``index_path`` (a ``<dir>/<name>.leann`` prefix)."""


class LeannBackendSearcherInterface(ABC):
    @abstractmethod
    def search(
        self,
        query: np.ndarray,
        top_k: int,
        *,
        complexity: int = 64,
        beam_width: int = 1,
        prune_ratio: float = 0.0,
        recompute_embeddings: bool = False,
        pruning_strategy: str = "global",
        zmq_port: "int | None" = None,  # accepted for API parity; unused here
        batch_size: int = 0,
        **kwargs,
    ) -> Dict[str, np.ndarray]:
        """Search ``query`` ([B, D] float32) returning ``{"labels": [B, k],
        "distances": [B, k]}`` with integer labels into the builder's id list."""

    @abstractmethod
    def compute_query_embedding(self, query: str, **kwargs) -> np.ndarray:
        """Embed a query string -> [1, D] float32."""


class LeannBackendFactoryInterface(ABC):
    @staticmethod
    @abstractmethod
    def builder(**kwargs) -> LeannBackendBuilderInterface: ...

    @staticmethod
    @abstractmethod
    def searcher(index_path: str, **kwargs) -> LeannBackendSearcherInterface: ...
