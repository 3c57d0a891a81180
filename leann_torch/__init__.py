"""leann_torch: the PyTorch/CUDA port of LEANN-TPU's low-storage vector index.

Builds and searches the same compact index as the JAX package (pruned graph
+ PQ codes + token store, no embedding matrix; search re-encodes only the
nodes it reranks) on an NVIDIA GPU. The two kernels the JAX package wrote
in Pallas are hand-written CUDA here (``csrc/``), built with nvcc at first
use. Entry points take ``device=`` and default to ``"cuda"``.
:class:`BatchedSearcher` coalesces concurrent callers' queries into one
batched search; :class:`LeannChat` answers questions over an index through
an LLM. ``python -m leann_torch.cli`` and ``python -m leann_torch.mcp`` are
the command line and the MCP server.
"""

__version__ = "0.1.0"

from .api import LeannBuilder, LeannChat, LeannSearcher, PassageManager, SearchResult  # noqa: F401
from .runtime.batcher import BatchedSearcher  # noqa: F401
from .registry import autodiscover_backends, get_registered_backends, register_backend  # noqa: F401

__all__ = [
    "BatchedSearcher",
    "LeannBuilder",
    "LeannChat",
    "LeannSearcher",
    "PassageManager",
    "SearchResult",
    "register_backend",
    "autodiscover_backends",
    "get_registered_backends",
]
