"""Distance + top-k primitives in plain PyTorch.

The three metrics of the reference (``l2`` squared L2, ``mips`` negative
inner product, ``cosine`` negative inner product of pre-normalized inputs).
Products take bf16-rounded operands with f32 accumulation, the numerics of
the JAX package's ``ops/distance.py``; squared norms are f32. This is the
plain version of the flat top-k kernel (``flat_topk.py``), which CPU tensors
use.
"""

from __future__ import annotations

from typing import Optional

import torch

INF = 3.4e38
# feature width the CUDA kernels take: one WMMA k-step, 16-byte row vectors
FEATURE_ALIGN = 16


def pad_features(x: torch.Tensor, align: int = FEATURE_ALIGN) -> torch.Tensor:
    """Zero-pad the last dimension of ``x`` to a multiple of ``align``
    (a fresh, contiguous tensor when it pads). Zero columns change no
    product and no norm."""
    pad = -x.shape[-1] % align
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def pairwise_distances(q: torch.Tensor, e: torch.Tensor, metric: str,
                       en: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, D], e [N, D] -> distances [B, N] (lower = closer) in f32.
    ``en`` (f32 [N]) supplies the corpus squared norms for l2 when ``e`` is
    held in bf16; by default they come from ``e`` itself."""
    dots = q.to(torch.bfloat16).float() @ e.to(torch.bfloat16).float().T
    if metric in ("mips", "cosine"):
        return -dots
    if metric == "l2":
        qn = q.float().square().sum(dim=-1, keepdim=True)
        if en is None:
            en = e.float().square().sum(dim=-1)
        return qn + en[None, :] - 2.0 * dots
    raise ValueError(f"unknown metric {metric!r}")


def stable_topk_smallest(d: torch.Tensor, k: int):
    """-> (values, indices) of the k smallest per row, ties to the lower
    index (the order of lax.top_k / lax.sort)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    # copies: a slice would keep the whole sorted [B, N] pair alive
    return vals[:, :k].clone(), idx[:, :k].clone()


def flat_search(e: torch.Tensor, q: torch.Tensor, valid_n: int, k: int, metric: str,
                en: Optional[torch.Tensor] = None):
    """Exact search -> (labels [B, k] i32, distances [B, k] f32). Rows at or
    beyond ``valid_n`` are never returned (they hold padding)."""
    d = pairwise_distances(q, e, metric, en)
    col = torch.arange(e.shape[0], device=d.device)[None, :]
    d = torch.where(col < valid_n, d, torch.full_like(d, INF))
    vals, idx = stable_topk_smallest(d, k)
    idx = torch.where(vals < INF, idx, torch.full_like(idx, -1))
    return idx.to(torch.int32), vals


def flat_search_packed(e, q, valid_n: int, k: int, metric: str, en=None) -> torch.Tensor:
    """:func:`flat_search` as one packed i32[B, 2k] buffer (see
    ops/beam_search.pack_results)."""
    from .beam_search import pack_results

    return pack_results(*flat_search(e, q, valid_n, k, metric, en))
