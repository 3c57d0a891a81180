"""Product quantization: train / encode / ADC lookup tables in PyTorch.

Counterpart of the JAX package's ``ops/pq.py`` with the same layout: D is
split into M subspaces of ds dims with K=256 centroids each; codes are
``u8[N, M]``; codebooks ``f32[M, K, ds]`` (plain) or lifted OPQ codebooks
``f32[M, K, D]`` with ``B[m, k] = R_m @ c[m, k]`` (``R_m`` the m-th ds-column
block of the learned rotation). Because R is orthogonal the lifted tensor is
the complete artifact: :func:`adc_lut` and :func:`encode_pq` dispatch on
shape (``M*ds == D`` plain, last dim ``== D`` lifted).

Training draws its sample and its k-means init from the same numpy
``default_rng(seed)`` calls as the JAX package, so both start from the same
centroids. ``adc_distances`` is a plain gather-and-sum (the JAX package's
bf16 one-hot formulation exists for the TPU's matrix unit and computes the
same function).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..device import resolve_device

logger = logging.getLogger(__name__)

# bound on the [M, S, K] f32 distance block one k-means step materializes
_KMEANS_BLOCK_BYTES = 1 << 30


def choose_m(dim: int, target_m: int = 0) -> int:
    """Pick a subspace count that divides dim (prefer ~dim/8, i.e. ds=8)."""
    if target_m and dim % target_m == 0:
        return target_m
    for m in (dim // 8, dim // 4, dim // 16, dim // 2):
        if m and dim % m == 0:
            return m
    return 1


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x [M, S, ds], c [M, K, ds] -> [M, S, K] squared L2 (f32)."""
    return x.square().sum(-1, keepdim=True) - 2.0 * torch.bmm(x, c.transpose(1, 2)) + c.square().sum(-1)[:, None, :]


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per (subspace, row): [M, S] int64, first on ties.
    Subspaces are processed in groups so [M, S, K] stays bounded."""
    m, s, _ = x.shape
    k = c.shape[1]
    step = max(1, _KMEANS_BLOCK_BYTES // max(s * k * 4, 1))
    return torch.cat([_sq_dists(x[i : i + step], c[i : i + step]).argmin(dim=2) for i in range(0, m, step)])


def _kmeans_all_subspaces(xs: torch.Tensor, init: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Lloyd's k-means in every subspace at once: xs [M, S, ds], init
    [M, K, ds] -> [M, K, ds]. Dead centroids keep their previous position.
    Cluster sums are one-hot products, as in the JAX package: a float
    scatter-add would sum in atomic order on the card, and the codebooks
    (and so the index) would change from run to run."""
    c = init.clone()
    m, s, ds = xs.shape
    k = c.shape[1]
    step = max(1, _KMEANS_BLOCK_BYTES // max(s * k * 4, 1))
    for _ in range(n_iters):
        a = _assign(xs, c)  # [M, S]
        counts = torch.empty((m, k), dtype=torch.float32, device=xs.device)
        sums = torch.empty((m, k, ds), dtype=torch.float32, device=xs.device)
        for i in range(0, m, step):
            one_hot = torch.nn.functional.one_hot(a[i : i + step], k).to(torch.float32)  # [m', S, K]
            counts[i : i + step] = one_hot.sum(dim=1)
            sums[i : i + step] = torch.bmm(one_hot.transpose(1, 2), xs[i : i + step])
        c = torch.where(counts[:, :, None] > 0, sums / counts.clamp_min(1.0)[:, :, None], c)
    return c


def _bucket_sample(x: np.ndarray, sample: int, rng) -> np.ndarray:
    """Subsample to the largest power of two <= min(n, sample) rows (the JAX
    package buckets to bound compiles; kept so both draw the same rows)."""
    n = x.shape[0]
    size = min(n, sample)
    bucket = 1 << (size.bit_length() - 1)
    if bucket == n:
        return x
    return x[rng.choice(n, bucket, replace=False)]


def train_pq(x: np.ndarray, m: int = 0, k: int = 256, n_iters: int = 10, sample: int = 65536,
             seed: int = 0, device: "str | torch.device" = "cuda") -> np.ndarray:
    """Train codebooks on (a sample of) x [N, D] -> f32[M, K, ds]."""
    dev = resolve_device(device)
    n, d = x.shape
    m = choose_m(d, m)
    ds = d // m
    rng = np.random.default_rng(seed)
    x = np.asarray(_bucket_sample(x, sample, rng), np.float32)
    xs = torch.from_numpy(np.ascontiguousarray(x.reshape(-1, m, ds).transpose(1, 0, 2))).to(dev)
    k_eff = min(k, xs.shape[1])
    init_idx = rng.choice(xs.shape[1], k_eff, replace=False)
    init = xs[:, torch.from_numpy(init_idx).to(dev), :]
    cb = _kmeans_all_subspaces(xs, init, n_iters)
    if k_eff < k:  # pad to fixed K so codes stay u8-addressable
        cb = torch.cat([cb, cb[:, :1, :].expand(m, k - k_eff, ds) + 1e6], dim=1)
    return cb.cpu().numpy()


def _opq_iter(x: torch.Tensor, r: torch.Tensor, cb: torch.Tensor, n_kmeans: int):
    """One OPQ-NP alternation step (rotation fixed): refine codebooks on the
    rotated sample, then return X^T @ recon for the host-side Procrustes SVD.
    x [S, D], r [D, D], cb [M, K, ds] -> (cb', XtY [D, D], mse)."""
    s, d = x.shape
    m, k, ds = cb.shape
    xr = x @ r
    xs = xr.reshape(s, m, ds).transpose(0, 1).contiguous()  # [M, S, ds]
    cb = _kmeans_all_subspaces(xs, cb, n_kmeans)
    codes = _assign(xs, cb)  # [M, S]
    recon = torch.gather(cb, 1, codes[:, :, None].expand(m, s, ds))  # [M, S, ds]
    y = recon.transpose(0, 1).reshape(s, d)
    xty = x.T @ y
    mse = (xr - y).square().sum(1).mean()
    return cb, xty, mse


def train_opq(x: np.ndarray, m: int = 0, k: int = 256, n_iters: int = 10, opq_iters: int = 8,
              sample: int = 65536, seed: int = 0, factorized: bool = False,
              device: "str | torch.device" = "cuda"):
    """OPQ-NP: alternate per-subspace k-means with the Procrustes update
    R = U V^T of SVD(X^T Y). Returns lifted codebooks f32[M, K, D], or with
    ``factorized=True`` ``(rotation f32[D, D], plain codebooks f32[M, K, ds])``,
    the compact on-disk form."""
    dev = resolve_device(device)
    n, d = x.shape
    m = choose_m(d, m)
    ds = d // m
    rng = np.random.default_rng(seed)
    x = np.asarray(_bucket_sample(x, sample, rng), np.float32)
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    r = torch.eye(d, dtype=torch.float32, device=dev)  # identity init: starts at plain PQ
    k_eff = min(k, x.shape[0])
    init_idx = rng.choice(x.shape[0], k_eff, replace=False)
    cb = torch.from_numpy(np.ascontiguousarray(x[init_idx].reshape(k_eff, m, ds).transpose(1, 0, 2))).to(dev)
    for it in range(opq_iters):
        # early iterations: few k-means refinements (centroids chase the
        # moving rotation); final pass: full-budget polish
        cb, xty, _ = _opq_iter(xd, r, cb, n_kmeans=(n_iters if it == opq_iters - 1 else 3))
        if it < opq_iters - 1:  # Procrustes on host: D x D SVD is tiny
            u, _, vt = np.linalg.svd(xty.cpu().numpy())
            r = torch.from_numpy((u @ vt).astype(np.float32)).to(dev)
    cb = cb.cpu().numpy()
    if k_eff < k:
        cb = np.concatenate([cb, np.tile(cb[:, :1], (1, k - k_eff, 1)) + 1e6], axis=1)
    rot = r.cpu().numpy()
    if factorized:
        return rot, cb
    return lift_codebooks(rot, cb)


def lift_codebooks(rotation: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """(R f32[D, D], plain cb f32[M, K, ds]) -> lifted f32[M, K, D] with
    B[m, k] = R_m @ c[m, k], R_m = ds-column block m of R."""
    d = rotation.shape[0]
    m, k, ds = cb.shape
    r_blocks = torch.tensor(rotation.reshape(d, m, ds).transpose(1, 0, 2), dtype=torch.float32)
    return torch.bmm(torch.tensor(cb, dtype=torch.float32), r_blocks.transpose(1, 2)).numpy()


def encode_pq(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x [B, D], codebooks [M, K, ds] (plain) or [M, K, D] (lifted OPQ)
    -> codes u8[B, M] (nearest centroid, first on ties)."""
    x = x.float()
    m, k, ds = codebooks.shape
    if m * ds != x.shape[1]:  # lifted: argmin_k ||B||^2 - 2 x.B
        dots = (x @ codebooks.reshape(m * k, -1).T).reshape(x.shape[0], m, k)
        d = codebooks.square().sum(-1)[None] - 2.0 * dots
        return d.argmin(dim=2).to(torch.uint8)
    xs = x.reshape(x.shape[0], m, ds).transpose(0, 1).contiguous()  # [M, B, ds]
    return _assign(xs, codebooks).T.to(torch.uint8)


def encode_pq_blocked(x: np.ndarray, codebooks: np.ndarray, block: int = 16384,
                      device: "str | torch.device" = "cuda") -> np.ndarray:
    dev = resolve_device(device)
    t0 = time.time()
    cb = torch.tensor(codebooks, dtype=torch.float32, device=dev)
    out = np.empty((x.shape[0], codebooks.shape[0]), dtype=np.uint8)
    for bi, s in enumerate(range(0, x.shape[0], block)):
        rows = torch.from_numpy(np.ascontiguousarray(x[s : s + block], dtype=np.float32)).to(dev)
        out[s : s + block] = encode_pq(rows, cb).cpu().numpy()
        if bi % 64 == 63:
            logger.info("encode_pq_blocked: %d/%d rows (%.0fs)", min(s + block, x.shape[0]), x.shape[0],
                        time.time() - t0)
    return out


def decode_pq(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct vectors from plain-PQ codes: codebooks [M, K, ds], codes
    int [..., M] -> [..., M*ds]; subspace m fills dims m*ds:(m+1)*ds."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codes.device)
    dec = codebooks[sub, codes.long()]  # [..., M, ds]
    return dec.reshape(*codes.shape[:-1], -1)


def adc_lut(q: torch.Tensor, codebooks: torch.Tensor, metric: str) -> torch.Tensor:
    """ADC tables: q [..., D] -> lut f32[..., M, K] with
    dist(q, x) ~ sum_m lut[m, code[x, m]] (lower = closer). Codebooks may be
    plain [M, K, ds] or lifted [M, K, D]."""
    m, k, ds = codebooks.shape
    q = q.float()
    if m * ds != q.shape[-1]:  # lifted
        dots = (q @ codebooks.reshape(m * k, -1).T).reshape(*q.shape[:-1], m, k)
        if metric in ("mips", "cosine"):
            return -dots
        # + ||q||^2/M so sum_m lut = full ||qR - recon||^2 (absolute scale)
        return codebooks.square().sum(-1) - 2.0 * dots + (q.square().sum(-1) / m)[..., None, None]
    qs = q.reshape(*q.shape[:-1], m, 1, ds)
    if metric in ("mips", "cosine"):
        return -(qs * codebooks).sum(-1)
    return (qs - codebooks).square().sum(-1)


def adc_distances(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes int [..., C, M], lut [..., M, K] (matching leading dims, or an
    unbatched [C, M] / [M, K] pair) -> approx distances [..., C] f32: a
    gather of each subspace's table entry and a sum over subspaces."""
    m, k = lut.shape[-2:]
    flat = lut.reshape(*lut.shape[:-2], 1, m * k)
    idx = codes.long() + torch.arange(m, device=codes.device) * k  # [..., C, M]
    flat = flat.expand(*idx.shape[:-1], m * k)
    return torch.gather(flat, -1, idx).sum(-1)
