"""Flat exact search of leann_torch (the plain version of the flat top-k
kernel on CPU tensors) against the JAX package's Pallas kernel run in
interpret mode and its XLA flat search. The bar is TestPallasFlatTopk's:
>= 95% id overlap, distances within rtol 1e-2, padding never returned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_torch.ops.flat_topk import flat_topk
from leann_tpu.ops.distance import flat_search as jax_flat_search
from leann_tpu.ops.pallas_topk import pallas_flat_search


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(np.asarray(a).tolist(), np.asarray(b).tolist())])


def _inputs(seed, n, d, b, metric):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return e, q


def _port(e, q, valid_n, k, metric, device="cpu"):
    et = torch.from_numpy(e).to(device)
    ids, dists = flat_topk(torch.from_numpy(q).to(device), et.to(torch.bfloat16).contiguous(),
                           et.square().sum(1).contiguous(), valid_n, k, metric)
    return ids.cpu().numpy(), dists.cpu().numpy()


@pytest.mark.parametrize("metric", ["l2", "mips", "cosine"])
def test_matches_pallas_interpret_and_xla(metric):
    n, d, b, k = 1024, 64, 4, 5
    e, q = _inputs(0, n, d, b, metric)
    vn = n - 50
    ids, dists = _port(e, q, vn, k, metric)
    ip, dp = pallas_flat_search(jnp.asarray(e), jnp.asarray(q), jnp.int32(vn), k, metric, tile=256,
                                interpret=True)
    ix, dx = jax_flat_search(jnp.asarray(e), jnp.asarray(q), jnp.int32(vn), k, metric)
    for ref_i, ref_d in ((ip, dp), (ix, dx)):
        assert _overlap(ids, ref_i) >= 0.95
        np.testing.assert_allclose(np.sort(dists), np.sort(np.asarray(ref_d)), rtol=1e-2, atol=1e-2)
    assert (ids < vn).all() and (ids >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_valid_n_masks_padding(metric):
    rng = np.random.default_rng(1)
    n, d = 512, 32
    e = np.zeros((n, d), np.float32)
    e[:10] = rng.standard_normal((10, d))
    # padding rows would win under mips if unmasked (dot=0 beats negatives)
    q = -np.abs(rng.standard_normal((2, d))).astype(np.float32)
    ids, _ = _port(e, q, 10, 3, metric)
    assert (ids < 10).all()


def test_fewer_valid_rows_than_k():
    e, q = _inputs(2, 64, 16, 3, "l2")
    ids, dists = _port(e, q, 4, 6, "l2")
    assert (ids[:, :4] >= 0).all() and (ids[:, 4:] == -1).all()
    assert (dists[:, 4:] >= 3e38).all()
