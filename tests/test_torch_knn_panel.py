"""Exact k-NN of leann_torch's build (the plain version of the knn_panel
kernel on CPU tensors) against the JAX package's exact_knn with its default
XLA panel and approx_recall=1.0. The bar is test_exact_knn_e2e_pallas_panel's:
>= 98% id overlap; self and padding never returned."""

import numpy as np
import pytest
import torch

from leann_torch.ops import knn_panel as kp
from leann_torch.ops.graph import exact_knn
from leann_torch.ops.knn_panel import knn_panel, panel_inputs
from leann_tpu.ops.graph import exact_knn as jax_exact_knn


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a.tolist(), b.tolist())])


@pytest.mark.parametrize("n,d,k", [(300, 16, 8), (257, 385, 16), (200, 64, 64)])
def test_exact_knn_matches_jax(n, d, k):
    emb = np.random.default_rng(n + d).standard_normal((n, d)).astype(np.float32)
    ids, dists = exact_knn(emb, k, device="cpu")
    ref_i, ref_d = jax_exact_knn(emb, k, approx_recall=1.0)
    assert ids.shape == (n, k) and ids.dtype == np.int32
    assert _overlap(ids, ref_i) >= 0.98
    np.testing.assert_allclose(dists, ref_d, rtol=1e-4, atol=1e-3)
    assert not (ids == np.arange(n)[:, None]).any()  # self never returned
    assert ((ids >= 0) & (ids < n)).all()


def test_plain_version_blocks_match_one_block(monkeypatch):
    emb = np.random.default_rng(8).standard_normal((300, 40)).astype(np.float32)
    ebf, norms = panel_inputs(torch.from_numpy(emb))
    assert ebf.shape == (300, 48) and (ebf[:, 40:] == 0).all()  # features padded to 16
    whole = knn_panel(ebf, norms, 12, q_start=20, q_count=250, n_real=290)
    monkeypatch.setattr(kp, "PLAIN_ROWS", 64)  # 250 rows -> 4 blocks, the last ragged
    blocked = knn_panel(ebf, norms, 12, q_start=20, q_count=250, n_real=290)
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


def test_padding_rows_never_returned():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((120, 24)).astype(np.float32)
    emb[100:] = 0.0  # padding rows: zeros would be close to everything small
    ebf, norms = panel_inputs(torch.from_numpy(emb))
    ids, dists = knn_panel(ebf, norms, 10, q_start=10, q_count=50, n_real=100)
    ids = ids.numpy()
    assert ((ids >= 0) & (ids < 100)).all()
    assert not (ids == (np.arange(50) + 10)[:, None]).any()
    assert (np.diff(dists.numpy(), axis=1) >= 0).all()


def test_small_corpus_fills_with_minus_one():
    emb = np.random.default_rng(6).standard_normal((5, 8)).astype(np.float32)
    ids, dists = exact_knn(emb, 6, device="cpu")
    assert (ids[:, :4] >= 0).all() and (ids[:, 4:] == -1).all()
