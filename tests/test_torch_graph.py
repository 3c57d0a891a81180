"""leann_torch's graph build against the JAX package's on the same inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import torch

from leann_torch.ops import graph as tg
from leann_torch.ops.knn_panel import panel_inputs
from leann_tpu.ops import graph as jg


def _emb(seed, n=256, d=24):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_robust_prune_same_candidates():
    emb = _emb(0)
    n = emb.shape[0]
    cand, _ = jg.exact_knn(emb, 32, approx_recall=1.0)
    ebf = jnp.asarray(emb).astype(jnp.bfloat16)
    nrm = jnp.sum(jnp.square(jnp.asarray(emb)), axis=1)
    want = np.asarray(jg._robust_prune_device(ebf, nrm, jnp.asarray(cand), jnp.int32(0), 16, 1.2, 4,
                                              64, n_blocks=n // 64))
    tbf, tn = panel_inputs(torch.from_numpy(emb))
    got = tg._robust_prune_device(tbf, tn, torch.from_numpy(cand.astype(np.int64)), 16, 1.2, 4, 64).numpy()
    assert got.shape == want.shape == (n, 16)
    assert (got == want).all(axis=1).mean() >= 0.99


def test_fill_reverse_edges_identical():
    nb = np.random.default_rng(1).integers(-1, 300, (300, 12)).astype(np.int32)
    want = jg._fill_reverse_edges(nb, np.random.default_rng(0))
    got = tg._fill_reverse_edges(nb, np.random.default_rng(0))
    assert np.array_equal(got, want)


def test_augment_reverse_candidates_identical():
    cand, _ = jg.exact_knn(_emb(2), 16, approx_recall=1.0)
    assert np.array_equal(tg._augment_reverse_candidates(cand, 8), jg._augment_reverse_candidates(cand, 8))


def test_medoid_identical():
    emb = _emb(3, n=500)
    assert tg.compute_medoid(emb, device="cpu") == jg.compute_medoid(emb)


def test_build_graph_overlaps_jax():
    emb = _emb(4, n=400, d=32)
    want, med_j = jg.build_graph(emb, r=16, candidate_factor=2)
    got, med_t = tg.build_graph(emb, r=16, candidate_factor=2, device="cpu")
    assert got.shape == want.shape and med_t == med_j
    ov = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, len(set(b[b >= 0])))
                  for a, b in zip(got, want)])
    assert ov >= 0.95
    assert not (got == np.arange(400)[:, None]).any()
    assert ((got >= -1) & (got < 400)).all()
