"""leann_torch's build past the card's memory against the JAX package's on
the same inputs (CPU): the PQ-mode prune, build_graph with the sharded
k-NN and the PQ prune forced by lowering both thresholds (as the JAX
package's own tests force them), and the checkpointed build, resumed across
packages."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_torch.ops import graph as tg
from leann_tpu.ops import graph as jg
from leann_tpu.ops.pq import encode_pq as jax_encode_pq
from leann_tpu.ops.pq import train_pq as jax_train_pq


def _clustered(seed, n, d, n_c=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, n_c, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7)


def _overlap(a, b):
    return np.mean([len(set(x[x >= 0]) & set(y[y >= 0])) / max(1, len(set(y[y >= 0]))) for x, y in zip(a, b)])


def test_prune_pq_m_matches_jax():
    for d in (29, 32, 48, 384, 385, 768, 784):
        assert tg._prune_pq_m(d) == jg._prune_pq_m(d)
    for n in (1, 100, 1000, 1025, 5000, 123_457):
        assert tg._bucket_rows(n, 512) == jg._bucket_rows(n, 512)


def test_robust_prune_pq_same_codes_and_codebooks():
    n, d, c = 512, 32, 24
    emb = _clustered(0, n, d)
    m = jg._prune_pq_m(d)
    cb = jax_train_pq(emb, m=m, n_iters=8)
    codes = np.array(jax_encode_pq(jnp.asarray(emb), jnp.asarray(cb)))
    cand, _ = jg.exact_knn(emb, c, approx_recall=1.0)
    pe = jnp.asarray(emb).astype(jnp.bfloat16)
    want = np.asarray(jg._robust_prune_pq_device(jnp.asarray(codes), jnp.asarray(cb), pe, jnp.asarray(cand),
                                                 8, 1.2, 2, 64, n_blocks=n // 64))
    got = tg._robust_prune_pq_device(torch.from_numpy(codes), torch.from_numpy(np.array(cb)),
                                     torch.from_numpy(emb).to(torch.bfloat16), torch.from_numpy(cand.astype(np.int64)),
                                     8, 1.2, 2, 100).numpy()
    assert got.shape == want.shape == (n, 8)
    assert (got == want).all(axis=1).mean() >= 0.99


@pytest.fixture()
def forced(monkeypatch):
    """Both thresholds low in both packages: the sharded k-NN and the PQ prune run."""
    monkeypatch.setattr(jg, "EXACT_KNN_MAX_N", 500)
    monkeypatch.setattr(jg, "PRUNE_EBF_MAX_BYTES", 1)
    monkeypatch.setattr(tg, "exact_knn_max_n", lambda d, k, device: 500)
    monkeypatch.setattr(tg, "prune_ebf_max_bytes", lambda device: 1)
    seen = []
    orig = tg.exact_knn_sharded
    monkeypatch.setattr(tg, "exact_knn_sharded", lambda *a, **kw: (seen.append(1), orig(*a, **kw))[1])
    return seen


def test_build_graph_past_both_caps_overlaps_jax(forced):
    emb = _clustered(1, 1500, 32)
    want, med_j = jg.build_graph(emb, r=8)
    got, med_t = tg.build_graph(emb, r=8, device="cpu")
    assert forced == [1]
    assert got.shape == want.shape == (1500, 8) and med_t == med_j
    assert _overlap(got, want) >= 0.95
    assert not (got == np.arange(1500)[:, None]).any() and ((got >= -1) & (got < 1500)).all()


def test_pq_prune_nondivisible_dim_pads(forced):
    """A width with no usable subspace divisor (29, prime) zero-pads instead
    of one global codebook; the graph keeps its near neighbours."""
    emb = np.random.default_rng(2).standard_normal((800, 29)).astype(np.float32)
    g, _ = tg.build_graph(emb, r=8, device="cpu")
    d2 = ((emb[:64, None, :] - emb[None, :, :]) ** 2).sum(-1)
    true_nn = np.argsort(d2, axis=1)[:, 1:9]
    assert np.mean([len(set(g[i][g[i] >= 0]) & set(true_nn[i])) / 8 for i in range(64)]) >= 0.3


def test_checkpointed_build_resumes_every_phase(forced, tmp_path, monkeypatch):
    """A second build with the same directory takes the pruned graph; with
    only the k-NN and the PQ codes left it takes those and runs neither the
    k-NN nor the codebook training again. Each time the same graph."""
    emb = _clustered(3, 1200, 24)
    ck = str(tmp_path)
    first, med = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck)
    names = set(os.listdir(ck))
    assert {"ckpt_knn.npy", "ckpt_pruned.npy", "ckpt_prune_codes.npy", "ckpt_prune_codes.npy.cb.npy"} <= names
    assert not any(n.startswith("exknn_state") for n in names)  # the sharded state is removed at its end
    monkeypatch.setattr(tg, "exact_knn_sharded", lambda *a, **kw: pytest.fail("k-NN ran again"))
    monkeypatch.setattr(tg, "train_pq", lambda *a, **kw: pytest.fail("codebooks trained again"))
    again, med2 = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck)
    assert np.array_equal(again, first) and med2 == med
    os.remove(os.path.join(ck, "ckpt_pruned.npy.json"))
    again, med2 = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck)
    assert np.array_equal(again, first) and med2 == med


@pytest.mark.parametrize("left", ["pruned", "knn"])
def test_jax_written_checkpoint_resumes_in_port(tmp_path, monkeypatch, left):
    """A directory the JAX package's build_graph wrote resumes in the port's,
    which never runs its own k-NN (patched to raise): from the pruned graph
    the same graph, from the k-NN candidates alone the port's prune over
    them."""
    emb = _clustered(4, 900, 24)
    ck = str(tmp_path / "ck")
    want, med_j = jg.build_graph(emb, r=8, checkpoint_dir=ck)
    if left == "knn":
        os.remove(os.path.join(ck, "ckpt_pruned.npy.json"))
    monkeypatch.setattr(tg, "exact_knn", lambda *a, **kw: pytest.fail("the port ran its own k-NN"))
    got, med_t = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck)
    assert med_t == med_j
    if left == "pruned":
        assert np.array_equal(got, want)
    else:
        assert (got == want).all(axis=1).mean() >= 0.99


def test_port_written_checkpoint_resumes_in_jax(tmp_path, monkeypatch):
    emb = _clustered(5, 900, 24)
    ck = str(tmp_path / "ck")
    want, _ = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck)
    assert json.load(open(os.path.join(ck, "ckpt_knn.npy.json")))["key"].endswith("_c16")
    monkeypatch.setattr(jg, "exact_knn", lambda *a, **kw: pytest.fail("the JAX package ran its own k-NN"))
    got, _ = jg.build_graph(emb, r=8, checkpoint_dir=ck)
    assert np.array_equal(got, want)
