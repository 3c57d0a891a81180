"""leann_torch's PQ/OPQ against the JAX package's on the same inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_torch.ops import pq as tpq
from leann_tpu.ops import pq as jpq


def _aniso(rng, n=4000, d=32):
    # decaying spectrum rotated off-axis: plain PQ's worst case
    spec = np.exp(-np.arange(d) / 4.0)
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return ((rng.standard_normal((n, d)) * spec) @ basis.T).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    emb = _aniso(rng, n=3000, d=32)
    cb_plain = jpq.train_pq(emb, m=8, n_iters=6, sample=2048)
    rot, cb_f = jpq.train_opq(emb, m=8, n_iters=6, opq_iters=3, sample=2048, factorized=True)
    return emb, np.array(cb_plain), np.array(rot), np.array(cb_f)  # writable copies


def _mse(emb, cb, encode):
    codes = encode(emb, cb)
    m = cb.shape[0]
    rec = np.sum(np.stack([cb[i][codes[:, i]] for i in range(m)], 0), 0) if cb.shape[2] == emb.shape[1] \
        else np.concatenate([cb[i][codes[:, i]] for i in range(m)], 1)
    return float(((emb - rec) ** 2).sum(1).mean())


def test_lift_codebooks_matches(data):
    _, _, rot, cb_f = data
    np.testing.assert_allclose(tpq.lift_codebooks(rot, cb_f), jpq.lift_codebooks(rot, cb_f), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lifted", [False, True])
def test_encode_same_codes_with_same_codebooks(data, lifted):
    emb, cb_plain, rot, cb_f = data
    cb = jpq.lift_codebooks(rot, cb_f) if lifted else cb_plain
    want = jpq.encode_pq_blocked(emb, cb)
    got = tpq.encode_pq_blocked(emb, cb, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).mean() >= 0.999  # argmin near-ties may flip


@pytest.mark.parametrize("lifted", [False, True])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_adc_lut_and_distances_match(data, lifted, metric):
    emb, cb_plain, rot, cb_f = data
    cb = jpq.lift_codebooks(rot, cb_f) if lifted else cb_plain
    codes = jpq.encode_pq_blocked(emb, cb)[:500].astype(np.int32)
    q = emb[7]
    lut_j = np.asarray(jpq.adc_lut(jnp.asarray(q), jnp.asarray(cb), metric))
    lut_t = tpq.adc_lut(torch.tensor(q), torch.tensor(cb), metric).numpy()
    np.testing.assert_allclose(lut_t, lut_j, rtol=1e-5, atol=1e-5)
    # 500 rows takes the JAX package's bf16 hi/lo one-hot path, which is
    # f32-accurate to ~2^-17 relative per table entry
    ad_j = np.asarray(jpq.adc_distances(jnp.asarray(codes), jnp.asarray(lut_j)))
    ad_t = tpq.adc_distances(torch.tensor(codes), torch.tensor(lut_j)).numpy()
    np.testing.assert_allclose(ad_t, ad_j, rtol=1e-5, atol=1e-5)


def test_adc_batched_matches_per_query(data):
    emb, cb_plain, _, _ = data
    cb = torch.from_numpy(cb_plain)
    codes = torch.from_numpy(jpq.encode_pq_blocked(emb, cb_plain)[:64].astype(np.int64))
    qs = torch.from_numpy(emb[:3])
    lut = tpq.adc_lut(qs, cb, "l2")  # [3, M, K]
    batched = tpq.adc_distances(codes[None].expand(3, -1, -1), lut)
    for i in range(3):
        np.testing.assert_allclose(batched[i].numpy(), tpq.adc_distances(codes, lut[i]).numpy(), rtol=1e-6)


def test_decode_matches(data):
    emb, cb_plain, _, _ = data
    codes = jpq.encode_pq_blocked(emb, cb_plain)[:100]
    want = np.asarray(jpq.decode_pq(jnp.asarray(cb_plain), jnp.asarray(codes)))
    got = tpq.decode_pq(torch.from_numpy(cb_plain), torch.from_numpy(codes.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_pq_mse_within_5pct(data):
    emb = data[0]
    cb_j = jpq.train_pq(emb, m=8, n_iters=6, sample=2048)
    cb_t = tpq.train_pq(emb, m=8, n_iters=6, sample=2048, device="cpu")
    assert cb_t.shape == cb_j.shape == (8, 256, 4)
    mse_j = _mse(emb, cb_j, jpq.encode_pq_blocked)
    mse_t = _mse(emb, cb_t, lambda x, c: tpq.encode_pq_blocked(x, c, device="cpu"))
    assert abs(mse_t - mse_j) <= 0.05 * mse_j


def test_train_opq_mse_within_5pct(data):
    emb = data[0]
    cb_j = jpq.train_opq(emb, m=8, n_iters=6, opq_iters=3, sample=2048)
    cb_t = tpq.train_opq(emb, m=8, n_iters=6, opq_iters=3, sample=2048, device="cpu")
    assert cb_t.shape == cb_j.shape == (8, 256, 32)
    mse_j = _mse(emb, cb_j, jpq.encode_pq_blocked)
    mse_t = _mse(emb, cb_t, lambda x, c: tpq.encode_pq_blocked(x, c, device="cpu"))
    assert abs(mse_t - mse_j) <= 0.05 * mse_j


# -- the properties of tests/test_graph_backends.py TestPQ / TestOPQ -------

def test_adc_approximates_l2():
    from scipy.stats import spearmanr

    emb = np.random.default_rng(0).standard_normal((2000, 32)).astype(np.float32)
    cb = tpq.train_pq(emb, m=8, n_iters=8, device="cpu")
    codes = tpq.encode_pq_blocked(emb, cb, device="cpu")
    lut = tpq.adc_lut(torch.from_numpy(emb[0]), torch.from_numpy(cb), "l2")
    approx = tpq.adc_distances(torch.from_numpy(codes[:100]), lut).numpy()
    exact = ((emb[:100] - emb[0]) ** 2).sum(-1)
    assert spearmanr(approx, exact).correlation > 0.85


def test_lifted_shapes_and_adc_scale():
    emb = _aniso(np.random.default_rng(1))
    cb = tpq.train_opq(emb, m=8, n_iters=6, opq_iters=4, sample=2048, device="cpu")
    assert cb.shape == (8, 256, 32)
    codes = tpq.encode_pq_blocked(emb, cb, device="cpu")
    assert codes.dtype == np.uint8 and codes.shape == (emb.shape[0], 8)
    q = emb[7]
    lut = tpq.adc_lut(torch.from_numpy(q), torch.from_numpy(cb), "l2")
    ad = tpq.adc_distances(torch.from_numpy(codes[:200]), lut).numpy()
    rec = np.sum(np.stack([cb[m][codes[:200, m]] for m in range(8)], 0), 0)
    np.testing.assert_allclose(ad, ((q[None] - rec) ** 2).sum(-1), rtol=1e-3, atol=1e-2)


def test_opq_beats_plain_pq_on_anisotropic():
    emb = _aniso(np.random.default_rng(2))
    cb_p = tpq.train_pq(emb, m=8, n_iters=6, sample=2048, device="cpu")
    cb_o = tpq.train_opq(emb, m=8, n_iters=6, opq_iters=4, sample=2048, device="cpu")

    def recall10(cb):
        codes = torch.from_numpy(tpq.encode_pq_blocked(emb, cb, device="cpu"))
        hits = 0
        for qi in range(0, 200, 10):
            q = emb[qi]
            ad = tpq.adc_distances(codes, tpq.adc_lut(torch.from_numpy(q), torch.from_numpy(cb), "l2")).numpy()
            hits += len(set(np.argsort(ad)[:10].tolist()) & set(np.argsort(((emb - q) ** 2).sum(-1))[:10].tolist()))
        return hits / 200

    assert recall10(cb_o) >= recall10(cb_p)


def test_mips_lut_matches_reconstruction():
    emb = _aniso(np.random.default_rng(3))
    cb = tpq.train_opq(emb, m=4, n_iters=4, opq_iters=3, sample=2048, device="cpu")
    codes = tpq.encode_pq_blocked(emb, cb, device="cpu")
    q = emb[3]
    ad = tpq.adc_distances(torch.from_numpy(codes[:100]),
                           tpq.adc_lut(torch.from_numpy(q), torch.from_numpy(cb), "mips")).numpy()
    rec = np.sum(np.stack([cb[m][codes[:100, m]] for m in range(4)], 0), 0)
    np.testing.assert_allclose(ad, -(rec @ q), rtol=1e-3, atol=1e-3)
