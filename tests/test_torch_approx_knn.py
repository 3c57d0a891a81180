"""The approximate k-NN past the card (LEANN_KNN_MODE=spill | descent) of
leann_torch against the JAX package's, on the CPU.

The same seeded clustered corpus (N = 5,500 rows of D = 64 around 60
centres, so that NN-descent takes the cluster bootstrap above 4,096 rows;
k = 16) goes through both packages' pieces: the jax.random streams that
descent draws (bit-equal), k-means and the cluster assignment, the window
k-NN, the spill merge (bit-equal), spill and the cluster bootstrap, the
reverse-edge scatter (bit-equal), one descent round and the whole
descent. The mechanics (a descent state resumed across packages, the
state in host RAM, build_graph's dispatch and checkpoint keys) run on its
first 1,500 rows, where descent starts from random lists: a CPU round at
5,500 rows costs seconds. Candidate recall is scored against the exact
lists."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_torch.embeddings import seeded
from leann_torch.ops import graph as tg
from leann_tpu.ops import graph as jg

N, D, K = 5500, 64, 16
N_SMALL = 1500


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emb():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((60, D)).astype(np.float32) * 0.7
    return centers[rng.integers(0, 60, N)] + rng.standard_normal((N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def exact(emb):
    torch.set_num_threads(1)
    return tg.exact_knn(emb, K, device="cpu")[0]


@pytest.fixture(scope="module")
def small(emb):
    """The corpus's first rows and their exact lists."""
    torch.set_num_threads(1)
    return emb[:N_SMALL].copy(), tg.exact_knn(emb[:N_SMALL], K, device="cpu")[0]


def _recall(ids, exact):
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids.tolist(), exact.tolist())]))


def _overlap(a, b):
    """Mean share of b's real ids found in a's row (1 where neither has one)."""
    return float(np.mean([len((set(x) & set(y)) - {-1}) / len(set(y) - {-1}) if set(y) - {-1} else
                          float(not set(x) - {-1}) for x, y in zip(np.asarray(a).tolist(), np.asarray(b).tolist())]))


def _data(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_random_streams_bit_equal(seed, monkeypatch):
    key = jax.random.key(seed)
    kn = seeded.key(seed)
    assert np.array_equal(_data(key), kn)
    for data in (0, 1, 37, 2**32 - 1):
        assert np.array_equal(_data(jax.random.fold_in(key, data)), seeded.fold_in(kn, data))
    np.testing.assert_array_equal(seeded.fold_in(kn, np.arange(5)),
                                  np.stack([_data(jax.random.fold_in(key, i)) for i in range(5)]))
    # sizes of one round of sorts and of two (n > 1,625)
    for n in (16, 1700):
        assert np.array_equal(np.asarray(jax.random.permutation(key, n)), seeded.permutation(kn, n)), n
    keys = np.stack([_data(k) for k in jax.random.split(key, 3)])
    for hi in (16, 100_000):  # spans past 2^16 square the multiplier to 0
        want = np.stack([np.asarray(jax.random.randint(jax.random.wrap_key_data(jnp.asarray(kk)), (9, 7), 0, hi,
                                                       dtype=jnp.int32)) for kk in keys])
        np.testing.assert_array_equal(seeded.randint(keys[0], (9, 7), 0, hi), want[0])
        np.testing.assert_array_equal(seeded.randint_many(keys, 63, 0, hi, "cpu").numpy().reshape(3, 9, 7), want)
        # a draw taken in ranges is the whole draw, hashed in numpy (the
        # host) and by the card's torch rounds (run here on the CPU), these
        # in passes of 16 counters
        cpu = torch.device("cpu")
        monkeypatch.setattr(seeded, "_DEVICE_CHUNK", 16)
        for draw in (seeded.randint_range, lambda *a: seeded._randint_range_device(*a, cpu)):
            parts = [draw(keys[1], s, min(s + 20, 63), 0, hi).numpy() for s in range(0, 63, 20)]
            np.testing.assert_array_equal(np.concatenate(parts).reshape(9, 7), want[1])
        np.testing.assert_array_equal(seeded._randint_many_device(keys, 63, 0, hi, cpu).numpy().reshape(3, 9, 7),
                                      want)
        monkeypatch.undo()


@pytest.fixture(scope="module")
def sample(emb):
    rng = np.random.default_rng(3)
    s = np.asarray(emb[np.sort(rng.choice(N, 4096, replace=False))], np.float32)
    init = s[rng.choice(4096, 85, replace=False)]
    return s, init


def test_kmeans_and_assignment(emb, sample):
    s, init = sample
    s_pad = jg._pad_rows(s, 8192)  # padding rows are dropped in both
    want = np.asarray(jg._kmeans_full(jnp.asarray(s_pad), jnp.asarray(init), jnp.int32(4096), 8, block=4096))
    got = tg._kmeans_full(torch.from_numpy(s_pad), torch.from_numpy(init), 4096, 8, block=4096).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rows = jg._pad_rows(emb, 8192)
    a_want = np.asarray(jg._assign_clusters(jnp.asarray(rows), jnp.asarray(want), 4096))[:N]
    a_got = tg._assign_clusters(torch.from_numpy(emb), torch.from_numpy(want), 4096).numpy()
    assert np.mean(a_got == a_want) >= 0.999
    t_want = np.asarray(jg._assign_clusters_topk(jnp.asarray(rows), jnp.asarray(want), 4096, 2))[:N]
    t_got = tg._assign_clusters_topk(torch.from_numpy(emb), torch.from_numpy(want), 4096, 2).numpy()
    assert np.mean(np.all(t_got == t_want, axis=1)) >= 0.999


def test_window_knn(emb):
    window, n_real = 1024, N - 380
    rows = jg._pad_rows(emb, 6144)
    ebf = torch.from_numpy(rows).to(torch.bfloat16)
    norms = np.einsum("ij,ij->i", rows, rows, dtype=np.float32)
    wi, wd = jg._window_knn_device(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(norms), jnp.int32(n_real), K, window)
    ti, td = tg._window_knn_device(ebf, torch.from_numpy(norms), n_real, K, window)
    wi, ti = np.asarray(wi), ti.numpy()
    assert _overlap(ti, wi) >= 0.999
    assert (ti < n_real).all() and not (ti == np.arange(6144)[:, None]).any()
    assert (ti // window == np.arange(6144)[:, None] // window)[ti >= 0].all()
    np.testing.assert_allclose(td[:n_real].numpy(), np.asarray(wd)[:n_real], rtol=1e-5, atol=1e-3)


def test_merge_spill_lists_bit_equal():
    rng = np.random.default_rng(5)
    n, p, k = 700, 3, 8
    exp_orig = np.repeat(np.arange(n, dtype=np.int64), p)[rng.permutation(n * p)]
    ids = rng.integers(-1, n, (n * p, k)).astype(np.int32)
    dists = np.round(rng.random((n * p, k)) * 4, 1).astype(np.float32)  # ties across probes
    for row_block in (1 << 20, 128):
        want = jg._merge_spill_lists(ids, dists, exp_orig, n, p, k, row_block=row_block)
        got = tg._merge_spill_lists(ids, dists, exp_orig, n, p, k, row_block=row_block)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def spill(emb):
    # chunks of 8,192 rows: the JAX package pads each chunk to chunk_rows
    cluster_ids, cluster_d = jg.cluster_window_init(emb, K, n_probe=2)
    return {"jax_spill": jg.spill_knn_streamed(emb, K, chunk_rows=8192)[0], "jax_cluster": cluster_ids,
            "jax_cluster_d": cluster_d}


@pytest.mark.parametrize("which", ["spill", "cluster"])
def test_spill_and_cluster_bootstrap(emb, exact, spill, which):
    if which == "spill":  # chunks of 2 windows: the lists do not depend on the chunk
        got = tg.spill_knn_streamed(emb, K, chunk_rows=4096, device="cpu")[0]
    else:
        got = tg.cluster_window_init(emb, K, n_probe=2, device="cpu")[0]
    want = spill[f"jax_{which}"]
    assert _overlap(got, want) >= 0.99
    assert abs(_recall(got, exact) - _recall(want, exact)) <= 0.01
    assert not (got == np.arange(N)[:, None]).any()


@pytest.mark.parametrize("rows_per_chunk", [0, 128, 333])
def test_reverse_edges_bit_equal(emb, rows_per_chunk):
    """The whole draw at once, and in chunks of rows (the slots' draws
    hash their flat indices, so a split leaves them as they are)."""
    rng = np.random.default_rng(9)
    nbrs = rng.integers(0, 900, (1000, K)).astype(np.int32)  # many collisions per slot
    nbrs[rng.random(nbrs.shape) < 0.2] = -1
    key = jax.random.fold_in(jax.random.key(4), 2)
    want = np.asarray(jg._reverse_edges_device(jnp.asarray(nbrs), key, K))
    got = tg._reverse_edges_device(torch.from_numpy(nbrs), _data(key), K, rows_per_chunk).numpy()
    np.testing.assert_array_equal(got, want)


def _descent_shape(k, d):
    """nn_descent's h, k2, n_rand, block and padded rows at (N, d, k)."""
    h, k2, n_rand = min(k, max(4, 512 // k)), min(k, 32), max(4, k // 4)
    mem_cap = max(64, int((256 << 20) / ((2 * k + 4 * h * k2 + n_rand) * d * 2)))
    block = max(8, (min(2048, mem_cap) // 8) * 8)
    return h, k2, n_rand, block, jg._bucket_rows(N, block)


def test_one_round(emb, spill):
    """One round from the JAX package's cluster bootstrap, over the rows of
    the second block (the round's random escapes are drawn per block from
    its index)."""
    h, k2, n_rand, block, np_total = _descent_shape(K, D)
    nb0 = jg._pad_rows(np.asarray(spill["jax_cluster"], np.int32), np_total, fill=-1)
    d0 = jg._pad_rows(np.asarray(spill["jax_cluster_d"], np.float32), np_total, fill=np.float32(3.4e38))
    rows = jg._pad_rows(emb, np_total)
    norms = np.einsum("ij,ij->i", rows, rows, dtype=np.float32)
    rev_key, it_key = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))
    rev = jg._reverse_edges_device(jnp.asarray(nb0), rev_key, cap=K)
    wi, wd, wchg = jg._nn_descent_iter(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(norms), jnp.asarray(nb0), rev,
                                       jnp.asarray(d0), jnp.int32(N), jnp.int32(block), jnp.int32(0), it_key,
                                       k=K, k2=k2, h=h, n_rand=n_rand, block=block, n_blocks=1)
    ti, td, tchg = tg._nn_descent_iter(torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(norms),
                                       torch.from_numpy(nb0), torch.from_numpy(np.asarray(rev)),
                                       torch.from_numpy(d0), N, block, 0, _data(it_key), K, k2, h, n_rand, block, 1)
    assert _overlap(ti.numpy(), np.asarray(wi)) >= 0.999
    assert abs(tchg - int(wchg)) <= 0.005 * int(wchg)


@pytest.fixture(scope="module")
def descent(emb):
    """Each package's whole descent at its defaults, with its round count."""
    calls = {"jax": 0, "torch": 0}
    out = {}
    for name, m in (("jax", jg), ("torch", tg)):
        real = m._nn_descent_iter

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1  # one call a round at this size
            return _real(*a, **kw)

        m._nn_descent_iter = counting
        try:
            torch.set_num_threads(1)
            out[name] = jg.nn_descent(emb, K)[0] if name == "jax" else tg.nn_descent(emb, K, device="cpu")[0]
        finally:
            m._nn_descent_iter = real
    return {**out, "jax_rounds": calls["jax"], "torch_rounds": calls["torch"]}


def test_descent_recall(emb, exact, descent, spill):
    got = descent["torch"]
    assert abs(_recall(got, exact) - _recall(descent["jax"], exact)) <= 0.01
    assert descent["torch_rounds"] >= 3 and descent["jax_rounds"] >= 3
    assert _recall(got, exact) > _recall(spill["jax_cluster"], exact)  # the rounds improve on the bootstrap


def test_descent_host_state_below_the_whole_draw(small, monkeypatch):
    """Host-resident state at a budget below the whole reverse-edge draw:
    a round draws its reverse edges in chunks of one block (six of them)
    and joins in chunks of rows, and the lists are those of the state on
    the device."""
    emb = small[0]
    kw = dict(n_iters=1, block=256, device="cpu")
    whole = tg.nn_descent(emb, K, **kw)
    np_total = tg._bucket_rows(N_SMALL, 256)
    slots = np_total * K
    # past the matrix and the host path's lists and reverse edges, 6 B a slot
    budget = np_total * (2 * D + 4) + slots * (8 + 6)
    assert budget < np_total * (2 * D + 4) + slots * 20  # the state goes to host RAM
    assert budget < slots * tg.REV_DRAW_SLOT_BYTES  # below the whole draw
    monkeypatch.setenv("LEANN_DESCENT_HBM_BUDGET", str(budget))
    chunks = []
    real = tg._reverse_edges_device

    def recording(nbrs, key, cap, rows_per_chunk=0):
        chunks.append(rows_per_chunk)
        return real(nbrs, key, cap, rows_per_chunk)

    monkeypatch.setattr(tg, "_reverse_edges_device", recording)
    part = tg.nn_descent(emb, K, **kw)
    assert chunks == [256] and np_total == 6 * 256
    for a, b in zip(part, whole):
        np.testing.assert_array_equal(a, b)


class _Stop(Exception):
    pass


def test_descent_state_resumes_across_packages(small, tmp_path, monkeypatch):
    """Four rounds at a floor of 0, handed across: the JAX package stops as
    round 3 starts (its state after round 2), the port resumes it and stops
    as round 4 starts (its state after round 3), and the JAX package
    resumes that. Each resumed run runs only its rounds, and the lists are
    the JAX package's whole run's."""
    emb = small[0]
    kw = dict(n_iters=4, min_update_frac=0.0, checkpoint_dir=str(tmp_path))
    pkg = {"jax": jg, "torch": tg}
    calls = {"jax": 0, "torch": 0}
    stop_at = {}
    real = {name: m._nn_descent_iter for name, m in pkg.items()}

    def counting(name):
        def one_round(*a, **k):
            calls[name] += 1  # one call a round at this size in both
            if calls[name] == stop_at.get(name):
                raise _Stop
            return real[name](*a, **k)
        return one_round

    for name, m in pkg.items():
        monkeypatch.setattr(m, "_nn_descent_iter", counting(name))
    monkeypatch.setattr(jg, "QCKPT_SECS", -1.0)  # a state after every round
    monkeypatch.setenv("LEANN_EXACT_QCKPT_SECS", "-1")
    run = {"jax": lambda: jg.nn_descent(emb, K, **kw), "torch": lambda: tg.nn_descent(emb, K, device="cpu", **kw)}

    stop_at["jax"] = 3
    with pytest.raises(_Stop):
        run["jax"]()
    assert json.load(open(tmp_path / "nd_state.json"))["iter"] == 2
    stop_at["torch"] = 2
    with pytest.raises(_Stop):
        run["torch"]()
    assert calls["torch"] == 2 and json.load(open(tmp_path / "nd_state.json"))["iter"] == 3
    calls["jax"], stop_at["jax"] = 0, None
    ids, _ = run["jax"]()
    assert calls["jax"] == 1
    assert not any(f.startswith("nd_state") for f in os.listdir(tmp_path))
    monkeypatch.undo()
    whole, _ = jg.nn_descent(emb, K, n_iters=4, min_update_frac=0.0)
    assert _overlap(ids, whole) >= 0.99


@pytest.mark.parametrize("mode", ["spill", "descent", "exact"])
def test_build_graph_modes_and_keys(small, tmp_path, monkeypatch, mode):
    """Past a lowered card cap each mode builds, with the JAX package's
    ckpt_knn.npy key; spill's scratch memmaps (forced by
    LEANN_SPILL_MEMMAP_BYTES) are gone once the k-NN is saved, descent's
    state in host RAM (LEANN_DESCENT_HBM_BUDGET=1, chunks of one block)
    gives the lists of its state on the device, and a rerun resumes."""
    emb, exact = small
    n = emb.shape[0]
    monkeypatch.setattr(tg, "exact_knn_max_n", lambda d, k, device: n // 3)
    monkeypatch.setenv("LEANN_KNN_MODE", mode)
    monkeypatch.setenv("LEANN_SPILL_MEMMAP_BYTES", "1")
    seen = []
    real = {name: getattr(tg, name) for name in ("spill_knn_streamed", "nn_descent", "exact_knn_sharded")}

    def recording(name):
        def run(*a, **kw):
            if name == "nn_descent":
                kw["n_iters"] = 1  # from random lists at this size it would run all 16
            out = real[name](*a, **kw)
            seen.append((name, os.listdir(tmp_path / "t")))
            return out
        return run

    for name in real:
        monkeypatch.setattr(tg, name, recording(name))
    if mode == "descent":
        monkeypatch.setenv("LEANN_DESCENT_HBM_BUDGET", "1")
    graph, medoid = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=str(tmp_path / "t"))
    want_pass = {"spill": "spill_knn_streamed", "descent": "nn_descent"}.get(mode, "exact_knn_sharded")
    assert [s[0] for s in seen] == [want_pass]
    if mode == "spill":
        assert {"spill_out_ids.npy", "spill_out_d.npy"} <= set(seen[0][1])  # memmaps while it ran
    assert not any(f.startswith(("spill_", "nd_state", "exknn_state")) for f in os.listdir(tmp_path / "t"))
    assert graph.shape == (n, 8) and ((graph >= -1) & (graph < n)).all() and (graph >= 0).any(axis=1).all()
    assert 0 <= medoid < n
    knn = np.load(tmp_path / "t" / "ckpt_knn.npy")
    # the pass's own lists (C = 2 R = K); descent's from its state on the device
    monkeypatch.delenv("LEANN_DESCENT_HBM_BUDGET", raising=False)
    if mode == "exact":
        assert _recall(knn, exact) >= 0.999
    elif mode == "spill":
        np.testing.assert_array_equal(knn, real["spill_knn_streamed"](emb, K, device="cpu")[0])
    else:
        np.testing.assert_array_equal(knn, real["nn_descent"](emb, K, n_iters=1, device="cpu")[0])
    # the JAX package's key of this corpus under its table of modes
    want = jg._ckpt_key(emb, {"exact": "c16ex", "descent": "c16nd"}.get(mode, "c16"))
    assert json.load(open(tmp_path / "t" / "ckpt_knn.npy.json"))["key"] == want
    assert json.load(open(tmp_path / "t" / "ckpt_pruned.npy.json"))["key"] == f"{want}_r8_a1.2_kc2"
    seen.clear()
    again, _ = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=str(tmp_path / "t"))
    assert seen == [] and np.array_equal(again, graph)
