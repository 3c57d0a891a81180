"""leann_torch's gp-mesh build (parallel/sharded_build.py) against the JAX
package's on the same numpy-seeded inputs: the port on 8 CPU shards, the JAX
package on its 8 virtual CPU devices (tests/conftest.py).

Tolerances: ring_knn's ids are equal and its distances within rtol 1e-4 on
Gaussian data, where no two distances tie (both take bf16 products with f32
sums, in another order; tie order legitimately differs: the JAX ring breaks
ties by ring step, kernel B2 and its plain version by id).
sharded_build_graph is held where tests/test_torch_graph.py holds
build_graph: the medoid equal, rows' neighbour sets overlapping >= 0.95.
An index built with build_sharded=True by either package is searched
sharded by the other: top-3 sets equal on >= 0.95 of queries."""

import numpy as np
import pytest
import torch

from leann_torch.backends import common
from leann_torch.ops import graph as tg
from leann_torch.parallel import mesh as tm
from leann_torch.parallel import sharded_build as tsb
from leann_tpu.parallel import mesh as jm
from leann_tpu.parallel import sharded_build as jsb

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture()
def cpu_shards(monkeypatch):
    """The backends' gp meshes over 8 CPU shards, as the JAX tests' meshes
    over 8 virtual devices (the backends take one shard per device)."""
    monkeypatch.setattr(common, "shard_devices", lambda device: CPU8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models and graphs: one intra-op thread, so that a worker beside
    others does not wait on thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("n,d,k,qb", [(512, 32, 16, 256), (700, 24, 8, 32), (320, 16, 5, 16)])
def test_ring_knn_matches_jax(n, d, k, qb):
    """Shard rows as the JAX package's (at n = 512, qb = 256 only 2 of 8
    shards hold rows; 700 and 320 do not divide by 8)."""
    emb = _gauss(n, n, d)
    ij, dj = jsb.ring_knn(emb, k, jm.graph_mesh(8), qb=qb)
    it, dt = tsb.ring_knn(emb, k, tm.graph_mesh(8, CPU8), qb=qb)
    assert it.shape == dt.shape == (n, k) and it.dtype == np.int32
    assert np.array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=1e-4)


def test_ring_knn_equals_exact_knn_at_any_shard_count():
    """The ring over 1, 3 or 8 shards gives the one-pass exact_knn's lists
    (the same kernel arithmetic, the same tie rule)."""
    emb = _gauss(5, 300, 24)
    want_i, want_d = tg.exact_knn(emb, 12, device="cpu")
    for gp in (1, 3, 8):
        got_i, got_d = tsb.ring_knn(emb, 12, tm.graph_mesh(gp, CPU8), qb=16)
        assert np.array_equal(got_i, want_i), gp
        assert np.array_equal(got_d, want_d), gp


def test_ring_knn_fewer_rows_than_k():
    emb = _gauss(6, 10, 8)
    ids, dists = tsb.ring_knn(emb, 12, tm.graph_mesh(4, CPU8), qb=4)
    assert (ids[:, 9:] == -1).all() and (dists[:, 9:] > 1e38).all()
    assert all(set(ids[i, :9]) == set(range(10)) - {i} for i in range(10))


def test_gather_local_rotates_every_row_home():
    """One ring turn gives each shard the rows of any ids, -1 as zeros."""
    emb = _gauss(7, 50, 16)
    devs = CPU8[:4]
    s = tsb.shard_rows(50, 4, 8)
    ebf, _ = tsb.place_rows(emb, devs, s)
    rng = np.random.default_rng(0)
    ids = [torch.from_numpy(rng.integers(-1, 50, 30)) for _ in devs]
    got = tsb._gather_local(list(ebf), ids, s, devs)
    full = torch.cat(ebf)
    for want_ids, rows in zip(ids, got):
        want = torch.where(want_ids[:, None] >= 0, full[want_ids.clamp(0)], torch.zeros_like(full[:1]))
        assert torch.equal(rows, want)


def test_sharded_build_graph_matches_jax():
    emb = _gauss(4, 600, 24)
    want, med_j = jsb.sharded_build_graph(emb, jm.graph_mesh(8), r=16, qb=32, prune_block=16)
    got, med_t = tsb.sharded_build_graph(emb, tm.graph_mesh(8, CPU8), r=16, qb=32, prune_block=16)
    assert got.shape == want.shape == (600, 16) and got.dtype == np.int32
    assert med_t == med_j
    ov = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, len(set(b[b >= 0]))) for a, b in zip(got, want)])
    assert ov >= 0.95
    assert not (got == np.arange(600)[:, None]).any()
    assert ((got >= -1) & (got < 600)).all()


def test_sharded_build_graph_independent_of_layout():
    """The shard count and the prune's block change no row: the graph is
    build_graph's (its prune takes the f32 rows' norms, the mesh build the
    bf16 rows', so it is held to the overlap, not equality)."""
    emb = _gauss(8, 400, 32)
    base, med = tsb.sharded_build_graph(emb, tm.graph_mesh(1, CPU8), r=16)
    for gp, blk in ((3, 7), (8, 0)):
        got, m = tsb.sharded_build_graph(emb, tm.graph_mesh(gp, CPU8), r=16, prune_block=blk)
        assert np.array_equal(got, base) and m == med, (gp, blk)
    single, med1 = tg.build_graph(emb, r=16, device="cpu")
    assert med1 == med
    ov = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, len(set(b[b >= 0]))) for a, b in zip(base, single)])
    assert ov >= 0.95


def test_sharded_build_records_phase_seconds():
    times = {}
    tsb.sharded_build_graph(_gauss(9, 64, 8), tm.graph_mesh(2, CPU8), r=8, phase_seconds=times)
    assert set(times) == {"knn", "prune", "reverse_fill"}


# ---------------------------------------------------------------------------
# build_sharded= through the builders, across the packages
# ---------------------------------------------------------------------------

SEARCH_KW = dict(top_k=3, complexity=32, beam_width=4)


def _texts(rng, n=240):
    vocab = [f"w{i}" for i in range(300)]
    return [f"doc {i} " + " ".join(rng.choice(vocab, 10)) for i in range(n)]


@pytest.fixture(scope="module", params=["hnsw", "diskann"])
def sharded_indexes(request, tmp_path_factory):
    """The same chunks through each package's builder with
    build_sharded=True: the JAX package over its 8 devices, the port over 8
    CPU shards (diskann: LDG-partitioned into 8 in both)."""
    import leann_torch
    import leann_tpu

    backend = request.param
    rng = np.random.default_rng(3)
    texts = _texts(rng)
    queries = [" ".join(texts[i].split()[:6]) for i in rng.choice(len(texts), 24, replace=False)]
    kw = {"hnsw": {"M": 8}, "diskann": {"graph_degree": 8, "num_partitions": 8, "partition_passes": 3}}[backend]
    d = tmp_path_factory.mktemp(f"sharded_{backend}")
    paths = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "shard_devices", lambda device: CPU8)
        for name, pkg, extra in (("jax", leann_tpu, {}), ("torch", leann_torch, {"device": "cpu"})):
            b = pkg.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, build_sharded=True,
                                 **kw, **extra)
            for t in texts:
                b.add_text(t)
            paths[name] = str(d / f"{name}.leann")
            b.build_index(paths[name])
    return backend, paths, queries


def _ids(results):
    return [[r.id for r in row] for row in results]


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_build_sharded_index_searched_sharded_by_the_other(sharded_indexes, built_by, cpu_shards):
    import leann_torch
    import leann_tpu

    backend, paths, queries = sharded_indexes
    prefix = paths[built_by]
    got_t = _ids(leann_torch.LeannSearcher(prefix, sharded=True, device="cpu").search(
        queries, **SEARCH_KW))
    got_j = _ids(leann_tpu.LeannSearcher(prefix, sharded=True).search(queries, **SEARCH_KW))
    assert all(len(r) == 3 for r in got_t)
    assert np.mean([set(a) == set(b) for a, b in zip(got_t, got_j)]) >= 0.95
    plain = _ids(leann_torch.LeannSearcher(prefix, device="cpu").search(queries, **SEARCH_KW))
    assert np.mean([set(a) == set(b) for a, b in zip(got_t, plain)]) >= 0.9


def test_build_sharded_writes_the_single_device_graph(tmp_path, monkeypatch):
    """The port's build_sharded=True writes the graph its one-device build
    writes over the same chunks, up to the prune's norms (>= 0.95 of rows
    equal); the options persist in the index's meta."""
    import json

    import leann_torch
    from leann_torch.storage import unpack_neighbors

    texts = _texts(np.random.default_rng(4), n=200)
    graphs = {}
    monkeypatch.setattr(common, "shard_devices", lambda device: CPU8[:4])
    for name, extra in (("sharded", {"build_sharded": True}), ("one", {})):
        b = leann_torch.LeannBuilder(backend_name="hnsw", embedding_model="hash-tiny", max_length=32, M=8,
                                     device="cpu", **extra)
        for t in texts:
            b.add_text(t)
        prefix = str(tmp_path / f"{name}.leann")
        b.build_index(prefix)
        graphs[name] = unpack_neighbors(np.load(prefix + ".hnsw.npz"))
    meta = json.load(open(str(tmp_path / "sharded.leann.meta.json")))
    assert meta["backend_kwargs"]["build_sharded"] is True
    assert {"backend/knn", "backend/prune", "backend/reverse_fill"} <= set(b.phase_seconds)
    assert (graphs["sharded"] == graphs["one"]).all(axis=1).mean() >= 0.95
