"""leann_torch's parallel layer against the JAX package's on the same
numpy-seeded inputs (test_parallel.py's sizes: n = 512, d = 32, r = 16): the
port's meshes of 8 CPU shards against the JAX package's 8 virtual CPU
devices (tests/conftest.py).

* mesh.py: the meshes' shapes, the JAX package's error, the collectives;
* ShardedSearcher: the stored and pq traversals give the JAX sharded
  search's labels (distances within rtol 1e-4); the recompute traversal
  under each pruning strategy, with both encoders in f32, gives its top-k
  sets on >= 0.95 of rows and distances within rtol 1e-4 (atol 1e-5 for
  cosine distances near 0), as tests/test_torch_hnsw.py holds the
  one-device search; a (dp, gp) mesh gives the gp mesh's labels;
* the searchers' sharded=: a sharded hnsw search gives the unsharded
  search's ids (stored) and the JAX sharded searcher's (recompute);
  "auto" stays unsharded off the card.

The trainer's (dp, tp) mesh is held in tests/test_torch_parallel_train.py."""

import dataclasses

import numpy as np
import pytest
import torch

from leann_torch.backends import common
from leann_torch.embeddings import encoder as te
from leann_torch.ops.beam_search import BeamConfig as TConfig
from leann_torch.parallel import mesh as tm
from leann_torch.parallel.sharded_search import ShardedSearcher as TSharded
from leann_tpu.embeddings import encoder as je
from leann_tpu.ops.beam_search import BeamConfig as JConfig
from leann_tpu.parallel import mesh as jm
from leann_tpu.parallel.sharded_search import ShardedSearcher as JSharded

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


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


# ---------------------------------------------------------------------------
# mesh.py
# ---------------------------------------------------------------------------


def test_meshes_and_their_shapes():
    m = tm.make_mesh([("dp", 2), ("tp", 4)], CPU8)
    assert m.shape == {"dp": 2, "tp": 4} and m.axis_names == ("dp", "tp") and m.devices.shape == (2, 4)
    assert tm.graph_mesh(8, CPU8).shape == dict(jm.graph_mesh(8).shape)
    assert tm.serving_mesh(2, 4, CPU8).shape == dict(jm.serving_mesh(2, 4).shape)
    assert tm.graph_mesh(devices=CPU8[:3]).shape == {"gp": 3}
    axes = [("gp", 16)]
    with pytest.raises(ValueError) as want:
        jm.make_mesh(axes)
    with pytest.raises(ValueError, match="need 16 devices") as got:
        tm.make_mesh(axes, CPU8)
    assert str(got.value) == str(want.value)


def test_no_cpu_mesh_unless_asked():
    """The default devices are the cards: without CUDA the meshes raise
    resolve_device's error; CPU shards come only from CPU devices."""
    for make in (tm.graph_mesh, lambda: tm.serving_mesh(1, 1), lambda: tm.make_mesh([("gp", 1)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.shard_devices("cuda", 4)
    assert tm.shard_devices("cpu") == [CPU] and tm.shard_devices("cpu", 8) == CPU8


def test_collectives():
    parts = [torch.full((2,), float(i)) for i in range(4)]
    assert torch.equal(tm.psum(parts, CPU), torch.full((2,), 6.0))
    rot = tm.ppermute(parts, CPU8[:4])
    assert [int(p[0]) for p in rot] == [3, 0, 1, 2]
    assert rot[1] is parts[0]  # one device: a rotation moves no data


# ---------------------------------------------------------------------------
# ShardedSearcher against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gauss_index():
    """512 Gaussian rows, their graph and PQ codes (the port's build: both
    searchers take the same arrays)."""
    from leann_torch.ops.graph import build_graph
    from leann_torch.ops.pq import encode_pq_blocked, train_pq

    rng = np.random.default_rng(0)
    n, d, r = 512, 32, 16
    emb = rng.standard_normal((n, d)).astype(np.float32)
    g, medoid = build_graph(emb, r=r, device="cpu")
    entries = np.asarray([medoid] + list(range(0, n, n // 8)), np.int32)
    cb = train_pq(emb, n_iters=6, device="cpu")
    codes = encode_pq_blocked(emb, cb, device="cpu")
    q = rng.standard_normal((8, d)).astype(np.float32)
    return dict(neighbors=g, entries=entries, emb=emb, codes=codes, codebooks=cb), q


MODES = {"stored": dict(traversal="stored"), "pq": dict(traversal="pq"),
         "pq_rerank": dict(traversal="pq", rerank=64, rerank_source="stored")}


@pytest.mark.parametrize("mode", list(MODES))
def test_search_matches_jax(gauss_index, mode):
    arrays, q = gauss_index
    kw = dict(metric="l2", k=10, complexity=64, beam=4, max_steps=64, **MODES[mode])
    rest = {k: v for k, v in arrays.items() if k != "neighbors"}
    lj, dj = JSharded(jm.graph_mesh(8), arrays["neighbors"], **rest).search(q, JConfig(**kw))
    lt, dt = TSharded(tm.graph_mesh(8, CPU8), arrays["neighbors"], **rest).search(q, TConfig(**kw))
    assert lt.dtype == np.int32 and lt.shape == dt.shape == (8, 10)
    assert np.array_equal(lt, np.asarray(lj))
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=1e-4)


def test_stored_search_matches_one_device(gauss_index):
    """The mesh search's stored traversal is the one-device search's."""
    from leann_torch.ops.beam_search import GraphData, beam_search_batch

    arrays, q = gauss_index
    cfg = TConfig(metric="l2", k=10, complexity=64, beam=4, max_steps=64, traversal="stored")
    lt, dt = TSharded(tm.graph_mesh(8, CPU8), arrays["neighbors"], entries=arrays["entries"],
                      emb=arrays["emb"]).search(q, cfg)
    g = GraphData(neighbors=torch.from_numpy(arrays["neighbors"].astype(np.int64)),
                  entry_ids=torch.from_numpy(arrays["entries"].astype(np.int64)), emb=torch.from_numpy(arrays["emb"]))
    l1, d1, _, _ = beam_search_batch(torch.from_numpy(q), g, cfg)
    assert np.array_equal(lt, l1.numpy()) and np.array_equal(dt, d1.numpy())


@pytest.mark.parametrize("mode", ["stored", "pq_rerank"])
def test_serving_mesh_matches_gp_only(gauss_index, mode):
    """dp splits the batch: each dp group searches its part over the whole
    gp-sharded index; a batch that does not divide pads and trims."""
    arrays, q = gauss_index
    cfg = TConfig(metric="l2", k=5, complexity=32, beam=4, max_steps=32, **MODES[mode])
    rest = {k: v for k, v in arrays.items() if k != "neighbors"}
    ss = TSharded(tm.graph_mesh(4, CPU8), arrays["neighbors"], **rest)
    sd = TSharded(tm.serving_mesh(2, 4, CPU8), arrays["neighbors"], **rest)
    l_gp, d_gp = ss.search(q[:6], cfg)
    l_dp, d_dp = sd.search(q[:6], cfg)
    assert np.array_equal(l_gp, l_dp)
    np.testing.assert_allclose(d_gp, d_dp, rtol=1e-6)
    l5, _ = sd.search(q[:5], cfg)
    assert np.array_equal(l5, l_gp[:5])


@pytest.fixture(scope="module")
def text_index():
    """A hash-tiny token index of 256 seeded texts, built by the port (both
    searchers take the same arrays); both encoders in f32."""
    from leann_torch.ops.graph import build_graph
    from leann_torch.ops.pq import encode_pq_blocked, train_pq

    rng = np.random.default_rng(1)
    enc = te.get_encoder("hash-tiny", max_length=32, device="cpu")
    vocab = [f"w{i}" for i in range(300)]
    texts = [" ".join(rng.choice(vocab, int(rng.integers(4, 20)))) for _ in range(256)]
    emb = enc.encode(texts)
    toks, mask = enc.tokenize(texts, 32)
    g, medoid = build_graph(emb, r=16, device="cpu")
    cb = train_pq(emb, n_iters=4, device="cpu")
    arrays = dict(entries=np.asarray([medoid] + list(range(0, 256, 32)), np.int32), tokens=toks,
                  lengths=mask.sum(axis=1).astype(np.int32), codes=encode_pq_blocked(emb, cb, device="cpu"),
                  codebooks=cb)
    q = enc.encode([" ".join(rng.choice(vocab, 6)) for _ in range(16)])
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    tcfg = dataclasses.replace(enc.cfg, compute_dtype="float32")
    jcfg = je.EncoderConfig(**dataclasses.asdict(tcfg))
    tree = te.init_params(tcfg)  # the JAX package's draws: both encoders take this tree
    return g, arrays, q, (jcfg, tree), (tcfg, te.params_to_torch(tree, "cpu"))


def _check_recompute(lt, dt, lj, dj):
    lj, dj = np.asarray(lj), np.asarray(dj)
    same = np.array([set(a) == set(b) for a, b in zip(lt.tolist(), lj.tolist())])
    assert same.mean() >= 0.95
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("strategy", ["global", "local", "proportional"])
def test_recompute_matches_jax(text_index, strategy):
    """Per-shard picks of keep_local owned survivors under each strategy:
    the union the JAX package's mesh search re-encodes."""
    g, arrays, q, (jcfg, jp), (tcfg, tp) = text_index
    kw = dict(metric="cosine", k=5, complexity=32, beam=4, max_steps=32, traversal="recompute", normalize=True,
              prune_strategy=strategy)
    lj, dj = JSharded(jm.graph_mesh(8), g, **arrays).search(q, JConfig(enc_cfg=jcfg, **kw), jp, keep_local=4)
    lt, dt = TSharded(tm.graph_mesh(8, CPU8), g, **arrays).search(q, TConfig(enc_cfg=tcfg, **kw), tp, keep_local=4)
    _check_recompute(lt, dt, lj, dj)


def test_pq_with_distributed_rerank_matches_jax(text_index):
    """The diskann tier on the mesh: PQ traversal, then each shard
    re-encodes the pool-head rows it owns."""
    g, arrays, q, (jcfg, jp), (tcfg, tp) = text_index
    kw = dict(metric="cosine", k=5, complexity=32, beam=4, max_steps=32, traversal="pq", rerank=32, normalize=True)
    lj, dj = JSharded(jm.graph_mesh(8), g, **arrays).search(q, JConfig(enc_cfg=jcfg, **kw), jp)
    lt, dt = TSharded(tm.graph_mesh(8, CPU8), g, **arrays).search(q, TConfig(enc_cfg=tcfg, **kw), tp)
    _check_recompute(lt, dt, lj, dj)


# ---------------------------------------------------------------------------
# the searchers' sharded=
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hnsw_indexes(tmp_path_factory):
    """The port's hnsw over 256 Gaussian rows (stored, l2) and over 240
    texts (compact, recompute, PQ-screened)."""
    import leann_torch

    d = tmp_path_factory.mktemp("sharded_searchers")
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((256, 32)).astype(np.float32)
    stored = str(d / "stored.leann")
    b = leann_torch.LeannBuilder(backend_name="hnsw", embedding_mode="simulated", embedding_model="simulated",
                                 distance_metric="l2", is_recompute=False, M=16, device="cpu")
    b.build_index_from_embeddings(stored, [str(i) for i in range(256)], emb)
    vocab = [f"w{i}" for i in range(300)]
    texts = [f"doc {i} " + " ".join(rng.choice(vocab, 10)) for i in range(240)]
    recompute = str(d / "recompute.leann")
    b = leann_torch.LeannBuilder(backend_name="hnsw", embedding_model="hash-tiny", max_length=32, M=8, device="cpu")
    for t in texts:
        b.add_text(t)
    b.build_index(recompute)
    queries = [" ".join(texts[i].split()[:6]) for i in rng.choice(240, 24, replace=False)]
    return emb, stored, recompute, queries


def _ids(results):
    return [[r.id for r in row] for row in results]


def test_sharded_stored_search_matches_unsharded(hnsw_indexes, cpu_shards):
    import leann_torch

    emb, stored, _, _ = hnsw_indexes
    plain = leann_torch.LeannSearcher(stored, device="cpu")
    shard = leann_torch.LeannSearcher(stored, sharded=True, device="cpu")
    assert shard.backend._sharded.gp == 8 and plain.backend._sharded is None
    kw = dict(top_k=5, complexity=32, beam_width=4, recompute_embeddings=False)
    assert _ids(shard.search(emb[[0, 7, 100]], **kw)) == _ids(plain.search(emb[[0, 7, 100]], **kw))
    # sharded="auto" shards only over more than one card
    assert leann_torch.LeannSearcher(stored, sharded="auto", device="cpu").backend._sharded is None


@pytest.mark.parametrize("prune_ratio", [0.0, 0.5])
def test_sharded_recompute_search_matches_jax(hnsw_indexes, prune_ratio, cpu_shards):
    """The port's sharded hnsw searcher over 8 CPU shards against the JAX
    package's over its 8 devices, on the port's index: each shard
    re-encodes at most prune_keep // 8 candidates a hop (the whole hop's
    share without a prune ratio)."""
    import leann_torch
    import leann_tpu

    _, _, prefix, queries = hnsw_indexes
    kw = dict(top_k=3, complexity=32, beam_width=4, prune_ratio=prune_ratio)
    got = _ids(leann_torch.LeannSearcher(prefix, sharded=True, device="cpu").search(queries, **kw))
    want = _ids(leann_tpu.LeannSearcher(prefix, sharded=True).search(queries, **kw))
    assert np.mean([set(a) == set(b) for a, b in zip(got, want)]) >= 0.95


def test_sharded_diskann_keeps_tokens_on_the_devices(tmp_path, monkeypatch):
    """A sharded diskann searcher keeps its token store on the devices, even
    when asked for host residency, and searches as the unsharded one."""
    import leann_torch

    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(300)]
    texts = [f"doc {i} " + " ".join(rng.choice(vocab, 10)) for i in range(200)]
    prefix = str(tmp_path / "d.leann")
    b = leann_torch.LeannBuilder(backend_name="diskann", embedding_model="hash-tiny", max_length=32, graph_degree=8,
                                 device="cpu")
    for t in texts:
        b.add_text(t)
    b.build_index(prefix)
    monkeypatch.setattr(common, "shard_devices", lambda device: CPU8[:4])
    s = leann_torch.LeannSearcher(prefix, sharded=True, token_residency="host", device="cpu")
    assert s.backend.tokens_host is None and s.backend._sharded.graphs[0].tokens[0].shape[0] == 50
    queries = [" ".join(t.split()[:6]) for t in texts[:16]]
    kw = dict(top_k=3, complexity=32, beam_width=4)
    got = _ids(s.search(queries, **kw))
    want = _ids(leann_torch.LeannSearcher(prefix, device="cpu").search(queries, **kw))
    assert np.mean([set(a) == set(b) for a, b in zip(got, want)]) >= 0.9
