"""leann_torch's HNSW backend and recompute traversal against the JAX
package's on the same inputs (CPU): the PQ-screened ``_traversal_dists``
for each strategy, search on one JAX-built index, the JAX package's own
behavioural checks run on the port, batch lanes under the recompute
traversal, and the builder's on-disk payload. Each side encodes with its own
identically seeded hash-tiny weights."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

STRATEGIES = ["global", "local", "proportional"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    from scale_500k import synth_corpus

    from leann_tpu import LeannBuilder

    rng = np.random.default_rng(0)
    chunks = synth_corpus(400, rng)
    prefix = str(tmp_path_factory.mktemp("hnsw") / "idx.leann")
    b = LeannBuilder(embedding_model="hash-tiny", max_length=64, M=8)  # the default backend: hnsw
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)
    q_idx = rng.choice(len(chunks), 32, replace=False)
    queries = [" ".join(chunks[i].split()[:12]) for i in q_idx]
    return prefix, chunks, queries


def _searchers(prefix):
    from leann_torch.backends.hnsw.backend import HnswSearcher as TS
    from leann_tpu.backends.hnsw.backend import HnswSearcher as JS

    return JS(prefix), TS(prefix, device="cpu")


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _cfgs(js, ts, prune_ratio, strategy):
    args = (3, 32, 4, prune_ratio, True, strategy, 0)
    (cfg_j, pj), (cfg_t, pt) = js._make_cfg(*args), ts._make_cfg(*args)
    assert (cfg_j.prune_keep, cfg_j.traversal) == (cfg_t.prune_keep, cfg_t.traversal)
    return cfg_j, pj, cfg_t, pt


# (a) -----------------------------------------------------------------------
@pytest.mark.parametrize("prune_ratio,strategy", [(0.0, "global")] + [(p, s) for p in (0.5, 0.9) for s in STRATEGIES])
def test_traversal_dists_match(built, prune_ratio, strategy):
    """Same ids, valid mask and ADC table through the JAX function vmapped
    per lane and the port's batched one: the same positions get exact
    distances, the distances agree (rtol 1e-4; atol 1e-5 for cosine
    distances near 0), n_exact is equal. Both encoders compute in f32 here:
    in bf16 they round at other places and agree only to ~1e-2
    (test_torch_encoder.py), which would hide the traversal's own error."""
    from leann_torch.ops.beam_search import _traversal_dists as t_dists
    from leann_torch.ops.pq import adc_distances, adc_lut
    from leann_tpu.ops.beam_search import _traversal_dists as j_dists

    prefix, _, queries = built
    js, ts = _searchers(prefix)
    cfg_j, pj, cfg_t, pt = _cfgs(js, ts, prune_ratio, strategy)
    cfg_j = dataclasses.replace(cfg_j, enc_cfg=dataclasses.replace(cfg_j.enc_cfg, compute_dtype="float32"))
    cfg_t = dataclasses.replace(cfg_t, enc_cfg=dataclasses.replace(cfg_t.enc_cfg, compute_dtype="float32"))
    b, beam, r = 6, cfg_t.beam, int(ts.neighbors.shape[1])
    f = beam * r
    rng = np.random.default_rng(11)
    q = _unit(ts._encoder().encode(queries[:b])).astype(np.float32)
    ids = rng.integers(0, ts.n, size=(b, f)).astype(np.int32)
    valid = rng.random((b, f)) < 0.7
    valid[1, :] = False  # a lane with nothing fresh (a frozen lane's hop)
    valid[2, : f // 2] = False
    # the ADC table shifted by 1 per subspace: the screen's order is the same,
    # and every ADC estimate sits M = 8 above any exact cosine distance
    # (with 256 centroids for 400 rows many estimates are exact otherwise),
    # so the positions given exact distances show in the output
    lut = adc_lut(torch.from_numpy(q), ts.codebooks, ts.metric) + 1.0
    dt, nt = t_dists(torch.from_numpy(q), ts._graph_data(), torch.from_numpy(ids).long(),
                     torch.from_numpy(valid), lut if cfg_t.prune_keep else None, cfg_t, pt, per_source=beam)
    g_j = js._graph_data()
    dj, nj = jax.vmap(lambda qi, ii, vi, li: j_dists(qi, g_j, ii, vi, li, cfg_j, pj, per_source=beam))(
        jnp.asarray(q), jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(lut.numpy()))
    dt, dj = dt.numpy(), np.asarray(dj)
    assert nt.tolist() == np.asarray(nj).tolist()
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-5)
    ad = adc_distances(ts.codes[torch.from_numpy(ids).long()], lut).numpy()
    exact_t, exact_j = valid & (dt < ad - 4.0), valid & (dj < ad - 4.0)
    assert (exact_t == exact_j).all()
    assert exact_t.sum(1).tolist() == nt.tolist()
    np.testing.assert_allclose(np.where(valid & ~exact_t, dt, 0), np.where(valid & ~exact_t, ad, 0), rtol=1e-6)
    if cfg_t.prune_keep:
        assert (nt <= cfg_t.prune_keep).all() and int(nt[1]) == 0
    else:
        assert nt.tolist() == valid.sum(1).tolist()


# (b) -----------------------------------------------------------------------
@pytest.mark.parametrize("mode", STRATEGIES + ["stored"])
def test_search_matches_jax(built, mode):
    from leann_torch.ops.beam_search import beam_search_batch as t_search
    from leann_tpu.ops.beam_search import beam_search_batch as j_search

    prefix, chunks, queries = built
    js, ts = _searchers(prefix)
    enc = ts._encoder()
    q = _unit(enc.encode(queries))
    emb_rows = _unit(enc.encode(chunks))[np.asarray([int(i) for i in ts.id_list])]
    cfg_j, pj, cfg_t, pt = _cfgs(js, ts, 0.5, "global" if mode == "stored" else mode)
    g_j, g_t = js._graph_data(), ts._graph_data()
    if mode == "stored":
        cfg_j = dataclasses.replace(cfg_j, traversal="stored", prune_keep=0)
        cfg_t = dataclasses.replace(cfg_t, traversal="stored", prune_keep=0)
        g_j = g_j._replace(emb=jnp.asarray(emb_rows))
        g_t = g_t._replace(emb=torch.from_numpy(emb_rows))
    lj, _, _, ej = (np.asarray(x) for x in j_search(jnp.asarray(q), g_j, cfg_j, pj))
    lt, _, _, et = (x.numpy() for x in t_search(torch.from_numpy(q), g_t, cfg_t, pt))
    assert np.mean([set(a) == set(b) for a, b in zip(lj.tolist(), lt.tolist())]) >= 0.95
    truth = np.argsort(-(q @ emb_rows.T), axis=1, kind="stable")[:, :3]

    def recall(pred):
        return np.mean([len(set(p) & set(t)) / 3 for p, t in zip(pred.tolist(), truth.tolist())])

    assert abs(recall(lt) - recall(lj)) <= 0.02
    assert abs(int(et.sum()) - int(ej.sum())) <= 0.02 * int(ej.sum())


# (c) -----------------------------------------------------------------------
def test_make_cfg_auto_prune_and_batch_cap(built):
    prefix, _, _ = built
    _, ts = _searchers(prefix)
    auto, _ = ts._make_cfg(3, 256, 4, None, True, "global", 0)
    assert auto.prune_keep > 0  # complexity 256: the screen applies by itself
    assert ts._make_cfg(3, 256, 4, 0.0, True, "global", 0)[0].prune_keep == 0  # explicit 0.0: unpruned
    assert ts._make_cfg(3, 32, 4, None, True, "global", 0)[0].prune_keep == 0  # small search: no screen
    assert ts._make_cfg(3, 32, 4, 0.5, True, "global", 0)[0].prune_keep == 16  # ceil(4 x 8 x 0.5)
    assert ts._make_cfg(3, 32, 4, 0.5, True, "global", 5)[0].prune_keep == 5  # batch_size caps it
    with pytest.raises(ValueError):
        ts._make_cfg(3, 32, 4, 0.5, True, "nearest", 0)


def test_strategy_budgets_and_selection(built):
    """The JAX package's check on the port: proportional spends fewer exact
    distances than global, and under a harsh screen local picks other
    candidates than global."""
    from leann_torch.ops.beam_search import beam_search_batch

    prefix, chunks, _ = built
    _, ts = _searchers(prefix)
    q = torch.from_numpy(ts._encoder().encode([chunks[i] for i in (3, 77, 200, 311)]))

    def run(strategy, ratio=0.5):
        cfg, params = ts._make_cfg(5, 32, 4, ratio, True, strategy, 0)
        assert cfg.prune_keep > 0 and cfg.prune_strategy == strategy
        labels, dists, _, n_exact = beam_search_batch(q, ts._graph_data(), cfg, params)
        assert labels.shape == (4, 5) and (labels >= 0).all() and int(n_exact.sum()) > 0
        return dists.numpy(), int(n_exact.sum())

    assert run("proportional")[1] < run("global")[1]
    assert not np.allclose(run("local", 0.9)[0], run("global", 0.9)[0])


def test_compact_index_refuses_what_it_cannot_do(built):
    import leann_torch

    prefix, _, queries = built
    s = leann_torch.LeannSearcher(prefix, device="cpu")
    with pytest.raises(RuntimeError):
        s.search(queries[0], top_k=2, recompute_embeddings=False)  # no stored embeddings
    with pytest.raises(RuntimeError):  # nor on the two-phase adaptive search
        s.search(queries[0], top_k=2, recompute_embeddings=False, adaptive_steps=8)
    _, ts = _searchers(prefix)
    ts.has_tokens = False  # a compact index without its token store
    with pytest.raises(RuntimeError, match="token store"):
        ts._make_cfg(3, 32, 4, None, True, "global", 0)


# (d) -----------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batch_lanes_freeze_independently_under_recompute(built, strategy):
    """A converged lane changes nothing while the others run on: a batch
    gives each query the labels, distances, steps and n_exact it gets alone
    (the proportional budget is per lane)."""
    from leann_torch.ops.beam_search import beam_search_batch

    prefix, _, queries = built
    _, ts = _searchers(prefix)
    q = torch.from_numpy(_unit(ts._encoder().encode(queries[:8])))
    cfg, params = ts._make_cfg(3, 32, 4, 0.5, True, strategy, 0)
    g = ts._graph_data()
    ids_b, d_b, steps_b, exact_b = beam_search_batch(q, g, cfg, params)
    assert len(set(steps_b.tolist())) > 1
    for i in range(8):
        ids_1, d_1, steps_1, exact_1 = beam_search_batch(q[i : i + 1], g, cfg, params)
        assert ids_1[0].tolist() == ids_b[i].tolist()
        np.testing.assert_allclose(d_1[0].numpy(), d_b[i].numpy(), rtol=1e-5, atol=1e-6)
        assert (int(steps_1[0]), int(exact_1[0])) == (int(steps_b[i]), int(exact_b[i]))


# (e) -----------------------------------------------------------------------
@pytest.mark.parametrize("metric,compact", [("mips", True), ("l2", False)])
def test_builder_writes_the_jax_payload(tmp_path, metric, compact):
    from leann_torch.backends.hnsw.backend import HnswBuilder as TB
    from leann_tpu.backends.hnsw.backend import HnswBuilder as JB

    data = np.random.default_rng(5).standard_normal((300, 32)).astype(np.float32)
    ids = [str(i) for i in range(300)]
    kw = dict(distance_metric=metric, is_compact=compact, M=8, efConstruction=32)
    tb = TB(device="cpu", **kw)
    tb.build(data, ids, str(tmp_path / "t"))
    JB(**kw).build(data, ids, str(tmp_path / "j"))
    zt, zj = np.load(tmp_path / "t.hnsw.npz"), np.load(tmp_path / "j.hnsw.npz")
    assert sorted(zt.files) == sorted(zj.files)
    for f in zt.files:
        assert zt[f].dtype == zj[f].dtype and zt[f].shape == zj[f].shape, f
    for f in ("entries", "medoid", "dim", "metric", "is_compact", "is_recompute"):
        assert (zt[f] == zj[f]).all(), f
    assert ("embeddings" in zt.files) == (not compact)
    assert ("entry_emb" in zt.files) == compact  # mips pools stay in the npz
    assert set(tb.phase_seconds) == {"knn", "prune", "reverse_fill", "pq_train", "pq_encode", "persist"}
