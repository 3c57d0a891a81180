"""leann_torch's two-phase adaptive search and the host-resident token store
with its deferred rerank, against the port's own one-pass search and the
JAX package's functions, on the same inputs (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_torch.ops import beam_search as tb
from leann_tpu.ops import beam_search as jb


@pytest.fixture(scope="module")
def stored_graph():
    """One graph (the port's build) in both packages' GraphData, stored
    traversal: lanes converge after different hop counts."""
    from leann_torch.ops.graph import build_graph

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((600, 16)).astype(np.float32)
    g, medoid = build_graph(emb, r=8, device="cpu")
    gt = tb.GraphData(neighbors=torch.from_numpy(g.astype(np.int64)), entry_ids=torch.tensor([medoid]),
                      emb=torch.from_numpy(emb))
    gj = jb.GraphData(neighbors=jnp.asarray(g), entry_ids=jnp.asarray(np.asarray([medoid], np.int32)),
                      emb=jnp.asarray(emb), tokens=jnp.zeros((1, 1), jnp.int32), lengths=jnp.zeros((1,), jnp.int32),
                      codes=jnp.zeros((1, 1), jnp.uint8), codebooks=jnp.zeros((1, 1), jnp.float32))
    q = rng.standard_normal((16, 16)).astype(np.float32)
    return gt, gj, q


def _cfgs(**kw):
    args = dict(metric="l2", k=5, complexity=32, beam=2, max_steps=64, traversal="stored", **kw)
    return tb.BeamConfig(**args), jb.BeamConfig(**args)


def test_adaptive_equals_uncapped_run_and_jax(stored_graph):
    gt, gj, q = stored_graph
    cfg_t, cfg_j = _cfgs()
    fl, fd, fs, fne = (x.numpy() for x in tb.beam_search_batch(torch.from_numpy(q), gt, cfg_t))
    assert fs.max() > 2, "fixture too easy: no lane would escalate"
    al, ad, asteps, ane = tb.beam_search_adaptive(q, gt, cfg_t, first_steps=2)
    np.testing.assert_array_equal(al, fl)
    np.testing.assert_allclose(ad, fd, rtol=1e-6)
    np.testing.assert_array_equal(asteps, fs)  # escalated lanes report their full run
    np.testing.assert_array_equal(ane, fne)
    jl, jd, js, jne = jb.beam_search_adaptive(q, gj, cfg_j, first_steps=2)
    np.testing.assert_array_equal(al, jl)
    np.testing.assert_allclose(ad, jd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(asteps, js)


def test_adaptive_without_escalation_is_one_call(stored_graph, monkeypatch):
    gt, _, q = stored_graph
    cfg_t, _ = _cfgs()
    fl, _, fs, _ = (x.numpy() for x in tb.beam_search_batch(torch.from_numpy(q), gt, cfg_t))
    calls = []
    orig = tb.beam_search_batch_packed_full
    monkeypatch.setattr(tb, "beam_search_batch_packed_full", lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    cap = int(fs.max()) + 1  # above every lane's convergence: no second call
    assert np.array_equal(tb.beam_search_adaptive(q, gt, cfg_t, first_steps=cap)[0], fl) and len(calls) == 1
    assert np.array_equal(tb.beam_search_adaptive(q, gt, cfg_t, first_steps=cfg_t.max_steps)[0], fl)
    assert len(calls) == 2


def test_pack_results_full_round_trip():
    labels = torch.tensor([[3, -1], [7, 2]])
    dists = torch.tensor([[0.5, 3.4e38], [-1.25, 2.0]])
    packed = tb.pack_results_full(labels, dists, torch.tensor([4, 9]), torch.tensor([0, 17]))
    assert packed.dtype == torch.int32 and packed.shape == (2, 6)
    l, d, s, ne = tb.unpack_results_full(packed)
    assert l.tolist() == [[3, -1], [7, 2]] and d.tolist() == dists.tolist()
    assert s.tolist() == [4, 9] and ne.tolist() == [0, 17] and l.flags.writeable
    jl, jd, js, jne = jb.unpack_results_full(jb.pack_results_full(
        jnp.asarray(labels.numpy(), jnp.int32), jnp.asarray(dists.numpy()), jnp.asarray([4, 9], jnp.int32),
        jnp.asarray([0, 17], jnp.int32)))
    assert np.array_equal(jl, l) and np.array_equal(jd, d) and np.array_equal(js, s) and np.array_equal(jne, ne)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A diskann index and an hnsw index, built by the port, over 300 short
    documents (the JAX package's host-rerank fixture)."""
    import leann_torch

    rng = np.random.default_rng(13)
    texts = [f"doc {i} " + " ".join(f"w{rng.integers(0, 300)}" for _ in range(10)) for i in range(300)]
    d = tmp_path_factory.mktemp("hostrr")
    out = {"texts": texts}
    for backend, kw in (("diskann", {"graph_degree": 8}), ("hnsw", {"M": 8})):
        prefix = str(d / f"{backend}.leann")
        b = leann_torch.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32,
                                     device="cpu", **kw)
        for t in texts:
            b.add_text(t)
        b.build_index(prefix)
        out[backend] = prefix
    return out


def _queries(texts, idx):
    from leann_torch.embeddings.encoder import get_encoder

    q = get_encoder("hash-tiny", max_length=32, device="cpu").encode([texts[i] for i in idx])
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)


def test_rerank_tokens_batch_matches_jax_and_the_device_rerank(built):
    """The deferred rerank over host-gathered rows gives the device-resident
    rerank's answer bit for bit, and the JAX package's (both encoders in f32
    here: in bf16 they round at other places)."""
    from leann_torch.backends.diskann.backend import DiskannSearcher
    from leann_tpu.embeddings.encoder import get_encoder as jax_get_encoder

    s = DiskannSearcher(built["diskann"], device="cpu")
    q = torch.from_numpy(_queries(built["texts"], [7, 120, 255, 30]))
    cfg, params = s._make_cfg(5, complexity=24, beam_width=4, rerank_size=16)
    labels, dists, _, _ = tb.beam_search_batch(q, s._graph_data(), cfg, params)
    pool_cfg, _ = s._make_cfg(16, complexity=24, beam_width=4, recompute_embeddings=False)
    ids = tb.beam_search_batch(q, s._graph_data(), pool_cfg)[0].to(torch.int32)
    safe = ids.clamp(0, s.n - 1).long()
    toks, lens = s.tokens[safe], s.lengths[safe]
    got_l, got_d = tb.unpack_results(tb.rerank_tokens_batch(q, toks, lens, ids, 5, "cosine", True, cfg.enc_cfg,
                                                             params))
    assert np.array_equal(got_l, labels.numpy()) and np.array_equal(got_d, dists.numpy())
    f32 = dataclasses.replace(cfg.enc_cfg, compute_dtype="float32")
    t_l, t_d = tb.unpack_results(tb.rerank_tokens_batch(q, toks, lens, ids, 5, "cosine", True, f32, params))
    jenc = jax_get_encoder("hash-tiny", max_length=32)
    j_l, j_d = jb.unpack_results(jb.rerank_tokens_batch(
        jnp.asarray(q.numpy()), jnp.asarray(toks.numpy()), jnp.asarray(lens.numpy()), jnp.asarray(ids.numpy()),
        k=5, metric="cosine", normalize=True, enc_cfg=dataclasses.replace(jenc.cfg, compute_dtype="float32"),
        enc_params=jenc.params))
    assert np.array_equal(t_l, j_l)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-4, atol=1e-5)


def test_host_token_store_matches_device_and_jax(built):
    from leann_torch.backends.diskann.backend import DiskannSearcher
    from leann_tpu.backends.diskann.backend import DiskannSearcher as JaxSearcher

    dev = DiskannSearcher(built["diskann"], device="cpu")
    host = DiskannSearcher(built["diskann"], device="cpu", token_residency="host")
    assert dev.tokens_host is None and dev.tokens is not None
    assert host.tokens is None and host.tokens_host is not None
    q = _queries(built["texts"], [7, 120, 255])
    kw = dict(top_k=5, complexity=24, beam_width=4, rerank_size=16)
    rd, rh = dev.search(q, **kw), host.search(q, **kw)
    np.testing.assert_array_equal(rh["labels"], rd["labels"])
    np.testing.assert_allclose(rh["distances"], rd["distances"], rtol=1e-5)
    ra = host.search(q, adaptive_steps=2, **kw)  # the adaptive traversal under the host rerank
    np.testing.assert_array_equal(ra["labels"], rd["labels"])
    rj = JaxSearcher(built["diskann"], token_residency="host").search(q, **kw)
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(rh["labels"].tolist(), rj["labels"].tolist())]) >= 0.9


def test_host_token_store_through_the_searcher(built):
    """LeannSearcher passes token_residency and adaptive_steps through; text
    queries take the host rerank, labels as on the device path."""
    import leann_torch

    texts = built["texts"]
    queries = [texts[42], texts[200], texts[3]]
    kw = dict(top_k=3, complexity=64, beam_width=4)
    dev = leann_torch.LeannSearcher(built["diskann"], device="cpu")
    host = leann_torch.LeannSearcher(built["diskann"], device="cpu", token_residency="host")
    assert host.backend.tokens_host is not None
    want = [[r.id for r in row] for row in dev.search(queries, **kw)]
    for extra in ({}, {"adaptive_steps": 2}):
        got = host.search(queries, **kw, **extra)
        assert [[r.id for r in row] for row in got] == want
        assert [[r.id for r in row] for row in dev.search(queries, **kw, **extra)] == want
    assert want[0][0] == "42"


@pytest.mark.parametrize("backend", ["diskann", "hnsw"])
def test_adaptive_steps_on_both_backends(built, backend):
    from leann_torch.registry import get_backend

    s = get_backend(backend).searcher(built[backend], device="cpu")
    q = _queries(built["texts"], [3, 144, 270])
    kw = dict(top_k=5, complexity=32, beam_width=2, prune_ratio=0.5)
    base = s.search(q, **kw)
    adap = s.search(q, adaptive_steps=2, **kw)
    np.testing.assert_array_equal(adap["labels"], base["labels"])
    np.testing.assert_allclose(adap["distances"], base["distances"], rtol=1e-5)
    texts = [built["texts"][i] for i in (3, 144, 270)]
    np.testing.assert_array_equal(s.search_text(texts, adaptive_steps=2, **kw)["labels"],
                                  s.search_text(texts, **kw)["labels"])
