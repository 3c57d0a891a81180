"""leann_torch's batched beam search against the JAX package's vmapped one
on the same GraphData, read from one diskann index built by the JAX
package (CPU). The same query vectors go to both; each side re-encodes the
rerank pool with its own (identically seeded) encoder."""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    from scale_500k import synth_corpus

    from leann_tpu import LeannBuilder

    rng = np.random.default_rng(0)
    chunks = synth_corpus(600, rng)
    prefix = str(tmp_path_factory.mktemp("bs") / "idx.leann")
    b = LeannBuilder(backend_name="diskann", embedding_model="hash-tiny", max_length=64, graph_degree=16)
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)
    q_idx = rng.choice(len(chunks), 64, replace=False)
    queries = [" ".join(chunks[i].split()[:12]) for i in q_idx]
    return prefix, chunks, queries


def _searchers(prefix):
    from leann_torch.backends.diskann.backend import DiskannSearcher as TS
    from leann_tpu.backends.diskann.backend import DiskannSearcher as JS

    return JS(prefix), TS(prefix, device="cpu")


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _run_both(js, ts, q, cfg_j, cfg_t, g_j, g_t):
    from leann_torch.ops.beam_search import beam_search_batch_packed as t_search
    from leann_torch.ops.beam_search import unpack_results as t_unpack
    from leann_tpu.ops.beam_search import beam_search_batch_packed as j_search
    from leann_tpu.ops.beam_search import unpack_results as j_unpack

    lj, _ = j_unpack(j_search(jnp.asarray(q), g_j, cfg_j, js._encoder().params if cfg_j.enc_cfg else None))
    lt, _ = t_unpack(t_search(torch.from_numpy(q), g_t, cfg_t, ts._encoder().params if cfg_t.enc_cfg else None))
    return lj, lt


def _recall(pred, truth):
    return np.mean([len(set(p) & set(t)) / len(t) for p, t in zip(pred.tolist(), truth.tolist())])


@pytest.mark.parametrize("rerank_source", ["recompute", "stored"])
def test_pq_traversal_same_ids_and_recall(built, rerank_source):
    prefix, chunks, queries = built
    js, ts = _searchers(prefix)
    enc = js._encoder()
    q = _unit(enc.encode(queries))
    emb = _unit(enc.encode(chunks))
    order = np.asarray([int(i) for i in js.id_list])  # graph row -> chunk (the build may relayout rows)
    emb_rows = emb[order]
    cfg_j, _ = js._make_cfg(3, complexity=32, beam_width=4)
    cfg_t, _ = ts._make_cfg(3, complexity=32, beam_width=4)
    g_j, g_t = js._graph_data(), ts._graph_data()
    if rerank_source == "stored":
        cfg_j = dataclasses.replace(cfg_j, rerank_source="stored")
        cfg_t = dataclasses.replace(cfg_t, rerank_source="stored")
        g_j = g_j._replace(emb=jnp.asarray(emb_rows))
        g_t = g_t._replace(emb=torch.from_numpy(emb_rows))
    lj, lt = _run_both(js, ts, q, cfg_j, cfg_t, g_j, g_t)
    same = np.mean([set(a) == set(b) for a, b in zip(lj.tolist(), lt.tolist())])
    assert same >= 0.95
    truth_rows = np.argsort(-(q @ emb_rows.T), axis=1, kind="stable")[:, :3]
    assert abs(_recall(lt, truth_rows) - _recall(lj, truth_rows)) <= 0.02


def test_search_text_matches_vector_path(built):
    prefix, _, queries = built
    _, ts = _searchers(prefix)
    a = ts.search_text(queries[:8], 3, complexity=32, beam_width=4)["labels"]
    q = _unit(ts._encoder().encode(queries[:8]))
    b = ts.search(q, 3, complexity=32, beam_width=4)["labels"]
    assert np.mean([set(x) == set(y) for x, y in zip(a.tolist(), b.tolist())]) >= 0.85


def test_batch_lanes_freeze_independently(built):
    """Lanes converge after different hop counts; a converged lane must not
    change while the others run on (vmap(while_loop) semantics), so a batch
    gives each query the result it gets alone."""
    from leann_torch.ops.beam_search import beam_search_batch

    prefix, _, queries = built
    _, ts = _searchers(prefix)
    q = torch.from_numpy(_unit(ts._encoder().encode(queries[:8])))
    cfg, enc_params = ts._make_cfg(3, complexity=32, beam_width=4)
    g = ts._graph_data()
    ids_b, d_b, steps_b, exact_b = beam_search_batch(q, g, cfg, enc_params)
    assert len(set(steps_b.tolist())) > 1  # the lanes do stop at different hops
    for i in range(8):
        ids_1, d_1, steps_1, exact_1 = beam_search_batch(q[i : i + 1], g, cfg, enc_params)
        assert ids_1[0].tolist() == ids_b[i].tolist()
        np.testing.assert_allclose(d_1[0].numpy(), d_b[i].numpy(), rtol=1e-5, atol=1e-6)
        assert (int(steps_1[0]), int(exact_1[0])) == (int(steps_b[i]), int(exact_b[i]))


def test_metric_dists_stay_f32_on_bf16_rows():
    from leann_torch.ops.beam_search import _metric_dists

    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((50, 64)).astype(np.float32)).to(torch.bfloat16)
    e64 = e.double().numpy()
    for metric in ("l2", "cosine"):
        d = _metric_dists(q, e, metric)
        assert d.dtype == torch.float32
        want = -(q.double().numpy() @ e64.T)
        if metric == "l2":
            want = (q.double().numpy() ** 2).sum(1)[:, None] + (e64 ** 2).sum(1)[None] + 2 * want
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-4)


def test_ties_go_to_the_lower_position():
    from leann_torch.ops.beam_search import _merge_pool
    from leann_torch.ops.distance import stable_topk_smallest

    ids, dist, flag = _merge_pool(torch.tensor([[7, 3]]), torch.tensor([[1.0, 2.0]]), torch.tensor([[False, False]]),
                                  torch.tensor([[9, 4]]), torch.tensor([[1.0, 2.0]]), torch.tensor([[False, True]]), 3)
    assert ids.tolist() == [[7, 9, 3]] and flag.tolist() == [[False, False, False]]
    vals, idx = stable_topk_smallest(torch.tensor([[0.5, 0.1, 0.1, 0.1]]), 2)
    assert idx.tolist() == [[1, 2]]


def test_dedup_and_visited_bitmap():
    from leann_torch.ops.beam_search import _dedup_mask, _mark_visited

    nbrs = torch.tensor([[5, 3, 5, -1, 3, 7], [1, 1, 1, 2, 40, 2]])
    valid = nbrs >= 0
    got = _dedup_mask(nbrs, valid)
    assert got.tolist() == [[True, True, False, False, False, True], [True, False, False, True, True, False]]
    visited = torch.zeros((2, 2), dtype=torch.int64)
    _mark_visited(visited, nbrs.clamp(0), got)
    for row in range(2):
        want = {int(i) for i, v in zip(nbrs[row], got[row]) if v}
        have = {w * 32 + b for w in range(2) for b in range(32) if (int(visited[row, w]) >> b) & 1}
        assert have == want
