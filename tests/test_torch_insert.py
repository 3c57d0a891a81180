"""The port's incremental insert held against the JAX package on the CPU:
robust_prune_explicit, node_embeddings, insert_batch, the hnsw and flat
inserts and LeannBuilder.from_index / update_index, on the same seeded
inputs and the same on-disk indexes (mirrors tests/test_incremental.py)."""

import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

BASE_KW = dict(embedding_model="hash-tiny", max_length=32)
SEARCH_KW = dict(top_k=3, complexity=32, beam_width=4)


def _kw(pkg):
    return {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}


def _build(pkg, backend, chunks, prefix, **kw):
    b = pkg.LeannBuilder(backend_name=backend, **BASE_KW, **_kw(pkg), **kw)
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)


def _update(pkg, prefix, chunks, **kw):
    u = pkg.LeannBuilder.from_index(prefix, **_kw(pkg))
    for c in chunks:
        u.add_text(c)
    u.update_index(prefix, **kw)


def _copy_index(src_prefix, dst_dir):
    """A copy of an index in ``dst_dir``, its meta pointing at the copy's
    passages (meta.json holds the paths the build wrote)."""
    os.makedirs(dst_dir, exist_ok=True)
    src_dir, base = os.path.split(src_prefix)
    for f in os.listdir(src_dir):
        if f.startswith(base):
            shutil.copy(os.path.join(src_dir, f), dst_dir)
    prefix = os.path.join(dst_dir, base)
    meta = json.load(open(prefix + ".meta.json"))
    for src in meta["passage_sources"]:
        src.update(path=prefix + ".passages.jsonl", index_path=prefix + ".passages.idx")
    json.dump(meta, open(prefix + ".meta.json", "w"))
    return prefix


def _ids(results):
    return [[r.id for r in row] for row in results]


def _recall(pred, truth):
    return float(np.mean([len(set(p) & set(t)) / len(t) for p, t in zip(pred, truth)]))


@pytest.fixture(scope="module")
def corpus():
    from scale_500k import synth_corpus

    return synth_corpus(240, np.random.default_rng(0)), synth_corpus(24, np.random.default_rng(8))


@pytest.fixture(scope="module")
def base(tmp_path_factory, corpus):
    """A compact recompute hnsw index and a stored-embedding one, both built
    by the JAX package."""
    import leann_tpu

    chunks, _ = corpus
    d = tmp_path_factory.mktemp("insert_base")
    paths = {"recompute": str(d / "rc" / "b.leann"), "stored": str(d / "st" / "b.leann")}
    _build(leann_tpu, "hnsw", chunks, paths["recompute"], M=8)
    _build(leann_tpu, "hnsw", chunks, paths["stored"], M=8, is_recompute=False)
    return paths


@pytest.fixture(scope="module")
def updated(tmp_path_factory, base, corpus):
    """The recompute index updated by each package (two batches), and a flat
    oracle over all chunks."""
    import leann_torch
    import leann_tpu

    chunks, new = corpus
    d = tmp_path_factory.mktemp("insert_updated")
    out = {}
    for name, pkg in (("jax", leann_tpu), ("torch", leann_torch)):
        out[name] = _copy_index(base["recompute"], str(d / name))
        _update(pkg, out[name], new, insert_batch_size=16)
        # the grown pool's sidecar is stale: gone until the next searcher derives it
        out[name + "_sidecar"] = os.path.exists(out[name] + ".entries.cache.npy")
    out["flat"] = str(d / "flat" / "f.leann")
    _build(leann_torch, "flat", chunks + new, out["flat"])
    return out


def _same_encoder(js, ts):
    """Give both searchers the f32 forward on the JAX package's weights
    (copies; the encoder caches stay as they were), so that a comparison
    sees the code under test and not the bf16 forward's rounding, which
    tests/test_torch_encoder.py holds at 2e-3."""
    import copy
    from dataclasses import replace

    import jax

    from leann_torch.embeddings.encoder import params_from_jax

    je, te = copy.copy(js._encoder()), copy.copy(ts._encoder())
    je.cfg = replace(je.cfg, compute_dtype="float32")
    te.cfg = replace(te.cfg, compute_dtype="float32")
    te.params = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), device="cpu")
    js._enc, ts._enc = je, te


@pytest.mark.parametrize("r,alpha,keep", [(8, 1.2, 2), (12, 1.0, 3), (6, 1.5, 1)])
def test_robust_prune_explicit_matches_jax(r, alpha, keep):
    import jax.numpy as jnp
    from leann_tpu.ops.graph import robust_prune_explicit as jax_prune

    from leann_torch.ops.graph import robust_prune_explicit

    rng = np.random.default_rng(r)
    b, c, d = 16, 24, 32
    p = rng.standard_normal((b, d)).astype(np.float32)
    ce = rng.standard_normal((b, c, d)).astype(np.float32)
    ids = rng.integers(0, 1000, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1
    want = np.asarray(jax_prune(jnp.asarray(p), jnp.asarray(ids), jnp.asarray(ce), r, alpha, keep))
    got = robust_prune_explicit(torch.from_numpy(p), torch.from_numpy(ids), torch.from_numpy(ce), r, alpha, keep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["stored", "recompute"])
def test_node_embeddings_match_jax(base, kind):
    from leann_tpu.backends.hnsw.backend import HnswSearcher as JaxSearcher
    from leann_tpu.ops.insert import node_embeddings as jax_node_embeddings

    from leann_torch.backends.hnsw.backend import HnswSearcher
    from leann_torch.ops.insert import node_embeddings

    js, ts = JaxSearcher(base[kind]), HnswSearcher(base[kind], device="cpu")
    assert (ts.emb is None) == (kind == "recompute")
    _same_encoder(js, ts)
    n = ts.n
    rng = np.random.default_rng(3)
    d = int(ts.meta["dimensions"])
    new = rng.standard_normal((5, d)).astype(np.float32)
    ids = rng.integers(-1, n + 5, (7, 9)).astype(np.int32)
    ids[0, :3] = (-1, n, n + 4)
    want = jax_node_embeddings(js, ids, new_emb=new, n_old=n)
    got = node_embeddings(ts, ids, new_emb=torch.from_numpy(new), n_old=n).numpy()
    assert got.shape == want.shape == (7, 9, d)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not got[0, 0].any()  # a -1 row is zeros


def test_insert_batch_matches_jax_given_the_same_discovery(base, corpus):
    """Given the same discovery labels, the prune and the reverse repair
    give the same rows in both packages."""
    from leann_tpu.backends.hnsw.backend import HnswSearcher as JaxSearcher
    from leann_tpu.embeddings.compute import compute_embeddings
    from leann_tpu.ops.insert import insert_batch as jax_insert_batch

    from leann_torch.backends.hnsw.backend import HnswSearcher
    from leann_torch.ops.insert import insert_batch

    _, new = corpus
    js, ts = JaxSearcher(base["recompute"]), HnswSearcher(base["recompute"], device="cpu")
    _same_encoder(js, ts)
    emb = compute_embeddings(new[:12], "hash-tiny", max_length=32)
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    c = min(max(2 * ts.neighbors.shape[1], 16), ts.n)
    found = js.search(emb, c, complexity=max(64, c), beam_width=8, recompute_embeddings=True, prune_ratio=0.0)
    fixed = {"labels": np.asarray(found["labels"]), "distances": np.asarray(found["distances"])}
    js.search = ts.search = lambda *a, **k: fixed
    want = jax_insert_batch(js, emb)
    got = insert_batch(ts, emb)
    for g, w, name in zip(got, want, ("new_rows", "touched", "touched_rows")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[1].size > 0


def test_update_finds_new_and_old_chunks_with_recall_near_jax(updated, corpus):
    import leann_torch
    import leann_tpu

    chunks, new = corpus
    queries = [" ".join(c.split()[:12]) for c in chunks[::12] + new]
    truth = _ids(leann_torch.LeannSearcher(updated["flat"], device="cpu").search(queries, top_k=3))
    ts = leann_torch.LeannSearcher(updated["torch"], device="cpu")
    got = _ids(ts.search(queries, **SEARCH_KW))
    want = _ids(leann_tpu.LeannSearcher(updated["jax"]).search(queries, **SEARCH_KW))
    assert abs(_recall(got, truth) - _recall(want, truth)) <= 0.05
    assert _recall(got, truth) >= 0.8
    # each chunk, its whole text as the query, is its own first hit
    hits_new = sum(r and r[0].text == c for r, c in zip(ts.search(new, **SEARCH_KW), new))
    hits_old = sum(r and r[0].text == c for r, c in zip(ts.search(chunks[:24], **SEARCH_KW), chunks[:24]))
    assert hits_new >= 22 and hits_old >= 22, (hits_new, hits_old)


def test_update_artifacts_match_jax(updated, corpus):
    from leann_torch.storage import load_ids, load_token_cache, unpack_neighbors

    chunks, new = corpus
    n = len(chunks) + len(new)
    zt, zj = (np.load(updated[k] + ".hnsw.npz") for k in ("torch", "jax"))
    assert set(zt.files) == set(zj.files)
    for f in zt.files:
        assert zt[f].dtype == zj[f].dtype and (zt[f].shape == zj[f].shape or f == "neighbors_packed"), f
    np.testing.assert_array_equal(zt["entries"], zj["entries"])
    assert int(zt["medoid"]) == int(zj["medoid"])
    nt, nj = unpack_neighbors(zt), unpack_neighbors(zj)
    assert nt.shape == nj.shape == (n, 8)
    assert np.mean([set(a) == set(b) for a, b in zip(nt.tolist(), nj.tolist())]) >= 0.9
    for i, row in enumerate(nt):  # no self loops, no duplicate edges, ids in range
        row = row[row >= 0]
        assert i not in row and row.size == np.unique(row).size and (row < n).all()
    assert updated["torch_sidecar"] is updated["jax_sidecar"] is False
    mt, mj = (json.load(open(updated[k] + ".meta.json")) for k in ("torch", "jax"))
    assert mt["num_chunks"] == mj["num_chunks"] == n and mt["passage_sources"][0]["count"] == n
    assert {k: v for k, v in mt.items() if k != "passage_sources"} == {k: v for k, v in mj.items()
                                                                      if k != "passage_sources"}
    assert load_ids(updated["torch"]) == load_ids(updated["jax"]) == [str(i) for i in range(n)]
    (tt, lt), (tj, lj) = load_token_cache(updated["torch"]), load_token_cache(updated["jax"])
    assert tt.dtype == tj.dtype and tt.shape == (n, 32)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(lt, lj)
    offsets = [pickle.load(open(updated[k] + ".passages.idx", "rb")) for k in ("torch", "jax")]
    assert offsets[0] == offsets[1] and len(offsets[0]) == n


@pytest.mark.parametrize("case", ["duplicate_id", "diskann", "backend_mismatch"])
def test_update_refuses(tmp_path, base, case):
    import leann_torch

    if case == "diskann":
        prefix = str(tmp_path / "d.leann")
        _build(leann_torch, "diskann", [f"passage {i} on topic {i % 7}" for i in range(40)], prefix,
               graph_degree=8)
        u = leann_torch.LeannBuilder.from_index(prefix, device="cpu")
        u.add_text("a new chunk")
        with pytest.raises(NotImplementedError, match="partition-contiguous"):
            u.update_index(prefix)
        return
    prefix = _copy_index(base["recompute"], str(tmp_path / "c"))
    if case == "backend_mismatch":
        u = leann_torch.LeannBuilder(backend_name="flat", **BASE_KW, device="cpu")
        u.add_text("a new chunk")
        with pytest.raises(ValueError, match="builder is 'flat'"):
            u.update_index(prefix)
        return
    u = leann_torch.LeannBuilder.from_index(prefix, device="cpu")
    u.add_text("a chunk with an explicit id", id="x")
    u.update_index(prefix)
    u = leann_torch.LeannBuilder.from_index(prefix, device="cpu")
    u.add_text("another chunk, the same id", id="x")
    with pytest.raises(ValueError, match="duplicate id 'x'"):
        u.update_index(prefix)


@pytest.mark.parametrize("against", ["rebuild", "jax_update"])
def test_flat_insert(tmp_path, corpus, against):
    """The port's flat insert equals its rebuild over all chunks (the same
    matrix, the same answers), and the JAX package's insert of the same
    chunks into a copy of the same index (its own bf16 encoder: within the
    2e-3 that tests/test_torch_encoder.py holds the two forwards to)."""
    import leann_torch
    import leann_tpu

    chunks, new = corpus
    base = str(tmp_path / "b" / "x.leann")
    _build(leann_torch, "flat", chunks, base)
    inc = _copy_index(base, str(tmp_path / "inc"))
    _update(leann_torch, inc, new)
    ref = _copy_index(base, str(tmp_path / "ref"))
    if against == "rebuild":
        _build(leann_torch, "flat", chunks + new, ref)
    else:
        _update(leann_tpu, ref, new)
    zi, zr = np.load(inc + ".flat.npz"), np.load(ref + ".flat.npz")
    assert set(zi.files) == set(zr.files) and str(zi["metric"]) == str(zr["metric"])
    ei, er = zi["embeddings"], zr["embeddings"]
    assert ei.dtype == er.dtype == np.float32 and ei.shape == er.shape == (len(chunks) + len(new), 64)
    np.testing.assert_allclose(ei, er, rtol=0, atol=1e-6 if against == "rebuild" else 2e-3)
    if against == "rebuild":
        queries = [" ".join(c.split()[:12]) for c in chunks[::20] + new]
        ri = leann_torch.LeannSearcher(inc, device="cpu").search(queries, top_k=3)
        rr = leann_torch.LeannSearcher(ref, device="cpu").search(queries, top_k=3)
        assert _ids(ri) == _ids(rr)
        np.testing.assert_allclose([[x.score for x in r] for r in ri], [[x.score for x in r] for r in rr],
                                   atol=1e-6)


@pytest.mark.parametrize("built_by,updated_by", [("jax", "torch"), ("torch", "jax")])
def test_update_across_packages(tmp_path, corpus, built_by, updated_by):
    """An index one package built, the other updated, searched by both."""
    import leann_torch
    import leann_tpu

    pkgs = {"jax": leann_tpu, "torch": leann_torch}
    chunks, new = corpus
    prefix = str(tmp_path / "x.leann")
    _build(pkgs[built_by], "hnsw", chunks, prefix, M=8)
    _update(pkgs[updated_by], prefix, new, insert_batch_size=16)
    queries = [" ".join(c.split()[:12]) for c in new]
    res = {name: _ids(pkg.LeannSearcher(prefix, **_kw(pkg)).search(queries, **SEARCH_KW))
           for name, pkg in pkgs.items()}
    assert np.mean([set(a) == set(b) for a, b in zip(res["jax"], res["torch"])]) >= 0.9
    for got in res.values():  # an inserted chunk's prefix finds it
        assert np.mean([str(240 + i) in row for i, row in enumerate(got)]) >= 0.9
