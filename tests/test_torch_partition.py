"""The diskann LDG partition and relayout, build_index_from_embeddings and
the repack / relabel tools of the port, held against the JAX package on the
CPU on the same seeded inputs and the same on-disk indexes."""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

SEARCH_KW = dict(top_k=3, complexity=32, beam_width=4)


def _kw(pkg):
    return {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}


def _ids(results):
    return [[r.id for r in row] for row in results]


def _files(prefix):
    d, base = os.path.split(prefix)
    return sorted(f[len(base):] for f in os.listdir(d) if f.startswith(base))


def _arrays(path):
    """Every array of an .npz or .npy file -> {name: array}."""
    if path.endswith(".npy"):
        return {"": np.load(path)}
    z = np.load(path)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def corpus():
    from scale_500k import synth_corpus

    rng = np.random.default_rng(0)
    chunks = synth_corpus(320, rng)
    q_idx = rng.choice(len(chunks), 24, replace=False)
    return chunks, [" ".join(chunks[i].split()[:12]) for i in q_idx]


def _seeded_graph(n, r, seed, pad=False):
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, n, (n, r)).astype(np.int32)
    if pad:
        nb[rng.random((n, r)) < 0.3] = -1
        nb[:5] = -1  # rows with no edge at all
    return nb


@pytest.mark.parametrize("n_parts,pad", [(2, False), (4, False), (8, False), (4, True)])
def test_ldg_matches_jax(n_parts, pad):
    from leann_tpu.backends.diskann import partition as jp

    from leann_torch.backends.diskann.partition import edge_locality, ldg_partition

    assert jp._load_lib() is not None, "the JAX package's native LDG core must build to be the reference"
    nb = _seeded_graph(3000, 16, n_parts, pad)
    want = jp.ldg_partition(nb, n_parts)
    got = ldg_partition(nb, n_parts)
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got).min() >= 3000 // n_parts
    assert edge_locality(nb, got) == jp.edge_locality(nb, want)
    assert (ldg_partition(nb, 1) == 0).all()


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory, corpus):
    """A diskann build at num_partitions=4 by each package over the same
    chunks, each given the same graph (the port's build_graph): the graphs
    the two packages build differ in a few near-tie rows, and LDG turns any
    difference into another assignment."""
    import leann_torch
    import leann_tpu
    from leann_tpu.backends.diskann import backend as jax_backend

    from leann_torch.backends.diskann import backend as torch_backend
    from leann_torch.ops.graph import build_graph

    chunks, _ = corpus
    saved = {}

    def fixed_graph(data, **kw):
        if "graph" not in saved:
            kw = {k: v for k, v in kw.items() if k in ("r", "candidate_factor", "alpha")}
            saved["graph"] = build_graph(np.asarray(data, np.float32), device="cpu", **kw)
        return saved["graph"][0].copy(), saved["graph"][1]

    d = tmp_path_factory.mktemp("partitioned")
    paths = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch_backend, "build_graph", fixed_graph)
        mp.setattr(jax_backend, "build_graph", fixed_graph)
        for name, pkg in (("torch", leann_torch), ("jax", leann_tpu)):
            paths[name] = str(d / name / "p.leann")
            b = pkg.LeannBuilder(backend_name="diskann", embedding_model="hash-tiny", max_length=32,
                                 graph_degree=12, num_partitions=4, **_kw(pkg))
            for c in chunks:
                b.add_text(c)
            b.build_index(paths[name])
    finally:
        mp.undo()
    paths["graph"] = saved["graph"]
    return paths


def test_partitioned_build_matches_jax(partitioned, corpus):
    from leann_torch.backends.diskann.partition import ldg_partition
    from leann_torch.storage import load_ids, load_partition, load_token_cache, unpack_neighbors

    chunks, _ = corpus
    n = len(chunks)
    t, j = partitioned["torch"], partitioned["jax"]
    assert load_ids(t) == load_ids(j) and sorted(load_ids(t), key=int) == [str(i) for i in range(n)]
    assert load_ids(t) != [str(i) for i in range(n)]  # the relayout relabeled the rows
    np.testing.assert_array_equal(np.load(t + ".partition.npz")["counts"], np.load(j + ".partition.npz")["counts"])
    assert np.load(t + ".partition.npz")["counts"].sum() == n
    zt, zj = np.load(t + ".diskann.npz"), np.load(j + ".diskann.npz")
    assert set(zt.files) == set(zj.files)
    assert int(zt["medoid"]) == int(zj["medoid"])
    np.testing.assert_array_equal(zt["entries"], zj["entries"])
    np.testing.assert_array_equal(unpack_neighbors(zt), unpack_neighbors(zj))
    (tt, lt), (tj, lj) = load_token_cache(t), load_token_cache(j)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(lt, lj)
    # the relayout: partitions contiguous, rows are the graph's in LDG order
    nb0, med0 = partitioned["graph"]
    order = np.argsort(ldg_partition(nb0, 4), kind="stable")
    assert [str(i) for i in order] == load_ids(t)
    assert order[int(zt["medoid"])] == med0
    np.testing.assert_array_equal(np.diff(load_partition(t)) >= 0, True)
    assert not os.path.exists(t + ".tokens.cache.done.json")  # a rebuild writes the store anew


@pytest.mark.parametrize("built_by,searched_by", [("jax", "torch"), ("torch", "jax")])
def test_partitioned_index_interchange(partitioned, corpus, built_by, searched_by):
    import leann_torch
    import leann_tpu

    pkgs = {"jax": leann_tpu, "torch": leann_torch}
    _, queries = corpus
    native = _ids(pkgs[built_by].LeannSearcher(partitioned[built_by], **_kw(pkgs[built_by])).search(
        queries, **SEARCH_KW))
    other = _ids(pkgs[searched_by].LeannSearcher(partitioned[built_by], **_kw(pkgs[searched_by])).search(
        queries, **SEARCH_KW))
    assert np.mean([set(a) == set(b) for a, b in zip(native, other)]) >= 0.9


@pytest.mark.parametrize("with_texts", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("backend", ["hnsw", "diskann", "flat"])
def test_build_index_from_embeddings_matches_jax(tmp_path, corpus, backend, dtype, with_texts):
    import leann_torch
    import leann_tpu

    chunks, queries = corpus
    chunks = chunks[:160]
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((len(chunks), 48)).astype(dtype)  # not unit-norm: cosine normalizes
    ids = [f"doc{i}" for i in range(len(chunks))]
    kw = {"hnsw": {"M": 8}, "diskann": {"graph_degree": 8, "num_partitions": 1}, "flat": {}}[backend]
    prefixes = {}
    for name, pkg in (("torch", leann_torch), ("jax", leann_tpu)):
        prefixes[name] = str(tmp_path / name / "e.leann")
        b = pkg.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32,
                             distance_metric="cosine", **kw, **_kw(pkg))
        arr = emb.copy()
        b.build_index_from_embeddings(prefixes[name], ids, arr, texts=chunks if with_texts else None)
        if dtype == "float32":
            np.testing.assert_allclose(np.linalg.norm(arr, axis=1), 1.0, rtol=1e-5)  # normalized in place
    t, j = prefixes["torch"], prefixes["jax"]
    assert _files(t) == _files(j)
    zt, zj = np.load(f"{t}.{backend}.npz"), np.load(f"{j}.{backend}.npz")
    assert set(zt.files) == set(zj.files)
    for f in zt.files:
        assert zt[f].dtype == zj[f].dtype and (zt[f].shape == zj[f].shape or f == "neighbors_packed"), f
    if "embeddings" in zt.files:
        want = np.float16 if (dtype == "float16" and backend != "flat") else np.float32
        assert zt["embeddings"].dtype == want
        np.testing.assert_allclose(zt["embeddings"].astype(np.float32), zj["embeddings"].astype(np.float32),
                                   rtol=0, atol=1e-3 if dtype == "float16" else 1e-6)
    mt, mj = json.load(open(t + ".meta.json")), json.load(open(j + ".meta.json"))
    for key in ("is_recompute", "is_compact", "num_chunks", "dimensions", "distance_metric", "backend_name"):
        assert mt[key] == mj[key], key
    assert mt["is_recompute"] is with_texts or backend == "flat"
    if not mt["is_recompute"] or backend == "flat":  # the search ranks the given vectors
        res = leann_torch.LeannSearcher(t, device="cpu").search(emb[:8].astype(np.float32), top_k=1,
                                                                complexity=32)
        assert [r[0].id for r in res] == ids[:8]  # each row finds itself


def _legacy(prefix):
    """Take an index back to the legacy artifacts repack migrates: raw
    neighbor rows, the entry pool inside the npz, a list of ids, legacy token
    names, a raw partition array."""
    from leann_torch.storage import load_partition, unpack_neighbors

    path = next(f"{prefix}.{b}.npz" for b in ("diskann", "hnsw") if os.path.exists(f"{prefix}.{b}.npz"))
    z = dict(np.load(path, allow_pickle=False))
    nbr = unpack_neighbors(z)
    for k in ("neighbors_packed", "neighbors_n", "neighbors_r"):
        z.pop(k)
    z["neighbors"] = nbr
    z["entry_emb"] = np.load(f"{prefix}.entries.cache.npy")
    os.remove(f"{prefix}.entries.cache.npy")
    np.savez(path, **z)
    json.dump([str(i) for i in range(nbr.shape[0])], open(f"{prefix}.ids.json", "w"))
    os.rename(f"{prefix}.tokens.cache.npz", f"{prefix}.tokens.npz")
    part = load_partition(prefix)
    if part is not None:
        np.save(f"{prefix}.partition.npy", part)
        os.remove(f"{prefix}.partition.npz")


@pytest.mark.parametrize("backend", ["hnsw", "diskann"])
def test_repack_relabel_unrelabel_match_jax(tmp_path, corpus, backend, capsys):
    """repack_index, relabel_index(order=...) and unrelabel_index leave the
    same arrays in both packages, on copies of one legacy index; the
    unrelabel restores the repacked index."""
    import leann_torch
    import leann_tpu
    from leann_tpu import repack as jax_repack

    from leann_torch import repack
    from leann_torch.storage import load_ids, unpack_neighbors

    chunks, queries = corpus
    src = str(tmp_path / "src" / "r.leann")
    kw = {"hnsw": {"M": 8}, "diskann": {"graph_degree": 8, "num_partitions": 1}}[backend]
    b = leann_tpu.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, **kw)
    for c in chunks:
        b.add_text(c)
    b.build_index(src)
    _legacy(src)
    prefixes = {}
    for name in ("torch", "jax"):
        shutil.copytree(tmp_path / "src", tmp_path / name)
        prefixes[name] = str(tmp_path / name / "r.leann")
    t, j = prefixes["torch"], prefixes["jax"]
    order = np.random.default_rng(11).permutation(len(chunks))

    def same_files():
        assert _files(t) == _files(j)
        for f in _files(t):
            if f.endswith((".npz", ".npy")):
                at, aj = _arrays(t + f), _arrays(j + f)
                assert at.keys() == aj.keys(), f
                for k in at:
                    np.testing.assert_array_equal(at[k], aj[k], err_msg=f + k)
            elif f == ".ids.json":
                assert json.load(open(t + f)) == json.load(open(j + f)), f

    rt, rj = repack.repack_index(t), jax_repack.repack_index(j)
    assert rt == rj and rt["after_bytes"] < rt["before_bytes"]
    same_files()
    repacked = {f: _arrays(t + f) for f in _files(t) if f.endswith((".npz", ".npy"))}
    before = _ids(leann_torch.LeannSearcher(t, device="cpu").search(queries, **SEARCH_KW))
    rt, rj = repack.relabel_index(t, order=order), jax_repack.relabel_index(j, order=order)
    assert rt == rj
    same_files()
    assert load_ids(t) == [str(i) for i in order]
    relabeled = _ids(leann_torch.LeannSearcher(t, device="cpu").search(queries, **SEARCH_KW))
    assert np.mean([set(a) == set(b) for a, b in zip(before, relabeled)]) >= 0.9
    repack.main([t, "--unrelabel"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"]
    jax_repack.unrelabel_index(j)
    same_files()
    assert load_ids(t) == [str(i) for i in range(len(chunks))] and not os.path.exists(t + ".ids.perm.npy")
    for f, arrays in repacked.items():
        now = _arrays(t + f)
        for k, a in arrays.items():
            np.testing.assert_array_equal(now[k], a, err_msg=f + k)
    npz = f".{backend}.npz"
    np.testing.assert_array_equal(unpack_neighbors(np.load(t + npz)), unpack_neighbors(repacked[npz]))


def test_relabel_refusals(partitioned, tmp_path):
    """A multi-partition index refuses the locality relabel
    (relabel_index(order=None), which refused as not ported before it was)
    and the unrelabel, and an index with neither embeddings nor PQ codes
    refuses the locality relabel, in both packages alike."""
    from leann_tpu import repack as jax_repack

    from leann_torch import repack

    for mod, prefix in ((repack, partitioned["torch"]), (jax_repack, partitioned["jax"])):
        kw = {"device": "cpu"} if mod is repack else {}
        with pytest.raises(ValueError, match="multi-partition"):
            mod.relabel_index(prefix, **kw)
        with pytest.raises(ValueError, match="multi-partition"):
            mod.unrelabel_index(prefix)
    for mod in (repack, jax_repack):
        bare = str(tmp_path / mod.__name__ / "b.leann")
        os.makedirs(os.path.dirname(bare))
        np.savez(bare + ".hnsw.npz", neighbors=_seeded_graph(40, 4, 1))
        kw = {"device": "cpu"} if mod is repack else {}
        with pytest.raises(ValueError, match="neither embeddings nor PQ codes"):
            mod.relabel_index(bare, **kw)
