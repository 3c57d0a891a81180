"""The locality relabel of leann_torch (``ops/relabel.py``,
``repack.relabel_index`` with no order) against the JAX package's, on the
CPU: the locality order over a seeded clustered matrix (N = 6,000, D = 64),
the block sources and the cell chain, then the relabel of a diskann index
(geometry from its PQ codes) and of a non-compact hnsw index (its stored
embeddings), each on two copies, one per package: the same row order,
search results equal up to the id mapping, and ``unrelabel_index``
restoring every array."""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leann_torch.ops import graph as tg
from leann_torch.ops import relabel as tr
from leann_tpu.ops import relabel as jr

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

N, D = 6000, 64
SEARCH_KW = dict(top_k=3, complexity=32, beam_width=4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emb():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((80, D)).astype(np.float32) * 1.5
    return centers[rng.integers(0, 80, N)] + rng.standard_normal((N, D)).astype(np.float32)


def test_locality_order_matches_jax(emb):
    want = jr.locality_order(jr.matrix_source(emb), N, D)  # 64 cells (the floor of N / 2048)
    got = tr.locality_order(tr.matrix_source(emb), N, D, device="cpu")
    assert np.mean(got == want) >= 0.999
    assert np.array_equal(np.sort(got), np.arange(N))
    # neighbors land near each other: the exact 8-NN's ids move closer
    knn, _ = tg.exact_knn(emb, 8, device="cpu")
    new_of_old = np.empty(N, np.int64)
    new_of_old[got] = np.arange(N)
    assert tr.edge_locality(new_of_old[knn][got], window=512) > 2 * tr.edge_locality(knn, window=512)
    # too few rows for the cells: the identity
    assert np.array_equal(tr.locality_order(tr.matrix_source(emb[:255]), 255, D, device="cpu"), np.arange(255))


def test_sources_and_chain_match_jax(emb):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (300, 8)).astype(np.uint8)
    cb = rng.standard_normal((8, 256, 8)).astype(np.float32)
    np.testing.assert_array_equal(tr.decoded_source(codes, cb)(17, 211), jr.decoded_source(codes, cb)(17, 211))
    np.testing.assert_array_equal(tr.matrix_source(emb.astype(np.float16))(5, 50),
                                  jr.matrix_source(emb.astype(np.float16))(5, 50))
    cent = rng.standard_normal((200, D)).astype(np.float32)
    np.testing.assert_array_equal(tr.chain_rank(cent), jr.chain_rank(cent))
    idx = np.sort(rng.choice(N, 700, replace=False))
    np.testing.assert_array_equal(tr._gather_sample(tr.matrix_source(emb), idx, N), emb[idx])
    nb = rng.integers(-1, N, (N, 8)).astype(np.int32)
    assert tr.edge_locality(nb, window=300) == jr.edge_locality(nb, window=300)


@pytest.fixture(scope="module")
def corpus():
    from scale_500k import synth_corpus

    rng = np.random.default_rng(3)
    chunks = synth_corpus(400, rng)
    q_idx = rng.choice(len(chunks), 24, replace=False)
    return chunks, [" ".join(chunks[i].split()[:12]) for i in q_idx]


def _arrays(prefix):
    """Every array of the index's .npz / .npy files, and its ids list."""
    d, base = os.path.split(prefix)
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith(base) and f.endswith((".npz", ".npy")):
            z = np.load(os.path.join(d, f))
            out.update({f"{f}:{k}": z[k] for k in z.files} if f.endswith(".npz") else {f: z})
    out["ids"] = json.load(open(prefix + ".ids.json"))
    return out


@pytest.mark.parametrize("backend", ["diskann", "hnsw"])
def test_relabel_index_without_order(tmp_path, corpus, backend):
    """diskann (compact: PQ codes, decoded_source) and hnsw non-compact (its
    stored embeddings, matrix_source), 8 cells: the port's and the JAX
    package's relabels give the same ids order on copies of one index,
    the port's searches give the same ids, and the unrelabel restores
    every array."""
    import leann_torch
    from leann_tpu import repack as jax_repack

    from leann_torch import repack
    from leann_torch.storage import load_ids

    chunks, queries = corpus
    kw = {"diskann": {"graph_degree": 8, "num_partitions": 1}, "hnsw": {"M": 8, "is_compact": False}}[backend]
    src = str(tmp_path / "src" / "r.leann")
    b = leann_torch.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, device="cpu",
                                 **kw)
    for c in chunks:
        b.add_text(c)
    b.build_index(src)
    z = np.load(f"{src}.{backend}.npz")
    assert ("codes" in z.files and "embeddings" not in z.files) if backend == "diskann" else "embeddings" in z.files
    for name in ("torch", "jax"):
        shutil.copytree(tmp_path / "src", tmp_path / name)
    t, j = str(tmp_path / "torch" / "r.leann"), str(tmp_path / "jax" / "r.leann")
    ids_before = [[r.id for r in row] for row in leann_torch.LeannSearcher(t, device="cpu").search(queries, **SEARCH_KW)]
    before = _arrays(t)  # with the caches the search derived

    rep = repack.relabel_index(t, n_cells=8, device="cpu")
    jax_repack.relabel_index(j, n_cells=8)
    order_t, order_j = np.array(load_ids(t), np.int64), np.array(load_ids(j), np.int64)
    assert not np.array_equal(order_t, np.arange(len(chunks)))
    assert np.mean(order_t == order_j) >= 0.999
    loc = rep["edge_locality_64k"]
    assert loc["before"] == loc["after"] == 1.0  # the whole index is inside one 64K window
    ids_after = [[r.id for r in row] for row in leann_torch.LeannSearcher(t, device="cpu").search(queries, **SEARCH_KW)]
    assert ids_after == ids_before

    repack.unrelabel_index(t)
    after = _arrays(t)
    assert after.keys() == before.keys()
    for k, a in before.items():
        if k == "ids":
            assert after[k] == a
        else:
            np.testing.assert_array_equal(after[k], a, err_msg=k)
    assert not os.path.exists(t + ".ids.perm.npy")
