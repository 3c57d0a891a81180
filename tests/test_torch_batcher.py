"""leann_torch's BatchedSearcher (CPU): the six cases of tests/test_batcher.py
on a small port index (coalescing, equality with direct search, parameter
isolation, error propagation, shutdown, an existing searcher), the same
labels as the JAX package's BatchedSearcher on the same index."""

import threading

import numpy as np
import pytest
import torch

import leann_torch
import leann_tpu
from leann_torch import BatchedSearcher, LeannSearcher

DOCS = [
    ("machine learning is a subset of artificial intelligence", {"chapter": 1}),
    ("neural networks learn hierarchical representations from data", {"chapter": 2}),
    ("the solar system contains eight planets orbiting the sun", {"chapter": 3}),
    ("jupiter is the largest planet in the solar system", {"chapter": 4}),
    ("photosynthesis converts sunlight into chemical energy in plants", {"chapter": 5}),
    ("mitochondria are the powerhouse of the cell", {"chapter": 6}),
    ("the stock market fluctuates based on investor sentiment", {"chapter": 7}),
    ("compound interest grows savings exponentially over time", {"chapter": 8}),
]
QUERIES = ["solar system planets", "neural networks data", "stock market investors", "photosynthesis energy",
           "jupiter largest planet", "compound interest savings", "machine learning intelligence",
           "mitochondria cell"]
KW = dict(top_k=2, complexity=8, beam_width=2)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def built_index(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("batcher") / "idx.leann")
    b = leann_torch.LeannBuilder(backend_name="hnsw", embedding_model="hash-tiny", max_length=32, M=4, device="cpu")
    for text, md in DOCS:
        b.add_text(text, metadata=md)
    b.build_index(path)
    return path


def test_matches_direct_search(built_index):
    want = LeannSearcher(built_index, device="cpu").search("planets of the solar system", **KW)
    with BatchedSearcher(built_index, max_batch=4, max_wait_ms=1.0, enable_warmup=False, device="cpu") as bs:
        assert bs.searcher.device == torch.device("cpu")
        got = bs.search("planets of the solar system", **KW)
    assert [r.id for r in got] == [r.id for r in want]


def test_coalesces_concurrent_queries(built_index):
    with BatchedSearcher(built_index, max_batch=8, max_wait_ms=200.0, **CPU) as bs:
        bs.search(QUERIES[0], **KW)
        results = {}

        def worker(q):
            results[q] = bs.search(q, timeout=120, **KW)

        threads = [threading.Thread(target=worker, args=(q,)) for q in QUERIES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        batches, n_q = bs.batches_run, bs.queries_run
    assert n_q == len(QUERIES) + 1
    assert batches <= 4, f"expected coalescing, got {batches} batches"
    direct = LeannSearcher(built_index, device="cpu")
    for q in QUERIES:
        assert [r.id for r in results[q]] == [r.id for r in direct.search(q, **KW)]


def test_param_changes_do_not_mix(built_index):
    with BatchedSearcher(built_index, max_batch=8, max_wait_ms=50.0, **CPU) as bs:
        f1 = bs.submit("solar system", top_k=1, complexity=8, beam_width=2)
        f2 = bs.submit("solar system", top_k=3, complexity=8, beam_width=2)
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    assert len(r1) == 1
    assert len(r2) == 3


def test_error_propagates(built_index):
    with BatchedSearcher(built_index, max_batch=4, max_wait_ms=1.0, **CPU) as bs:
        fut = bs.submit("anything", top_k=2, pruning_strategy="not-a-strategy")
        with pytest.raises(Exception):
            fut.result(timeout=120)
        assert len(bs.search("solar system", timeout=120, **KW)) == 2  # the worker goes on


def test_submit_after_close_raises(built_index):
    bs = BatchedSearcher(built_index, max_batch=2, max_wait_ms=1.0, **CPU)
    bs.close()
    assert not bs._worker.is_alive()
    with pytest.raises(RuntimeError):
        bs.submit("x", top_k=1)


def test_accepts_existing_searcher(built_index):
    s = LeannSearcher(built_index, device="cpu")
    with BatchedSearcher(s, max_batch=2, max_wait_ms=1.0) as bs:
        out = bs.search("mitochondria", top_k=1, complexity=8, beam_width=2)
    assert len(out) == 1
    assert s.search("mitochondria", top_k=1, complexity=8, beam_width=2)  # not owned: still usable


def test_labels_equal_jax_batcher(built_index):
    """The JAX package's BatchedSearcher over the port's index gives the same
    labels for the same concurrent queries."""
    want = {}
    with leann_tpu.BatchedSearcher(built_index, max_batch=8, max_wait_ms=50.0) as bs:
        futs = {q: bs.submit(q, **KW) for q in QUERIES}
        want = {q: [r.id for r in f.result(timeout=120)] for q, f in futs.items()}
    with BatchedSearcher(built_index, max_batch=8, max_wait_ms=50.0, **CPU) as bs:
        futs = {q: bs.submit(q, **KW) for q in QUERIES}
        got = {q: [r.id for r in f.result(timeout=120)] for q, f in futs.items()}
    assert np.mean([got[q] == want[q] for q in QUERIES]) >= 0.875  # own seeded weights on each side
