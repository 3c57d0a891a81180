"""leann_torch's recompute traversal in a batch (CPU): each lane of a batch
freezes on its own, so a query gets in a batch what it gets alone, for each
prune strategy. Its cases are the slowest of the hnsw parity tests, so they
sit in a file of their own, which ``--dist loadfile`` gives a worker of its
own; the fixture is test_torch_hnsw.py's."""

import sys
from pathlib import Path

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


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batch_lanes_freeze_independently_under_recompute(built, strategy):
    """A converged lane changes nothing while the others run on: a batch
    gives each query the labels, distances, steps and n_exact it gets alone
    (the proportional budget is per lane)."""
    from leann_torch.backends.hnsw.backend import HnswSearcher
    from leann_torch.ops.beam_search import beam_search_batch

    prefix, _, queries = built
    ts = HnswSearcher(prefix, device="cpu")
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
