"""LEANN_KNN_MODE in leann_torch's build_graph (CPU). Past the card's
memory both packages read it (``leann_tpu/ops/graph.py`` build_graph):
"spill" and "descent" select the approximate k-NN (spill_knn_streamed,
nn_descent), whose lists the port's build takes as the JAX package's
function gives them; any other value, or none, runs the exact pass in both
packages, and the two build the same graph. Below the card neither package
reads it. The card's cap is lowered in both packages by monkeypatching
(``exact_knn_max_n``, ``EXACT_KNN_MAX_N``), as the build-resume tests do.
``tests/test_torch_approx_knn.py`` holds the approximate passes themselves."""

import numpy as np
import pytest
import torch

from leann_torch.ops import graph as tg
from leann_tpu.ops import graph as jg

N, D, R = 300, 16, 8  # C = 2 R = 16 candidates a row


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def emb():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((6, D)).astype(np.float32) * 3
    return centers[rng.integers(0, 6, N)] + rng.standard_normal((N, D)).astype(np.float32)


@pytest.fixture()
def knn_calls(monkeypatch):
    """Which k-NN pass build_graph ran, with its candidate ids."""
    calls = []

    def record(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, np.asarray(out[0])))
            return out
        return run

    for name in ("exact_knn", "exact_knn_sharded", "spill_knn_streamed", "nn_descent"):
        monkeypatch.setattr(tg, name, record(name, getattr(tg, name)))
    return calls


def _past_the_card(monkeypatch):
    monkeypatch.setattr(tg, "exact_knn_max_n", lambda d, k, device: N // 3)
    monkeypatch.setattr(jg, "EXACT_KNN_MAX_N", N // 3)


@pytest.mark.parametrize("mode", ["spill", "descent"])
def test_approximate_modes_past_the_card_are_refused(monkeypatch, emb, knn_calls, mode):
    """No longer refused: each mode runs its approximate pass (and no exact
    one), whose lists are the JAX package's function's on the same rows."""
    _past_the_card(monkeypatch)
    monkeypatch.setenv("LEANN_KNN_MODE", mode)
    graph, medoid = tg.build_graph(emb, r=R, device="cpu")
    name = {"spill": "spill_knn_streamed", "descent": "nn_descent"}[mode]
    assert [n for n, _ in knn_calls] == [name]
    # chunks of one window: the JAX package pads each chunk to chunk_rows
    want = (jg.spill_knn_streamed(emb, 2 * R, chunk_rows=2048) if mode == "spill" else jg.nn_descent(emb, 2 * R))[0]
    got = knn_calls[0][1]
    assert np.mean([len(set(a) & set(b)) / len(set(b)) for a, b in zip(got.tolist(), want.tolist())]) >= 0.99
    assert graph.shape == (N, R) and ((graph >= -1) & (graph < N)).all() and 0 <= medoid < N


@pytest.mark.parametrize("mode", [None, "exact", "bogus"])
def test_other_values_past_the_card_build_the_exact_lists(monkeypatch, emb, knn_calls, mode):
    _past_the_card(monkeypatch)
    if mode is None:
        monkeypatch.delenv("LEANN_KNN_MODE", raising=False)
    else:
        monkeypatch.setenv("LEANN_KNN_MODE", mode)
    graph, medoid = tg.build_graph(emb, r=R, device="cpu")
    assert [name for name, _ in knn_calls] == ["exact_knn_sharded"]
    exact, _ = tg.exact_knn(emb, 2 * R, device="cpu")  # the one-pass lists: the exact ones
    np.testing.assert_array_equal(knn_calls[0][1], np.asarray(exact))
    want, want_medoid = jg.build_graph(emb, r=R)  # the JAX package, under the same variable and cap
    np.testing.assert_array_equal(graph, np.asarray(want))
    assert medoid == want_medoid
    monkeypatch.delenv("LEANN_KNN_MODE", raising=False)
    again, medoid_again = tg.build_graph(emb, r=R, device="cpu")
    np.testing.assert_array_equal(graph, again)
    assert medoid == medoid_again


@pytest.mark.parametrize("mode", ["spill", "descent", "bogus"])
def test_below_the_card_the_variable_is_not_read(monkeypatch, emb, knn_calls, mode):
    monkeypatch.delenv("LEANN_KNN_MODE", raising=False)
    want, _ = tg.build_graph(emb, r=R, device="cpu")
    monkeypatch.setenv("LEANN_KNN_MODE", mode)
    got, _ = tg.build_graph(emb, r=R, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert [name for name, _ in knn_calls] == ["exact_knn", "exact_knn"]
