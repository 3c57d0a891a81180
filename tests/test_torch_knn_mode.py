"""LEANN_KNN_MODE in leann_torch's build_graph (CPU). Past the card's
memory the JAX package reads it (``leann_tpu/ops/graph.py`` build_graph):
"spill" and "descent" select its approximate k-NN, which the port does not
have, so the port refuses them by name; any other value, or none, runs the
exact pass in both packages, and the two build the same graph. Below the
card neither package reads it. The card's cap is lowered in both packages
by monkeypatching (``exact_knn_max_n``, ``EXACT_KNN_MAX_N``), as the
build-resume tests do."""

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
    one, sharded = tg.exact_knn, tg.exact_knn_sharded

    def record(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, np.asarray(out[0])))
            return out
        return run

    monkeypatch.setattr(tg, "exact_knn", record("exact_knn", one))
    monkeypatch.setattr(tg, "exact_knn_sharded", record("exact_knn_sharded", sharded))
    return calls


def _past_the_card(monkeypatch):
    monkeypatch.setattr(tg, "exact_knn_max_n", lambda d, k, device: N // 3)
    monkeypatch.setattr(jg, "EXACT_KNN_MAX_N", N // 3)


@pytest.mark.parametrize("mode", ["spill", "descent"])
def test_approximate_modes_past_the_card_are_refused(monkeypatch, emb, knn_calls, mode):
    _past_the_card(monkeypatch)
    monkeypatch.setenv("LEANN_KNN_MODE", mode)
    with pytest.raises(NotImplementedError, match=rf"LEANN_KNN_MODE={mode}.*not ported.*ROADMAP\.md §A #6"):
        tg.build_graph(emb, r=R, device="cpu")
    assert knn_calls == []  # refused before any k-NN work


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
