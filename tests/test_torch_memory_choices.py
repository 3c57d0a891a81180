"""The build's memory-dependent choices read the card's total memory, never
its free memory (CPU). ``device.card_memory`` is the port's one memory
query; here it is patched to describe a card, so each choice runs as on an
80 GiB card with other processes holding all but a sliver of it. The
choices return what they return on a free card; where a chosen mode lacks
the room, ``device.require_room`` raises with the free and total bytes and
what selects the other mode. The chunk sizes follow the card's free
memory (``_device_budget``, ``descent_budget(free=True)``): they give
bit-equal lists under other budgets."""

import pathlib

import numpy as np
import pytest
import torch

from leann_torch import device as tdev
from leann_torch.backends.diskann.backend import DiskannSearcher
from leann_torch.ops import graph as tg

REPO = pathlib.Path(__file__).resolve().parent.parent
CUDA = torch.device("cuda")  # never reached: the one memory query is patched
GIB = 1 << 30
FREE_CARD = (80 * GIB, 80 * GIB)
FULL_CARD = (4 << 20, 80 * GIB)  # 4 MiB free: other processes hold the rest
N, D = 1_000, 384  # small enough that each mode's room fits in 4 MiB


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _card(monkeypatch, free, total):
    monkeypatch.setattr(tdev, "card_memory", lambda dev: (free, total))


def _choices(n=N):
    """Every mode of the build and the searcher that the card's memory
    chooses, at a corpus of ``n`` rows."""
    return {"exact_knn_max_n": tg.exact_knn_max_n(D, 64, CUDA),
            "prune_ebf_max_bytes": tg.prune_ebf_max_bytes(CUDA),
            "prune_on_pq": tg.prune_on_pq(n, D, CUDA),
            "medoid_on_host": tg.medoid_on_host(n, D, CUDA),
            "descent_budget": tg.descent_budget(CUDA),
            "tokens_on_host": DiskannSearcher.tokens_on_host(n, 128, CUDA)}


def _chunk_sizes():
    """The sizes that follow what is free: a pass's bytes, spill's rows an
    upload, descent's bytes for its draws and host-resident rounds."""
    return {"device_budget": tg._device_budget(CUDA), "spill_chunk_rows": tg._chunk_rows(D, 64, 2048, CUDA),
            "descent_chunks": tg.descent_budget(CUDA, free=True)}


def test_every_choice_ignores_what_other_processes_hold(monkeypatch):
    monkeypatch.delenv("LEANN_PRUNE_EBF_MAX_BYTES", raising=False)
    monkeypatch.delenv("LEANN_DESCENT_HBM_BUDGET", raising=False)
    _card(monkeypatch, *FREE_CARD)
    free = _choices()
    _card(monkeypatch, *FULL_CARD)
    assert _choices() == free
    assert free == {"exact_knn_max_n": 40 * GIB // (2 * D + 4 + 8 * 64), "prune_ebf_max_bytes": 40 * GIB,
                    "prune_on_pq": False, "medoid_on_host": False, "descent_budget": float(40 * GIB),
                    "tokens_on_host": False}


def test_the_chunk_sizes_follow_what_is_free(monkeypatch):
    """The chunks shrink beside other processes instead of running out of
    memory; the lists stay the same (the spill and descent tests below)."""
    monkeypatch.delenv("LEANN_DESCENT_HBM_BUDGET", raising=False)
    _card(monkeypatch, *FREE_CARD)
    assert _chunk_sizes() == {"device_budget": 20 * GIB,
                              "spill_chunk_rows": 20 * GIB // (6 * D + 16 * 64 + 16) // 2048 * 2048,
                              "descent_chunks": float(40 * GIB)}
    _card(monkeypatch, *FULL_CARD)
    assert _chunk_sizes() == {"device_budget": FULL_CARD[0] // 4, "spill_chunk_rows": 2048,
                              "descent_chunks": float(FULL_CARD[0] // 2)}


def test_the_total_moves_the_choices(monkeypatch):
    """A card of 1 GiB takes the modes past the card where 80 GiB does not."""
    monkeypatch.delenv("LEANN_PRUNE_EBF_MAX_BYTES", raising=False)
    monkeypatch.delenv("LEANN_DESCENT_HBM_BUDGET", raising=False)
    n = 1_000_000  # 768 MB of bf16 rows, 3 GB of f32 rows and their centred copy, 512 MB of tokens
    _card(monkeypatch, 80 * GIB, 80 * GIB)
    big = _choices(n)
    _card(monkeypatch, 1 * GIB, 1 * GIB)
    small = _choices(n)
    assert small["exact_knn_max_n"] == GIB // 2 // (2 * D + 4 + 8 * 64) < big["exact_knn_max_n"]
    assert small["prune_ebf_max_bytes"] == GIB // 2 and small["descent_budget"] == GIB // 2
    assert (big["prune_on_pq"], small["prune_on_pq"]) == (False, True)
    assert (big["medoid_on_host"], small["medoid_on_host"]) == (False, True)
    assert (big["tokens_on_host"], small["tokens_on_host"]) == (False, True)


def test_the_overrides_still_hold(monkeypatch):
    _card(monkeypatch, *FULL_CARD)
    monkeypatch.setenv("LEANN_PRUNE_EBF_MAX_BYTES", "1")
    monkeypatch.setenv("LEANN_DESCENT_HBM_BUDGET", "12345")
    assert tg.prune_ebf_max_bytes(CUDA) == 1 and tg.prune_on_pq(N, D, CUDA)
    assert tg.descent_budget(CUDA) == tg.descent_budget(CUDA, free=True) == 12345.0


@pytest.mark.parametrize("mode,other", [
    ("prune", "LEANN_PRUNE_EBF_MAX_BYTES"),
    ("medoid", "host=True"),
    ("tokens", 'token_residency="host"'),
])
def test_a_mode_without_room_fails_loudly(monkeypatch, mode, other):
    """The mode the card's total chose stays chosen; a card whose free bytes
    cannot hold it raises, naming the free and total bytes and what selects
    the other mode."""
    monkeypatch.delenv("LEANN_PRUNE_EBF_MAX_BYTES", raising=False)
    _card(monkeypatch, *FULL_CARD)
    n = 100_000
    call = {"prune": lambda: tg.prune_on_pq(n, D, CUDA), "medoid": lambda: tg.medoid_on_host(n, D, CUDA),
            "tokens": lambda: DiskannSearcher.tokens_on_host(n, 128, CUDA)}[mode]
    with pytest.raises(RuntimeError) as e:
        call()
    msg = str(e.value)
    assert other in msg and f"{FULL_CARD[0]:,} free of {FULL_CARD[1]:,}" in msg
    _card(monkeypatch, *FREE_CARD)
    assert call() is False


@pytest.mark.parametrize("override", ["LEANN_DESCENT_HBM_BUDGET=1", "LEANN_KNN_MODE=spill"])
def test_descent_without_room_fails_loudly(monkeypatch, override):
    """NN-descent's state on the card, and in host RAM its matrix and lists
    on the card: without the room either raises before it allocates,
    naming what selects the mode that takes less."""
    monkeypatch.setattr(tg, "resolve_device", lambda device: CUDA)
    _card(monkeypatch, 64 << 10, 80 * GIB)
    if override == "LEANN_KNN_MODE=spill":
        monkeypatch.setenv("LEANN_DESCENT_HBM_BUDGET", "1")
    else:
        monkeypatch.delenv("LEANN_DESCENT_HBM_BUDGET", raising=False)
    with pytest.raises(RuntimeError, match=override) as e:
        tg.nn_descent(_clustered(2_000, 16, 2), k=16, n_iters=1, block=64, device="cuda")
    assert f"{64 << 10:,} free of {80 * GIB:,}" in str(e.value)


@pytest.mark.parametrize("k", [64, 128, 512])
def test_the_exact_pass_counts_what_it_allocates(monkeypatch, k):
    """The room the exact pass checks: every row's share as its cap counts
    it, and one launch's partial lists and scratch, which above k = 64
    hold a buffered list of every split."""
    monkeypatch.setattr(tg, "multiprocessors", lambda dev: 132)
    n = 300_000
    rows = tg.KNN_ROWS_PER_LAUNCH
    plan = tg.plan_launch(rows, n, k, D, 132)
    need = tg.exact_knn_bytes(n, D, k, CUDA)
    assert need == n * (2 * D + 4 + 8 * k) + 8 * tg.list_entries(plan, rows, k)  # one split at these rows
    assert (need > n * (2 * D + 4 + 8 * k)) == (k > 64)
    _card(monkeypatch, *FREE_CARD)
    assert tg.exact_knn_bytes(tg.exact_knn_max_n(D, k, CUDA), D, k, CUDA) <= 40 * GIB + 8 * rows * 2 * k


def test_require_room_off_the_card_and_with_room(monkeypatch):
    _card(monkeypatch, *FULL_CARD)
    tdev.require_room("cpu", 1 << 40, "anything", "nothing")  # no check off the card
    tdev.require_room(CUDA, FULL_CARD[0], "a fit", "nothing")
    with pytest.raises(RuntimeError, match="OVERRIDE_NAME"):
        tdev.require_room(CUDA, FULL_CARD[0] + 1, "one byte more", "OVERRIDE_NAME")
    with pytest.raises(RuntimeError, match="no variable selects another mode"):
        tdev.require_room(CUDA, FULL_CARD[0] + 1, "one byte more", None)


def test_one_memory_query_in_the_port():
    """Only ``device.card_memory`` asks CUDA for the card's memory."""
    hits = sorted(str(p.relative_to(REPO)) for p in (REPO / "leann_torch").rglob("*.py")
                  if "mem_get_info" in p.read_text(encoding="utf-8"))
    assert hits == ["leann_torch/device.py"]
    assert (REPO / "leann_torch" / "device.py").read_text(encoding="utf-8").count("mem_get_info(") == 1


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32)
    return centers[rng.integers(0, 40, n)] + 0.6 * rng.standard_normal((n, d)).astype(np.float32)


def test_spill_lists_are_the_same_under_any_chunk_budget(monkeypatch):
    """``_device_budget`` sizes spill's chunks of expanded rows (one chunk
    here on the CPU's 1 GiB); chunks of one window give the same bits."""
    emb = _clustered(4_500, 16, 0)
    one = tg.spill_knn_streamed(emb, 16, device="cpu")
    monkeypatch.setattr(tg, "_device_budget", lambda dev: 2048 * (6 * 16 + 16 * 16 + 16))
    assert tg._chunk_rows(16, 16, 2048, torch.device("cpu")) == 2048
    many = tg.spill_knn_streamed(emb, 16, device="cpu")
    assert np.array_equal(one[0], many[0]) and np.array_equal(one[1], many[1])
    explicit = tg.spill_knn_streamed(emb, 16, chunk_rows=4096, device="cpu")
    assert np.array_equal(one[0], explicit[0]) and np.array_equal(one[1], explicit[1])


@pytest.mark.parametrize("budget", ["blocks_per_step", "host_state"])
def test_descent_lists_are_the_same_under_any_budget(monkeypatch, budget):
    """NN-descent under the CPU's budgets (every block in one step, its
    state on the device) against one block a step (``_device_budget``) and
    against host-resident state drawn and dispatched one block at a time
    (``LEANN_DESCENT_HBM_BUDGET=1``): the same lists, bit for bit."""
    monkeypatch.delenv("LEANN_DESCENT_HBM_BUDGET", raising=False)
    emb = _clustered(2_000, 16, 1)
    kw = dict(k=16, n_iters=3, block=64, device="cpu")
    seen = []
    real = tg._nn_descent_iter

    def counting(*a, **k):
        out = real(*a, **k)
        seen.append(out[0].shape[0])
        return out

    def drawing(*a, **k):  # one draw of random escapes a step of blocks
        steps.append(len(a[0]))
        return real_draw(*a, **k)

    steps, real_draw = [], tg.seeded.randint_many
    monkeypatch.setattr(tg, "_nn_descent_iter", counting)
    monkeypatch.setattr(tg.seeded, "randint_many", drawing)
    want = tg.nn_descent(emb, **kw)
    assert seen == [2_048] * 3 and steps == [32] * 3  # all 32 blocks a round, in one dispatch and one step
    seen.clear()
    steps.clear()
    if budget == "blocks_per_step":
        monkeypatch.setattr(tg, "_device_budget", lambda dev: 2 * 64 * (2 * 16 + 4 * 16 * 16 + 4) * 16 * 2)
    else:
        monkeypatch.setenv("LEANN_DESCENT_HBM_BUDGET", "1")
    got = tg.nn_descent(emb, **kw)
    assert seen == ([2_048] * 3 if budget == "blocks_per_step" else [64] * 96) and steps == [1] * 96
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])


def test_the_medoids_two_branches_agree():
    """compute_medoid on the device (f32 mean) and its host pass (f64 mean,
    blocks of rows) pick the same row."""
    for seed in range(3):
        emb = _clustered(5_000, 64, seed)
        assert tg.compute_medoid(emb, "cpu") == tg.compute_medoid(emb, "cpu", host=True)
