"""The CUDA kernels of leann_torch against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a machine without JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from leann_torch.ops import knn_panel as kp
from leann_torch.ops import tile_plan
from leann_torch.ops.distance import flat_search, pad_features
from leann_torch.ops.flat_topk import flat_topk
from leann_torch.ops.knn_panel import knn_panel, knn_panel_plain, panel_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    torch.set_float32_matmul_precision("highest")  # the plain versions' products in full f32
    return torch.device("cuda")


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a.tolist(), b.tolist())])


def _flat_inputs(seed, n, d, b, metric):
    rng = np.random.default_rng(seed)
    e = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    if metric == "cosine":
        e, q = e / e.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    return e, q


@pytest.mark.parametrize("b,n", [(1, 5000), (64, 4999), (65, 5000), (130, 4999)])
@pytest.mark.parametrize("d", [33, 384, 400, 784])
@pytest.mark.parametrize("k", [1, 3, 5, 16, 64, 65, 128, 256, 257, 512, 1000])
@pytest.mark.parametrize("metric", ["l2", "mips", "cosine"])
def test_flat_topk_matches_plain(cuda, metric, k, d, b, n):
    e, q = _flat_inputs(3, n, d, b, metric)
    ebf, en = e.to(torch.bfloat16), e.square().sum(1)
    valid_n = n - 100
    # the kernel takes features padded to a multiple of 16; the plain version any width
    ids, dists = flat_topk(pad_features(q).to(cuda), pad_features(ebf).to(cuda), en.to(cuda), valid_n, k, metric)
    pi, pd = flat_topk(q, ebf, en, valid_n, k, metric)  # CPU tensors: the plain version
    assert _overlap(ids.cpu().numpy(), pi.numpy()) >= 0.95
    np.testing.assert_allclose(dists.cpu().numpy(), pd.numpy(), rtol=1e-2, atol=1e-2)
    assert (ids.cpu().numpy() < valid_n).all() and (ids.cpu().numpy() >= 0).all()


def test_flat_topk_fills_past_valid_rows(cuda):
    e, q = _flat_inputs(4, 300, 48, 5, "l2")
    ebf = e.to(torch.bfloat16).to(cuda)
    ids, dists = flat_topk(q.to(cuda), ebf, e.square().sum(1).to(cuda), 10, 16, "l2")
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    assert (ids[:, :10] >= 0).all() and (ids[:, 10:] == -1).all()
    assert np.allclose(dists[:, 10:], 3.4e38)


# n_real = N is the build's own call: the last tile (rows 2944 .. 3071) runs
# past the corpus and TMA fills it with zeros; n_real = 2900 masks real rows.
# k = 64 is the diskann build's list, 128 the HNSW build's (shared-memory
# lists), 512 the HNSW build's at M = 64, efConstruction = 512 (lists in
# device memory)
@pytest.mark.parametrize("n_real", [2900, 3000])
@pytest.mark.parametrize("grid", ["split", "unsplit"])
@pytest.mark.parametrize("q_count", [1, 129, 1000])
@pytest.mark.parametrize("d", [384, 385, 784])
@pytest.mark.parametrize("k", [64, 65, 128, 256, 257, 512, 1000])
def test_knn_panel_matches_plain(cuda, monkeypatch, k, d, q_count, grid, n_real):
    n, q_start = 3000, 100
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal((n, d)).astype(np.float32))
    ebf, norms = panel_inputs(emb.to(cuda))
    if grid == "unsplit":  # as if on a one-SM card: the row blocks alone fill it
        monkeypatch.setattr(kp, "multiprocessors", lambda dev: 1)
    plan = tile_plan.plan_launch(q_count, n_real, k, ebf.shape[1], kp.multiprocessors(cuda))
    assert (plan.col_splits > 1) == (grid == "split")
    ids, dists = knn_panel(ebf, norms, k, q_start=q_start, q_count=q_count, n_real=n_real)
    pi, pd = knn_panel_plain(ebf, norms, k, q_start, q_count, n_real)
    ids = ids.cpu().numpy()
    assert _overlap(ids, pi.cpu().numpy()) >= 0.98
    assert not (ids == (np.arange(q_count) + q_start)[:, None]).any()
    assert ((ids >= 0) & (ids < n_real)).all()
    np.testing.assert_allclose(dists.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-2)


def _assert_lower_twin_first(ids, dists, half, own=None):
    """Rows i and i + half are equal: wherever the upper twin is returned,
    the lower one stands before it (unless the lower one is the query's own
    row, ``own``), and equal distances ascend by id."""
    own = [-1] * len(ids) if own is None else own
    for row_i, row_d, me in zip(ids.tolist(), dists.tolist(), own):
        pos = {x: p for p, x in enumerate(row_i)}
        for p, x in enumerate(row_i):
            if x >= half and x - half != me:
                assert pos.get(x - half, len(row_i)) < p
        for p in range(1, len(row_i)):
            if row_d[p] == row_d[p - 1]:
                assert row_i[p] > row_i[p - 1]


@pytest.mark.parametrize("k", [8, 128, 512])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_flat_topk_ties_go_to_the_lower_id(cuda, metric, k):
    half, d = 2000, 384
    e, q = _flat_inputs(5, half, d, 70, metric)
    e = torch.cat([e, e])  # every corpus row twice: exact ties
    ids, dists = flat_topk(q.to(cuda), e.to(torch.bfloat16).to(cuda), e.square().sum(1).to(cuda), 2 * half, k,
                           metric)
    pi, _ = flat_search(e.to(torch.bfloat16), q, 2 * half, k, metric, en=e.square().sum(1))
    _assert_lower_twin_first(ids.cpu().numpy(), dists.cpu().numpy(), half)
    assert _overlap(ids.cpu().numpy(), pi.numpy()) >= 0.95


@pytest.mark.parametrize("k", [16, 128, 512])
def test_knn_panel_ties_go_to_the_lower_id(cuda, k):
    half = 1500
    emb = torch.from_numpy(np.random.default_rng(9).standard_normal((half, 384)).astype(np.float32))
    ebf, norms = panel_inputs(torch.cat([emb, emb]).to(cuda))
    ids, dists = knn_panel(ebf, norms, k, q_start=0, q_count=2 * half)
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    _assert_lower_twin_first(ids, dists, half, own=list(range(2 * half)))
    # the twin is at distance ~0 and comes first; the self row never appears
    assert (ids[:half, 0] == np.arange(half) + half).all() and (ids[half:, 0] == np.arange(half)).all()


@pytest.mark.parametrize("k_flat,k_knn", [(3, 64), (128, 128), (512, 512)])
def test_kernels_are_deterministic(cuda, k_flat, k_knn):
    e, q = _flat_inputs(6, 20000, 384, 64, "cosine")
    ebf = e.to(torch.bfloat16).to(cuda)
    qc = q.to(cuda)
    a = flat_topk(qc, ebf, None, 20000, k_flat, "cosine")
    b = flat_topk(qc, ebf, None, 20000, k_flat, "cosine")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    eb, norms = panel_inputs(e.to(cuda))
    a = knn_panel(eb, norms, k_knn)
    b = knn_panel(eb, norms, k_knn)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    e = torch.randn(100, 32, device=cuda)
    q = torch.randn(4, 32, device=cuda)
    with pytest.raises(TypeError):
        flat_topk(q, e, e.square().sum(1), 100, 3, "l2")  # corpus must be bf16
    with pytest.raises(ValueError):
        flat_topk(q, e.bfloat16(), e.square().sum(1), 100, 0, "l2")  # an empty list
    with pytest.raises(ValueError):
        flat_topk(q.cpu(), e.bfloat16(), e.square().sum(1), 100, 3, "l2")  # mixed devices
    with pytest.raises(ValueError):
        flat_topk(q[:, :31].contiguous(), e[:, :31].bfloat16().contiguous(), None, 100, 3, "mips")  # D % 16
    with pytest.raises(ValueError):
        knn_panel(e[:, :31].bfloat16().contiguous(), e.square().sum(1), 8)  # unpadded D
    ebf, norms = panel_inputs(e)
    with pytest.raises(ValueError):
        knn_panel(ebf, norms, 0)
    with pytest.raises(ValueError):
        kp.knn_panel_ext(ebf[:4], norms[:4], ebf, norms, 8, col_id0=-1)
    with pytest.raises(TypeError):
        kp.topk_merge(torch.zeros(4, 2, 8, device=cuda), torch.zeros(4, 2, 8, device=cuda))  # ids must be int32
    with pytest.raises(ValueError):
        knn_panel(ebf, norms, 8, q_start=90, q_count=20)


# The column-sharded k-NN's entry: query rows uploaded apart from the slab or
# sliced from it, a slab whose column 0 is corpus row col_id0, global ids
# out, the query's own row excluded wherever it falls in the slab
@pytest.mark.parametrize("grid", ["split", "unsplit"])
@pytest.mark.parametrize("k", [16, 64, 128, 257, 512])
@pytest.mark.parametrize("layout", ["uploaded", "in_slab", "no_self"])
def test_knn_panel_ext_matches_plain(cuda, monkeypatch, layout, k, grid):
    n, d, col_id0, m = 4000, 384, 1024, 2500
    emb = torch.from_numpy(np.random.default_rng(11).standard_normal((n, d)).astype(np.float32))
    ebf, norms = panel_inputs(emb.to(cuda))
    c, cn = ebf[col_id0 : col_id0 + m], norms[col_id0 : col_id0 + m]
    # uploaded: rows 900 .. 1599, the upper ones inside the slab
    qs = 900 if layout == "uploaded" else 2000
    q_id0 = -1 if layout == "no_self" else qs
    q = ebf[qs : qs + 700].clone() if layout == "uploaded" else c[qs - col_id0 : qs - col_id0 + 700]
    qn = norms[qs : qs + 700].clone()
    if grid == "unsplit":
        monkeypatch.setattr(kp, "multiprocessors", lambda dev: 1)
    ids, dists = kp.knn_panel_ext(q, qn, c, cn, k, m - 37, col_id0, q_id0)
    pi, pd = kp.knn_panel_ext_plain(q, qn, c, cn, k, m - 37, col_id0, q_id0)
    ids = ids.cpu().numpy()
    assert _overlap(ids, pi.cpu().numpy()) >= 0.98
    assert ((ids >= col_id0) & (ids < col_id0 + m - 37)).all()
    if q_id0 >= 0:
        assert not (ids == (np.arange(700) + q_id0)[:, None]).any()
    else:  # no exclusion: a row of the slab finds itself first
        assert (ids[:, 0] == np.arange(700) + qs).all()
    np.testing.assert_allclose(dists.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("k", [3, 16, 64, 65, 256, 257, 512])
def test_running_state_merge_matches_plain(cuda, k):
    """topk_merge over [S, 2, k] (the sharded k-NN's running state and a new
    shard's lists) against its plain version: identical ids and values,
    exact ties to the lower id, empty (-1) entries last; twice the same."""
    rng = np.random.default_rng(k)
    s = 700
    vals = np.sort(rng.integers(0, 50, (s, 2, k)).astype(np.float32), axis=2)  # many exact ties
    ids = rng.permutation(s * 2 * k).reshape(s, 2, k).astype(np.int32)
    vals[:200, 0, k // 3 :] = 3.4e38
    ids[:200, 0, k // 3 :] = -1
    # each list sorted by (value, id), as the kernels write them
    order = np.lexsort((ids, vals), axis=2)
    vals, ids = np.take_along_axis(vals, order, 2), np.take_along_axis(ids, order, 2)
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    got_i, got_d = kp.topk_merge(v, i)
    want_i, want_d = kp.topk_merge_plain(v.cpu(), i.cpu())
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_d.cpu(), want_d)
    again = kp.topk_merge(v, i)
    assert torch.equal(again[0], got_i) and torch.equal(again[1], got_d)


def test_update_index_on_the_card_matches_the_cpu(cuda, tmp_path):
    """update_index of a small hnsw index on the card against the same
    update with device="cpu": the graph rows agree as sets, and searches of
    both updated indexes give the same labels."""
    import json
    import shutil

    from leann_torch import LeannBuilder, LeannSearcher

    rng = np.random.default_rng(9)
    vocab = [f"w{i}" for i in range(300)]

    def texts(n, tag):
        return [f"{tag}{i} " + " ".join(rng.choice(vocab, 14)) for i in range(n)]

    base, new = texts(600, "base"), texts(48, "new")
    src = tmp_path / "src"
    b = LeannBuilder(embedding_model="hash-tiny", max_length=32, M=8, device="cuda")
    for t in base:
        b.add_text(t)
    b.build_index(str(src / "x.leann"))
    prefixes = {}
    for dev in ("cuda", "cpu"):
        shutil.copytree(src, tmp_path / dev)
        prefix = str(tmp_path / dev / "x.leann")
        meta = json.load(open(prefix + ".meta.json"))
        meta["passage_sources"][0].update(path=prefix + ".passages.jsonl", index_path=prefix + ".passages.idx")
        json.dump(meta, open(prefix + ".meta.json", "w"))
        u = LeannBuilder.from_index(prefix, device=dev)
        for t in new:
            u.add_text(t)
        u.update_index(prefix, insert_batch_size=24)
        prefixes[dev] = prefix
    from leann_torch.storage import unpack_neighbors

    rows = [unpack_neighbors(np.load(prefixes[d] + ".hnsw.npz")).tolist() for d in ("cuda", "cpu")]
    assert len(rows[0]) == len(rows[1]) == 648
    assert np.mean([set(a) == set(c) for a, c in zip(*rows)]) >= 0.95
    queries = [" ".join(t.split()[:8]) for t in new[:8] + base[:8]]
    labels = [[[r.id for r in row] for row in LeannSearcher(prefixes[d], device="cuda").search(
        queries, top_k=3, complexity=32, beam_width=4)] for d in ("cuda", "cpu")]
    assert labels[0] == labels[1]
