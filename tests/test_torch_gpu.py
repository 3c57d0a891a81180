"""The CUDA kernels of leann_torch against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a machine without JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

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
@pytest.mark.parametrize("k", [1, 3, 5, 16, 64, 65, 96, 128, 200, 256, 257, 512, 1000])
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
# k = 64 is the diskann build's list (registers), 128 the HNSW build's
# (buffered), 512 the HNSW build's at M = 64, efConstruction = 512 (buffered,
# folded through memory)
@pytest.mark.parametrize("n_real", [2900, 3000])
@pytest.mark.parametrize("grid", ["split", "unsplit"])
@pytest.mark.parametrize("q_count", [1, 129, 1000])
@pytest.mark.parametrize("d", [384, 385, 784])
@pytest.mark.parametrize("k", [64, 65, 96, 128, 200, 256, 257, 512, 1000])
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


@pytest.mark.parametrize("k", [8, 96, 128, 200, 257, 512])
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


@pytest.mark.parametrize("k", [16, 96, 128, 200, 257, 512])
def test_knn_panel_ties_go_to_the_lower_id(cuda, k):
    half = 1500
    emb = torch.from_numpy(np.random.default_rng(9).standard_normal((half, 384)).astype(np.float32))
    ebf, norms = panel_inputs(torch.cat([emb, emb]).to(cuda))
    ids, dists = knn_panel(ebf, norms, k, q_start=0, q_count=2 * half)
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    _assert_lower_twin_first(ids, dists, half, own=list(range(2 * half)))
    # the twin is at distance ~0 and comes first; the self row never appears
    assert (ids[:half, 0] == np.arange(half) + half).all() and (ids[half:, 0] == np.arange(half)).all()


@pytest.mark.parametrize("k_flat,k_knn", [(3, 64), (128, 128), (200, 96), (257, 200), (512, 512)])
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


@pytest.mark.parametrize("k", [3, 16, 64, 65, 128, 256, 257, 512, 513])
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


# Above k = 64 every row buffers the survivors of its bar and folds the
# buffer into a sorted list of k2 entries (topk_common.cuh BufRows); the
# merges fold the splits' lists the same way.
WIDE_K = [65, 96, 128, 200, 256, 257, 512]


def _ladder(n, d=384):
    """Integer rows (exact in bf16) whose entries sum to the row index and
    never fall along the rows: for positive query weights each row scores
    above every row before it, and the l2 distance from a later row falls
    row by row up to it, so every column beats the bar. Distances are exact
    integers in f32."""
    i, j = np.arange(n)[:, None], np.arange(d)[None, :]
    return torch.from_numpy(np.clip(i - 255 * j, 0, 255).astype(np.float32))


@pytest.mark.parametrize("grid", ["split", "unsplit"])
@pytest.mark.parametrize("k", WIDE_K)
def test_every_column_beats_the_bar(cuda, monkeypatch, k, grid):
    """Both kernels where every column beats every column before it for the
    rows taken: each tile fills the buffers and forces folds; ids and
    distances equal the plain versions' exactly."""
    if grid == "unsplit":
        monkeypatch.setattr(kp, "multiprocessors", lambda dev: 1)
        monkeypatch.setattr("leann_torch.ops.flat_topk.multiprocessors", lambda dev: 1)
    ebf, norms = panel_inputs(_ladder(6000).to(cuda))
    args = (ebf, norms, k, 6000 - 300, 300, 6000)
    got, want = knn_panel(*args), knn_panel_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    e = _ladder(20000).to(torch.bfloat16).to(cuda)
    q = torch.ones((70, 384), device=cuda)
    q[:, 0] = torch.arange(70, device=cuda, dtype=torch.float32) % 4 + 1
    got, want = flat_topk(q, e, None, 20000, k, "mips"), flat_search(e, q, 20000, k, "mips")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [65, 128, 257, 512])
def test_fewer_columns_than_k_keep_empty_slots(cuda, k):
    """n_cols < k: the lists keep empty slots (-1, 3.4e38) after the
    candidates, as the plain versions do."""
    emb = torch.from_numpy(np.random.default_rng(13).standard_normal((400, 384)).astype(np.float32))
    ebf, norms = panel_inputs(emb.to(cuda))
    ids, dists = knn_panel(ebf, norms, k, q_start=0, q_count=200, n_real=60)
    pi, pd = knn_panel_plain(ebf, norms, k, 0, 200, 60)
    # every candidate is in every list: the same sets, in distance order
    assert torch.equal(torch.sort(ids, 1).values.cpu(), torch.sort(pi, 1).values.cpu())
    np.testing.assert_allclose(dists.cpu().numpy(), pd.cpu().numpy(), rtol=1e-4, atol=1e-2)
    # rows 0 .. 59 are real columns and skip themselves: 59 candidates; the others 60
    assert (ids[:60, :59] >= 0).all() and (ids[:60, 59:] == -1).all()
    assert (ids[60:, :60] >= 0).all() and (ids[60:, 60:] == -1).all()
    e, q = _flat_inputs(14, 400, 384, 9, "l2")
    ids, dists = flat_topk(q.to(cuda), e.to(torch.bfloat16).to(cuda), e.square().sum(1).to(cuda), 50, k, "l2")
    assert (ids[:, :50] >= 0).all() and (ids[:, 50:] == -1).all() and (dists[:, 50:] == 3.4e38).all()


@pytest.mark.parametrize("k", [65, 128, 513, 3000])
@pytest.mark.parametrize("lists", [3, 40, 132])
def test_merge_of_many_lists_matches_plain(cuda, k, lists):
    """topk_merge over as many lists as the flat search's column splits
    (several warps a row, folded into each other), identical to the plain
    version; k = 3000 keeps the warps' lists in device memory."""
    rng = np.random.default_rng(k + lists)
    s = 40 if k > 600 else 300
    vals = np.sort(rng.standard_normal((s, lists, k)).astype(np.float32), axis=2)
    ids = rng.permutation(s * lists * k).reshape(s, lists, k).astype(np.int32)
    vals[: s // 3, :, k // 2 :] = 3.4e38
    ids[: s // 3, :, k // 2 :] = -1
    order = np.lexsort((ids, vals), axis=2)
    vals, ids = np.take_along_axis(vals, order, 2), np.take_along_axis(ids, order, 2)
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    got_i, got_d = kp.topk_merge(v, i)
    want_i, want_d = kp.topk_merge_plain(v.cpu(), i.cpu())
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_d.cpu(), want_d)


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


def _minilm_checkpoint(path):
    """A full-width all-MiniLM-L6-v2-shaped checkpoint (seeded weights, the
    port's own writer) with an uncased WordPiece vocab.txt of 30,522 lines."""
    import json
    import os
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te

    cfg = replace(te.MODEL_REGISTRY["hash-minilm"], name="minilm-l6-seeded", vocab_size=30522, n_heads=12,
                  max_len=512, arch="bert")
    te.save_hf_weights(te.init_params(cfg), cfg, path)
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + ["##" + c for c in chars] + [
        "the", "run", "##ning", "cat", "!"]
    vocab += [f"[unused{i}]" for i in range(30522 - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer"}, f)
    return path, vocab


def test_full_width_checkpoint_encodes_on_cuda_as_on_cpu(cuda, tmp_path):
    """The port's saved full-width checkpoint loads and encodes on the card
    within the bf16 tolerance of tests/test_torch_encoder.py of the CPU."""
    from leann_torch.embeddings.encoder import TorchEncoder

    path, _ = _minilm_checkpoint(str(tmp_path / "minilm"))
    texts = [f"the cat {i} running w{i} cats{i % 7}!" for i in range(40)]
    encs = {d: TorchEncoder(path, max_length=128, device=d) for d in ("cuda", "cpu")}
    for enc in encs.values():
        assert enc.loaded_hf and enc.cfg.n_heads == 12 and enc.cfg.vocab_size == 30522
        assert type(enc.tokenizer).__name__ == "HFTokenizer"
    got, want = encs["cuda"].encode(texts), encs["cpu"].encode(texts)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_wordpiece_without_transformers(tmp_path, monkeypatch):
    """The port's WordPiece needs no transformers (the card's machine has
    none; here its import is blocked): known pieces of a known
    vocabulary."""
    import builtins
    import sys

    from leann_torch.embeddings import tokenizer as tt

    real_import = builtins.__import__

    def guarded(name, *a, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("transformers is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] == "transformers"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", guarded)
    path, vocab = _minilm_checkpoint(str(tmp_path / "minilm"))
    tok = tt.get_tokenizer(path, vocab_size=30522, max_length=12)
    assert isinstance(tok, tt.HFTokenizer)
    ids, mask = tok.encode_batch(["The running CATS! zz9"])
    want = ["[CLS]", "the", "run", "##ning", "cat", "##s", "!", "z", "##z", "##9", "[SEP]", "[PAD]"]
    assert ids[0].tolist() == [vocab.index(t) for t in want]
    assert mask[0].tolist() == [1] * 11 + [0]


def test_native_libraries_build_and_match(tmp_path):
    """The host libraries build with this machine's compiler and give the
    Python paths' answers."""
    import json
    import pickle

    from leann_torch.embeddings.tokenizer import HashTokenizer
    from leann_torch.ops import cuda_build
    from leann_torch.runtime.fast_tokenizer import encode_batch_ascii
    from leann_torch.runtime.passage_store import NativePassageStore

    cuda_build.build(["hash_tokenizer", "passage_store"])
    rng = np.random.default_rng(5)
    texts = [" ".join(f"w{i}" for i in rng.integers(0, 9000, 30)) + " don't STOP, x\x1cy" for _ in range(500)]
    tok = HashTokenizer(vocab_size=30522, max_length=64)
    for a, b in zip(encode_batch_ascii(texts, 64, 30522), tok.encode_batch_python(texts)):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "p.passages.jsonl"
    offsets = {}
    with open(path, "wb") as f:
        for i, t in enumerate(texts):
            offsets[str(i)] = f.tell()
            f.write(json.dumps({"id": str(i), "text": t, "metadata": {}}).encode() + b"\n")
    with open(tmp_path / "p.passages.idx", "wb") as f:
        pickle.dump(offsets, f)
    store = NativePassageStore(str(path))
    assert len(store) == 500 and all(store.get(str(i))["text"] == texts[i] for i in range(500))
    store.close()


def test_split_product_on_the_card_ignores_every_flag(cuda):
    """leann_torch.device.matmul on the card: the same bits under every
    float32 matmul precision and bf16-reduction setting, within 2^-21
    |a| @ |b| of the f64 product, for f32 and bf16 operands, 2-D and
    batched. The bound is twice what the tensor cores' f32 sums reach on
    their own: one bf16 GEMM of exact operands at these shapes came within
    2^-22.2 |a| @ |b| on an H100 (the CPU's IEEE sums are held to 2^-22 in
    tests/test_torch_precision.py)."""
    from leann_torch.device import matmul

    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((384, 1536)).astype(np.float32)).to(cuda)
    cases = [(a, b), (a.to(torch.bfloat16), b), (a.to(torch.bfloat16), b.to(torch.bfloat16)),
             (a.reshape(8, 32, 384), b[:, :256].reshape(384, 8, 32).permute(1, 0, 2))]
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    try:
        for x, y in cases:
            outs = []
            for precision in ("highest", "high", "medium"):
                for reduced in (True, False):
                    torch.set_float32_matmul_precision(precision)
                    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
                    outs.append(matmul(x, y))
            assert all(torch.equal(outs[0], o) for o in outs[1:]), (tuple(x.shape), x.dtype, y.dtype)
            ref = x.double() @ y.double()
            bound = 2.0 ** -21 * (x.double().abs() @ y.double().abs())
            assert bool(((outs[0].double() - ref).abs() <= bound).all()), (tuple(x.shape), x.dtype, y.dtype)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev[1]


@pytest.mark.parametrize("backend", ["diskann", "hnsw"])
def test_search_identical_under_a_callers_high(cuda, tmp_path, backend):
    """A search on the card gives the same labels and distances, bit for
    bit, under a caller's "high" (TF32) and "highest": the port's products
    do not read the flag."""
    from leann_torch import LeannBuilder, LeannSearcher

    rng = np.random.default_rng(11)
    vocab = [f"w{i}" for i in range(300)]
    texts = [f"doc{i} " + " ".join(rng.choice(vocab, 14)) for i in range(800)]
    kw = {"diskann": dict(graph_degree=16, num_partitions=1), "hnsw": dict(M=8)}[backend]
    b = LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, device="cuda", **kw)
    for t in texts:
        b.add_text(t)
    prefix = str(tmp_path / "x.leann")
    b.build_index(prefix)
    queries = [" ".join(t.split()[:8]) for t in texts[:32]]
    s = LeannSearcher(prefix, device="cuda")
    prev = torch.get_float32_matmul_precision()
    out = {}
    try:
        for precision in ("highest", "high", "highest"):
            torch.set_float32_matmul_precision(precision)
            res = s.search(queries, top_k=3, complexity=32, beam_width=4)
            assert torch.get_float32_matmul_precision() == precision
            out.setdefault(precision, []).append([[(r.id, r.score) for r in row] for row in res])
    finally:
        torch.set_float32_matmul_precision(prev)
    assert out["highest"][0] == out["highest"][1] == out["high"][0]


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One ContrastiveTrainer step at all-MiniLM-L6-v2's widths (bert arch,
    bf16 products) on the card against the same step on the CPU: losses
    within 1e-3 and probe embeddings of the stepped encoders at cosine >=
    0.999 (the gather's backward adds in atomic order on the card, so no
    bit-equality is asked)."""
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te
    from leann_torch.parallel.train import ContrastiveTrainer

    cfg = replace(te.MODEL_REGISTRY["hash-minilm"], name="minilm-l6-seeded", vocab_size=30522, n_heads=12,
                  max_len=512, arch="bert")
    tree = te.init_params(cfg)
    rng = np.random.default_rng(3)
    q = rng.integers(0, cfg.vocab_size, (32, 32)).astype(np.int32)
    d = rng.integers(0, cfg.vocab_size, (32, 64)).astype(np.int32)
    qm = (np.arange(32)[None, :] < rng.integers(4, 33, 32)[:, None]).astype(np.int32)
    dm = (np.arange(64)[None, :] < rng.integers(8, 65, 32)[:, None]).astype(np.int32)
    losses, probes = {}, {}
    for dev in ("cuda", "cpu"):
        tr = ContrastiveTrainer(cfg, learning_rate=1e-4, params=tree, device=dev)
        losses[dev] = [tr.train_step(q, qm, d, dm) for _ in range(2)]
        p = te.params_to_torch(tr.params, dev)
        probes[dev] = te.encode_tokens(p, torch.from_numpy(q).to(dev), torch.from_numpy(qm).to(dev),
                                       cfg).cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0, atol=1e-3)
    cos = (probes["cuda"] * probes["cpu"]).sum(1) / (
        np.linalg.norm(probes["cuda"], axis=1) * np.linalg.norm(probes["cpu"], axis=1))
    assert cos.min() >= 0.999


def test_trainer_raises_without_cuda():
    """ContrastiveTrainer's default device is cuda: without a card it raises
    instead of running on the CPU."""
    from leann_torch.embeddings.encoder import MODEL_REGISTRY
    from leann_torch.parallel.train import ContrastiveTrainer

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device="):
        ContrastiveTrainer(MODEL_REGISTRY["hash-tiny"])


def test_cli_runs_on_the_card_by_default(cuda, tmp_path, monkeypatch, capsys):
    """The port's CLI at its default device: `build` then `search` on the
    card print the card searcher's top-5 texts in order, and `ask` the
    simulated LLM's answer over them; the same index searched with --device
    cpu finds mostly the same passages."""
    from leann_torch import LeannSearcher, cli

    monkeypatch.setenv("LEANN_HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(300)]
    (tmp_path / "docs").mkdir()
    for f in range(20):
        sents = [" ".join(rng.choice(words, 12)) + "." for _ in range(12)]
        (tmp_path / "docs" / f"n{f}.txt").write_text("\n\n".join(sents) + "\n")
    tiny = ["--embedding-model", "hash-tiny", "--max-length", "64", "-M", "8", "--complexity", "16",
            "--doc-chunk-size", "24", "--doc-chunk-overlap", "0"]
    assert cli.main(["build", "demo", "--docs", "docs", *tiny]) == 0
    prefix = cli.find_index("demo")
    q = " ".join((tmp_path / "docs" / "n3.txt").read_text().split()[:8])
    capsys.readouterr()
    assert cli.main(["search", "demo", q, "--non-interactive"]) == 0
    out = capsys.readouterr().out
    want = LeannSearcher(prefix).search(q, top_k=5, complexity=64, beam_width=8)
    pos = [out.index(f"] (score {r.score:.4f}) {r.text}") for r in want]
    assert len(want) == 5 and pos == sorted(pos)
    assert cli.main(["ask", "demo", q, "--llm", "simulated"]) == 0
    assert capsys.readouterr().out.startswith("[simulated] Based on the retrieved context: ")
    on_cpu = LeannSearcher(prefix, device="cpu").search(q, top_k=5, complexity=64, beam_width=8)
    assert len({r.id for r in on_cpu} & {r.id for r in want}) >= 4


def _int32_checkpoint(path, words):
    """A tiny checkpoint (hidden 32, 2 layers; seeded weights, the port's
    writer) whose vocabulary passes 65,535 rows, with a Unigram
    tokenizer.json written here (no tokenizers on the card's machine): the
    ``words`` as whole pieces at ids 70,000 and up, letters and digits
    below, fillers between."""
    import json
    import os
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te

    vocab = [[p, 0.0] for p in ("<s>", "<pad>", "</s>", "<unk>")] + [["▁", -10.0]]
    vocab += [[c, -11.0] for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    vocab += [[f"▁f{i}", -12.0] for i in range(70_000 - len(vocab))] + [["▁" + w, -8.0] for w in words]
    cfg = replace(te.EncoderConfig(), name="int32-tiny", arch="bert", vocab_size=len(vocab), dim=32, n_layers=2,
                  n_heads=4, mlp_dim=64, max_len=64)
    te.save_hf_weights(te.init_params(cfg), cfg, path)
    template = [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                {"SpecialToken": {"id": "</s>", "type_id": 0}}]
    spec = {"version": "1.0", "added_tokens": [{"id": i, "content": p, "special": True, "normalized": False}
                                               for i, p in enumerate(("<s>", "<pad>", "</s>", "<unk>"))],
            "normalizer": {"type": "Sequence", "normalizers": [{"type": "Nmt"}, {"type": "NFKC"}]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always"},
            "post_processor": {"type": "TemplateProcessing", "single": template, "pair": [], "special_tokens": {
                "<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                "</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}},
            "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "XLMRobertaTokenizer", "pad_token": "<pad>"}, f)
    return path


@pytest.mark.parametrize("backend", ["hnsw", "diskann"])
def test_int32_token_store_on_the_card_matches_the_cpu(cuda, tmp_path, backend):
    """A vocabulary above 65,535 rows makes the token store int32: the hnsw
    recompute search and the diskann rerank, with the store on the card and
    (diskann) on the host, give the labels of the same searches on the
    CPU."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.embeddings.tokenizer_json import JsonTokenizer
    from leann_torch.storage import load_token_cache

    rng = np.random.default_rng(13)
    words = [f"w{i}" for i in range(300)]
    path = _int32_checkpoint(str(tmp_path / "ckpt"), words)
    texts = [f"doc{i} " + " ".join(rng.choice(words, 14)) for i in range(600)]
    kw = {"diskann": dict(graph_degree=16, num_partitions=1), "hnsw": dict(M=8)}[backend]
    b = LeannBuilder(backend_name=backend, embedding_model=path, max_length=32, device="cuda", **kw)
    for t in texts:
        b.add_text(t)
    prefix = str(tmp_path / "x.leann")
    b.build_index(prefix)
    tok, lengths = load_token_cache(prefix)
    assert tok.dtype == np.int32 and int(np.asarray(tok).max()) >= 70_000 and lengths.min() > 2
    queries = [" ".join(t.split()[:8]) for t in texts[:32]]
    search = dict(top_k=3, complexity=32, beam_width=4)
    cpu = [[r.id for r in row] for row in LeannSearcher(prefix, device="cpu").search(queries, **search)]
    residencies = ("device", "host") if backend == "diskann" else (None,)
    for residency in residencies:
        s = LeannSearcher(prefix, device="cuda", **({"token_residency": residency} if residency else {}))
        assert isinstance(s.backend.get_encoder().tokenizer, JsonTokenizer)
        if residency:
            assert (s.backend.tokens_host is not None) == (residency == "host")
        got = [[r.id for r in row] for row in s.search(queries, **search)]
        assert got == cpu, residency


@pytest.mark.parametrize("k", [64, 128])
def test_ring_knn_on_the_card_matches_plain(cuda, k):
    """ring_knn over 4 shards of one card: each of the 4 x 4 ring steps one
    launch of B2's external entry and one of the merge, the lists those of
    the same ring run through the plain versions (the same mesh of CPU
    shards), id overlap >= 0.9999 and distances within 1e-5."""
    from leann_torch.parallel.mesh import graph_mesh
    from leann_torch.parallel.sharded_build import ring_knn

    emb = np.random.default_rng(k).standard_normal((20_000, 384)).astype(np.float32)
    kp.knn_panel_ext.launches = kp.topk_merge.launches = 0
    ids, dists = ring_knn(emb, k, graph_mesh(4, [cuda] * 4))
    assert (kp.knn_panel_ext.launches, kp.topk_merge.launches) == (16, 16)
    pi, pd = ring_knn(emb, k, graph_mesh(4, [torch.device("cpu")] * 4))
    assert _overlap(ids, pi) >= 0.9999
    assert np.abs(dists - pd).max() <= 1e-5 * max(1.0, float(np.abs(pd).max()))
    assert not (ids == np.arange(20_000)[:, None]).any()


def test_sharded_search_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """An hnsw index built with build_sharded=True over 4 shards of the card
    and searched sharded on it: the labels of the same build and search on
    4 CPU shards (recompute, PQ-screened) on >= 0.95 of queries, and recall@3
    against a flat oracle within 0.05 of the unsharded search's (the mesh
    re-encodes a union of per-shard picks, not the one-device pick)."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.backends import common

    rng = np.random.default_rng(21)
    words = [f"w{i}" for i in range(400)]
    texts = [f"doc{i} " + " ".join(rng.choice(words, 14)) for i in range(2000)]
    queries = [" ".join(t.split()[:8]) for t in texts[:64]]
    search = dict(top_k=3, complexity=32, beam_width=4, prune_ratio=0.5)
    got = {}
    # 4 shards of the device the entry point runs on (one card here)
    monkeypatch.setattr(common, "shard_devices", lambda device: [torch.device(device)] * 4)
    for dev, backend, extra in (("cuda", "hnsw", {"build_sharded": True, "M": 8}),
                                ("cpu", "hnsw", {"build_sharded": True, "M": 8}),
                                ("cuda", "flat", {})):
        b = LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, device=dev, **extra)
        for t in texts:
            b.add_text(t)
        prefix = str(tmp_path / f"{dev}_{backend}.leann")
        b.build_index(prefix)
        if backend == "flat":
            truth = [[r.id for r in row] for row in LeannSearcher(prefix, device=dev).search(queries, top_k=3)]
            continue
        s = LeannSearcher(prefix, sharded=True, device=dev)
        assert s.backend._sharded.gp == 4
        got[dev] = [[r.id for r in row] for row in s.search(queries, **search)]
    assert np.mean([set(a) == set(b) for a, b in zip(got["cuda"], got["cpu"])]) >= 0.95
    plain = [[r.id for r in row] for row in LeannSearcher(str(tmp_path / "cuda_hnsw.leann"), device="cuda").search(
        queries, **search)]

    def recall(rows):
        return np.mean([len(set(a) & set(b)) / 3 for a, b in zip(rows, truth)])

    assert recall(got["cuda"]) >= recall(plain) - 0.05


def test_trainer_mesh_on_the_card_matches_one_device(cuda):
    """ContrastiveTrainer on a (2, 2) mesh of one card at hash-minilm's
    widths: three steps' losses within 1e-3 of the one-device trainer's."""
    from leann_torch.embeddings import encoder as te
    from leann_torch.parallel.mesh import make_mesh
    from leann_torch.parallel.train import ContrastiveTrainer

    cfg = te.MODEL_REGISTRY["hash-minilm"]
    rng = np.random.default_rng(5)
    q = rng.integers(0, cfg.vocab_size, (32, 32)).astype(np.int32)
    d = rng.integers(0, cfg.vocab_size, (32, 64)).astype(np.int32)
    qm = (np.arange(32)[None, :] < rng.integers(4, 33, 32)[:, None]).astype(np.int32)
    dm = (np.arange(64)[None, :] < rng.integers(8, 65, 32)[:, None]).astype(np.int32)
    one = ContrastiveTrainer(cfg, learning_rate=1e-4, device="cuda")
    mesh = ContrastiveTrainer(cfg, make_mesh([("dp", 2), ("tp", 2)], [cuda] * 4), 1e-4)
    l_one = [one.train_step(q, qm, d, dm) for _ in range(3)]
    l_mesh = [mesh.train_step(q, qm, d, dm) for _ in range(3)]
    np.testing.assert_allclose(l_mesh, l_one, rtol=1e-3)


def test_sentencepiece_checkpoint_builds_on_the_card(cuda, tmp_path, monkeypatch):
    """A CamemBERT checkpoint whose only tokenizer file is
    sentencepiece.bpe.model (chip_smoke's writers, at small widths): the
    port's sentencepiece reader, no <unk>, a diskann build on the card that
    launches B2 once at k = 64, and B2 on that build's embeddings against
    its plain version (id overlap >= 0.999, max abs error <= 1e-5, no self
    match)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from leann_torch import LeannBuilder
    from leann_torch.embeddings.encoder import get_encoder
    from leann_torch.embeddings.tokenizer import SpmTokenizer
    from leann_torch.ops import graph
    from leann_torch.storage import load_token_cache

    path = str(tmp_path / "camembert")
    os.makedirs(path)
    cs.camembert_checkpoint(path, dict(vocab_size=4005, dim=64, n_layers=2, n_heads=4, mlp_dim=128, max_len=130))
    chunks = cs.synth_corpus(3000, np.random.default_rng(5))
    seen = {}
    real = graph.exact_knn

    def recording(emb, k, *a, **kw):
        seen["emb"], seen["k"] = emb, k
        return real(emb, k, *a, **kw)

    monkeypatch.setattr(graph, "exact_knn", recording)
    kp.knn_panel.launches = 0
    b = LeannBuilder(backend_name="diskann", embedding_model=path, max_length=128, graph_degree=32, device="cuda")
    for c in chunks:
        b.add_text(c)
    prefix = str(tmp_path / "x.leann")
    b.build_index(prefix)
    assert kp.knn_panel.launches == 1 and seen["k"] == 64
    tokenizer = get_encoder(path, max_length=128, device="cuda").tokenizer
    assert isinstance(tokenizer, SpmTokenizer)
    tok, lengths = load_token_cache(prefix)
    real_rows = np.arange(tok.shape[1])[None, :] < lengths[:, None]
    assert not (np.asarray(tok)[real_rows] == tokenizer.unk_id).any()
    ebf, norms = kp.upload_panel_inputs(seen["emb"], cuda)
    n = ebf.shape[0]
    ik, dk = kp.knn_panel(ebf, norms, 64)
    ip, dp = kp.knn_panel_plain(ebf, norms, 64, 0, n, n)
    assert _overlap(ik.cpu().numpy(), ip.cpu().numpy()) >= 0.999
    assert float((dk - dp).abs().max()) <= 1e-5
    assert not (ik.cpu().numpy() == np.arange(n)[:, None]).any()
