"""A rebuild into the same prefix (CPU, hash-tiny): the port's passage store
and token cache are rewritten when any row changed, and kept when every row
is the same. Their ``.done`` sidecars key on every row (``api._rows_sha1``);
a key of the count and the first and last rows alone kept the old passages
and tokens beside a new graph when only middle rows changed, and the
searcher returned the old text. The JAX package keys on the first and last
rows: its sidecar never equals the port's, so either package rewrites over
the other's."""

import json
import os

import numpy as np
import pytest
import torch

N = 240
MID = N // 2
BACKENDS = {"hnsw": {"M": 8}, "diskann": {"graph_degree": 8}}
SEARCH_KW = dict(top_k=3, complexity=64, beam_width=4)
STORES = (".passages.jsonl", ".passages.idx", ".tokens.cache.npz")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texts(seed: int, tag: str):
    rng = np.random.default_rng(seed)
    return [f"{tag} {i} " + " ".join(f"w{rng.integers(0, 300)}" for _ in range(10)) for i in range(N)]


@pytest.fixture(scope="module")
def texts():
    """The first build's texts and the rebuild's: rows 1 .. N-2 changed, the
    count and both end rows kept."""
    a = _texts(0, "doc")
    b = [a[0]] + _texts(1, "edit")[1:-1] + [a[-1]]
    return a, b


def _pkg(name):
    import leann_torch
    import leann_tpu

    return {"torch": leann_torch, "jax": leann_tpu}[name]


def _build(pkg, backend, prefix, texts, metadata=None):
    kw = {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}
    b = pkg.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, **BACKENDS[backend],
                         **kw)
    for i, t in enumerate(texts):
        b.add_text(t, metadata=None if metadata is None else metadata(i))
    b.build_index(prefix)


def _stamps(prefix):
    """(inode, mtime) of each store file: a rewrite replaces the file."""
    return {s: (os.stat(prefix + s).st_ino, os.stat(prefix + s).st_mtime_ns) for s in STORES}


def _stores(prefix):
    from leann_torch.storage import load_token_cache

    with open(prefix + ".passages.jsonl", "rb") as f:
        jsonl = f.read()
    with open(prefix + ".passages.idx", "rb") as f:
        idx = f.read()
    return jsonl, idx, load_token_cache(prefix)


def _same_stores(a, b) -> bool:
    return a[0] == b[0] and a[1] == b[1] and all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))


def _top(pkg, prefix, query):
    kw = {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}
    return pkg.LeannSearcher(prefix, **kw).search(query, **SEARCH_KW)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a_rebuild_with_middle_rows_changed_rewrites_both_stores(tmp_path, texts, backend):
    """The stores after the rebuild are a fresh build's of the new texts, and
    a search for a changed row returns its new text."""
    import leann_torch

    a, b = texts
    prefix, fresh = str(tmp_path / "idx.leann"), str(tmp_path / "fresh" / "idx.leann")
    os.makedirs(os.path.dirname(fresh))
    _build(leann_torch, backend, prefix, a)
    before = _stores(prefix)
    _build(leann_torch, backend, prefix, b)
    _build(leann_torch, backend, fresh, b)
    after = _stores(prefix)
    assert after[0] != before[0] and after[1] != before[1]
    assert not np.array_equal(after[2][0], before[2][0])
    assert _same_stores(after, _stores(fresh))
    res = _top(leann_torch, prefix, b[MID])
    assert res[0].id == str(MID) and res[0].text == b[MID]
    assert all(r.text == b[int(r.id)] for r in res)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a_rebuild_on_the_same_texts_skips_both_stores(tmp_path, texts, backend):
    import leann_torch

    a, _ = texts
    prefix = str(tmp_path / "idx.leann")
    _build(leann_torch, backend, prefix, a)
    stamps, stores = _stamps(prefix), _stores(prefix)
    _build(leann_torch, backend, prefix, a)
    assert _stamps(prefix) == stamps and _same_stores(_stores(prefix), stores)
    res = _top(leann_torch, prefix, a[MID])
    assert res[0].id == str(MID) and res[0].text == a[MID]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a_metadata_change_rewrites_the_passages_alone(tmp_path, texts, backend):
    """Metadata are part of a passage row; the token cache keys on the texts."""
    import leann_torch

    a, _ = texts
    prefix = str(tmp_path / "idx.leann")
    _build(leann_torch, backend, prefix, a, metadata=lambda i: {"part": 0})
    stamps = _stamps(prefix)
    _build(leann_torch, backend, prefix, a, metadata=lambda i: {"part": int(i == MID)})
    now = _stamps(prefix)
    assert now[".passages.jsonl"] != stamps[".passages.jsonl"] and now[".passages.idx"] != stamps[".passages.idx"]
    assert now[".tokens.cache.npz"] == stamps[".tokens.cache.npz"]
    with open(prefix + ".passages.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["metadata"]["part"] for r in rows] == [int(i == MID) for i in range(N)]
    res = _top(leann_torch, prefix, a[MID])
    assert res[0].id == str(MID) and res[0].metadata == {"part": 1}


def test_the_sidecars_key_on_every_row(tmp_path, texts):
    """Each sidecar holds a hash over every row under ``rows_sha1``, and no
    ``fp`` field: the JAX package's key, which its reader compares."""
    import leann_torch
    from leann_torch.api import _rows_sha1

    a, b = texts
    prefix = str(tmp_path / "idx.leann")
    _build(leann_torch, "hnsw", prefix, a)
    with open(prefix + ".passages.done.json") as f:
        passages = json.load(f)
    with open(prefix + ".tokens.cache.done.json") as f:
        tokens = json.load(f)
    assert passages == {"count": N, "rows_sha1": _rows_sha1([str(i) for i in range(N)], a, [{}] * N)}
    assert tokens == {"count": N, "model": "hash-tiny", "max_length": 32, "rows_sha1": _rows_sha1(a)}
    assert _rows_sha1(a) != _rows_sha1(b) and _rows_sha1(a[::-1]) != _rows_sha1(a)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_a_rebuild_over_the_other_packages_stores_rewrites(tmp_path, texts, backend, first, second):
    """One package builds, the other rebuilds into the same prefix with the
    middle rows changed: the rebuild rewrites both stores (the sidecars'
    keys never match across packages), and the first package's searcher
    reads the new text from the rebuilt index."""
    a, b = texts
    prefix = str(tmp_path / "idx.leann")
    _build(_pkg(first), backend, prefix, a)
    stamps = _stamps(prefix)
    _build(_pkg(second), backend, prefix, b)
    now = _stamps(prefix)
    assert all(now[s] != stamps[s] for s in STORES)
    with open(prefix + ".passages.jsonl") as f:
        assert [json.loads(line)["text"] for line in f] == b
    res = _top(_pkg(first), prefix, b[MID])
    assert res[0].id == str(MID) and res[0].text == b[MID]
    assert all(r.text == b[int(r.id)] for r in res)


def _relabel(prefix, backend):
    from leann_torch.repack import relabel_index

    relabel_index(prefix, order=np.random.default_rng(2).permutation(N), device="cpu")


def _relabel_and_back(prefix, backend):
    from leann_torch.repack import unrelabel_index

    _relabel(prefix, backend)
    unrelabel_index(prefix)


def _insert(prefix, backend):
    import leann_torch

    b = leann_torch.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32,
                                 **BACKENDS[backend], device="cpu")
    for t in _texts(3, "added")[:16]:
        b.add_text(t)
    b.update_index(prefix)


CHANGES = {"relabel": _relabel, "unrelabel": _relabel_and_back, "update_index": _insert}


@pytest.mark.parametrize("change,backend", [("relabel", "hnsw"), ("relabel", "diskann"), ("unrelabel", "hnsw"),
                                            ("update_index", "hnsw")])
def test_a_rebuild_after_a_change_outside_the_build_rewrites_the_stores(tmp_path, texts, change, backend):
    """A relabel moves the token rows and an insert appends rows to both
    stores, outside the build; each drops the sidecars of what it changed.
    A rebuild on the first texts then gives a fresh build's stores, and a
    search the texts of its rows."""
    import leann_torch

    a, _ = texts
    prefix, fresh = str(tmp_path / "idx.leann"), str(tmp_path / "fresh" / "idx.leann")
    os.makedirs(os.path.dirname(fresh))
    _build(leann_torch, backend, prefix, a)
    CHANGES[change](prefix, backend)
    _build(leann_torch, backend, prefix, a)
    _build(leann_torch, backend, fresh, a)
    assert _same_stores(_stores(prefix), _stores(fresh))
    res = _top(leann_torch, prefix, a[MID])
    assert res[0].id == str(MID) and res[0].text == a[MID]
    assert all(r.text == a[int(r.id)] for r in res)
