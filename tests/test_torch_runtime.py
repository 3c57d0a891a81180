"""leann_torch's host runtime against the JAX package's (CPU): the native
hash tokenizer, the native passage store, and the LEANN_KNN_CANDIDATES
override of the graph build.

The port's native tokenizer must give exactly the Python HashTokenizer's
ids (which define them) and the JAX package's native ids wherever that one
agrees with its own Python path. Two inputs where it does not are kept as
cases: a \\x1c-\\x1f separator and a word longer than 2,048 characters.
"""

import json
import logging
import os
import pickle

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from leann_torch.embeddings import tokenizer as tt
from leann_torch.ops import cuda_build
from leann_torch.ops import graph as tg
from leann_torch.runtime import fast_tokenizer as tf
from leann_torch.runtime import passage_store as tps
from leann_tpu.embeddings import tokenizer as jt
from leann_tpu.ops import graph as jg
from leann_tpu.runtime import fast_tokenizer as jf
from leann_tpu.runtime import passage_store as jps

TEXTS = ["The quick brown fox", "don't stop-me now!!", "it's 3 o'clock... x'", "UPPER lower MiXeD 123abc",
         "tabs\tand\nnewlines\r\x0b\x0c", "symbols #$%&*()[]{}<>?/\\|~`^", "", "    ", "a" * 600,
         "one two three four five six seven eight nine ten eleven twelve thirteen"]


def _synth(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{i}" for i in rng.integers(0, 5000, int(rng.integers(5, 40)))) for _ in range(n)]


@pytest.mark.parametrize("max_length,vocab", [(8, 2048), (64, 32768), (128, 30522)])
def test_native_equals_python_and_jax_native(max_length, vocab):
    texts = TEXTS + _synth(300)
    tok = tt.HashTokenizer(vocab_size=vocab, max_length=max_length)
    want = tok.encode_batch_python(texts)
    got = tf.encode_batch_ascii(texts, max_length, vocab)
    jax_native = jf.encode_batch_ascii(texts, max_length, vocab)
    for a, b, c in zip(got, want, jax_native):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(tok.encode_batch(texts)[0], want[0])  # the routed path


@settings(max_examples=200, deadline=None)
@given(st.lists(st.text(alphabet=st.characters(min_codepoint=0, max_codepoint=127), max_size=60), min_size=1,
                max_size=8))
def test_native_equals_python_on_any_ascii(texts):
    tok = tt.HashTokenizer(vocab_size=1000, max_length=24)
    got, want = tf.encode_batch_ascii(texts, 24, 1000), tok.encode_batch_python(texts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_jax_native_faults_are_not_copied():
    """Where the JAX package's native path leaves its own Python path, the
    port's native path stays with the Python one (both packages' Python
    paths agree)."""
    for text in ("a\x1cb\x1dc\x1ed\x1fe", "x" * 3000 + " y"):
        want = tt.HashTokenizer(vocab_size=1000, max_length=16).encode_batch_python([text])[0]
        jax_py = np.stack([jt.HashTokenizer(vocab_size=1000, max_length=16).encode(text)[0]])
        np.testing.assert_array_equal(want, jax_py)
        np.testing.assert_array_equal(tf.encode_batch_ascii([text], 16, 1000)[0], want)
        assert not np.array_equal(jf.encode_batch_ascii([text], 16, 1000)[0], want)


def test_mixed_batch_routes_per_text(monkeypatch):
    """ASCII texts through the native library together, the others in
    Python one by one; the same ids as the JAX package's routing."""
    texts = ["plain ascii text", "naïve café", "中文 text", "more ascii", "Ünïcödé only"]
    seen = []
    orig = tf.encode_batch_ascii
    monkeypatch.setattr(tf, "encode_batch_ascii", lambda t, *a: (seen.append(list(t)), orig(t, *a))[1])
    tok = tt.HashTokenizer(vocab_size=32768, max_length=16)
    got = tok.encode_batch(texts)
    assert seen == [["plain ascii text", "more ascii"]]
    want = jt.HashTokenizer(vocab_size=32768, max_length=16).encode_batch(texts)
    for a, b, c in zip(got, tok.encode_batch_python(texts), want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert tok.encode_batch(["ümlaut"])[0].shape == (1, 16) and len(seen) == 1  # none ASCII: no native call


@pytest.fixture()
def no_compiler(tmp_path, monkeypatch):
    """An empty build directory and a compiler that always fails."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "_cxx", lambda: "false")


def test_failed_builds_raise(no_compiler, tmp_path):
    with pytest.raises(RuntimeError, match="the build failed for hash_tokenizer"):
        tt.HashTokenizer(vocab_size=1000, max_length=8).encode_batch(["ascii"])
    p = tmp_path / "p.jsonl"
    p.write_text('{"id": "0", "text": "x", "metadata": {}}\n')
    with pytest.raises(RuntimeError, match="the build failed for passage_store"):
        tps.NativePassageStore(str(p))


def _write_jsonl(path, items):
    offsets = {}
    with open(path, "wb") as f:
        for it in items:
            offsets[it["id"]] = f.tell()
            f.write(json.dumps(it, ensure_ascii=False).encode() + b"\n")
    with open(str(path).replace(".jsonl", ".idx"), "wb") as f:
        pickle.dump(offsets, f)
    return offsets


def test_native_store_equals_offsets(tmp_path):
    rng = np.random.default_rng(3)
    items = [{"id": str(i), "text": f"passage {i} " + "x" * int(rng.integers(1, 200)), "metadata": {"i": i}}
             for i in range(500)]
    items += [{"id": "a-b", "text": 'second "quoted"', "metadata": {}}, {"id": "中文", "text": "中文内容", "metadata": {}}]
    path = tmp_path / "s.passages.jsonl"
    offsets = _write_jsonl(path, items)
    store = tps.NativePassageStore(str(path))
    assert len(store) == len(items) and os.path.exists(tmp_path / "s.passages.cidx")
    with open(path, "rb") as f:
        for it in items:
            f.seek(offsets[it["id"]])
            assert store.get_raw(it["id"]) == f.readline().rstrip(b"\n")
            assert store.get(it["id"]) == it
    assert store.get("missing") is None
    store.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cidx_opens_across_packages(tmp_path, writer):
    items = [{"id": str(i), "text": f"t{i}", "metadata": {}} for i in range(50)]
    path = str(tmp_path / "x.passages.jsonl")
    _write_jsonl(path, items)
    first, second = (jps, tps) if writer == "jax" else (tps, jps)
    first.NativePassageStore(path).close()
    cidx = str(tmp_path / "x.passages.cidx")
    stamp = os.stat(cidx).st_mtime_ns
    store = second.NativePassageStore(path)
    assert os.stat(cidx).st_mtime_ns == stamp  # read as written, not rebuilt
    assert [store.get(str(i))["text"] for i in range(50)] == [f"t{i}" for i in range(50)]
    store.close()


def _flat_index(tmp_path, texts):
    import leann_torch

    prefix = str(tmp_path / "f.leann")
    b = leann_torch.LeannBuilder(backend_name="flat", embedding_model="hash-tiny", max_length=32, device="cpu")
    for t in texts:
        b.add_text(t)
    b.build_index(prefix)
    return prefix


def test_passage_manager_native_and_update(tmp_path):
    """The native store serves the searcher; an id appended by update_index
    after the .cidx was written is found (the stale store misses it and the
    offset map answers; the next open writes the store again)."""
    import leann_torch
    from leann_torch.api import PassageManager

    texts = [f"chunk {i} about topic {i % 7}" for i in range(60)]
    prefix = _flat_index(tmp_path, texts)
    meta = json.load(open(prefix + ".meta.json"))
    pm = PassageManager(meta["passage_sources"], meta_dir=str(tmp_path))
    plain = PassageManager(meta["passage_sources"], meta_dir=str(tmp_path), use_native=False)
    assert pm._native[0] is not None and plain._native[0] is None
    for pid in pm.ids():
        assert pm.get_passage(pid) == plain.get_passage(pid)

    stale = tps.NativePassageStore(meta["passage_sources"][0]["path"])  # opened before the append
    u = leann_torch.LeannBuilder.from_index(prefix, device="cpu")
    u.add_text("a brand new chunk about zebras")
    u.update_index(prefix)
    assert stale.get("60") is None
    meta = json.load(open(prefix + ".meta.json"))
    pm = PassageManager(meta["passage_sources"], meta_dir=str(tmp_path))
    assert pm._native[0].get("60")["text"] == "a brand new chunk about zebras"  # written again at open
    pm._native[0] = stale
    assert pm.get_passage("60")["text"] == "a brand new chunk about zebras"  # the miss: the offset map
    assert pm.get_passage("3") == plain.get_passage("3")
    hits = leann_torch.LeannSearcher(prefix, device="cpu").search("brand new chunk about zebras", top_k=1)
    assert hits[0].id == "60" and hits[0].text == "a brand new chunk about zebras"


def test_rebuild_into_same_prefix_rewrites_the_store(tmp_path):
    """A rebuild with other passages rewrites the jsonl; the older .cidx is
    written again, so no lookup lands inside another line."""
    from leann_torch.api import PassageManager

    prefix = _flat_index(tmp_path, [f"short {i}" for i in range(40)])
    meta = json.load(open(prefix + ".meta.json"))
    PassageManager(meta["passage_sources"], meta_dir=str(tmp_path))  # writes the .cidx
    longer = [f"a much longer passage number {i} " + "y" * i for i in range(40)]
    prefix = _flat_index(tmp_path, longer)
    meta = json.load(open(prefix + ".meta.json"))
    pm = PassageManager(meta["passage_sources"], meta_dir=str(tmp_path))
    assert [pm.get_passage(str(i))["text"] for i in range(40)] == longer
    assert [pm._native[0].get(str(i))["text"] for i in range(40)] == longer


def test_rebuild_to_shorter_passages_under_an_open_searcher(tmp_path):
    """A searcher whose native store mapped a long jsonl stays whole while the
    prefix is rebuilt with a much shorter one: the rebuild replaces the file,
    so the open store still reads the old passages (a rewrite in place would
    leave it mapped past the end of the new file)."""
    import leann_torch

    longer = [f"a much longer passage number {i} " + "y" * (40 * i) for i in range(40)]
    prefix = _flat_index(tmp_path, longer)
    searcher = leann_torch.LeannSearcher(prefix, device="cpu")
    assert searcher.passage_manager._native[0] is not None
    jsonl = prefix + ".passages.jsonl"
    size = os.path.getsize(jsonl)
    _flat_index(tmp_path, [f"s{i}" for i in range(40)])
    assert os.path.getsize(jsonl) < size // 10
    assert [searcher.passage_manager.get_passage(str(i))["text"] for i in range(40)] == longer
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    hits = leann_torch.LeannSearcher(prefix, device="cpu").search("s7", top_k=1)
    assert hits[0].text.startswith("s")


def test_unwritable_store_index_reads_through_the_offsets(tmp_path, monkeypatch, caplog):
    """Where the .cidx is missing and cannot be written beside the jsonl (a
    read-only index directory), the passages are read through the offset map,
    with a warning, and the searcher still serves."""
    import builtins

    import leann_torch

    texts = [f"chunk {i} about topic {i % 7}" for i in range(30)]
    prefix = _flat_index(tmp_path, texts)
    for f in os.listdir(tmp_path):
        if f.endswith(".cidx"):
            os.unlink(tmp_path / f)

    def refusing_open(path, *a, **kw):
        if str(path).startswith(str(tmp_path)) and str(path).endswith(".tmp"):
            raise PermissionError(13, "Permission denied", str(path))
        return builtins.open(path, *a, **kw)

    monkeypatch.setattr(tps, "open", refusing_open, raising=False)
    with caplog.at_level(logging.WARNING):
        searcher = leann_torch.LeannSearcher(prefix, device="cpu")
    assert searcher.passage_manager._native[0] is None
    assert any("offset map" in r.getMessage() for r in caplog.records)
    assert [searcher.passage_manager.get_passage(str(i))["text"] for i in range(30)] == texts
    assert searcher.search("chunk 11 about topic 4", top_k=1)[0].text == texts[11]
    assert not [f for f in os.listdir(tmp_path) if f.endswith((".cidx", ".tmp"))]


def _clustered(seed, n, d, n_c=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 3
    return centers[rng.integers(0, n_c, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


@pytest.mark.parametrize("c_env,want_c", [(4, 8), (24, 24)])
def test_knn_candidates_override_matches_jax(tmp_path, monkeypatch, caplog, c_env, want_c):
    """LEANN_KNN_CANDIDATES below R (clamped to R, with the warning) and above
    it: the port's candidate width, warning and checkpoint key equal the JAX
    package's."""
    monkeypatch.setenv("LEANN_KNN_CANDIDATES", str(c_env))
    emb = _clustered(0, 300, 16)
    out = {}
    for name, build in (("jax", lambda ck: jg.build_graph(emb, r=8, checkpoint_dir=ck)),
                        ("torch", lambda ck: tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck))):
        ck = str(tmp_path / name)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            build(ck)
        warned = [r.getMessage() for r in caplog.records if "LEANN_KNN_CANDIDATES" in r.getMessage()]
        out[name] = (np.load(os.path.join(ck, "ckpt_knn.npy")).shape[1],
                     json.load(open(os.path.join(ck, "ckpt_knn.npy.json")))["key"], warned)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == want_c and out["torch"][1].endswith(f"_c{want_c}")
    assert bool(out["torch"][2]) == (c_env < 8)


def test_jax_written_knn_resumes_with_the_override(tmp_path, monkeypatch):
    """With LEANN_KNN_CANDIDATES set, a ckpt_knn.npy the JAX package wrote
    resumes in the port, which runs no k-NN of its own."""
    monkeypatch.setenv("LEANN_KNN_CANDIDATES", "24")
    emb = _clustered(1, 300, 16)
    ck = str(tmp_path / "ck")
    want, _ = jg.build_graph(emb, r=8, checkpoint_dir=ck)
    os.remove(os.path.join(ck, "ckpt_pruned.npy.json"))
    monkeypatch.setattr(tg, "exact_knn", lambda *a, **kw: pytest.fail("the port ran its own k-NN"))
    got, _ = tg.build_graph(emb, r=8, device="cpu", checkpoint_dir=ck)
    assert got.shape == want.shape
    assert (got == want).all(axis=1).mean() >= 0.99
