"""The serving path over a local checkpoint, end to end in each package (CPU).

A tiny BERT written by ``transformers`` with a WordPiece ``vocab.txt``
(every ``synth_corpus`` word decomposes into its pieces, so no ``[UNK]``)
drives a few-hundred-chunk diskann build and a flat oracle through
``LeannBuilder(embedding_model=<dir>)`` in both packages. The corpus
calibrations (``<prefix>.calib.npz``) agree, the port's labels agree with the
JAX package's at the slice tests' tolerance, an index built by either package
searches the same in the other, and ``BatchedSearcher`` serves the port's.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

KW = dict(top_k=3, complexity=32, beam_width=4)
CHARS = list("abcdefghijklmnopqrstuvwxyz0123456789")


def _ids(results):
    return [[r.id for r in row] for row in results]


def _recall(pred, truth):
    return float(np.mean([len(set(p) & set(t)) / len(t) for p, t in zip(pred, truth)]))


def _checkpoint(path):
    from transformers import BertConfig, BertModel, BertTokenizerFast

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + CHARS + ["##" + c for c in CHARS]
    vocab += [f"w{i}" for i in range(100)] + [f"##{i}" for i in range(10, 100)]
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    BertModel(cfg).save_pretrained(path)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    BertTokenizerFast(vocab_file=os.path.join(path, "vocab.txt"), do_lower_case=True).save_pretrained(path)
    return path


def _build(pkg, backend, ckpt, chunks, prefix):
    kwargs = {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}
    kwargs.update({"diskann": {"graph_degree": 16, "num_partitions": 1}}.get(backend, {}))
    b = pkg.LeannBuilder(backend_name=backend, embedding_model=ckpt, max_length=64, **kwargs)
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)
    return b


@pytest.fixture(scope="module", params=["tokenizer.json", "vocab.txt"])
def hf_indexes(request, tmp_path_factory):
    """Both packages' indexes over the checkpoint, by each tokenizer route:
    the saved tokenizer.json first, as AutoTokenizer, or vocab.txt alone
    (tokenizer.json removed from the directory)."""
    import leann_torch
    import leann_tpu
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je
    from scale_500k import synth_corpus

    d = tmp_path_factory.mktemp("hf_slice")
    ckpt = _checkpoint(str(d / "bert"))
    if request.param == "vocab.txt":
        os.remove(os.path.join(ckpt, "tokenizer.json"))
    rng = np.random.default_rng(0)
    chunks = synth_corpus(400, rng)
    queries = [" ".join(chunks[i].split()[:12]) for i in rng.choice(len(chunks), 32, replace=False)]
    te._ENCODER_CACHE.clear()
    je._ENCODER_CACHE.clear()
    paths = {k: str(d / f"{k}.leann") for k in ("torch", "jax", "flat", "jax_flat")}
    builder = _build(leann_torch, "diskann", ckpt, chunks, paths["torch"])
    _build(leann_tpu, "diskann", ckpt, chunks, paths["jax"])
    _build(leann_torch, "flat", ckpt, chunks, paths["flat"])
    _build(leann_tpu, "flat", ckpt, chunks, paths["jax_flat"])
    # fresh encoders for the searches: only <prefix>.calib.npz carries the calibration
    te._ENCODER_CACHE.clear()
    je._ENCODER_CACHE.clear()
    truth = _ids(leann_torch.LeannSearcher(paths["flat"], device="cpu").search(queries, top_k=3))
    return dict(paths=paths, ckpt=ckpt, chunks=chunks, queries=queries, truth=truth, phases=builder.phase_seconds,
                route=request.param)


def test_build_loads_the_checkpoint_and_calibrates(hf_indexes):
    from leann_torch.embeddings.encoder import get_encoder
    from leann_torch.storage import load_token_cache

    p = hf_indexes["paths"]
    for k in ("torch", "jax", "flat", "jax_flat"):
        assert os.path.exists(p[k] + ".calib.npz"), k
    enc = get_encoder(hf_indexes["ckpt"], max_length=64, device="cpu")
    want_tok = {"tokenizer.json": "JsonTokenizer", "vocab.txt": "HFTokenizer"}[hf_indexes["route"]]
    assert enc.loaded_hf and type(enc.tokenizer).__name__ == want_tok
    tok, lengths = load_token_cache(p["torch"])
    assert not (tok == enc.tokenizer.unk_id).any() and lengths.min() > 2
    assert hf_indexes["phases"]["calibrate"] > 0
    # the build's embeddings carry the calibration it saved: the flat index
    # holds them, and the calibrated encoder gives them again
    z = np.load(p["flat"] + ".calib.npz")
    emb = np.load(p["flat"] + ".flat.npz")["embeddings"].astype(np.float32)
    want = enc.with_calibration({"out_center": z["out_center"], "out_pc": z["out_pc"]}).encode(hf_indexes["chunks"][:64])
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(emb[:64], want, rtol=0, atol=1e-5)


def test_calibration_agrees_with_jax(hf_indexes):
    """The same mean within 1e-5 and the same projector within 1e-4, though
    each package calibrates on its own bf16 forward."""
    p = hf_indexes["paths"]
    for ours, theirs in (("torch", "jax"), ("flat", "jax_flat")):
        zt, zj = np.load(p[ours] + ".calib.npz"), np.load(p[theirs] + ".calib.npz")
        assert zt["out_pc"].shape == zj["out_pc"].shape == (32, 8)
        np.testing.assert_allclose(zt["out_center"], zj["out_center"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(zt["out_pc"] @ zt["out_pc"].T, zj["out_pc"] @ zj["out_pc"].T, rtol=0, atol=1e-4)


def test_labels_agree_with_jax(hf_indexes):
    import leann_torch
    import leann_tpu

    p, queries, truth = hf_indexes["paths"], hf_indexes["queries"], hf_indexes["truth"]
    got = _ids(leann_torch.LeannSearcher(p["torch"], device="cpu").search(queries, **KW))
    want = _ids(leann_tpu.LeannSearcher(p["jax"]).search(queries, **KW))
    assert all(len(r) == 3 for r in got)
    assert _recall(got, truth) >= 0.9
    assert np.mean([set(a) == set(b) for a, b in zip(got, want)]) >= 0.9
    jax_truth = _ids(leann_tpu.LeannSearcher(p["jax_flat"]).search(queries, top_k=3))
    assert abs(_recall(got, truth) - _recall(want, jax_truth)) <= 0.05


@pytest.mark.parametrize("built_by,searched_by", [("jax", "torch"), ("torch", "jax")])
def test_index_interchange(hf_indexes, built_by, searched_by):
    import leann_torch
    import leann_tpu

    p, queries, truth = hf_indexes["paths"], hf_indexes["queries"], hf_indexes["truth"]
    pkgs = {"torch": (leann_torch, {"device": "cpu"}), "jax": (leann_tpu, {})}
    native = _ids(pkgs[built_by][0].LeannSearcher(p[built_by], **pkgs[built_by][1]).search(queries, **KW))
    other = _ids(pkgs[searched_by][0].LeannSearcher(p[built_by], **pkgs[searched_by][1]).search(queries, **KW))
    assert np.mean([set(a) == set(b) for a, b in zip(native, other)]) >= 0.9
    assert abs(_recall(native, truth) - _recall(other, truth)) <= 0.05


def test_batcher_serves_the_checkpoint_index(hf_indexes):
    import leann_torch

    p, queries = hf_indexes["paths"], hf_indexes["queries"]
    direct = _ids(leann_torch.LeannSearcher(p["torch"], device="cpu").search(queries, **KW))
    with leann_torch.BatchedSearcher(p["torch"], max_batch=16, max_wait_ms=2.0, device="cpu") as bs:
        futs = [bs.submit(q, **KW) for q in queries]
        got = [[r.id for r in f.result(timeout=120)] for f in futs]
    assert got == direct


def test_update_embeds_with_the_index_calibration(hf_indexes, tmp_path):
    """update_index in a fresh process state embeds the new chunks with the
    index's calibration, as the build embedded the others."""
    import leann_torch
    from leann_torch.embeddings import encoder as te

    src = hf_indexes["paths"]["flat"]
    d = tmp_path / "upd"
    d.mkdir()
    for f in os.listdir(os.path.dirname(src)):
        if f.startswith("flat.leann."):
            shutil.copy(os.path.join(os.path.dirname(src), f), d)
    prefix = str(d / "flat.leann")
    meta = json.load(open(prefix + ".meta.json"))
    for s in meta["passage_sources"]:
        s.update(path=prefix + ".passages.jsonl", index_path=prefix + ".passages.idx")
    json.dump(meta, open(prefix + ".meta.json", "w"))
    te._ENCODER_CACHE.clear()
    new = ["w1 w2 w3 w45 w67 new chunk", "w9 w99 w12 another new chunk"]
    u = leann_torch.LeannBuilder.from_index(prefix, device="cpu")
    for t in new:
        u.add_text(t)
    u.update_index(prefix)
    z = np.load(prefix + ".calib.npz")
    te._ENCODER_CACHE.clear()
    enc = te.get_encoder(hf_indexes["ckpt"], max_length=64, device="cpu")
    want = enc.with_calibration({"out_center": z["out_center"], "out_pc": z["out_pc"]}).encode(new)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    emb = np.load(prefix + ".flat.npz")["embeddings"].astype(np.float32)
    np.testing.assert_allclose(emb[-2:], want, rtol=0, atol=1e-5)


def test_rebuild_with_a_hash_model_drops_the_calibration(hf_indexes, tmp_path):
    """A hash-model build into a prefix a checkpoint build left a
    .calib.npz at removes it, so the searchers do not apply it."""
    import leann_torch

    prefix = str(tmp_path / "re.leann")
    chunks = hf_indexes["chunks"][:60]
    _build(leann_torch, "flat", hf_indexes["ckpt"], chunks, prefix)
    assert os.path.exists(prefix + ".calib.npz")
    _build(leann_torch, "flat", "hash-tiny", chunks, prefix)
    assert not os.path.exists(prefix + ".calib.npz")
    hits = leann_torch.LeannSearcher(prefix, device="cpu").search(chunks[7], top_k=1)
    assert hits[0].id == "7"
