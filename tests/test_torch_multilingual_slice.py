"""Checkpoints whose tokenizer is not WordPiece, end to end in each package
(CPU).

Two tiny checkpoints written by ``transformers`` (2 layers, hidden 32): a
``BertModel`` with a SentencePiece Unigram ``tokenizer.json`` saved as
``XLMRobertaTokenizerFast`` (multilingual-e5-small's pairing), and a
``RobertaForMaskedLM`` (keys under ``roberta.``, an ``lm_head``) with a
byte-level BPE saved as ``RobertaTokenizerFast`` (all-distilroberta-v1's).
Each tokenizer is trained here on the corpus: ``synth_corpus`` chunks, each
with two words of another script. The port's loader gives the JAX package's
tree, its encoder the JAX package's ids and embeddings, and a diskann and a
flat index built by either package search the same in the other.
"""

import logging
import os
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

KW = dict(top_k=3, complexity=32, beam_width=4)
FOREIGN = ["naïve", "straße", "façade", "中文", "日本語", "مرحبا", "بالعالم", "नमस्ते", "दुनिया", "привет", "мир",
           "γειά", "한국어", "👍", "ＡＢＣ", "résumé"]
FAMILIES = ("unigram", "bpe")


def _ids(results):
    return [[r.id for r in row] for row in results]


def _corpus(n, seed=0):
    from scale_500k import synth_corpus

    rng = np.random.default_rng(seed)
    chunks = [f"{c} {FOREIGN[i % len(FOREIGN)]} {FOREIGN[(i * 7 + 3) % len(FOREIGN)]}"
              for i, c in enumerate(synth_corpus(n, rng))]
    queries = [" ".join(chunks[i].split()[:12]) for i in rng.choice(n, 24, replace=False)]
    return chunks, queries


def _unigram_checkpoint(path, chunks):
    u = tokenizers.SentencePieceUnigramTokenizer()
    u.train_from_iterator(chunks, vocab_size=1500, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
                          unk_token="<unk>", show_progress=False)
    tok = u._tokenizer
    tok.post_processor = tokenizers.processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    hf_tok = transformers.XLMRobertaTokenizerFast(tokenizer_object=tok)
    cfg = transformers.BertConfig(vocab_size=len(hf_tok), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    transformers.BertModel(cfg).save_pretrained(path)
    hf_tok.save_pretrained(path)
    return path


def _bpe_checkpoint(path, chunks):
    b = tokenizers.ByteLevelBPETokenizer()
    b.train_from_iterator(chunks, vocab_size=1200, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
                          show_progress=False)
    tok = b._tokenizer
    tok.post_processor = tokenizers.processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    hf_tok = transformers.RobertaTokenizerFast(tokenizer_object=tok)
    cfg = transformers.RobertaConfig(vocab_size=len(hf_tok), hidden_size=32, num_hidden_layers=2,
                                     num_attention_heads=4, intermediate_size=64, max_position_embeddings=66,
                                     type_vocab_size=1, pad_token_id=1, hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0)
    torch.manual_seed(1)
    transformers.RobertaForMaskedLM(cfg).save_pretrained(path)
    hf_tok.save_pretrained(path)
    return path


def _build(pkg, backend, ckpt, chunks, prefix):
    kwargs = {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}
    kwargs.update({"diskann": {"graph_degree": 16, "num_partitions": 1}}.get(backend, {}))
    b = pkg.LeannBuilder(backend_name=backend, embedding_model=ckpt, max_length=64, **kwargs)
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("multilingual")
    chunks, queries = _corpus(200)
    return {"unigram": _unigram_checkpoint(str(d / "unigram"), chunks),
            "bpe": _bpe_checkpoint(str(d / "bpe"), chunks), "dir": d, "chunks": chunks, "queries": queries}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoint_loads_the_jax_packages_tree(checkpoints, family, caplog):
    """The roberta.-prefixed RobertaForMaskedLM checkpoint (and the BERT
    one) give the JAX package's tree, leaf for leaf, and load without the
    seeded-weights warning."""
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    path = checkpoints[family]
    if family == "bpe":
        keys = te.read_safetensors(os.path.join(path, "model.safetensors"))
        assert any(k.startswith("roberta.") for k in keys) and any(k.startswith("lm_head.") for k in keys)
    got, cfg_t = te.load_hf_weights(path)
    want, cfg_j = je.load_hf_weights(path)
    _assert_same_tree(got, want)
    assert (cfg_t.vocab_size, cfg_t.max_len, cfg_t.n_layers) == (cfg_j.vocab_size, cfg_j.max_len, cfg_j.n_layers)
    with caplog.at_level(logging.WARNING, logger="leann_torch"):
        enc = te.TorchEncoder(path, max_length=64, device="cpu")
    assert enc.loaded_hf and not [r for r in caplog.records if "seeded" in r.getMessage()]


def test_integer_buffers_in_safetensors_are_skipped(checkpoints, tmp_path):
    """A checkpoint whose safetensors also holds an I64
    ``embeddings.position_ids`` buffer (as older conversions do) loads the
    same tree."""
    import shutil

    from safetensors.numpy import load_file, save_file

    from leann_torch.embeddings import encoder as te

    src = checkpoints["bpe"]
    out = tmp_path / "with_ids"
    shutil.copytree(src, out)
    sd = load_file(os.path.join(src, "model.safetensors"))
    sd["roberta.embeddings.position_ids"] = np.arange(66, dtype=np.int64)[None, :]
    save_file(sd, str(out / "model.safetensors"), metadata={"format": "pt"})
    _assert_same_tree(te.load_hf_weights(str(out))[0], te.load_hf_weights(src)[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_encoder_equals_the_jax_packages(checkpoints, family):
    """get_encoder(dir) in each package: the same tokenizer ids and masks
    (pad 1, <s> ... </s>), and on the f32 forward the same embeddings within
    1e-5."""
    from leann_torch.embeddings import encoder as te
    from leann_torch.embeddings.tokenizer_json import JsonTokenizer
    from leann_tpu.embeddings import encoder as je

    path, texts = checkpoints[family], checkpoints["chunks"][:24] + checkpoints["queries"][:8]
    tenc = te.TorchEncoder(path, max_length=64, device="cpu")
    jenc = je.JaxEncoder(path, max_length=64)
    assert isinstance(tenc.tokenizer, JsonTokenizer) and tenc.tokenizer.pad_id == 1
    ids_t, mask_t = tenc.tokenize(texts)
    ids_j, mask_j = jenc.tokenize(texts)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    assert (ids_t[:, 0] == 0).all() and (ids_t[mask_t == 0] == 1).all()
    assert not (ids_t == tenc.tokenizer.unk_id).any()
    tenc.cfg = replace(tenc.cfg, compute_dtype="float32")
    jenc.cfg = replace(jenc.cfg, compute_dtype="float32")
    np.testing.assert_allclose(tenc.encode(texts), jenc.encode(texts), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def indexes(checkpoints):
    import leann_torch
    import leann_tpu
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    d, chunks = checkpoints["dir"], checkpoints["chunks"]
    te._ENCODER_CACHE.clear()
    je._ENCODER_CACHE.clear()
    paths = {}
    for family in FAMILIES:
        for backend in ("diskann", "flat"):
            for name, pkg in (("torch", leann_torch), ("jax", leann_tpu)):
                paths[family, backend, name] = str(d / f"{family}_{backend}_{name}.leann")
                _build(pkg, backend, checkpoints[family], chunks, paths[family, backend, name])
    te._ENCODER_CACHE.clear()  # fresh encoders: only <prefix>.calib.npz carries the calibration
    je._ENCODER_CACHE.clear()
    return paths


@pytest.mark.parametrize("backend", ["diskann", "flat"])
@pytest.mark.parametrize("family", FAMILIES)
def test_indexes_search_the_same_in_both_packages(checkpoints, indexes, family, backend):
    """Each package's index, searched by each package: the same top-3
    labels; the port's token store is the one the JAX package wrote."""
    import leann_torch
    import leann_tpu
    from leann_torch.storage import load_token_cache

    queries = checkpoints["queries"]
    kw = KW if backend == "diskann" else dict(top_k=3)
    tok = {n: load_token_cache(indexes[family, backend, n]) for n in ("torch", "jax")}
    if tok["torch"] is not None:
        np.testing.assert_array_equal(tok["torch"][0], tok["jax"][0])
    labels = {}
    for built in ("torch", "jax"):
        prefix = indexes[family, backend, built]
        labels[built, "torch"] = _ids(leann_torch.LeannSearcher(prefix, device="cpu").search(queries, **kw))
        labels[built, "jax"] = _ids(leann_tpu.LeannSearcher(prefix).search(queries, **kw))
    for built in ("torch", "jax"):
        assert labels[built, "torch"] == labels[built, "jax"], built
    assert np.mean([set(a) == set(b) for a, b in zip(labels["torch", "torch"], labels["jax", "jax"])]) >= 0.9
