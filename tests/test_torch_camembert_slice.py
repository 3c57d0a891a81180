"""A CamemBERT checkpoint whose only tokenizer file is a SentencePiece
``sentencepiece.bpe.model``, end to end in each package (CPU), and the
loader's base prefixes for CamemBERT and ELECTRA heads.

The checkpoint: a tiny ``CamembertForMaskedLM`` (2 layers, hidden 32; keys
under ``roberta.`` beside an ``lm_head``) saved by ``transformers``, with a
Unigram counted here from the corpus (``synth_corpus`` chunks, each with two
words of another script) and written as a ``ModelProto`` with fairseq's head
pieces and a ``Precompiled`` charsmap (``RULES``). The port reads that
directory; the JAX package reads its twin, which holds the same weights and the
``tokenizer.json`` that ``transformers``' ``CamembertConverter`` makes of the
same file (``sentencepiece`` is not installed here, so ``AutoTokenizer``
cannot read the ``.model`` itself). The loader trees are equal, the
encoders give the same ids and embeddings within 1e-5 on the f32 forward,
and a diskann and a flat index built by either package search the same in
both (the JAX package searches the port's index through a copy whose meta
names the twin). A tiny ``ElectraForPreTraining`` (``electra.`` keys,
``discriminator_predictions``, ``embedding_size`` equal to the hidden size
as in ELECTRA-base) loads to the JAX package's tree; one with an
``embeddings_project`` raises a clear error.
"""

import collections
import json
import math
import os
import shutil
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("google.protobuf")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

from test_torch_multilingual_slice import KW, _assert_same_tree, _build, _corpus, _ids  # noqa: E402
from test_torch_spm_model import SPM, StandIn, write_model  # noqa: E402

# a charsmap that folds what the corpus's foreign words hold into what it
# also holds, so that no token is <unk>
RULES = {"Ａ": "A", "Ｂ": "B", "Ｃ": "C", "\xa0": " ", "\u3000": " ", "ﬁ": "fi", "①": "1", "e\u0301": "é",
         "\t": " "}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unigram_pieces(chunks, n_words=1200):
    """A Unigram vocabulary made from the corpus by counting, the same on
    every run (the ``tokenizers`` trainer's scores differ between runs):
    fairseq's head pieces, the ``n_words`` most frequent words whole behind
    "▁" at their log frequency, then "▁" and every character of the corpus
    well below them."""
    counts = collections.Counter(w for c in chunks for w in c.split())
    total = sum(counts.values())
    words = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:n_words]
    chars = sorted({ch for c in chunks for ch in c if not ch.isspace()})
    return ([["<unk>", 0.0], ["<s>", 0.0], ["</s>", 0.0]] + [["▁" + w, math.log(n / total)] for w, n in words]
            + [["▁", -20.0]] + [[ch, -21.0] for ch in chars])


def _camembert_checkpoint(root, chunks):
    """-> (the .model-only directory, its twin with tokenizer.json)."""
    pieces = _unigram_pieces(chunks)
    model_dir, twin = root / "camembert", root / "camembert_twin"
    cfg = transformers.CamembertConfig(vocab_size=len(pieces) + 5, hidden_size=32, num_hidden_layers=2,
                                       num_attention_heads=4, intermediate_size=64, max_position_embeddings=66,
                                       type_vocab_size=1, pad_token_id=1, hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0)
    torch.manual_seed(3)
    model = transformers.CamembertForMaskedLM(cfg)
    model.save_pretrained(str(model_dir))
    model.save_pretrained(str(twin))
    m = write_model(str(model_dir / SPM), pieces, True, True, rules=RULES)
    (model_dir / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "CamembertTokenizer"}))
    stand_in = StandIn(str(model_dir / SPM), "CamembertTokenizer", [(p.piece, p.score) for p in m.pieces])
    backend = transformers.convert_slow_tokenizer.CamembertConverter(stand_in).converted()
    transformers.CamembertTokenizerFast(tokenizer_object=backend).save_pretrained(str(twin))
    return str(model_dir), str(twin)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("camembert")
    chunks, queries = _corpus(200)
    model_dir, twin = _camembert_checkpoint(d, chunks)
    return {"dir": d, "model": model_dir, "twin": twin, "chunks": chunks, "queries": queries}


def test_the_model_only_directory(checkpoint):
    """The port's directory holds no tokenizer.json, vocab.txt or BPE
    files; the weights sit under roberta. beside an lm_head."""
    from leann_torch.embeddings import encoder as te

    files = set(os.listdir(checkpoint["model"]))
    assert SPM in files and not files & {"tokenizer.json", "vocab.txt", "vocab.json", "merges.txt"}
    keys = te.read_safetensors(os.path.join(checkpoint["model"], "model.safetensors"))
    assert any(k.startswith("roberta.") for k in keys) and any(k.startswith("lm_head.") for k in keys)


def test_checkpoint_loads_the_jax_packages_tree(checkpoint):
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    got, cfg_t = te.load_hf_weights(checkpoint["model"])
    want, cfg_j = je.load_hf_weights(checkpoint["twin"])
    _assert_same_tree(got, want)
    assert (cfg_t.vocab_size, cfg_t.max_len, cfg_t.n_layers) == (cfg_j.vocab_size, cfg_j.max_len, cfg_j.n_layers)


def test_encoder_equals_the_jax_packages(checkpoint):
    """The port's encoder on the .model directory, the JAX package's on the
    twin: the same ids and masks (<s> 5, pad 1, no <unk>) and, on the f32
    forward with the same output center, the same embeddings within
    1e-5."""
    from leann_torch.embeddings import encoder as te
    from leann_torch.embeddings.tokenizer import SpmTokenizer
    from leann_tpu.embeddings import encoder as je

    texts = checkpoint["chunks"][:24] + checkpoint["queries"][:8]
    tenc = te.TorchEncoder(checkpoint["model"], max_length=64, device="cpu")
    jenc = je.JaxEncoder(checkpoint["twin"], max_length=64)
    assert tenc.loaded_hf and isinstance(tenc.tokenizer, SpmTokenizer)
    ids_t, mask_t = tenc.tokenize(texts)
    ids_j, mask_j = jenc.tokenize(texts)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    assert (ids_t[:, 0] == 5).all() and (ids_t[mask_t == 0] == 1).all()
    assert not (ids_t == tenc.tokenizer.unk_id).any()
    # the seeded probe of the output center is drawn from the checkpoint's
    # path: the port's encoder takes the twin's
    tenc.cfg = replace(tenc.cfg, name=checkpoint["twin"])
    tenc.params["out_center"] = te._compute_out_center(tenc.params, tenc.cfg)
    tenc.cfg = replace(tenc.cfg, compute_dtype="float32")
    jenc.cfg = replace(jenc.cfg, compute_dtype="float32")
    np.testing.assert_allclose(tenc.encode(texts), jenc.encode(texts), rtol=0, atol=1e-5)


def _pointed_at(prefix, model, dst_dir):
    """A copy of the index at ``prefix`` whose meta names ``model`` and the
    copy's passages."""
    os.makedirs(dst_dir, exist_ok=True)
    src_dir, base = os.path.split(prefix)
    for f in os.listdir(src_dir):
        if f.startswith(base + "."):
            shutil.copy(os.path.join(src_dir, f), dst_dir)
    out = os.path.join(dst_dir, base)
    meta = json.load(open(out + ".meta.json"))
    meta["embedding_model"] = model
    for src in meta["passage_sources"]:
        src.update(path=out + ".passages.jsonl", index_path=out + ".passages.idx")
    json.dump(meta, open(out + ".meta.json", "w"))
    return out


@pytest.fixture(scope="module")
def indexes(checkpoint):
    import leann_torch
    import leann_tpu
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    d, chunks = checkpoint["dir"], checkpoint["chunks"]
    te._ENCODER_CACHE.clear()
    je._ENCODER_CACHE.clear()
    paths = {}
    for backend in ("diskann", "flat"):
        paths[backend, "torch"] = str(d / f"{backend}_torch.leann")
        _build(leann_torch, backend, checkpoint["model"], chunks, paths[backend, "torch"])
        paths[backend, "jax"] = str(d / f"{backend}_jax.leann")
        _build(leann_tpu, backend, checkpoint["twin"], chunks, paths[backend, "jax"])
        paths[backend, "torch_for_jax"] = _pointed_at(paths[backend, "torch"], checkpoint["twin"],
                                                      str(d / f"{backend}_torch_for_jax"))
    te._ENCODER_CACHE.clear()  # fresh encoders: only <prefix>.calib.npz carries the calibration
    je._ENCODER_CACHE.clear()
    return paths


@pytest.mark.parametrize("backend", ["diskann", "flat"])
def test_indexes_search_the_same_in_both_packages(checkpoint, indexes, backend):
    """Each package's index, searched by each package: the same top-3
    labels; the token stores are equal."""
    import leann_torch
    import leann_tpu
    from leann_torch.storage import load_token_cache

    queries = checkpoint["queries"]
    kw = KW if backend == "diskann" else dict(top_k=3)
    tok = {n: load_token_cache(indexes[backend, n]) for n in ("torch", "jax")}
    if tok["torch"] is not None:
        np.testing.assert_array_equal(tok["torch"][0], tok["jax"][0])
    labels = {
        ("torch", "torch"): _ids(leann_torch.LeannSearcher(indexes[backend, "torch"], device="cpu").search(queries,
                                                                                                        **kw)),
        ("torch", "jax"): _ids(leann_tpu.LeannSearcher(indexes[backend, "torch_for_jax"]).search(queries, **kw)),
        ("jax", "torch"): _ids(leann_torch.LeannSearcher(indexes[backend, "jax"], device="cpu").search(queries, **kw)),
        ("jax", "jax"): _ids(leann_tpu.LeannSearcher(indexes[backend, "jax"]).search(queries, **kw)),
    }
    for built in ("torch", "jax"):
        assert labels[built, "torch"] == labels[built, "jax"], built
    assert np.mean([set(a) == set(b) for a, b in zip(labels["torch", "torch"], labels["jax", "jax"])]) >= 0.9


def _electra(path, embedding_size):
    cfg = transformers.ElectraConfig(vocab_size=120, embedding_size=embedding_size, hidden_size=32,
                                     num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                                     max_position_embeddings=64, hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0)
    torch.manual_seed(4)
    transformers.ElectraForPreTraining(cfg).save_pretrained(str(path))
    return str(path)


def test_electra_loads_the_jax_packages_tree(tmp_path):
    """ElectraForPreTraining's keys sit under electra.; the head
    (discriminator_predictions) is dropped. With embedding_size below the
    hidden size the checkpoint has an embeddings_project, which neither
    encoder runs: the port's loader names it."""
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    path = _electra(tmp_path / "electra", 32)
    keys = te.read_safetensors(os.path.join(path, "model.safetensors"))
    assert any(k.startswith("electra.") for k in keys) and any(k.startswith("discriminator_") for k in keys)
    got, _ = te.load_hf_weights(path)
    _assert_same_tree(got, je.load_hf_weights(path)[0])
    small = _electra(tmp_path / "electra_small", 16)
    with pytest.raises(ValueError, match="embeddings_project"):
        te.load_hf_weights(small)
