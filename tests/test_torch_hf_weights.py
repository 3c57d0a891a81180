"""leann_torch's local HF checkpoint path against the JAX package's (CPU).

A tiny BertModel made by ``transformers`` (as tests/test_hf_weights.py makes
it) is read by both packages' ``load_hf_weights``: the port parses the files
itself (safetensors by hand, ``pytorch_model.bin`` through ``torch.load``),
the JAX package through ``AutoModel``. Trees must be equal leaf for leaf in
f32. The port's ``save_hf_weights`` writes a checkpoint ``AutoModel`` and the
JAX loader read back to the same tree; ``calibrate`` agrees with
``JaxEncoder.calibrate`` on the f32 forward within 1e-4 (mean and projector).
"""

import builtins
import json
import logging
import os
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from leann_torch.embeddings import encoder as te  # noqa: E402
from leann_tpu.embeddings import encoder as je  # noqa: E402

WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "sun", "moon", "star", "tree", "river", "stone",
         "red", "blue", "green", "big", "small", "fast", "slow"]


def _vocab():
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789")
    v = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + ["##" + c for c in chars] + WORDS + ["!", ",", "."]
    return v + [f"[unused{i}]" for i in range(120 - len(v))]


def _bert(path, model_cls=None, dtype=None, safe=True, seed=0):
    from transformers import BertConfig, BertModel

    cfg = BertConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    model = (model_cls or BertModel)(cfg).eval()
    with torch.no_grad():  # non-zero token-type rows and LayerNorm parameters, so the fold is seen
        for name, p in model.named_parameters():
            if "token_type" in name or "LayerNorm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    if dtype is not None:
        model = model.to(dtype)
    model.save_pretrained(str(path), safe_serialization=safe)
    return str(path), model


def _with_vocab(path):
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(_vocab()) + "\n")
    from transformers import BertTokenizerFast

    BertTokenizerFast(vocab_file=os.path.join(path, "vocab.txt"), do_lower_case=True).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    return _bert(tmp_path_factory.mktemp("hf") / "tiny-bert")


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _same_cfg(a, b):
    keys = ("vocab_size", "dim", "n_layers", "n_heads", "mlp_dim", "max_len", "arch", "normalize", "center")
    return all(getattr(a, k) == getattr(b, k) for k in keys)


def test_load_equals_jax_leaf_for_leaf(tiny_bert):
    path, _ = tiny_bert
    got, cfg_t = te.load_hf_weights(path)
    want, cfg_j = je.load_hf_weights(path)
    _assert_same_tree(got, want)
    assert _same_cfg(cfg_t, cfg_j) and cfg_t.name == cfg_j.name == path


def test_load_needs_neither_safetensors_nor_transformers(tiny_bert, monkeypatch):
    """The safetensors file is parsed by hand: with both modules unimportable
    the port reads the same tree."""
    path, _ = tiny_bert
    want, _ = je.load_hf_weights(path)
    real_import = builtins.__import__

    def guarded(name, *a, **kw):
        if name.split(".")[0] in ("safetensors", "transformers"):
            raise ImportError(f"{name} is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] in ("safetensors", "transformers")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", guarded)
    got, _ = te.load_hf_weights(path)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("variant", ["pytorch_model.bin", "float16", "bfloat16", "bert_prefixed"])
def test_load_other_files_equals_jax(tmp_path, variant):
    """``pytorch_model.bin`` (torch.load, weights only), F16 / BF16
    safetensors widened to f32, and a checkpoint saved from ``BertForMaskedLM``
    whose keys carry ``bert.``: the port's tree equals the JAX package's."""
    from transformers import BertForMaskedLM

    kw = {"pytorch_model.bin": dict(safe=False), "float16": dict(dtype=torch.float16),
          "bfloat16": dict(dtype=torch.bfloat16), "bert_prefixed": dict(model_cls=BertForMaskedLM)}[variant]
    path, _ = _bert(tmp_path / variant, **kw)
    files = set(os.listdir(path))
    assert ("pytorch_model.bin" in files) == (variant == "pytorch_model.bin")
    if variant == "bert_prefixed":
        header = te.read_safetensors(os.path.join(path, "model.safetensors"))
        assert any(k.startswith("bert.") for k in header)
    got, _ = te.load_hf_weights(path)
    want, _ = je.load_hf_weights(path)
    _assert_same_tree(got, want)


def test_old_layernorm_names_are_renamed(tmp_path, tiny_bert):
    """LayerNorm ``gamma`` / ``beta`` keys of an old ``pytorch_model.bin``
    read as ``weight`` / ``bias``, as AutoModel renames them."""
    path, model = tiny_bert
    sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"): v
          for k, v in model.state_dict().items()}
    out = tmp_path / "old"
    out.mkdir()
    torch.save(sd, out / "pytorch_model.bin")
    (out / "config.json").write_text(open(os.path.join(path, "config.json")).read())
    got, _ = te.load_hf_weights(str(out))
    want, _ = je.load_hf_weights(path)
    _assert_same_tree(got, want)


def test_save_loads_in_transformers_and_jax(tiny_bert, tmp_path):
    """The port's writer, without transformers: AutoModel loads it (every
    encoder weight equal to the original, token types zero) and the JAX
    loader reads the same tree back."""
    path, model = tiny_bert
    tree, cfg = te.load_hf_weights(path)
    out = str(tmp_path / "saved")
    te.save_hf_weights(tree, cfg, out)
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    hf = json.load(open(os.path.join(out, "config.json")))
    assert hf["model_type"] == "bert" and hf["architectures"] == ["BertModel"] and hf["type_vocab_size"] == 2
    loaded = transformers.AutoModel.from_pretrained(out, local_files_only=True).eval()
    sd_new, sd_old = loaded.state_dict(), model.state_dict()
    for k, v in sd_old.items():
        if k.startswith("pooler.") or "position_ids" in k:
            continue
        if k == "embeddings.token_type_embeddings.weight":
            assert not sd_new[k].any()
        elif k == "embeddings.word_embeddings.weight":  # token type 0 folded in
            torch.testing.assert_close(sd_new[k], v + sd_old["embeddings.token_type_embeddings.weight"][0],
                                       rtol=0, atol=0)
        else:
            assert torch.equal(sd_new[k], v), k
    _assert_same_tree(je.load_hf_weights(out)[0], tree)
    _assert_same_tree(te.load_hf_weights(out)[0], tree)


def test_jax_writer_output_loads_in_port(tiny_bert, tmp_path):
    path, _ = tiny_bert
    tree, cfg = je.load_hf_weights(path)
    out = str(tmp_path / "jax-saved")
    je.save_hf_weights(tree, cfg, out)
    _assert_same_tree(te.load_hf_weights(out)[0], je.load_hf_weights(out)[0])


@pytest.mark.parametrize("route", ["tokenizer.json", "vocab.txt"])
def test_encoder_from_dir_matches_jax(tiny_bert, tmp_path, route):
    """TorchEncoder(<dir>) takes the checkpoint's weights and its saved
    WordPiece, by either route: tokenizer.json first, as AutoTokenizer, or
    vocab.txt alone (the directory's tokenizer.json removed); the same
    embeddings as JaxEncoder(<dir>) within the bf16 forward's tolerance
    (tests/test_torch_encoder.py)."""
    path = _with_vocab(_bert(tmp_path / "with-vocab")[0])
    if route == "vocab.txt":
        os.remove(os.path.join(path, "tokenizer.json"))
    texts = ["the cat sat on the mat", "dogs ran", "the big red star!", "moon, sun. tree"]
    want = je.JaxEncoder(path, max_length=16)
    got = te.TorchEncoder(path, max_length=16, device="cpu")
    assert got.loaded_hf and want.loaded_hf and got.needs_corpus_calibration
    assert type(got.tokenizer).__name__ == {"tokenizer.json": "JsonTokenizer", "vocab.txt": "HFTokenizer"}[route]
    assert _same_cfg(got.cfg, want.cfg)
    np.testing.assert_allclose(got.params["out_center"].numpy(), np.asarray(want.params["out_center"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.encode(texts), want.encode(texts), rtol=0, atol=2e-3)


def test_calibrate_matches_jax(tiny_bert, tmp_path):
    """On the f32 forward: the same mean within 1e-4 and the same projector
    out_pc @ out_pc.T within 1e-4 (the SVD's signs are arbitrary)."""
    path = _with_vocab(_bert(tmp_path / "calib")[0])
    rng = np.random.default_rng(11)
    texts = [" ".join(rng.choice(WORDS, int(rng.integers(3, 12)))) for _ in range(300)]
    jenc = je.JaxEncoder(path, max_length=16)
    tenc = te.TorchEncoder(path, max_length=16, device="cpu")
    jenc.cfg = replace(jenc.cfg, compute_dtype="float32")
    tenc.cfg = replace(tenc.cfg, compute_dtype="float32")
    want = jenc.calibrate(texts)
    got = tenc.calibrate(texts)
    assert got["out_pc"].shape == want["out_pc"].shape == (32, 8)
    np.testing.assert_allclose(got["out_center"], want["out_center"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["out_pc"] @ got["out_pc"].T, want["out_pc"] @ want["out_pc"].T, rtol=0, atol=1e-4)
    assert torch.equal(tenc.params["out_pc"], torch.from_numpy(got["out_pc"]))
    # a calibrated encode agrees too
    np.testing.assert_allclose(tenc.encode(texts[:8]), jenc.encode(texts[:8]), rtol=0, atol=1e-4)
    # fewer texts than components: k = n - 1
    assert tenc.calibrate(texts[:3])["out_pc"].shape == (32, 2)


def test_vocab_clamp_with_explicit_params(tiny_bert):
    """params= with a 120-row table on a directory without tokenizer files:
    the hash tokenizer's ids stay under 120, as in the JAX package."""
    path, _ = tiny_bert
    tree, _ = je.load_hf_weights(path)
    text = ["hello world foo bar baz qux quux corge"]
    jenc = je.JaxEncoder(path, max_length=32, params=tree)
    tenc = te.TorchEncoder(path, max_length=32, device="cpu", params=tree)
    assert tenc.cfg.vocab_size == jenc.cfg.vocab_size == 120
    ids_t, mask_t = tenc.tokenize(text)
    ids_j, mask_j = jenc.tokenize(text)
    assert ids_t.max() < 120
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    # and through the checkpoint load (no params=): the checkpoint's vocab
    ids_l, _ = te.TorchEncoder(path, max_length=32, device="cpu").tokenize(text)
    np.testing.assert_array_equal(ids_l, ids_j)


def test_unreadable_dir_warns_and_seeds(tmp_path, caplog):
    """A directory that is not a readable checkpoint: the JAX package's
    warning, seeded weights, no corpus calibration."""
    d = tmp_path / "broken"
    d.mkdir()
    (d / "config.json").write_text("{not json")
    with caplog.at_level(logging.WARNING):
        enc = te.TorchEncoder(str(d), max_length=16, device="cpu")
    assert "could not load HF weights" in caplog.text
    assert not enc.loaded_hf and not enc.needs_corpus_calibration and enc.cfg.arch == "prenorm"
    assert type(enc.tokenizer).__name__ == "HashTokenizer"
