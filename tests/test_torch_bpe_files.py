"""A RoBERTa directory whose only tokenizer files are ``vocab.json`` +
``merges.txt``, read by leann_torch as ``transformers``' ``RobertaConverter``
converts them, against the JAX package's HFTokenizer (``AutoTokenizer``,
which loads such a directory as ``RobertaTokenizerFast``) on the same
directory (CPU).

The fixture: a byte-level BPE trained here with ``tokenizers`` on the
corpus and saved by ``save_model`` (``vocab.json``, and ``merges.txt`` with
its ``#version`` header). Varied: the class named by
``tokenizer_config.json`` with ``add_prefix_space`` false (the default) and
true, a ``merges.txt`` without the header (``RobertaTokenizer`` drops the
first line whatever it is, so the first merge is lost in both packages),
and no tokenizer config (the class from ``config.json``'s ``model_type``).
Ids and masks must be equal on the cases and on a hypothesis fuzz at
``max_length`` 8 and 64, also with ``transformers`` and ``tokenizers``
blocked.
"""

import builtins
import json
import sys

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from leann_torch.embeddings import tokenizer as tt  # noqa: E402

from test_torch_tokenizer_json import ALPHABET, CASES, CORPUS, _check  # noqa: E402

KINDS = {"roberta": {"tokenizer_class": "RobertaTokenizer"},
         "prefix_space": {"tokenizer_class": "RobertaTokenizerFast", "add_prefix_space": True},
         "no_version": {"tokenizer_class": "RobertaTokenizer"},
         "model_type": None}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe_files")
    b = tokenizers.ByteLevelBPETokenizer()
    b.train_from_iterator(CORPUS * 20, vocab_size=500, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
                          show_progress=False)
    out = {}
    for kind, cfg in KINDS.items():
        d = root / kind
        d.mkdir()
        b.save_model(str(d))
        if kind == "no_version":
            lines = (d / "merges.txt").read_text(encoding="utf-8").split("\n")
            assert lines[0].startswith("#version")
            (d / "merges.txt").write_text("\n".join(lines[1:]), encoding="utf-8")
        if cfg is None:
            (d / "config.json").write_text(json.dumps({"model_type": "roberta", "vocab_size": 500}))
        else:
            (d / "tokenizer_config.json").write_text(json.dumps(cfg))
        out[kind] = str(d)
    return out


@pytest.fixture(scope="module")
def readers(dirs):
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF

    tt._TOKENIZER_CACHE.clear()
    return {k: (tt.get_tokenizer(d, max_length=64), JaxHF(d)) for k, d in dirs.items()}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("max_length", [8, 64])
def test_cases_equal_the_jax_package(readers, kind, max_length):
    ours, jax = readers[kind]
    assert isinstance(ours, tt.BpeFilesTokenizer) and ours.tokenizer_class == "RobertaTokenizer"
    texts = CASES + CORPUS
    _check(ours.encode_batch(texts, max_length), jax.encode_batch(texts, max_length), texts)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.lists(st.sampled_from(ALPHABET), max_size=30).map("".join), min_size=1, max_size=5))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("max_length", [8, 64])
def test_fuzz_equals_the_jax_package(readers, kind, max_length, texts):
    ours, jax = readers[kind]
    _check(ours.encode_batch(texts, max_length), jax.encode_batch(texts, max_length), texts)


def test_the_header_line_is_dropped_whatever_it_holds(dirs, readers):
    """Without the #version line the first merge is gone; the prefix space
    changes the first word's ids; RoBERTa's <s> ... </s> and pad 1."""
    with_header = tt.read_merges(open(f"{dirs['roberta']}/merges.txt", encoding="utf-8").read())
    without = tt.read_merges(open(f"{dirs['no_version']}/merges.txt", encoding="utf-8").read())
    assert without == with_header[1:]
    assert tt.read_merges("#version: 0.2\na b\nc d\na b\n") == [("a", "b"), ("c", "d")]
    with pytest.raises(ValueError, match="two tokens"):
        tt.read_merges("#version\na b c\n")
    plain, spaced = readers["roberta"][0], readers["prefix_space"][0]
    assert plain.token_ids("Hello") != spaced.token_ids("Hello")
    ids, mask = plain.encode_batch(["hello"], 12)
    assert ids[0, 0] == 0 and 2 in ids[0].tolist() and ids[0, -1] == plain.pad_id == 1


def test_reads_without_transformers(dirs, readers, monkeypatch):
    real_import = builtins.__import__

    def guarded(name, *a, **kw):
        if name.split(".")[0] in ("transformers", "tokenizers"):
            raise ImportError(f"{name} is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] in ("transformers", "tokenizers")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", guarded)
    monkeypatch.setattr(tt, "_TOKENIZER_CACHE", {})
    for kind in ("roberta", "model_type"):
        tok = tt.get_tokenizer(dirs[kind], max_length=64)
        for L in (8, 64):
            _check(tok.encode_batch(CASES, L), readers[kind][0].encode_batch(CASES, L), CASES)


def test_missing_specials_raise(tmp_path):
    (tmp_path / "vocab.json").write_text(json.dumps({"a": 0, "b": 1}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\na b\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "RobertaTokenizer"}))
    with pytest.raises(ValueError, match="special tokens"):
        tt.get_tokenizer(str(tmp_path))
