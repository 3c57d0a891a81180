"""leann_torch's own BERT WordPiece against transformers' BertTokenizerFast (CPU).

The same vocab directory goes to both: ids and masks must be equal on every
case (ASCII, case, accents, punctuation, CJK, control characters, special
tokens' text, over-long words, truncation, padding) and on a hypothesis
fuzz. ``get_tokenizer``'s routing is checked with ``transformers`` blocked
from import on the port's side.
"""

import builtins
import json
import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

transformers = pytest.importorskip("transformers")

from leann_torch.embeddings import tokenizer as tt  # noqa: E402

CHARS = list("abcdefghijklmnopqrstuvwxyz0123456789")
WORDS = ["the", "cat", "sat", "on", "mat", "run", "##ning", "##s", "cafe", "naive", "uber", "über", "straße",
         "ß", "é", "σ", "ς", "中", "文", "，", "。", "«", "»", "¿", "¡", "–", "—", "…", "×", "÷", "€", "£", "ǆ",
         "!", ",", ".", "'", "-", "$", "^", "`", "~", "|", "<", ">", "=", "+", "(", ")", "[", "]", "{", "}",
         "@", "#", "%", "&", "*", "/", "\\", ":", ";", "?", "_", '"']
VOCAB = list(dict.fromkeys(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + CHARS + ["##" + c for c in CHARS]
                           + WORDS))
CASES = [
    "The cat sat on the mat!", "running cats", "Café naïve ÜBER straße STRASSE", "İstanbul ΣΑΣ σας",
    "中文，测试。", "a\x0bb\x0cc\x1cd\x85e\u2028f\u200bg\ufeffh\x00i\ufffdj\x7fk",
    "tab\there\nnew\rline  double  space", "", "   ", "x" * 101 + " cat", "y" * 100 + " cat",
    "hello [MASK] world[SEP]x [cls]", "price $5^2 `x` ~y~ |z| <a> =b+", "«quoted» ¿qué? ¡sí! – — …",
    "e\u0301 ä", "ǅ Ǆ", "１２３ ＡＢＣ", "don't stop-me now", "cat " * 40,
]
ALPHABET = list("abcXYZ019 .,!'-[]$") + ["\t", "\n", "\x0b", "\x1c", "\x7f", "\x00", "é", "Ü", "ß", "中", "，", "σ",
                                          "Σ", "\u0301", "\u200b", "\u3000", "\xa0", "«", "…", "€", "ǅ",
                                          "[MASK]", "[CLS]", "##s", "ning"]


def _vocab_dir(path, **tok_kw):
    os.makedirs(path, exist_ok=True)
    vf = os.path.join(path, "vocab.txt")
    with open(vf, "w", encoding="utf-8") as f:
        f.write("\n".join(VOCAB) + "\n")
    transformers.BertTokenizerFast(vocab_file=vf, **tok_kw).save_pretrained(path)
    return path


TOKENIZER_KWARGS = {
    "uncased": dict(do_lower_case=True),
    "cased": dict(do_lower_case=False),
    "uncased_keep_accents": dict(do_lower_case=True, strip_accents=False),
    "cased_strip_accents": dict(do_lower_case=False, strip_accents=True),
    "no_chinese_chars": dict(do_lower_case=True, tokenize_chinese_chars=False),
}


@pytest.fixture(scope="module", params=list(TOKENIZER_KWARGS))
def pair(request, tmp_path_factory):
    path = _vocab_dir(str(tmp_path_factory.mktemp("wp") / request.param), **TOKENIZER_KWARGS[request.param])
    return tt.HFTokenizer(path), transformers.BertTokenizerFast.from_pretrained(path)


def _check(ours, hf, texts, max_length):
    ids, mask = ours.encode_batch(texts, max_length)
    want = hf(list(texts), padding="max_length", truncation=True, max_length=max_length, return_tensors="np")
    assert ids.dtype == mask.dtype == np.int32
    for i, t in enumerate(texts):
        assert ids[i].tolist() == want["input_ids"][i].tolist(), repr(t)
        assert mask[i].tolist() == want["attention_mask"][i].tolist(), repr(t)


@pytest.mark.parametrize("max_length", [4, 16, 64])
def test_cases_equal_bert_tokenizer_fast(pair, max_length):
    ours, hf = pair
    _check(ours, hf, CASES, max_length)


def test_unknown_words_and_word_length_limit(pair):
    ours, hf = pair
    ids = ours.token_ids("q" * 100 + " " + "q" * 101)  # 100 pieces, then one [UNK]
    assert len(ids) == 101 and ids[-1] == ours.unk_id not in ids[:-1]
    _check(ours, hf, ["zzz ∂ ☃ qqq"], 16)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.lists(st.sampled_from(ALPHABET), max_size=40).map("".join), min_size=1, max_size=6))
def test_fuzz_equals_bert_tokenizer_fast(pair, texts):
    ours, hf = pair
    _check(ours, hf, texts, 24)


@pytest.fixture()
def uncased(tmp_path):
    path = _vocab_dir(str(tmp_path / "v"), do_lower_case=True)
    return path, transformers.BertTokenizerFast.from_pretrained(path)


@pytest.fixture()
def no_transformers(monkeypatch):
    """transformers unimportable, as on a machine without it; an empty
    tokenizer cache."""
    real_import = builtins.__import__

    def guarded(name, *a, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("transformers is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] == "transformers"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", guarded)
    monkeypatch.setattr(tt, "_TOKENIZER_CACHE", {})


def test_routing_without_transformers(uncased, no_transformers, tmp_path):
    """The routing cases with transformers blocked: a directory with
    tokenizer.json -> the port's reader of it, first (cached; the saved BERT
    directory holds vocab.txt too, and its WordPiece gives the same ids), and
    a Unigram, BPE or WordPiece tokenizer.json alone; vocab.txt alone ->
    WordPiece (no tokenizer_config.json: uncased, accents stripped); no
    tokenizer files -> the hash tokenizer at the given vocab; a
    sentencepiece model or vocab.json + merges.txt alone, a tokenizer.json
    with no model, or another tokenizer class -> not ported; a vocab.txt
    that cannot be read, or one without the special tokens -> raises."""
    from leann_torch.embeddings.tokenizer_json import JsonTokenizer

    path, hf = uncased
    with pytest.raises(ImportError):
        import transformers as _  # noqa: F401
    tok = tt.get_tokenizer(path, vocab_size=len(VOCAB), max_length=16)
    assert isinstance(tok, JsonTokenizer) and tok.vocab_size == len(VOCAB)
    assert tt.get_tokenizer(path, vocab_size=len(VOCAB), max_length=16) is tok
    _check(tok, hf, CASES, 16)
    _check(tt.HFTokenizer(path), hf, CASES, 16)

    def mkdir(name, **files):
        d = tmp_path / name
        d.mkdir()
        for fname, data in files.items():
            f = d / fname.replace("__", ".")
            f.write_bytes(data) if isinstance(data, bytes) else f.write_text(data, encoding="utf-8")
        return str(d)

    vocab_text = "\n".join(VOCAB) + "\n"
    bare = tt.get_tokenizer(mkdir("bare", vocab__txt=vocab_text), max_length=16)
    assert isinstance(bare, tt.HFTokenizer) and bare.lowercase and bare.strip_accents
    _check(bare, hf, CASES, 16)
    hashed = tt.get_tokenizer(mkdir("weights_only", config__json="{}"), vocab_size=120, max_length=16)
    assert isinstance(hashed, tt.HashTokenizer) and hashed.vocab_size == 120
    assert isinstance(tt.get_tokenizer("hash-minilm"), tt.HashTokenizer)
    for d in (mkdir("sp", spiece__model=b"\x00"), mkdir("tj", tokenizer__json="{}"),
              mkdir("roberta", vocab__txt=vocab_text, tokenizer_config__json='{"tokenizer_class": "RobertaTokenizer"}'),
              mkdir("bpe_files", vocab__json='{"a": 0}', merges__txt="#version: 0.2\n")):
        with pytest.raises(NotImplementedError, match=r"not ported.*§A #4"):
            tt.get_tokenizer(d)

    def tokenizer_json(model, pre_tokenizer=None, post_processor=None):
        return json.dumps({"version": "1.0", "added_tokens": [], "normalizer": None, "pre_tokenizer": pre_tokenizer,
                           "post_processor": post_processor, "model": model})

    config = json.dumps({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>"})
    unigram = {"type": "Unigram", "unk_id": 1, "vocab": [["<pad>", 0.0], ["<unk>", 0.0], ["\u2581", -2.0],
                                                          ["\u2581ab", -1.0], ["c", -3.0]]}
    bpe = {"type": "BPE", "vocab": {"<pad>": 0, "a": 1, "b": 2, "c": 3, "ab": 4, "abc": 5},
           "merges": [["a", "b"], "ab c"]}
    wp = {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
          "max_input_chars_per_word": 100, "vocab": {"[PAD]": 0, "[UNK]": 1, "ab": 2, "##c": 3}}
    routes = {
        "unigram": (unigram, {"type": "Metaspace", "replacement": "\u2581", "prepend_scheme": "always"}, [3, 4, 1]),
        "bpe": (bpe, {"type": "WhitespaceSplit"}, [5, 4]),
        "wordpiece": (wp, {"type": "BertPreTokenizer"}, [2, 3, 2]),
    }
    for name, (model, pre, want) in routes.items():
        d = mkdir(f"json_{name}", tokenizer__json=tokenizer_json(model, pre),
                  tokenizer_config__json=config.replace("<pad>", "[PAD]") if name == "wordpiece" else config)
        tj = tt.get_tokenizer(d, max_length=6)
        assert isinstance(tj, JsonTokenizer) and tj.pad_id == 0
        ids, mask = tj.encode(["abcd", "abc ab", "abc ab"][list(routes).index(name)])
        assert ids.tolist() == want + [0] * (6 - len(want)) and mask.tolist() == [1] * len(want) + [0] * (6 - len(want))
    with pytest.raises(UnicodeDecodeError):
        tt.get_tokenizer(mkdir("bad_utf8", vocab__txt=b"[PAD]\n\xff\xfe\n"))
    (tmp_path / "dir_vocab" / "vocab.txt").mkdir(parents=True)
    with pytest.raises(IsADirectoryError):
        tt.get_tokenizer(str(tmp_path / "dir_vocab"))
    with pytest.raises(ValueError, match="special tokens"):
        tt.get_tokenizer(mkdir("no_specials", vocab__txt="a\nb\n"))


def test_memo_is_bounded(tmp_path, monkeypatch):
    path = _vocab_dir(str(tmp_path / "v"), do_lower_case=True)
    from leann_torch.embeddings import tokenizer_json as tj

    tok = tt.HFTokenizer(path)
    monkeypatch.setattr(tj, "_MEMO_WORDS", 8)
    want = [tok.token_ids(f"cat{i} run{i}ning") for i in range(40)]
    assert len(tok._memo) <= 8
    fresh = tt.HFTokenizer(path)
    assert [fresh.token_ids(f"cat{i} run{i}ning") for i in range(40)] == want
