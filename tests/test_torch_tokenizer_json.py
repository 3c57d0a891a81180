"""leann_torch's own tokenizer.json reader against the JAX package's
HFTokenizer (transformers' AutoTokenizer) on the CPU.

Fixture checkpoints are trained here with the ``tokenizers`` trainers on a
multilingual corpus, wrapped with ``tokenizer_object=`` and saved by
``save_pretrained``: a SentencePiece Unigram as ``XLMRobertaTokenizerFast``
(with XLM-R's published ``<s> $A </s>`` template, with no post-processor, and
with a ``Precompiled`` normalizer from the darts-clone writer below), a
byte-level BPE as ``RobertaTokenizerFast`` (``RobertaProcessing``; the
trainer's ``ByteLevel`` processor; ``add_prefix_space`` set in the config),
and a WordPiece as ``BertTokenizerFast``. Ids and masks must be equal on the
cases and on a hypothesis fuzz, at ``max_length`` 8 and 64, also with
``transformers`` blocked from import. Each normalizer and pre-tokenizer is
also held alone against the ``tokenizers`` component of the same spec.
"""

import base64
import builtins
import json
import os
import struct
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from leann_torch.embeddings import tokenizer as tt  # noqa: E402
from leann_torch.embeddings import tokenizer_json as tj  # noqa: E402

CORPUS = [
    "The cat sat on the mat. Don't stop: it's 12345 and 678!", "Café naïve straße façade über résumé",
    "中文测试，这是一个句子。日本語のテキストです。", "مرحبا بالعالم، هذه جملة عربية", "नमस्ते दुनिया, यह एक वाक्य है।",
    "Привет мир, это предложение", "Γειά σου κόσμε", "한국어 문장입니다", "emoji 👍 👩\u200d💻 and flags 🇩🇪",
    "ＡＢＣ full width ﬁ ligature ① circled", "price $5 ~x~ |y| <a> =b+ #tag @user 50% off", "w1 w22 w333 g1a d2x",
]
CASES = [
    "Café naïve", "Cafe\u0301 nai\u0308ve", "e\u0301 a\u0301b ä", "中文测试 and 日本語", "مرحبا بالعالم", "नमस्ते दुनिया",
    "👩\u200d💻 👍🏽 👨\u200d👩\u200d👧 🇩🇪🇫🇷", "ＡＢＣ ﬁ ① ｶﾞ", "a\x01b\x7fc\x1cd\x85e", "nbsp\xa0here\u3000and\u200bzero",
    "tab\there\nnew\r\nline   runs    of  spaces", "don't it's 'S THEY'LL w12345 2024", "x" * 300,
    "<s> </s> hello <mask> x", " <mask>", "<mask>", "ab<mask>cd", "a  <s>b", "", "   ", "\t", "\u0301",
]
ALPHABET = (list("abcXYZ019 .,!'-$<>/_") + [
            "\t", "\n", "\r", "\x01", "\x1c", "\x7f", "\x85", "\xa0", "\u3000", "\u200b",
            "\u200d", "\ufeff", "�", "é", "e", "\u0301", "\u0308", "ä", "ß", "Ü", "İ", "Σ", "中", "文", "，",
            "ｶ", "ﾞ", "Ａ", "ﬁ", "①", "²", "٣", "م", "ر", "ह", "ि", "्", "ँ", "ः", "한", "ᄀ", "ᅡ", "ᆨ",
            "👍", "🏽", "👩", "💻", "©", "🇩", "🇪", "«", "…", "€", "▁", "Ġ", "<s>", "</s>", "<mask>", " <mask>",
            "'s", "'ll", "##", "[UNK]", "w12", "d2x"])


def _train_unigram():
    u = tokenizers.SentencePieceUnigramTokenizer()
    u.train_from_iterator(CORPUS * 20, vocab_size=400, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
                          unk_token="<unk>", show_progress=False)
    return u._tokenizer


def _template(tok):
    tok.post_processor = tokenizers.processors.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
        special_tokens=[("<s>", tok.token_to_id("<s>")), ("</s>", tok.token_to_id("</s>"))])
    return tok


def darts_blob(rules):
    """A Precompiled charsmap: u32 LE trie size, a darts-clone double array
    over the rules' UTF-8 keys (a leaf's value: its replacement's offset),
    then the NUL-terminated replacements."""
    strings, values = b"", {}
    for key, rep in rules.items():
        values[key.encode()] = len(strings)
        strings += rep.encode() + b"\0"
    root = {}
    for key, v in values.items():
        node = root
        for c in key:
            node = node.setdefault(c, {})
        node[None] = v
    units, used, bases = {0: 0}, {0}, set()

    def place(node, pos):
        labels = ([0] if None in node else []) + sorted(c for c in node if c is not None)
        base = 1
        while base in bases or any(base ^ c in used for c in labels):
            base += 1
        bases.add(base)
        used.update(base ^ c for c in labels)
        units[pos] = units.get(pos, 0) | ((pos ^ base) << 10) | ((None in node) << 8)
        if None in node:
            units[base] = node[None] | (1 << 31)
        for c in sorted(c for c in node if c is not None):
            units[base ^ c] = c
            place(node[c], base ^ c)

    place(root, 0)
    # whole 256-unit blocks: a lookup of any byte from any base stays inside
    arr = [units.get(i, 0) for i in range(((max(max(units), max(bases)) >> 8) + 1) << 8)]
    trie = struct.pack(f"<{len(arr)}I", *arr)
    return struct.pack("<I", len(trie)) + trie + strings


PRECOMPILED_RULES = {"a": "Y", "a\u0301": "Z", "Ａ": "A", "ab": "X", "\r": " ", "\t": " ", "ﬁ": "fi", "①": "1",
                     "\xa0": " ", "é": "e", "中": "zh", "👍": "+1", "İ": "I", "\u3000": " "}


def _precompiled_normalizer():
    return tokenizers.normalizers.Sequence([
        tokenizers.normalizers.Precompiled(darts_blob(PRECOMPILED_RULES)),
        tokenizers.normalizers.Replace(tokenizers.Regex(" {2,}"), " ")])


def _fixture(kind, path):
    if kind.startswith("unigram"):
        tok = _train_unigram()
        if kind in ("unigram_template", "unigram_precompiled"):
            _template(tok)
        if kind == "unigram_precompiled":
            tok.normalizer = _precompiled_normalizer()
        transformers.XLMRobertaTokenizerFast(tokenizer_object=tok).save_pretrained(path)
    elif kind.startswith("bpe"):
        b = tokenizers.ByteLevelBPETokenizer()
        b.train_from_iterator(CORPUS * 20, vocab_size=500, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
                              show_progress=False)
        tok = b._tokenizer
        if kind != "bpe_bytelevel_post":
            tok.post_processor = tokenizers.processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
        transformers.RobertaTokenizerFast(tokenizer_object=tok,
                                          add_prefix_space=kind == "bpe_prefix_space").save_pretrained(path)
    else:
        w = tokenizers.BertWordPieceTokenizer(lowercase=True)
        w.train_from_iterator(CORPUS * 20, vocab_size=300, show_progress=False,
                              special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
        tok = w._tokenizer
        tok.post_processor = tokenizers.processors.BertProcessing(("[SEP]", tok.token_to_id("[SEP]")),
                                                                  ("[CLS]", tok.token_to_id("[CLS]")))
        transformers.BertTokenizerFast(tokenizer_object=tok, do_lower_case=True).save_pretrained(path)
    return path


KINDS = ["unigram_template", "unigram_null", "unigram_precompiled", "bpe_roberta", "bpe_bytelevel_post",
         "bpe_prefix_space", "wordpiece"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokjson")
    return {k: _fixture(k, str(root / k)) for k in KINDS}


@pytest.fixture(scope="module")
def expected(dirs):
    """The JAX package's ids and masks of CASES at each length, taken while
    transformers can be imported."""
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF

    return {k: {L: JaxHF(d).encode_batch(CASES, L) for L in (8, 64)} for k, d in dirs.items()}


def _check(ours, want, texts):
    ids, mask = ours
    assert ids.dtype == mask.dtype == np.int32
    for i, t in enumerate(texts):
        assert ids[i].tolist() == want[0][i].tolist(), repr(t)
        assert mask[i].tolist() == want[1][i].tolist(), repr(t)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_length", [8, 64])
def test_cases_equal_the_jax_package(dirs, expected, kind, max_length):
    tok = tj.JsonTokenizer(dirs[kind])
    _check(tok.encode_batch(CASES, max_length), expected[kind][max_length], CASES)


@pytest.mark.parametrize("kind", KINDS)
def test_pad_id_and_special_tokens(dirs, expected, kind):
    """XLM-R and RoBERTa pad with 1, BERT with 0; the template and the
    RoBERTa / BERT processors wrap the content, null and ByteLevel add
    nothing."""
    tok = tj.JsonTokenizer(dirs[kind])
    ids, mask = tok.encode_batch(["hello"], 16)
    assert tok.pad_id == (0 if kind == "wordpiece" else 1) and ids[0, -1] == tok.pad_id
    wrapped = kind not in ("unigram_null", "bpe_bytelevel_post")
    assert (len(tok.before), len(tok.after)) == ((1, 1) if wrapped else (0, 0))


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.lists(st.sampled_from(ALPHABET), max_size=30).map("".join), min_size=1, max_size=5))
@pytest.mark.parametrize("kind", KINDS)
def test_fuzz_equals_the_jax_package(dirs, kind, texts):
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF

    want = JaxHF(dirs[kind]).encode_batch(texts, 24)
    _check(tj.JsonTokenizer(dirs[kind]).encode_batch(texts, 24), want, texts)


@pytest.fixture()
def no_transformers(monkeypatch):
    """transformers and tokenizers unimportable, as on the card's machine;
    an empty tokenizer cache."""
    real_import = builtins.__import__

    def guarded(name, *a, **kw):
        if name.split(".")[0] in ("transformers", "tokenizers"):
            raise ImportError(f"{name} is blocked in this test")
        return real_import(name, *a, **kw)

    for mod in [m for m in sys.modules if m.split(".")[0] in ("transformers", "tokenizers")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", guarded)
    monkeypatch.setattr(tt, "_TOKENIZER_CACHE", {})


@pytest.mark.parametrize("kind", KINDS)
def test_cases_without_transformers(dirs, expected, kind, no_transformers):
    with pytest.raises(ImportError):
        import transformers as _  # noqa: F401
    tok = tt.get_tokenizer(dirs[kind], max_length=64)
    assert isinstance(tok, tj.JsonTokenizer)
    for L in (8, 64):
        _check(tok.encode_batch(CASES, L), expected[kind][L], CASES)


def test_wordpiece_json_equals_the_vocab_txt_route(dirs):
    """A BERT directory with both tokenizer.json and vocab.txt: the file
    route gives the WordPiece route's ids."""
    d = dirs["wordpiece"]
    assert os.path.exists(os.path.join(d, "vocab.txt"))
    ours, wp = tj.JsonTokenizer(d), tt.HFTokenizer(d)
    for L in (8, 64):
        a, b = ours.encode_batch(CASES, L), wp.encode_batch(CASES, L)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_truncation_keeps_room_for_the_special_tokens(dirs):
    tok = tj.JsonTokenizer(dirs["unigram_template"])
    content = tok.token_ids("w1 w22 w333 " * 10)
    ids, mask = tok.encode_batch(["w1 w22 w333 " * 10], 8)
    assert ids[0].tolist() == [0, *content[:6], 2] and mask[0].sum() == 8
    null = tj.JsonTokenizer(dirs["unigram_null"])
    assert null.encode_batch(["w1 w22 w333 " * 10], 8)[0][0].tolist() == null.token_ids("w1 w22 w333 " * 10)[:8]


# ---------------------------------------------------------------------------
# The components alone, against tokenizers' own
# ---------------------------------------------------------------------------

def _spec(normalizer=None, pre_tokenizer=None):
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [], "normalizer": normalizer,
            "pre_tokenizer": pre_tokenizer, "post_processor": None, "decoder": None,
            "model": {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0], ["a", -1.0]], "byte_fallback": False}}


def _backend(normalizer=None, pre_tokenizer=None):
    return tokenizers.Tokenizer.from_str(json.dumps(_spec(normalizer, pre_tokenizer)))


NORMALIZERS = {
    "nmt": {"type": "Nmt"}, "nfkc": {"type": "NFKC"}, "nfd": {"type": "NFD"}, "nfc": {"type": "NFC"},
    "nfkd": {"type": "NFKD"}, "lowercase": {"type": "Lowercase"}, "strip_accents": {"type": "StripAccents"},
    "strip": {"type": "Strip", "strip_left": True, "strip_right": True},
    "strip_right": {"type": "Strip", "strip_left": False, "strip_right": True},
    "replace_regex": {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "},
    "replace_string": {"type": "Replace", "pattern": {"String": "ab"}, "content": "<>"},
    "bert": {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True, "strip_accents": None,
             "lowercase": True},
    "bert_cased": {"type": "BertNormalizer", "clean_text": False, "handle_chinese_chars": False,
                   "strip_accents": True, "lowercase": False},
    "xlmr_sequence": {"type": "Sequence", "normalizers": [
        {"type": "Nmt"}, {"type": "NFKC"}, {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
    "precompiled": {"type": "Precompiled",
                    "precompiled_charsmap": base64.b64encode(darts_blob(PRECOMPILED_RULES)).decode()},
}
PRE_TOKENIZERS = {
    "metaspace_always": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
    "metaspace_first": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True},
    "metaspace_never": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": True},
    "metaspace_nosplit": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": False},
    "metaspace_legacy": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
    "bytelevel": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True},
    "bytelevel_prefix": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
    "bytelevel_noregex": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False},
    "whitespace_split": {"type": "WhitespaceSplit"}, "whitespace": {"type": "Whitespace"},
    "bert": {"type": "BertPreTokenizer"},
    "sequence": {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"},
                                                       {"type": "Metaspace", "replacement": "▁",
                                                        "prepend_scheme": "first", "split": True}]},
}
COMPONENT_ALPHABET = [c for c in ALPHABET if len(c) == 1] + ["  ", "   ", "'re", "'ve", "'d", "'m", "'t", "'S", "ab",
                                                              "Ⅳ", "\u200c", "ǅ", "ﾞ", "\u3000"]


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from(COMPONENT_ALPHABET), max_size=40).map("".join))
@pytest.mark.parametrize("name", list(NORMALIZERS))
def test_normalizer_equals_tokenizers(name, text):
    want = _backend(normalizer=NORMALIZERS[name]).normalizer.normalize_str(text)
    assert tj.make_normalizer(NORMALIZERS[name])(text) == want


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from(COMPONENT_ALPHABET), max_size=40).map("".join))
@pytest.mark.parametrize("name", list(PRE_TOKENIZERS))
def test_pre_tokenizer_equals_tokenizers(name, text):
    want = [w for w, _ in _backend(pre_tokenizer=PRE_TOKENIZERS[name]).pre_tokenizer.pre_tokenize_str(text)]
    assert tj.make_pre_tokenizer(PRE_TOKENIZERS[name])([text] if text else [], True)[0] == want


def test_precompiled_works_by_grapheme_cluster():
    """The shortest key that prefixes a cluster under 6 bytes replaces the
    whole cluster; a key across two clusters never fires."""
    pc = tj.Precompiled(darts_blob({"a": "Y"}))
    assert pc("a\u0301b") == "Yb"
    assert tj.Precompiled(darts_blob({"a": "Y", "a\u0301": "Z"}))("a\u0301b") == "Yb"
    assert tj.Precompiled(darts_blob({"Ａ": "A"}))("Ａ\u0301") == "A"
    assert tj.Precompiled(darts_blob({"ab": "X"}))("ab") == "ab"
    # a conjunct is one cluster of 11 bytes, so each code point is looked
    # up alone: the accent stays (split after the virama, the short cluster
    # "ह\u0301" would go whole)
    assert tj.Precompiled(darts_blob({"ह": "X"}))("ह्ह\u0301") == "X्X\u0301"
    for rules, text in (({"a": "Y"}, "a\u0301b"), ({"a": "Y", "a\u0301": "Z"}, "a\u0301b"), ({"Ａ": "A"}, "Ａ\u0301"),
                        ({"ab": "X"}, "ab"), ({"ह": "X"}, "ह्ह\u0301")):
        want = tokenizers.normalizers.Precompiled(darts_blob(rules)).normalize_str(text)
        assert tj.Precompiled(darts_blob(rules))(text) == want


# a consonant, its script's virama and a consonant: one cluster (GB9c),
# in each of the six scripts Unicode 15.1 gives conjunct linkers
CONJUNCTS = ["ह्ह", "ক্ষ", "ક્ષ", "କ୍ଷ", "క్ష", "ക്ഷ"]


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from(COMPONENT_ALPHABET + ["ำ", "ः", "\U000e0041", "؀", "ힰ"]
                                + sorted(set("".join(CONJUNCTS)))),
                max_size=30).map("".join))
@example("ह्ह")
@example("ক্ষ")
@example("ક્ષ")
@example("କ୍ଷ")
@example("క్ష")
@example("ക്ഷ")
def test_graphemes_equal_the_regex_module(text):
    regex = pytest.importorskip("regex")
    assert tj.graphemes(text) == regex.findall(r"\X", text)


def test_gpt2_split_needs_no_unicode_properties():
    for split in (tj.gpt2_split, tj.compile_onig(tj.GPT2_PATTERN).findall):
        assert split("Hello world's 123  x\t\ty") == ["Hello", " world", "'s", " 123", " ", " x", "\t", "\t", "y"]
        assert split("a  ") == ["a", "  "]
    assert tj.gpt2_split("naïve 'S ٣٤") == ["naïve", " '", "S", " ٣٤"]  # not ASCII: the translated pattern


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(list("abZ09 '\t\n\x0b\x0c\r\x1c\x1f\x00!.-_sStmdrevl") + ["'s", "'ll", "'re", "  "]),
                max_size=20).map("".join))
def test_gpt2_split_over_ascii_equals_the_scanner(text):
    """ASCII text takes a re pattern with the classes spelled out, which
    splits as the translated GPT-2 pattern does."""
    assert tj.gpt2_split(text) == tj.compile_onig(tj.GPT2_PATTERN).findall(text)


def test_unknown_components_raise_not_ported(tmp_path):
    """Components the reader does not run raise, naming themselves: an
    unknown normalizer, the UnicodeScripts pre-tokenizer, a Split regex
    with a script property, an unknown post-processor, BPE dropout."""
    base = _spec()
    bpe = {"type": "BPE", "vocab": {"<unk>": 0, "a": 1}, "merges": [], "dropout": 0.1}
    for field, spec, name in (("normalizer", {"type": "Weird"}, "Weird"),
                              ("pre_tokenizer", {"type": "UnicodeScripts"}, "UnicodeScripts"),
                              ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Han}+"},
                                                 "behavior": "Removed", "invert": False}, "Han"),
                              ("post_processor", {"type": "Weird"}, "Weird"),
                              ("model", bpe, "dropout")):
        d = tmp_path / f"{field}_{name}"
        d.mkdir()
        (d / "tokenizer.json").write_text(json.dumps({**base, field: spec, "added_tokens": [
            {"id": 0, "content": "<unk>", "special": True}]}))
        (d / "tokenizer_config.json").write_text(json.dumps({"pad_token": "<unk>"}))
        with pytest.raises(NotImplementedError, match=name):
            tj.JsonTokenizer(str(d))
    (tmp_path / "cls").mkdir()
    (tmp_path / "cls" / "tokenizer.json").write_text(json.dumps(base))
    (tmp_path / "cls" / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "T5Tokenizer"}))
    with pytest.raises(NotImplementedError, match="T5Tokenizer"):
        tt.get_tokenizer(str(tmp_path / "cls"))


def test_memo_is_bounded(dirs, monkeypatch):
    tok = tj.JsonTokenizer(dirs["unigram_template"])
    monkeypatch.setattr(tj, "_MEMO_WORDS", 8)
    want = [tj.JsonTokenizer(dirs["unigram_template"]).token_ids(f"w{i} d{i}x naïve") for i in range(40)]
    assert [tok.token_ids(f"w{i} d{i}x naïve") for i in range(40)] == want
    assert len(tok._memo) <= 8
