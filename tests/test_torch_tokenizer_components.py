"""The tokenizer.json components leann_torch's reader gained for the last
of its refusals, each held alone against the ``tokenizers`` component of the
same spec and in whole pipelines against the JAX package's HFTokenizer
(``AutoTokenizer``) on the CPU.

Alone: the ``Prepend`` normalizer, the ``Digits`` (``individual_digits``
either way), ``Punctuation`` (each behaviour) and ``Split`` pre-tokenizers
(a string and a regex, each behaviour, ``invert``; GPT-2's, a cl100k-style
and a Qwen2-style pattern, whose ``\\p{..}`` classes the reader builds from
``unicodedata``), the ``WordLevel`` model, and ``byte_fallback`` in Unigram
and BPE. In pipelines trained here with the ``tokenizers`` trainers and
wrapped by ``PreTrainedTokenizerFast(tokenizer_object=...)``: a WordLevel
over a Split, a GPT-4-style byte-level BPE (Split then ByteLevel without its
own regex), a Llama-2-style BPE (``Prepend`` + ``Replace``, byte fallback,
no pre-tokenizer) and a Unigram with byte fallback behind ``Digits`` and
``Punctuation``. Then the CamemBERT and ELECTRA tokenizer classes on the
``tokenizer.json`` route, and ELECTRA on the ``vocab.txt`` route (named by
``tokenizer_config.json`` or by ``config.json``'s ``model_type``). Ids and
masks must be equal at ``max_length`` 8 and 64 on the cases and on a
hypothesis fuzz. BPE ``dropout`` above 0 raises.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from leann_torch.embeddings import tokenizer as tt  # noqa: E402
from leann_torch.embeddings import tokenizer_json as tj  # noqa: E402

from test_torch_tokenizer_json import ALPHABET, CASES, COMPONENT_ALPHABET, CORPUS, _check  # noqa: E402

GPT2 = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
CL100K = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"""
          r"""|\s*[\r\n]+|\s+(?!\S)|\s+""")
QWEN2 = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"""
         r"""|\s*[\r\n]+|\s+(?!\S)|\s+""")
BEHAVIORS = ["Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous"]
TEXT_ALPHABET = COMPONENT_ALPHABET + ["12", "345", "\r\n", "' ", "'S", "'LL", "ſ", "K", "½", "x", "xx", "a,b"]


def _spec(normalizer=None, pre_tokenizer=None, model=None):
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [], "normalizer": normalizer,
            "pre_tokenizer": pre_tokenizer, "post_processor": None, "decoder": None,
            "model": model or {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0], ["a", -1.0]],
                               "byte_fallback": False}}


def _backend(**kw):
    return tokenizers.Tokenizer.from_str(json.dumps(_spec(**kw)))


NORMALIZERS = {"prepend": {"type": "Prepend", "prepend": "▁"}, "prepend_word": {"type": "Prepend", "prepend": "ab "}}


def _split(pattern, behavior, invert=False):
    return {"type": "Split", "pattern": pattern, "behavior": behavior, "invert": invert}


PRE_TOKENIZERS = {
    "digits": {"type": "Digits", "individual_digits": False},
    "digits_individual": {"type": "Digits", "individual_digits": True},
    **{f"punctuation_{b}": {"type": "Punctuation", "behavior": b} for b in BEHAVIORS},
    **{f"split_string_{b}": _split({"String": "x"}, b) for b in BEHAVIORS},
    **{f"split_string_{b}_invert": _split({"String": "x"}, b, True) for b in BEHAVIORS},
    "split_space_removed": _split({"String": " "}, "Removed"),
    **{f"split_regex_{b}": _split({"Regex": r"\s+"}, b) for b in BEHAVIORS},
    "split_regex_words_invert": _split({"Regex": r"\w+"}, "Removed", True),
    "split_regex_notspace_merged": _split({"Regex": r"\S+"}, "MergedWithNext"),
    "split_regex_digits_class": _split({"Regex": r"[\d\p{P}]+"}, "Isolated"),
    "split_regex_negated_property": _split({"Regex": r"\P{L}+"}, "Contiguous"),
    "split_gpt2": _split({"Regex": GPT2}, "Isolated"),
    "split_gpt2_removed_invert": _split({"Regex": GPT2}, "Removed", True),
    "split_cl100k": _split({"Regex": CL100K}, "Isolated"),
    "split_qwen2": _split({"Regex": QWEN2}, "Isolated"),
}


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(TEXT_ALPHABET), max_size=40).map("".join))
@pytest.mark.parametrize("name", list(NORMALIZERS))
def test_normalizer_equals_tokenizers(name, text):
    want = _backend(normalizer=NORMALIZERS[name]).normalizer.normalize_str(text)
    assert tj.make_normalizer(NORMALIZERS[name])(text) == want


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(TEXT_ALPHABET), max_size=40).map("".join))
@pytest.mark.parametrize("name", list(PRE_TOKENIZERS))
def test_pre_tokenizer_equals_tokenizers(name, text):
    want = [w for w, _ in _backend(pre_tokenizer=PRE_TOKENIZERS[name]).pre_tokenizer.pre_tokenize_str(text)]
    assert tj.make_pre_tokenizer(PRE_TOKENIZERS[name])([text] if text else [], True)[0] == want


def test_split_patterns_on_fixed_text():
    """The GPT-2, cl100k- and Qwen2-style splits on one text of many
    scripts give tokenizers' words and cover the text; a regex property
    outside the general categories raises."""
    text = " ".join(CORPUS + CASES) + "  Hello world's 123456 x\t\ty ÜNÏ 'LL\r\n\n  z"
    for name in ("split_gpt2", "split_cl100k", "split_qwen2"):
        want = [w for w, _ in _backend(pre_tokenizer=PRE_TOKENIZERS[name]).pre_tokenizer.pre_tokenize_str(text)]
        got = tj.make_pre_tokenizer(PRE_TOKENIZERS[name])([text], True)[0]
        assert got == want and "".join(got) == text, name
    assert tj.make_pre_tokenizer(PRE_TOKENIZERS["split_cl100k"])(["x 123456"], True)[0] == ["x", " ", "123", "456"]
    with pytest.raises(NotImplementedError, match="Han"):
        tj.compile_onig(r"\p{Han}")


@pytest.mark.parametrize("field,spec", [
    ("normalizer", {"type": "ByteLevel"}),
    ("pre_tokenizer", {"type": "CharDelimiterSplit", "delimiter": "x"}),
    ("pre_tokenizer", {"type": "FixedLength", "length": 3}),
], ids=["bytelevel_normalizer", "chardelimiter", "fixedlength"])
def test_components_no_checkpoint_ships_raise(field, spec):
    """Components no tokenizer.json of a checkpoint the loaders read uses
    raise not_ported naming their type."""
    make = tj.make_normalizer if field == "normalizer" else tj.make_pre_tokenizer
    with pytest.raises(NotImplementedError, match=rf"{spec['type']}.*§A #4"):
        make(spec)


# ---------------------------------------------------------------------------
# Models alone
# ---------------------------------------------------------------------------

def _byte_pieces():
    return [f"<0x{b:02X}>" for b in range(256)]


def _models():
    wl_vocab = {w: i for i, w in enumerate(["<unk>", "a", "ab", "b", "é", "中", "ab c"])}
    uni_vocab = [["<unk>", 0.0], ["a", -1.0], ["ab", -1.5], ["b", -2.0], ["c", -2.5], ["é", -3.0]]
    bpe_vocab = {"<unk>": 0, "a": 1, "b": 2, "c": 3, "ab": 4, "abc": 5, "##b": 6, "##c": 7, "a##b": 8}
    return {
        "wordlevel": {"type": "WordLevel", "vocab": wl_vocab, "unk_token": "<unk>"},
        "unigram_byte_fallback": {"type": "Unigram", "unk_id": 0, "byte_fallback": True,
                                  "vocab": uni_vocab + [[p, -9.0] for p in _byte_pieces()]},
        "unigram_some_bytes": {"type": "Unigram", "unk_id": 0, "byte_fallback": True,
                               "vocab": uni_vocab + [[p, -9.0] for p in _byte_pieces()[:0xC0]]},
        "bpe_byte_fallback": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                              "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True,
                              "vocab": {**bpe_vocab, **{p: 9 + i for i, p in enumerate(_byte_pieces())}},
                              "merges": [["a", "b"], ["ab", "c"]]},
        "bpe_byte_fallback_some": {"type": "BPE", "dropout": 0.0, "unk_token": "<unk>",
                                   "continuing_subword_prefix": None, "end_of_word_suffix": None, "fuse_unk": False,
                                   "byte_fallback": True,
                                   "vocab": {**bpe_vocab, **{p: 9 + i for i, p in enumerate(_byte_pieces()[:0xC0])}},
                                   "merges": [["a", "b"], ["ab", "c"]]},
        "bpe_byte_fallback_prefix": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                                     "continuing_subword_prefix": "##", "end_of_word_suffix": None, "fuse_unk": False,
                                     "byte_fallback": True,
                                     "vocab": {**bpe_vocab, **{p: 9 + i for i, p in enumerate(_byte_pieces())}},
                                     "merges": [["a", "##b"]]},
    }


MODELS = _models()
MODEL_ALPHABET = list("abc é中") + ["ab", "ab c", "İ", "👍", "\x00", "<unk>", "##", "́"]


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from(MODEL_ALPHABET), max_size=12).map("".join))
@pytest.mark.parametrize("name", list(MODELS))
def test_model_equals_tokenizers(name, text):
    """The whole text as one word (no pre-tokenizer) through each model."""
    want = _backend(model=MODELS[name]).encode(text, add_special_tokens=False).ids
    assert list(tj.make_model(MODELS[name])(text)) == want


def test_bpe_dropout_raises():
    spec = {**MODELS["bpe_byte_fallback"], "dropout": 0.25}
    with pytest.raises(NotImplementedError, match="dropout 0.25"):
        tj.make_model(spec)
    for zero in (None, 0, 0.0):
        assert tj.make_model({**spec, "dropout": zero})("abc") == (5,)


# ---------------------------------------------------------------------------
# Whole pipelines against the JAX package's AutoTokenizer
# ---------------------------------------------------------------------------

SPECIALS = ["<pad>", "<unk>", "<s>", "</s>"]


def _template(tok):
    tok.post_processor = tokenizers.processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", tok.token_to_id("<s>")), ("</s>", tok.token_to_id("</s>"))])
    return tok


def _with_bytes(tok, **changes):
    """``tok`` with the 256 ``<0xNN>`` pieces added to its model's vocab
    (Unigram: lowest score; BPE: new ids) and ``changes`` to the model."""
    spec = json.loads(tok.to_str())
    model = spec["model"]
    if model["type"] == "Unigram":
        have = {p for p, _ in model["vocab"]}
        low = min(s for _, s in model["vocab"]) - 1.0
        model["vocab"] += [[p, low] for p in _byte_pieces() if p not in have]
    else:
        for p in _byte_pieces():
            model["vocab"].setdefault(p, len(model["vocab"]))
    model.update(changes)
    return tokenizers.Tokenizer.from_str(json.dumps(spec))


def _pipeline(kind):
    trainers, pre, norm = tokenizers.trainers, tokenizers.pre_tokenizers, tokenizers.normalizers
    if kind == "wordlevel_split":
        tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(unk_token="<unk>"))
        tok.normalizer = norm.Sequence([norm.NFKC(), norm.Lowercase()])
        tok.pre_tokenizer = pre.Sequence([pre.Split(tokenizers.Regex(QWEN2), "isolated"),
                                          pre.WhitespaceSplit()])
        tok.train_from_iterator(CORPUS * 5, trainers.WordLevelTrainer(special_tokens=SPECIALS, vocab_size=120))
    elif kind == "bpe_gpt4":
        tok = tokenizers.Tokenizer(tokenizers.models.BPE())
        tok.pre_tokenizer = pre.Sequence([pre.Split(tokenizers.Regex(CL100K), "isolated"),
                                          pre.ByteLevel(add_prefix_space=False, use_regex=False)])
        tok.train_from_iterator(CORPUS * 20, trainers.BpeTrainer(
            vocab_size=500, special_tokens=SPECIALS, initial_alphabet=pre.ByteLevel.alphabet(), show_progress=False))
    elif kind == "bpe_llama2":
        tok = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token="<unk>", fuse_unk=True))
        tok.normalizer = norm.Sequence([norm.Prepend("▁"), norm.Replace(" ", "▁")])
        tok.train_from_iterator(CORPUS * 20, trainers.BpeTrainer(
            vocab_size=400, special_tokens=SPECIALS, limit_alphabet=60, show_progress=False))
        tok = _with_bytes(tok, byte_fallback=True)
    else:  # unigram_digits_punct
        u = tokenizers.SentencePieceUnigramTokenizer()
        u.train_from_iterator(CORPUS * 20, vocab_size=300, special_tokens=SPECIALS, unk_token="<unk>",
                              show_progress=False)
        tok = u._tokenizer
        tok.pre_tokenizer = pre.Sequence([pre.Digits(individual_digits=True), pre.Punctuation("merged_with_next"),
                                          pre.Metaspace()])
        tok = _with_bytes(tok, byte_fallback=True)
    return _template(tok)


PIPELINES = ["wordlevel_split", "bpe_gpt4", "bpe_llama2", "unigram_digits_punct"]


def _electra_wordpiece():
    w = tokenizers.BertWordPieceTokenizer(lowercase=True)
    w.train_from_iterator(CORPUS * 20, vocab_size=300, show_progress=False,
                          special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tok = w._tokenizer
    tok.post_processor = tokenizers.processors.BertProcessing(("[SEP]", tok.token_to_id("[SEP]")),
                                                              ("[CLS]", tok.token_to_id("[CLS]")))
    return tok


def _camembert_unigram():
    u = tokenizers.SentencePieceUnigramTokenizer()
    u.train_from_iterator(CORPUS * 20, vocab_size=400, show_progress=False, unk_token="<unk>",
                          special_tokens=["<s>NOTUSED", "<pad>", "</s>NOTUSED", "<unk>", "<unk>NOTUSED", "<s>", "</s>"])
    return _template(u._tokenizer)


def _write_dirs(root):
    dirs = {}
    for kind in PIPELINES:
        dirs[kind] = str(root / kind)
        transformers.PreTrainedTokenizerFast(tokenizer_object=_pipeline(kind), pad_token="<pad>", unk_token="<unk>",
                                             bos_token="<s>", eos_token="</s>").save_pretrained(dirs[kind])
    dirs["camembert_json"] = str(root / "camembert_json")
    transformers.CamembertTokenizerFast(tokenizer_object=_camembert_unigram()).save_pretrained(dirs["camembert_json"])
    dirs["electra_json"] = str(root / "electra_json")
    transformers.ElectraTokenizerFast(tokenizer_object=_electra_wordpiece(), do_lower_case=False,
                                      strip_accents=False).save_pretrained(dirs["electra_json"])
    # the vocab.txt route: the same vocabulary with only vocab.txt, named by the
    # tokenizer config, or by config.json's model_type
    vocab = os.path.join(dirs["electra_json"], "vocab.txt")
    for name, files in (("electra_vocab", {"tokenizer_config.json": {"tokenizer_class": "ElectraTokenizer",
                                                                     "do_lower_case": False}}),
                        ("electra_model_type", {"config.json": {"model_type": "electra", "vocab_size": 300}})):
        d = root / name
        d.mkdir()
        (d / "vocab.txt").write_bytes(open(vocab, "rb").read())
        for fname, obj in files.items():
            (d / fname).write_text(json.dumps(obj))
        dirs[name] = str(d)
    return dirs


DIRS = PIPELINES + ["camembert_json", "electra_json", "electra_vocab", "electra_model_type"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _write_dirs(tmp_path_factory.mktemp("components"))


@pytest.fixture(scope="module")
def readers(dirs):
    """Each directory's reader in each package, made once."""
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF

    tt._TOKENIZER_CACHE.clear()
    return {k: (tt.get_tokenizer(d, max_length=64), JaxHF(d)) for k, d in dirs.items()}


@pytest.mark.parametrize("kind", DIRS)
@pytest.mark.parametrize("max_length", [8, 64])
def test_cases_equal_the_jax_package(readers, kind, max_length):
    ours, jax = readers[kind]
    _check(ours.encode_batch(CASES + CORPUS, max_length), jax.encode_batch(CASES + CORPUS, max_length),
           CASES + CORPUS)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.lists(st.sampled_from(ALPHABET + ["123", "4567", "İ", "ſ"]), max_size=30).map("".join),
                min_size=1, max_size=5))
@pytest.mark.parametrize("kind", DIRS)
def test_fuzz_equals_the_jax_package(readers, kind, texts):
    ours, jax = readers[kind]
    _check(ours.encode_batch(texts, 24), jax.encode_batch(texts, 24), texts)


def test_classes_and_routes(dirs, readers):
    """Each directory reaches its reader and class: CamemBERT's three
    NOTUSED tokens are special tokens matched on the raw text and its mask
    takes the space before it; ELECTRA's vocab.txt runs as BERT's
    WordPiece with the config's casing; the byte-fallback pipelines emit
    byte pieces for what their vocab lacks."""
    cam = readers["camembert_json"][0]
    assert isinstance(cam, tj.JsonTokenizer) and cam.tokenizer_class == "CamembertTokenizer"
    assert [cam.token_to_id(t) for t in ("<s>NOTUSED", "</s>NOTUSED", "<unk>NOTUSED")] == [0, 2, 4]
    assert cam.token_ids("a<unk>NOTUSED") [-1] == 4 and cam._added["<mask>"].lstrip
    for kind in ("electra_vocab", "electra_model_type"):
        e = readers[kind][0]
        assert isinstance(e, tt.HFTokenizer) and e.tokenizer_class == "ElectraTokenizer"
    assert not readers["electra_vocab"][0].lowercase and readers["electra_model_type"][0].lowercase
    assert readers["electra_json"][0].tokenizer_class == "ElectraTokenizer"
    for kind in ("bpe_llama2", "unigram_digits_punct"):
        tok = readers[kind][0]
        ids = tok.token_ids("İЖ")
        assert set(ids) <= {tok.token_to_id(p) for p in _byte_pieces()} | {tok.token_to_id("▁")}
        assert tok.unk_id not in ids
    assert np.array_equal(*[r.encode_batch(["x 12345"], 8)[0] for r in readers["wordlevel_split"]])


def test_a_class_added_mask_is_matched_on_the_raw_text(tmp_path):
    """An XLM-R tokenizer.json whose added tokens lack <mask> (the vocab
    holds it) under a normalizer that rewrites its letters: the fast class
    adds the mask as a special token, matched on the raw text with the
    space before it, as AutoTokenizer reads the directory."""
    from leann_tpu.embeddings.tokenizer import HFTokenizer as JaxHF
    from test_torch_tokenizer_json import _precompiled_normalizer, _train_unigram

    tok = _template(_train_unigram())
    tok.normalizer = _precompiled_normalizer()  # "a" -> "Y"
    spec = json.loads(tok.to_str())
    spec["model"]["vocab"].append(["<mask>", 0.0])
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "XLMRobertaTokenizer"}))
    texts = [" <mask> ab<mask>", "<mask>", "a <mask>a"]
    ours = tj.JsonTokenizer(str(tmp_path))
    assert ours.token_ids(" <mask>") == [ours.token_to_id("<mask>")]
    for L in (8, 64):
        _check(ours.encode_batch(texts, L), JaxHF(str(tmp_path)).encode_batch(texts, L), texts)
