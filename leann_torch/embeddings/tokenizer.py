"""Tokenization for the on-device encoder.

The recompute path needs token ids resident in device memory, so tokenization
is a first-class build step. Two tokenizers:

* :class:`HashTokenizer` — deterministic, dependency-free, offline hashing
  word tokenizer (ids from blake2b of the normalized word), the one the
  seeded hash-* models use. It emits the same ids as the JAX package's, so
  token stores written by either package read the same in the other. ASCII
  texts go through the native library (``runtime/fast_tokenizer.py``,
  ``csrc/hash_tokenizer.cpp``), which gives exactly this module's ids.
* :class:`HFTokenizer` — BERT's WordPiece over a local checkpoint's
  ``vocab.txt``: the pipeline ``transformers`` converts it to, run by
  ``tokenizer_json.py``, so the port needs no ``transformers``. It gives the
  ids and masks of ``transformers``' ``BertTokenizerFast`` on the same
  directory.

A checkpoint's ``tokenizer.json`` (SentencePiece Unigram, byte-level BPE,
WordPiece, WordLevel) is read by ``tokenizer_json.py``. The slow files that
``transformers`` converts are converted here as it converts them, and run
by the same reader: a SentencePiece ``sentencepiece.bpe.model`` (XLM-R,
CamemBERT; :class:`SpmTokenizer`, the file read by ``spm_model.py``) and
RoBERTa's ``vocab.json`` + ``merges.txt`` (:class:`BpeFilesTokenizer`).
:func:`get_tokenizer` routes a directory as ``AutoTokenizer`` does.
"""

from __future__ import annotations

import base64
import hashlib
import os
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import spm_model
from .tokenizer_json import JsonTokenizer, _not_ported, _read_json, _token_fields, read_config, tokenizer_class

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
_NUM_RESERVED = 4

# words / numbers / CJK chars (individually) / other single non-space symbols
_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?|[一-鿿぀-ヿ가-힯]|[^\sa-z0-9]", re.UNICODE)


def stable_hash(s: str, mod: "int | None" = None) -> int:
    h = int.from_bytes(hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "little")
    return h % mod if mod else h


@dataclass
class HashTokenizer:
    vocab_size: int = 32768
    max_length: int = 256

    def _word_id(self, w: str) -> int:
        return _NUM_RESERVED + stable_hash(w, self.vocab_size - _NUM_RESERVED)

    def tokenize_words(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFKC", text).lower()
        return _WORD_RE.findall(text)

    def encode(self, text: str, max_length: "int | None" = None) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids[max_length] int32, mask[max_length] int32)."""
        L = max_length or self.max_length
        words = self.tokenize_words(text)[: L - 2]
        ids = [CLS_ID] + [self._word_id(w) for w in words] + [SEP_ID]
        n = len(ids)
        out = np.full(L, PAD_ID, dtype=np.int32)
        out[:n] = ids
        mask = np.zeros(L, dtype=np.int32)
        mask[:n] = 1
        return out, mask

    def encode_batch(self, texts: Sequence[str], max_length: "int | None" = None) -> Tuple[np.ndarray, np.ndarray]:
        """ASCII texts through the native library, as in the JAX package:
        the whole batch when every text is ASCII, else the ASCII ones
        together and the others one by one in Python."""
        L = max_length or self.max_length
        ascii_idx = [i for i, t in enumerate(texts) if t.isascii()]
        if ascii_idx and len(ascii_idx) == len(texts):
            from ..runtime.fast_tokenizer import encode_batch_ascii

            return encode_batch_ascii(texts, L, self.vocab_size)
        ids = np.empty((len(texts), L), dtype=np.int32)
        mask = np.empty((len(texts), L), dtype=np.int32)
        if ascii_idx:
            from ..runtime.fast_tokenizer import encode_batch_ascii

            ids[ascii_idx], mask[ascii_idx] = encode_batch_ascii([texts[i] for i in ascii_idx], L, self.vocab_size)
        for i, t in enumerate(texts):
            if not t.isascii():
                ids[i], mask[i] = self.encode(t, L)
        return ids, mask

    def encode_batch_python(self, texts: Sequence[str], max_length: "int | None" = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Every text through :meth:`encode`: the definition the native
        path is held to."""
        L = max_length or self.max_length
        ids = np.empty((len(texts), L), dtype=np.int32)
        mask = np.empty((len(texts), L), dtype=np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, L)
        return ids, mask


# the slow tokenizer files transformers converts, and those each class reads
_TOKENIZER_FILES = ("vocab.txt", "sentencepiece.bpe.model", "spiece.model", "tokenizer.model", "vocab.json",
                    "merges.txt")
_SPM_FILE = "sentencepiece.bpe.model"
_SLOW_FILES = {"BertTokenizer": ("vocab.txt",), "DistilBertTokenizer": ("vocab.txt",),
               "ElectraTokenizer": ("vocab.txt",), "RobertaTokenizer": ("vocab.json", "merges.txt"),
               "XLMRobertaTokenizer": (_SPM_FILE,), "CamembertTokenizer": (_SPM_FILE,)}
_WORDPIECE_CLASSES = tuple(c + f for c, files in _SLOW_FILES.items() if files == ("vocab.txt",) for f in ("", "Fast"))


def bert_pipeline(tokens: Sequence[str], cfg: dict, path: str = "vocab.txt") -> dict:
    """The ``tokenizer.json`` that ``transformers`` makes of a BERT
    ``vocab.txt`` (its lines ``tokens``) and tokenizer config ``cfg``:
    ``BertNormalizer`` with the config's ``do_lower_case``,
    ``strip_accents`` and ``tokenize_chinese_chars``, ``BertPreTokenizer``,
    ``WordPiece`` with ``##`` continuations and words of at most 100
    characters, ``[CLS] $A [SEP]``, and the named special tokens in the
    vocab matched on the raw text. Raises if the vocab lacks the unknown,
    CLS, SEP or pad token."""
    vocab = {t: i for i, t in enumerate(tokens)}  # a repeated token: its last line
    names = {k: _token_fields(cfg.get(f"{k}_token"))[0] or d
             for k, d in (("unk", "[UNK]"), ("cls", "[CLS]"), ("sep", "[SEP]"), ("pad", "[PAD]"), ("mask", "[MASK]"))}
    missing = [names[k] for k in ("unk", "cls", "sep", "pad") if names[k] not in vocab]
    if missing:
        raise ValueError(f"{path} lacks the special tokens {missing}")
    lowercase = bool(cfg.get("do_lower_case", True))
    sa = cfg.get("strip_accents")
    cls, sep = names["cls"], names["sep"]
    return {
        "version": "1.0",
        "added_tokens": [{"id": vocab[n], "content": n, "single_word": False, "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for n in sorted({n for n in names.values() if n in vocab}, key=vocab.get)],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": bool(cfg.get("tokenize_chinese_chars", True)),
                       "strip_accents": lowercase if sa is None else bool(sa), "lowercase": lowercase},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": cls, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": sep, "type_id": 0}}],
                           "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]} for t in (cls, sep)}},
        "model": {"type": "WordPiece", "unk_token": names["unk"], "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }


class HFTokenizer(JsonTokenizer):
    """WordPiece over a local checkpoint directory's ``vocab.txt`` (BERT,
    DistilBERT, ELECTRA): the pipeline ``transformers`` converts it to
    (:func:`bert_pipeline`, from ``vocab.txt`` and ``tokenizer_config.json``,
    then ``special_tokens_map.json``), run by
    :class:`~.tokenizer_json.JsonTokenizer`. It gives the ids and masks of
    ``BertTokenizerFast`` on the directory: ``[CLS] ... [SEP]`` truncated
    and padded to ``max_length``, as int32."""

    def __init__(self, path: str, max_length: int = 256):
        cfg = read_config(path)
        cls_name = tokenizer_class(path, cfg)
        if cls_name is not None and cls_name not in _WORDPIECE_CLASSES:
            raise _not_ported(f"the tokenizer class {cls_name!r} of {path} (only BERT-type WordPiece reads vocab.txt)")
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as fh:
            tokens = [line.rstrip("\n") for line in fh]
        spec = bert_pipeline(tokens, cfg, os.path.join(path, "vocab.txt"))
        norm = spec["normalizer"]
        self.lowercase, self.strip_accents = norm["lowercase"], norm["strip_accents"]
        self.chinese_chars = norm["handle_chinese_chars"]
        self._setup(spec, {**cfg, "do_lower_case": self.lowercase, "strip_accents": self.strip_accents},
                    cls_name or "BertTokenizer", path, max_length)
        self.vocab_size = len(tokens)


# SpmConverter's subclasses for the classes whose weights the loader reads:
# the pieces before the SentencePiece ones (with scores), how many leading
# SentencePiece pieces they replace, the unknown piece's id
_SPM_HEADS = {
    "XLMRobertaTokenizer": ([("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)], 3, 3),
    "CamembertTokenizer": ([("<s>NOTUSED", 0.0), ("<pad>", 0.0), ("</s>NOTUSED", 0.0), ("<unk>", 0.0),
                            ("<unk>NOTUSED", -100.0)], 1, 3),
}


def _spm_special_id(cls_name: str, proto: spm_model.ModelProto, token: str, path: str) -> int:
    """The slow class's ``convert_tokens_to_ids(token)`` for ``<s>`` and
    ``</s>``: XLM-R's fairseq ids 0 and 2; CamemBERT's ``4 +`` the piece's
    SentencePiece id (its unknown id 3 when that id is 0)."""
    if cls_name == "XLMRobertaTokenizer":
        return {"<s>": 0, "</s>": 2}[token]
    at = next((i for i, p in enumerate(proto.pieces) if p.piece == token), None)
    if at is None:
        raise ValueError(f"{path} has no piece {token!r}, which CamemBERT's template needs")
    return 4 + at if at else 3


def spm_pipeline(proto: spm_model.ModelProto, cls_name: str, path: str = _SPM_FILE) -> dict:
    """The ``tokenizer.json`` that ``transformers``' ``SpmConverter`` makes
    of a SentencePiece Unigram model for ``cls_name`` (its
    ``XLMRobertaConverter`` / ``CamembertConverter``):

    * the vocab: the class's head pieces, then the model's pieces after the
      ones they replace (XLM-R: ``pieces[3:]``; CamemBERT: ``pieces[1:]``,
      behind ``<unk>NOTUSED`` at -100), then ``<mask>``; unknown id 3;
      ``byte_fallback`` off (neither converter handles it);
    * the normalizer: ``Precompiled`` when the charsmap is not empty, then
      ``Strip`` on the right and ``Replace(" {2,}", "▁")``;
    * ``Metaspace`` "▁" with the prepend scheme "always" (neither slow class
      has ``add_prefix_space`` or ``legacy``, so the tokenizer config plays
      no part, and the model's ``add_dummy_prefix`` and
      ``remove_extra_whitespaces`` are not read);
    * the template ``<s> $A </s>`` with the slow class's ids
      (:func:`_spm_special_id`);
    * the control (type 3, special) and user-defined (type 4) pieces as
      added tokens matched on the raw text.

    A BPE-type model raises ``not_ported`` (its merges come from
    ``sentencepiece``'s own extractor); a word or char model raises, as in
    ``transformers``; so does a class outside the two."""
    if cls_name not in _SPM_HEADS:
        raise _not_ported(f"the tokenizer class {cls_name!r} of {path} (a SentencePiece model is read for XLM-R and "
                          "CamemBERT, the classes whose weights the loader reads)")
    if proto.model_type == spm_model.BPE:
        raise _not_ported(f"{path}, a SentencePiece model of BPE type (transformers takes its merges from "
                          "sentencepiece's own extractor)")
    if proto.model_type != spm_model.UNIGRAM:
        raise ValueError(f"{path}: a SentencePiece model of type {proto.model_type}; only Unigram and BPE convert")
    head, skip, unk_id = _SPM_HEADS[cls_name]
    vocab = [list(h) for h in head] + [[p.piece, p.score] for p in proto.pieces[skip:]] + [["<mask>", 0.0]]
    ids = {p: i for i, (p, _) in enumerate(vocab)}  # a repeated piece: its last id, as the model's
    added, seen, next_id = [], set(), len(vocab)
    for p in proto.pieces:
        if p.type in (spm_model.CONTROL, spm_model.USER_DEFINED) and p.piece not in seen:
            seen.add(p.piece)
            tid = ids.get(p.piece)
            if tid is None:
                tid, next_id = next_id, next_id + 1
            added.append({"id": tid, "content": p.piece, "single_word": False, "lstrip": False, "rstrip": False,
                          "normalized": False, "special": p.type == spm_model.CONTROL})
    norm = [{"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]
    if proto.precompiled_charsmap:
        norm.insert(0, {"type": "Precompiled",
                        "precompiled_charsmap": base64.b64encode(proto.precompiled_charsmap).decode()})
    special = {t: {"id": t, "ids": [_spm_special_id(cls_name, proto, t, path)], "tokens": [t]} for t in ("<s>", "</s>")}
    return {
        "version": "1.0",
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": norm},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "special_tokens": special},
        "model": {"type": "Unigram", "unk_id": unk_id, "vocab": vocab, "byte_fallback": False},
    }


class SpmTokenizer(JsonTokenizer):
    """A directory's ``sentencepiece.bpe.model`` (XLM-R, CamemBERT), read by
    ``spm_model.py`` and run as the pipeline :func:`spm_pipeline` makes of
    it: the ids and masks of the fast class ``transformers`` converts it
    to."""

    def __init__(self, path: str, max_length: int = 256):
        cfg = read_config(path)
        cls_name = tokenizer_class(path, cfg)
        file = os.path.join(path, _SPM_FILE)
        self.proto = spm_model.read_model_file(file)
        self._setup(spm_pipeline(self.proto, cls_name, file), cfg, cls_name, path, max_length)


def read_merges(text: str) -> List[Tuple[str, ...]]:
    """``merges.txt`` as ``RobertaTokenizer`` reads it: the lines between
    the first (the ``#version`` header) and the last (empty after the final
    newline), so a file without the header loses its first merge, as in
    ``transformers``; a merge listed twice keeps its first rank."""
    merges = [tuple(line.split()) for line in text.split("\n")[1:-1]]
    bad = [m for m in merges if len(m) != 2]
    if bad:
        raise ValueError(f"merges.txt holds lines that are not two tokens: {bad[:3]}")
    return list(dict.fromkeys(merges))


def bpe_files_pipeline(vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], cfg: dict,
                       path: str = "vocab.json") -> dict:
    """The ``tokenizer.json`` that ``transformers``' ``RobertaConverter``
    makes of ``vocab.json`` + ``merges.txt``: ``ByteLevel`` with the
    config's ``add_prefix_space`` (default false), ``BPE`` with no unknown
    token, prefix or suffix, and ``RobertaProcessing`` with the config's
    CLS and SEP tokens. Raises if the vocab lacks them."""
    cls, sep = (_token_fields(cfg.get(f"{k}_token"))[0] or d for k, d in (("cls", "<s>"), ("sep", "</s>")))
    missing = [t for t in (cls, sep) if t not in vocab]
    if missing:
        raise ValueError(f"{path} lacks the special tokens {missing}")
    return {
        "version": "1.0",
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": bool(cfg.get("add_prefix_space", False)),
                          "trim_offsets": True, "use_regex": True},
        "post_processor": {"type": "RobertaProcessing", "sep": [sep, vocab[sep]], "cls": [cls, vocab[cls]]},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "vocab": vocab,
                  "merges": [list(m) for m in merges]},
    }


class BpeFilesTokenizer(JsonTokenizer):
    """RoBERTa's ``vocab.json`` + ``merges.txt``, run as the pipeline
    :func:`bpe_files_pipeline` makes of them: the ids and masks of
    ``RobertaTokenizerFast`` on the directory."""

    def __init__(self, path: str, max_length: int = 256):
        cfg = read_config(path)
        vocab = _read_json(os.path.join(path, "vocab.json"))
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = read_merges(f.read())
        spec = bpe_files_pipeline(vocab, merges, cfg, os.path.join(path, "vocab.json"))
        self._setup(spec, cfg, "RobertaTokenizer", path, max_length)


_READERS = {("vocab.txt",): HFTokenizer, ("vocab.json", "merges.txt"): BpeFilesTokenizer, (_SPM_FILE,): SpmTokenizer}


def slow_files_tokenizer(path: str, max_length: int = 256) -> JsonTokenizer:
    """A directory with no ``tokenizer.json``: the reader of the slow files
    its tokenizer class reads (a ``vocab.txt`` with no class: BERT). A
    class outside ``_SLOW_FILES``, no class, or a class whose files are
    missing raises ``not_ported``: ``AutoTokenizer`` cannot read such a
    directory either, or reads it for a model the loader does not load."""
    found = [f for f in _TOKENIZER_FILES if os.path.exists(os.path.join(path, f))]
    cls_name = tokenizer_class(path, read_config(path))
    if cls_name is None and "vocab.txt" in found:
        cls_name = "BertTokenizer"
    need = _SLOW_FILES.get(cls_name)
    if need is None or not all(f in found for f in need):
        if cls_name is None:
            why = "no tokenizer class"
        elif need is None:
            why = f"the class {cls_name!r}, whose checkpoints the loader does not read"
        else:
            why = f"the class {cls_name!r}, which reads {' + '.join(need)}"
        raise _not_ported(f"the tokenizer of {path} ({', '.join(found)}, no tokenizer.json; {why})")
    return _READERS[need](path, max_length=max_length)


_TOKENIZER_CACHE: dict = {}


def get_tokenizer(model_name: str, vocab_size: int = 32768, max_length: int = 256):
    """The tokenizer for ``model_name``, routed in ``AutoTokenizer``'s order:

    * a local directory with ``tokenizer.json``: the port's reader of it
      (:class:`~.tokenizer_json.JsonTokenizer`; a component it does not read
      raises, not ported);
    * else a directory with a slow tokenizer file: the reader of the files
      its class reads (:func:`slow_files_tokenizer`: ``vocab.txt``,
      ``sentencepiece.bpe.model`` or ``vocab.json`` + ``merges.txt``);
    * a directory with no tokenizer files, or a model name: the hash
      tokenizer at ``vocab_size``, as in the JAX package. A directory whose
      files cannot be read raises: the port never falls back to the hash
      tokenizer there.
    """
    key = (model_name, vocab_size, max_length)
    if key in _TOKENIZER_CACHE:
        return _TOKENIZER_CACHE[key]
    tok = None
    if os.path.isdir(model_name):
        if os.path.exists(os.path.join(model_name, "tokenizer.json")):
            tok = JsonTokenizer(model_name, max_length=max_length)
        elif any(os.path.exists(os.path.join(model_name, f)) for f in _TOKENIZER_FILES):
            tok = slow_files_tokenizer(model_name, max_length=max_length)
    if tok is None:
        tok = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    _TOKENIZER_CACHE[key] = tok
    return tok
