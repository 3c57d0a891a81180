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
WordPiece) is read by ``tokenizer_json.py``. :func:`get_tokenizer` picks
one: ``tokenizer.json`` first, then ``vocab.txt``, a directory with no
tokenizer files (or a model name) the hash tokenizer; a directory whose
tokenizer files are of another kind raises.
"""

from __future__ import annotations

import hashlib
import os
import re
import unicodedata
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .tokenizer_json import JsonTokenizer, _token_fields, read_config

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


# tokenizer files that transformers converts and the port does not read
_TOKENIZER_FILES = ("spiece.model", "sentencepiece.bpe.model", "tokenizer.model", "vocab.json", "merges.txt")
_WORDPIECE_CLASSES = ("BertTokenizer", "BertTokenizerFast", "DistilBertTokenizer", "DistilBertTokenizerFast")


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
    """BERT WordPiece over a local checkpoint directory's ``vocab.txt``: the
    pipeline ``transformers`` converts it to (:func:`bert_pipeline`, from
    ``vocab.txt`` and ``tokenizer_config.json``, then
    ``special_tokens_map.json``), run by :class:`~.tokenizer_json.JsonTokenizer`.
    It gives the ids and masks of ``BertTokenizerFast`` on the directory:
    ``[CLS] ... [SEP]`` truncated and padded to ``max_length``, as int32."""

    def __init__(self, path: str, max_length: int = 256):
        cfg = read_config(path)
        cls_name = cfg.get("tokenizer_class")
        if cls_name is not None and cls_name not in _WORDPIECE_CLASSES:
            from ..backends.common import not_ported

            raise not_ported(f"the tokenizer class {cls_name!r} of {path} (only BERT WordPiece reads vocab.txt)",
                             "ROADMAP.md §A #4")
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as fh:
            tokens = [line.rstrip("\n") for line in fh]
        spec = bert_pipeline(tokens, cfg, os.path.join(path, "vocab.txt"))
        norm = spec["normalizer"]
        self.lowercase, self.strip_accents = norm["lowercase"], norm["strip_accents"]
        self.chinese_chars = norm["handle_chinese_chars"]
        self._setup(spec, {**cfg, "do_lower_case": self.lowercase, "strip_accents": self.strip_accents},
                    "BertTokenizer", path, max_length)
        self.vocab_size = len(tokens)


_TOKENIZER_CACHE: dict = {}


def get_tokenizer(model_name: str, vocab_size: int = 32768, max_length: int = 256):
    """The tokenizer for ``model_name``, routed as ``AutoTokenizer`` prefers
    the fast file:

    * a local directory with ``tokenizer.json``: the port's reader of it
      (:class:`~.tokenizer_json.JsonTokenizer`: Unigram, BPE or WordPiece;
      another component raises, not ported);
    * else a directory with ``vocab.txt``: :class:`HFTokenizer` (a
      ``vocab.txt`` that cannot be read raises);
    * else a directory with only a sentencepiece model or ``vocab.json`` +
      ``merges.txt`` (which ``transformers`` converts): raises, not ported;
    * a directory with no tokenizer files, or a model name: the hash
      tokenizer at ``vocab_size``, as in the JAX package.
    """
    key = (model_name, vocab_size, max_length)
    if key in _TOKENIZER_CACHE:
        return _TOKENIZER_CACHE[key]
    tok = None
    if os.path.isdir(model_name):
        if os.path.exists(os.path.join(model_name, "tokenizer.json")):
            tok = JsonTokenizer(model_name, max_length=max_length)
        elif os.path.exists(os.path.join(model_name, "vocab.txt")):
            tok = HFTokenizer(model_name, max_length=max_length)
        else:
            found = [f for f in _TOKENIZER_FILES if os.path.exists(os.path.join(model_name, f))]
            if found:
                from ..backends.common import not_ported

                raise not_ported(f"the tokenizer of {model_name} ({', '.join(found)}, no tokenizer.json or vocab.txt)",
                                 "ROADMAP.md §A #4")
    if tok is None:
        tok = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    _TOKENIZER_CACHE[key] = tok
    return tok
