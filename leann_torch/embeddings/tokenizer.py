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
  ``vocab.txt``, written here: the port needs no ``transformers``. It gives
  the ids and masks of ``transformers``' ``BertTokenizerFast`` on the same
  directory.

:func:`get_tokenizer` picks one: a directory with ``vocab.txt`` gets the
WordPiece, a directory with no tokenizer files (or a model name) the hash
tokenizer, and a directory whose tokenizer is of another kind raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

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


# BERT's ASCII punctuation: ranges 33-47, 58-64, 91-96 and 123-126
_ASCII_PUNCT = "".join(chr(c) for c in (*range(33, 48), *range(58, 65), *range(91, 97), *range(123, 127)))
_ASCII_SPLIT = re.compile("[^ " + re.escape(_ASCII_PUNCT) + "]+|[" + re.escape(_ASCII_PUNCT) + "]")
# Unicode White_Space: the whitespace BERT's normalizer turns into spaces
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(chr(c) for c in range(0x2000, 0x200B)))
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_TOKENIZER_FILES = ("tokenizer.json", "spiece.model", "sentencepiece.bpe.model", "tokenizer.model",
                    "vocab.json", "merges.txt")
_WORDPIECE_CLASSES = ("BertTokenizer", "BertTokenizerFast", "DistilBertTokenizer", "DistilBertTokenizerFast")
_MEMO_WORDS = 1 << 20  # the per-word memo is cleared when it grows past this


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punct(ch: str) -> bool:
    return ch in _ASCII_PUNCT or unicodedata.category(ch).startswith("P")


def _token_content(tok) -> "str | None":
    return tok.get("content") if isinstance(tok, dict) else tok


class HFTokenizer:
    """BERT WordPiece over a local checkpoint directory's ``vocab.txt``.

    Reads ``tokenizer_config.json`` (then ``special_tokens_map.json``) for
    ``do_lower_case``, ``strip_accents``, ``tokenize_chinese_chars`` and the
    special tokens. The steps are those of ``BertTokenizerFast``:

    1. the special tokens' literal text is matched first and kept whole;
    2. the normalizer drops NUL, U+FFFD and control characters (category C,
       but tab, newline and return), turns whitespace into spaces, spaces
       out CJK ideographs, strips accents (NFD, the Mn marks dropped) and
       lowercases character by character;
    3. the text splits on whitespace and around each punctuation character
       (Unicode P* and ASCII 33-47, 58-64, 91-96, 123-126);
    4. each word takes the greedy longest-match WordPiece with ``##``
       continuations; a word of more than 100 characters, or one that
       cannot be covered, is ``[UNK]``.

    Output: ``[CLS] ... [SEP]`` truncated and padded to ``max_length``, as
    int32 ids and mask. Words are memoised, so a corpus of many passages
    pays for each distinct word once.
    """

    max_input_chars_per_word = 100

    def __init__(self, path: str, max_length: int = 256):
        cfg = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):  # the config wins
            f = os.path.join(path, name)
            if os.path.exists(f):
                with open(f, encoding="utf-8") as fh:
                    cfg.update(json.load(fh))
        cls_name = cfg.get("tokenizer_class")
        if cls_name is not None and cls_name not in _WORDPIECE_CLASSES:
            from ..backends.common import not_ported

            raise not_ported(f"the tokenizer class {cls_name!r} of {path}", "only BERT WordPiece is ported")
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as fh:
            tokens = [line.rstrip("\n") for line in fh]
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(tokens)}  # a repeated token: its last line
        self.lowercase = bool(cfg.get("do_lower_case", True))
        sa = cfg.get("strip_accents")
        self.strip_accents = self.lowercase if sa is None else bool(sa)
        self.chinese_chars = bool(cfg.get("tokenize_chinese_chars", True))
        names = {k: _token_content(cfg.get(f"{k}_token")) or d
                 for k, d in (("unk", "[UNK]"), ("cls", "[CLS]"), ("sep", "[SEP]"), ("pad", "[PAD]"), ("mask", "[MASK]"))}
        missing = [names[k] for k in ("unk", "cls", "sep", "pad") if names[k] not in self.vocab]
        if missing:
            raise ValueError(f"{path}/vocab.txt lacks the special tokens {missing}")
        self.unk_id, self.cls_id, self.sep_id, self.pad_id = (self.vocab[names[k]] for k in ("unk", "cls", "sep", "pad"))
        specials = sorted({n for n in names.values() if n in self.vocab}, key=len, reverse=True)
        self._special_re = re.compile("(" + "|".join(re.escape(t) for t in specials) + ")")
        self._ascii_table = {c: None for c in (*range(0, 9), 11, 12, *range(14, 32), 127)}
        self._ascii_table.update({9: " ", 10: " ", 13: " "})
        if self.lowercase:
            self._ascii_table.update({c: chr(c + 32) for c in range(65, 91)})
        self._memo: Dict[str, Tuple[int, ...]] = {}
        self.max_length = max_length
        self.vocab_size = len(tokens)

    # -- normalization and pre-tokenization ----------------------------------

    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            if ch == "\x00" or ch == "\ufffd" or (ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")):
                continue
            if ch in _WHITESPACE:
                out.append(" ")
            elif self.chinese_chars and _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        s = "".join(out)
        if self.strip_accents:
            s = "".join(c for c in unicodedata.normalize("NFD", s) if unicodedata.category(c) != "Mn")
        if self.lowercase:
            s = "".join(c.lower() for c in s)
        return s

    def _words(self, text: str) -> List[str]:
        if text.isascii():
            return _ASCII_SPLIT.findall(text.translate(self._ascii_table))
        words = []
        for w in self._normalize(text).split():
            start = 0
            for i, ch in enumerate(w):
                if _is_punct(ch):
                    if i > start:
                        words.append(w[start:i])
                    words.append(ch)
                    start = i + 1
            if start < len(w):
                words.append(w[start:])
        return words

    def _wordpiece(self, word: str) -> Tuple[int, ...]:
        ids = self._memo.get(word)
        if ids is not None:
            return ids
        if len(word) > self.max_input_chars_per_word:
            ids = (self.unk_id,)
        else:
            out, start = [], 0
            while start < len(word):
                end, cur = len(word), None
                while start < end:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    cur = self.vocab.get(piece)
                    if cur is not None:
                        break
                    end -= 1
                if cur is None:
                    out = [self.unk_id]
                    break
                out.append(cur)
                start = end
            ids = tuple(out)
        if len(self._memo) >= _MEMO_WORDS:
            self._memo.clear()
        self._memo[word] = ids
        return ids

    def token_ids(self, text: str) -> List[int]:
        """The ids of ``text`` without [CLS]/[SEP], truncation or padding."""
        ids: List[int] = []
        parts = self._special_re.split(text) if self._special_re.search(text) else [text]
        for j, part in enumerate(parts):
            if j % 2:  # a special token's literal text
                ids.append(self.vocab[part])
                continue
            for w in self._words(part):
                ids.extend(self._wordpiece(w))
        return ids

    # -- batches -------------------------------------------------------------

    def encode_batch(self, texts: Sequence[str], max_length: "int | None" = None) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.max_length
        ids = np.full((len(texts), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, t in enumerate(texts):
            row = [self.cls_id, *self.token_ids(t)[: max(L - 2, 0)], self.sep_id][:L]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def encode(self, text: str, max_length: "int | None" = None):
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]


_TOKENIZER_CACHE: dict = {}


def get_tokenizer(model_name: str, vocab_size: int = 32768, max_length: int = 256):
    """The tokenizer for ``model_name``:

    * a local directory with ``vocab.txt``: :class:`HFTokenizer` (a
      ``vocab.txt`` that cannot be read raises);
    * a directory with a tokenizer of another kind (``tokenizer.json`` or a
      sentencepiece / BPE model, and no ``vocab.txt``): raises, not ported;
    * a directory with no tokenizer files, or a model name: the hash
      tokenizer at ``vocab_size``, as in the JAX package.
    """
    key = (model_name, vocab_size, max_length)
    if key in _TOKENIZER_CACHE:
        return _TOKENIZER_CACHE[key]
    tok = None
    if os.path.isdir(model_name):
        if os.path.exists(os.path.join(model_name, "vocab.txt")):
            tok = HFTokenizer(model_name, max_length=max_length)
        elif any(os.path.exists(os.path.join(model_name, f)) for f in _TOKENIZER_FILES):
            from ..backends.common import not_ported

            raise not_ported(f"the tokenizer of {model_name} (no vocab.txt: not WordPiece)",
                             "only BERT WordPiece is ported")
    if tok is None:
        tok = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    _TOKENIZER_CACHE[key] = tok
    return tok
