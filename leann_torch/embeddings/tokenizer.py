"""Tokenization for the on-device encoder.

The recompute path needs token ids resident in device memory, so tokenization
is a first-class build step. The hash tokenizer here is the pure-Python form;
it emits the same ids as the JAX package's tokenizer (whose native ASCII path
is documented as bit-exact with this one), so token stores written by either
package read the same in the other.

Two tokenizers:

* :class:`HashTokenizer` — deterministic, dependency-free, offline hashing
  word tokenizer. Stable across processes/platforms (ids come from blake2b of
  the normalized word), so an index built in one process is searchable from
  another with bit-identical token streams.
* :class:`HFTokenizer` — wraps a local HuggingFace tokenizer when one is
  available on disk (no network fetch is ever attempted).
"""

from __future__ import annotations

import hashlib
import re
import unicodedata
from dataclasses import dataclass
from typing import List, Sequence, Tuple

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
        L = max_length or self.max_length
        ids = np.empty((len(texts), L), dtype=np.int32)
        mask = np.empty((len(texts), L), dtype=np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, L)
        return ids, mask


class HFTokenizer:
    """Local-only wrapper over a HuggingFace tokenizer directory."""

    def __init__(self, path: str, max_length: int = 256):
        from transformers import AutoTokenizer  # local files only; no fetch

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.max_length = max_length
        self.vocab_size = self._tok.vocab_size

    def encode_batch(self, texts: Sequence[str], max_length: "int | None" = None):
        L = max_length or self.max_length
        out = self._tok(
            list(texts), padding="max_length", truncation=True, max_length=L, return_tensors="np"
        )
        return out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.int32)

    def encode(self, text: str, max_length: "int | None" = None):
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]


_TOKENIZER_CACHE: dict = {}


def get_tokenizer(model_name: str, vocab_size: int = 32768, max_length: int = 256):
    """Return the tokenizer for ``model_name``. If the name is a local
    directory containing HF tokenizer files, load it; otherwise use the
    deterministic hash tokenizer."""
    key = (model_name, vocab_size, max_length)
    if key in _TOKENIZER_CACHE:
        return _TOKENIZER_CACHE[key]
    import os

    tok = None
    if os.path.isdir(model_name):
        try:
            tok = HFTokenizer(model_name, max_length=max_length)
        except Exception:
            tok = None
    if tok is None:
        tok = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    _TOKENIZER_CACHE[key] = tok
    return tok
