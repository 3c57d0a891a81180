"""A checkpoint's ``tokenizer.json``, read and run without ``tokenizers``.

``tokenizer.json`` is the serialised pipeline of the ``tokenizers`` library,
the file ``transformers``' fast tokenizers load. The card's machine has
neither library (nor ``regex``), so :class:`JsonTokenizer` runs the pipeline
itself and gives the ids and masks of ``AutoTokenizer`` on the same directory
called with ``padding="max_length", truncation=True, max_length=L``:

1. **added tokens** are cut out first: those with ``normalized`` false from
   the raw text, the others from each normalized piece between them
   (leftmost-longest, with ``lstrip`` / ``rstrip`` taking the whitespace
   beside a match and ``single_word`` refusing a match inside a word);
2. the **normalizer** runs on each piece between added tokens: ``Sequence``,
   ``Precompiled`` (SentencePiece's compiled rules, looked up per grapheme
   cluster), ``Replace``, ``Prepend``, ``Nmt``, ``NFC`` /
   ``NFD`` / ``NFKC`` / ``NFKD``, ``Lowercase``, ``StripAccents``,
   ``Strip``, ``BertNormalizer``;
3. the **pre-tokenizer** splits the pieces into words: ``Sequence``,
   ``Metaspace``, ``ByteLevel`` (the GPT-2 split), ``WhitespaceSplit``,
   ``Whitespace``, ``BertPreTokenizer``, ``Digits``, ``Punctuation``,
   ``Split`` (a string, or an Oniguruma regex translated to ``re`` by
   :func:`onig_to_re`, its ``\\p{..}`` classes built from ``unicodedata``
   at load; each split behaviour, ``invert``);
4. the **model** maps each word to ids, memoised per word: ``Unigram``
   (Viterbi over the piece scores), ``BPE`` (merges by rank), ``WordPiece``,
   ``WordLevel``; Unigram's and BPE's ``byte_fallback`` emit the ``<0xNN>``
   pieces of what the vocab lacks;
5. the content is cut to ``L`` less the **post-processor**'s special tokens
   (``TemplateProcessing``, ``RobertaProcessing``, ``BertProcessing``,
   ``ByteLevel``, ``Sequence``, or none), which are then added, and the row
   is padded with the tokenizer's pad id.

BERT's own pieces (``bert_normalize``, ``bert_split``, ``wordpiece``) live
here too: ``tokenizer.HFTokenizer`` runs a ``vocab.txt`` as the pipeline
``transformers`` converts it to, through this class, and so do the
converted pipelines of a SentencePiece ``.model`` and of ``vocab.json`` +
``merges.txt`` (``tokenizer.py``). Over ASCII text the BERT normalizer and
pre-tokenizer, and ``Precompiled``, take one ``str.translate`` or regex
each.

What ``transformers`` changes on load is done here too: the top-level
``ByteLevel`` pre-tokenizer takes ``add_prefix_space`` from
``tokenizer_config.json`` (default false), a BERT-type tokenizer's
``BertNormalizer`` takes ``do_lower_case``, ``strip_accents`` and
``tokenize_chinese_chars`` from it, and special tokens named there (or by
the class: CamemBERT's three ``NOTUSED`` tokens) that the file lacks are
added. Another component type (of ``tokenizers``' own, ``UnicodeScripts``:
``unicodedata`` has no Script property), BPE ``dropout`` above 0, and a
tokenizer class other than BERT, DistilBERT, ELECTRA, RoBERTa, XLM-R,
CamemBERT or the generic fast class, raise ``not_ported`` naming it.

Unicode tables: Python's are Unicode 15; the ``tokenizers`` library's
normalization and category tables are older, so a character assigned or
recategorised between the two may tokenize differently. The tests hold this
module to ``transformers`` on a curated alphabet of many scripts.
"""

from __future__ import annotations

import base64
import functools
import heapq
import itertools
import json
import os
import re
import struct
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_ROADMAP = "ROADMAP.md §A #4"
_MEMO_WORDS = 1 << 20  # the per-word memo is cleared when it grows past this
# BERT's ASCII punctuation: ranges 33-47, 58-64, 91-96 and 123-126
_ASCII_PUNCT = "".join(chr(c) for c in (*range(33, 48), *range(58, 65), *range(91, 97), *range(123, 127)))
# Unicode White_Space: the whitespace BERT's normalizer turns into spaces
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(chr(c) for c in range(0x2000, 0x200B)))
_WS = "".join(sorted(_WHITESPACE))
_ASCII_WS = "".join(sorted(c for c in _WHITESPACE if c.isascii()))
# bert_split over ASCII text: runs of neither whitespace nor punctuation, and each punctuation character
_ASCII_SPLIT = re.compile("[^" + re.escape(_ASCII_WS + _ASCII_PUNCT) + "]+|[" + re.escape(_ASCII_PUNCT) + "]")
# bert_normalize over ASCII text, by (clean_text, lowercase): with clean_text the
# controls dropped but tab, newline and return, which become spaces
_ASCII_CLEAN = {c: None for c in (*range(0, 9), 11, 12, *range(14, 32), 127)} | {9: " ", 10: " ", 13: " "}
_ASCII_LOWER = {c: chr(c + 32) for c in range(65, 91)}
_ASCII_BERT = {(clean, lower): {**(_ASCII_CLEAN if clean else {}), **(_ASCII_LOWER if lower else {})}
               for clean in (False, True) for lower in (False, True)}
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# the tokenizer classes whose loading is reproduced here, and the model
# types AutoTokenizer maps to them when tokenizer_config.json names none
_CLASSES = ("BertTokenizer", "DistilBertTokenizer", "ElectraTokenizer", "RobertaTokenizer", "XLMRobertaTokenizer",
            "CamembertTokenizer", "PreTrainedTokenizer")
_CLASS_OF_MODEL_TYPE = {"bert": "BertTokenizer", "distilbert": "DistilBertTokenizer", "electra": "ElectraTokenizer",
                        "roberta": "RobertaTokenizer", "xlm-roberta": "XLMRobertaTokenizer",
                        "camembert": "CamembertTokenizer"}
# the classes whose fast tokenizer sets BertNormalizer's options from the config
_BERT_CLASSES = ("BertTokenizer", "DistilBertTokenizer", "ElectraTokenizer")
_SPECIAL_NAMES = ("bos", "eos", "unk", "sep", "pad", "cls", "mask")
_BERT_SPECIALS = {"unk": "[UNK]", "sep": "[SEP]", "pad": "[PAD]", "cls": "[CLS]", "mask": "[MASK]"}
_ROBERTA_SPECIALS = {"bos": "<s>", "eos": "</s>", "sep": "</s>", "cls": "<s>", "unk": "<unk>", "pad": "<pad>",
                     "mask": "<mask>"}
_CLASS_SPECIALS = {"BertTokenizer": _BERT_SPECIALS, "DistilBertTokenizer": _BERT_SPECIALS,
                   "ElectraTokenizer": _BERT_SPECIALS, "RobertaTokenizer": _ROBERTA_SPECIALS,
                   "XLMRobertaTokenizer": _ROBERTA_SPECIALS, "CamembertTokenizer": _ROBERTA_SPECIALS,
                   "PreTrainedTokenizer": {}}
# the mask token of the RoBERTa classes takes the space before it and is
# matched on the raw text (the fast classes make it special, which turns
# normalization off)
_CLASS_MASK = {c: dict(lstrip=True, normalized=False)
               for c in ("RobertaTokenizer", "XLMRobertaTokenizer", "CamembertTokenizer")}
# the additional special tokens a class adds when the config names none
_CLASS_ADDITIONAL = {"CamembertTokenizer": ("<s>NOTUSED", "</s>NOTUSED", "<unk>NOTUSED")}
_NMT = {**{c: None for c in (*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F)},
        **{c: " " for c in (0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029, 0x2581,
                            0xFEFF, 0xFFFD)}}


def _not_ported(what: str) -> NotImplementedError:
    from ..backends.common import not_ported

    return not_ported(what, _ROADMAP)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_config(path: str) -> dict:
    """A checkpoint directory's tokenizer config: ``special_tokens_map.json``
    updated by ``tokenizer_config.json`` (the config wins)."""
    cfg: dict = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        cfg.update(_read_json(os.path.join(path, name)))
    return cfg


# ---------------------------------------------------------------------------
# Character classes
# ---------------------------------------------------------------------------

def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punct(ch: str) -> bool:
    return ch in _ASCII_PUNCT or unicodedata.category(ch).startswith("P")


def _is_word_char(ch: str) -> bool:
    """``\\w`` of Rust's regex and of Oniguruma: Alphabetic (letters and
    Nl), marks, Nd, Pc, the joiners."""
    cat = unicodedata.category(ch)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or ch in "\u200c\u200d"


# GPT-2's pre-tokenizer split, the pattern tokenizers' ByteLevel runs
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
# the same pattern over ASCII text, where its classes are plain ranges (White_Space
# in ASCII is space, \t, \n, \v, \f, \r; \x1c-\x1f are not, though Python's \s has them)
_GPT2_ASCII = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^ \t\n\x0b\x0c\rA-Za-z0-9]+"
                         r"|[ \t\n\x0b\x0c\r]+(?![^ \t\n\x0b\x0c\r])|[ \t\n\x0b\x0c\r]+")


def gpt2_split(s: str) -> List[str]:
    """The GPT-2 split (:data:`GPT2_PATTERN`): over ASCII text by ``re``
    with the classes spelled out, else by the pattern translated by
    :func:`compile_onig`. The pattern covers every character, so the
    matches are the pieces."""
    return _GPT2_ASCII.findall(s) if s.isascii() else compile_onig(GPT2_PATTERN).findall(s)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHARS = _bytes_to_unicode()


def _byte_chars(w: str) -> str:
    """``w``'s UTF-8 bytes as GPT-2's printable characters (each byte read
    as the Latin-1 code point of its value, then mapped)."""
    return w.encode("utf-8").decode("latin-1").translate(_BYTE_CHARS)


# ---------------------------------------------------------------------------
# Oniguruma patterns in Python's re
# ---------------------------------------------------------------------------

# in Oniguruma's \w beside letters, marks, Nd, Nl and Pc: Latin-1's superscripts
# and fractions, and the Alphabetic symbols (circled, squared, negative squared letters)
_ONIG_WORD_EXTRA = ((0xB2, 0xB3), (0xB9, 0xB9), (0xBC, 0xBE), (0x24B6, 0x24E9), (0x1F130, 0x1F149),
                    (0x1F150, 0x1F169), (0x1F170, 0x1F189))
_CATEGORY_NAMES = {"Letter": "L", "Mark": "M", "Number": "N", "Punctuation": "P", "Symbol": "S", "Separator": "Z",
                   "Other": "C"}


@functools.lru_cache(maxsize=1)
def _category_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """Each general category (``Lu``, ``Nd``, ...) -> its code point
    ranges, from ``unicodedata``."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    pos = 0
    for cat, run in itertools.groupby(map(unicodedata.category, map(chr, range(0x110000)))):
        n = sum(1 for _ in run)
        out.setdefault(cat, []).append((pos, pos + n - 1))
        pos += n
    return out


def _merge_ranges(ranges) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ranges) -> List[Tuple[int, int]]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= 0x10FFFF:
        out.append((nxt, 0x10FFFF))
    return out


def _predicate_ranges(pred: Callable[[str], bool]) -> List[Tuple[int, int]]:
    out, pos = [], 0
    for keep, run in itertools.groupby(map(pred, map(chr, range(0x110000)))):
        n = sum(1 for _ in run)
        if keep:
            out.append((pos, pos + n - 1))
        pos += n
    return out


@functools.lru_cache(maxsize=None)
def _class_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code point ranges of a property or shorthand class: a general
    category or its major class (``\\p{L}``, ``\\p{Nd}``, ``\\p{Letter}``),
    or Oniguruma's Unicode ``\\s`` (White_Space), ``\\w`` (letters, marks,
    Nd, Nl, Pc and ``_ONIG_WORD_EXTRA``), ``\\d`` (Nd)."""
    if name == "s":
        return tuple(_merge_ranges((ord(c), ord(c)) for c in _WHITESPACE))
    if name == "w":
        return tuple(_merge_ranges(_predicate_ranges(lambda ch: _is_word_char(ch) and ch not in "\u200c\u200d")
                                   + list(_ONIG_WORD_EXTRA)))
    name = "Nd" if name == "d" else _CATEGORY_NAMES.get(name, name)
    cats = _category_ranges()
    if name in cats:
        keys = [name]
    elif len(name) == 1 and any(k.startswith(name) for k in cats):
        keys = [k for k in cats if k.startswith(name)]
    else:
        raise _not_ported(f"the regex property \\p{{{name}}}")
    return tuple(_merge_ranges(r for k in keys for r in cats[k]))


def _ranges_re(ranges) -> str:
    return "".join(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}" for lo, hi in ranges)


def onig_to_re(pattern: str) -> str:
    """An Oniguruma pattern (``tokenizers``' ``Regex``, Ruby syntax) as a
    Python ``re`` pattern with the same matches on assigned characters:
    ``\\p{..}`` / ``\\P{..}`` / ``\\p{^..}`` and ``\\s \\w \\d`` (and their
    negations) become explicit classes (Python's ``\\s`` and ``\\w`` differ
    from Oniguruma's and it has no ``\\p``); compile with ``re.MULTILINE``
    (Ruby's ``^`` and ``$`` are line anchors). A character Python's Unicode
    tables leave unassigned may differ."""
    out: List[str] = []
    i, n, depth = 0, len(pattern), 0
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            name = None
            neg = False
            if e in "pP":
                neg = e == "P"
                if i + 2 < n and pattern[i + 2] == "{":
                    close = pattern.find("}", i + 3)
                    if close < 0:
                        raise _not_ported(f"the regex {pattern!r} (an unclosed \\{e}{{)")
                    name = pattern[i + 3 : close]
                    if name.startswith("^"):
                        neg, name = not neg, name[1:]
                    i = close + 1
                else:  # Ruby syntax has no \pL
                    raise _not_ported(f"the regex {pattern!r} (\\{e} without braces)")
            elif e in "sSwWdD":
                name, neg = e.lower(), e.isupper()
                i += 2
            if name is not None:
                ranges = _class_ranges(name)
                if neg:
                    ranges = tuple(_complement(ranges))
                out.append(_ranges_re(ranges) if depth else f"[{_ranges_re(ranges)}]")
                continue
            out.append(pattern[i : i + 2])
            i += 2
            continue
        if depth:
            if c == "[":
                raise _not_ported(f"the regex {pattern!r} (a nested character class)")
            if c == "]" and not (out and out[-1] in ("[", "[^")):
                depth = 0
            out.append(c)
            i += 1
            continue
        if c == "[":
            depth = 1
            if pattern.startswith("[^", i):
                out.append("[^")
                i += 2
            else:
                out.append("[")
                i += 1
            if i < n and pattern[i] == "]":  # a leading ] is a literal
                out.append("\\]")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=256)
def compile_onig(pattern: str) -> "re.Pattern":
    try:
        return re.compile(onig_to_re(pattern), re.MULTILINE)
    except re.error as e:
        raise _not_ported(f"the regex {pattern!r} ({e})")


def _find_matches(rx: "re.Pattern", s: str) -> List[Tuple[int, int, bool]]:
    """The pieces of ``s`` between and at ``rx``'s matches, in order:
    (start, stop, is a match). As Oniguruma's iterator, an empty match
    right where the last one ended is skipped."""
    out: List[Tuple[int, int, bool]] = []
    prev, last_end = 0, -1
    for m in rx.finditer(s):
        a, b = m.span()
        if a == b and a == last_end:
            continue
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = last_end = b
    if prev != len(s):
        out.append((prev, len(s), False))
    return out


def _char_matches(pred: Callable[[str], bool], s: str) -> List[Tuple[int, int, bool]]:
    """Each character ``pred`` takes a match of its own, the runs between
    them one piece each (``tokenizers``' pattern of a ``Fn(char)``)."""
    out: List[Tuple[int, int, bool]] = []
    last = 0
    for i, ch in enumerate(s):
        if pred(ch):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(s):
        out.append((last, len(s), False))
    return out


def split_by(s: str, matches: List[Tuple[int, int, bool]], behavior: str) -> List[str]:
    """``s`` cut at ``matches`` as ``NormalizedString::split`` does under
    ``behavior``: a match removed, alone, joined to the piece before or
    after it, or runs of matches (and of non-matches) kept together; no
    empty piece is kept."""
    if behavior == "Removed":
        spans = [(a, b) for a, b, m in matches if not m]
    elif behavior == "Isolated":
        spans = [(a, b) for a, b, _ in matches]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        spans, prev = [], False
        for a, b, m in matches:
            join = m == prev if behavior == "Contiguous" else (m and not prev)
            if join and spans:
                spans[-1] = (spans[-1][0], b)
            else:
                spans.append((a, b))
            prev = m
    elif behavior == "MergedWithNext":
        spans, prev = [], False
        for a, b, m in reversed(matches):
            if m and not prev and spans:
                spans[-1] = (a, spans[-1][1])
            else:
                spans.append((a, b))
            prev = m
        spans.reverse()
    else:
        raise ValueError(f"a split behavior {behavior!r}: tokenizers has Removed, Isolated, MergedWithPrevious, "
                         "MergedWithNext and Contiguous")
    return [s[a:b] for a, b in spans if b > a]


def _is_numeric(ch: str) -> bool:
    """Rust's ``char::is_numeric``: the categories Nd, Nl, No."""
    return unicodedata.category(ch)[0] == "N"


# ---------------------------------------------------------------------------
# BERT's normalizer, pre-tokenizer and WordPiece
# ---------------------------------------------------------------------------

def bert_normalize(text: str, clean_text: bool, chinese_chars: bool, strip_accents: bool, lowercase: bool) -> str:
    """BERT's normalizer (``BertNormalizer`` of ``tokenizers``): with
    ``clean_text`` NUL, U+FFFD and control characters (category C, but tab,
    newline and return) are dropped and whitespace becomes a space; CJK
    ideographs are spaced out; accents are stripped (NFD, the Mn marks
    dropped); lowercasing goes character by character. ASCII text takes one
    ``str.translate``, which does the same."""
    if text.isascii():
        return text.translate(_ASCII_BERT[bool(clean_text), bool(lowercase)])
    out = []
    for ch in text:
        if clean_text:
            if ch == "\x00" or ch == "\ufffd" or (ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")):
                continue
            if ch in _WHITESPACE:
                out.append(" ")
                continue
        if chinese_chars and _is_cjk(ord(ch)):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    s = "".join(out)
    if strip_accents:
        s = "".join(c for c in unicodedata.normalize("NFD", s) if unicodedata.category(c) != "Mn")
    if lowercase:
        s = "".join(c.lower() for c in s)
    return s


def bert_split(text: str) -> List[str]:
    """BERT's pre-tokenizer: split on Unicode whitespace, and around each
    punctuation character (Unicode P* and ASCII 33-47, 58-64, 91-96,
    123-126), which stands alone. ASCII text takes one regex, which does the
    same."""
    if text.isascii():
        return _ASCII_SPLIT.findall(text)
    words, start = [], 0
    for i, ch in enumerate(text):
        if ch in _WHITESPACE or _is_punct(ch):
            if i > start:
                words.append(text[start:i])
            if ch not in _WHITESPACE:
                words.append(ch)
            start = i + 1
    if start < len(text):
        words.append(text[start:])
    return words


def wordpiece(word: str, vocab: Dict[str, int], unk_id: int, prefix: str = "##",
              max_chars: int = 100) -> Tuple[int, ...]:
    """Greedy longest-match WordPiece of one word: the longest vocab entry
    at each position, ``prefix`` before every piece but the first; a word
    of more than ``max_chars`` characters, or one that cannot be covered,
    is one ``unk_id``."""
    if len(word) > max_chars:
        return (unk_id,)
    out, start = [], 0
    while start < len(word):
        end, cur = len(word), None
        while start < end:
            cur = vocab.get(word[start:end] if start == 0 else prefix + word[start:end])
            if cur is not None:
                break
            end -= 1
        if cur is None:
            return (unk_id,)
        out.append(cur)
        start = end
    return tuple(out)


# ---------------------------------------------------------------------------
# Grapheme clusters (UAX #29, the rules Precompiled's lookups can see)
# ---------------------------------------------------------------------------

_OTHER_GRAPHEME_EXTEND = frozenset([0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6, 0x0D3E,
                                    0x0D57, 0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E, 0x302F, 0xFF9E, 0xFF9F, 0x1133E,
                                    0x11357, 0x114B0, 0x114BD, 0x115AF, 0x11930, 0x1D165, *range(0x1D16E, 0x1D173)])
_NOT_SPACING = frozenset([0x102B, 0x102C, 0x1038, *range(0x1062, 0x1065), *range(0x1067, 0x106E), 0x1083,
                          *range(0x1087, 0x108D), 0x108F, *range(0x109A, 0x109D), 0x1A61, 0x1A63, 0x1A64, 0xAA7B,
                          0xAA7D, 0x11720, 0x11721])
_PREPEND = frozenset([*range(0x0600, 0x0606), 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x0D4E, 0x110BD, 0x110CD,
                      0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A, *range(0x11A84, 0x11A8A), 0x11D46, 0x11F02])
_EXT_PICT = ((0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
             (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328),
             (0x2388, 0x2388), (0x23CF, 0x23CF), (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
             (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
             (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712), (0x2714, 0x2714),
             (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
             (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755),
             (0x2757, 0x2757), (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
             (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
             (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3297), (0x3299, 0x3299),
             (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F),
             (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
             (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D),
             (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F),
             (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
             (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))
@functools.lru_cache(maxsize=1 << 16)
def _gcb(ch: str) -> str:
    """The Grapheme_Cluster_Break property, from ``unicodedata`` and the
    tables above."""
    cp, cat = ord(ch), unicodedata.category(ch)
    if ch == "\r":
        return "CR"
    elif ch == "\n":
        return "LF"
    elif ch == "\u200d":
        return "ZWJ"
    elif cp in _PREPEND:
        return "Prepend"
    elif cat in ("Mn", "Me") or cp in _OTHER_GRAPHEME_EXTEND or 0xE0020 <= cp <= 0xE007F or 0x1F3FB <= cp <= 0x1F3FF:
        return "Extend"
    elif cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return "Control"
    elif (cat == "Mc" and cp not in _NOT_SPACING) or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    elif 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    elif 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    elif 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    elif 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    elif 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    elif any(lo <= cp <= hi for lo, hi in _EXT_PICT):
        return "ExtPict"
    return "Other"


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters: CR LF, controls alone, Hangul syllable
    sequences, Extend / ZWJ / SpacingMark after their base, Prepend before
    it, emoji ZWJ sequences, regional-indicator pairs."""
    if text.isascii() and "\r\n" not in text:
        return list(text)
    out: List[str] = []
    start, prev = 0, None
    pict = pict_zwj = False
    ri = 0
    for i, ch in enumerate(text):
        a = _gcb(ch)
        if prev is not None:
            b = prev
            if b == "CR" and a == "LF":
                join = True
            elif b in ("Control", "CR", "LF") or a in ("Control", "CR", "LF"):
                join = False
            elif b == "L" and a in ("L", "V", "LV", "LVT"):
                join = True
            elif b in ("LV", "V") and a in ("V", "T"):
                join = True
            elif b in ("LVT", "T") and a == "T":
                join = True
            elif a in ("Extend", "ZWJ", "SpacingMark") or b == "Prepend":
                join = True
            elif pict_zwj and a == "ExtPict":
                join = True
            elif b == "RI" and a == "RI":
                join = ri % 2 == 1
            else:
                join = False
            if not join:
                out.append(text[start:i])
                start = i
        pict_zwj = a == "ZWJ" and pict
        pict = a == "ExtPict" or (a == "Extend" and pict)
        ri = ri + 1 if a == "RI" else 0
        prev = a
    if start < len(text):
        out.append(text[start:])
    return out


# ---------------------------------------------------------------------------
# Normalizers: str -> str
# ---------------------------------------------------------------------------

class Precompiled:
    """SentencePiece's compiled normalization rules (``precompiled_charsmap``):
    a little-endian u32 trie size, a darts-clone double array of that many
    bytes (u32 units), then the NUL-terminated replacements the leaves point
    into. As ``tokenizers`` applies it: each grapheme cluster under 6 bytes
    is looked up whole, and the FIRST (shortest) key that is a prefix of it
    replaces the whole cluster; otherwise (or for a longer cluster) each
    code point is looked up alone. In ASCII text without CR LF every
    character is a cluster of its own, so such text takes one
    ``str.translate`` by the ASCII characters' lookups."""

    def __init__(self, blob: bytes):
        self.units: Tuple[int, ...] = ()
        self.strings = b""
        if blob:
            (size,) = struct.unpack_from("<I", blob, 0)
            self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
            self.strings = blob[4 + size :]
        self._memo: Dict[str, Optional[str]] = {}
        self._ascii = {c: r for c in range(128) if (r := self._lookup(chr(c))) is not None}

    def _search(self, key: bytes) -> Optional[str]:
        """The replacement of the shortest key that prefixes ``key``."""
        units, n = self.units, len(self.units)
        if not n:
            return None
        u = units[0]
        pos = (u >> 10) << ((u & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= n:
                return None
            u = units[pos]
            if (u & ((1 << 31) | 0xFF)) != c:
                return None
            pos ^= (u >> 10) << ((u & (1 << 9)) >> 6)
            if (u >> 8) & 1:
                if pos >= n:
                    return None
                v = units[pos] & ((1 << 31) - 1)
                end = self.strings.find(b"\0", v)
                return self.strings[v : end if end >= 0 else len(self.strings)].decode("utf-8")
        return None

    def _lookup(self, s: str) -> Optional[str]:
        if s not in self._memo:
            self._memo[s] = self._search(s.encode("utf-8"))
        return self._memo[s]

    def __call__(self, text: str) -> str:
        if not self.units:
            return text
        if text.isascii() and "\r\n" not in text:
            return text.translate(self._ascii)
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                r = self._lookup(g)
                if r is not None:
                    out.append(r)
                    continue
            for ch in g:
                r = self._lookup(ch)
                out.append(ch if r is None else r)
        return "".join(out)


def _lowercase(s: str) -> str:
    return s.lower() if s.isascii() else "".join(c.lower() for c in s)  # per character: no final-sigma rule


def _replace(spec: dict) -> Callable[[str], str]:
    pattern, content = spec["pattern"], spec["content"]
    if "String" in pattern:
        lit = pattern["String"]
        return lambda s: s.replace(lit, content) if lit else s
    rx = compile_onig(pattern["Regex"])
    return lambda s: rx.sub(lambda _m: content, s)


def make_normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [f for f in (make_normalizer(s) for s in spec["normalizers"]) if f is not None]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s

        return seq
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return _lowercase
    if kind == "StripAccents":
        return lambda s: "".join(c for c in s if not unicodedata.category(c).startswith("M"))
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s: str) -> str:
            s = s.lstrip(_WS) if left else s
            return s.rstrip(_WS) if right else s

        return strip
    if kind == "Nmt":
        return lambda s: s.translate(_NMT)
    if kind == "Replace":
        return _replace(spec)
    if kind == "Prepend":
        prepend = spec["prepend"]
        return lambda s: prepend + s if s else s
    if kind == "Precompiled":
        return Precompiled(base64.b64decode(spec.get("precompiled_charsmap") or ""))
    if kind == "BertNormalizer":
        lower = spec.get("lowercase", True)
        sa = spec.get("strip_accents")
        args = (spec.get("clean_text", True), spec.get("handle_chinese_chars", True),
                lower if sa is None else sa, lower)
        return lambda s: bert_normalize(s, *args)
    raise _not_ported(f"the normalizer type {kind!r}")


# ---------------------------------------------------------------------------
# Pre-tokenizers: (pieces, the first starts the text) -> (words, the first
# starts the text); no piece or word is empty
# ---------------------------------------------------------------------------

PreTokenizer = Callable[[List[str], bool], Tuple[List[str], bool]]


def _merged_with_next(s: str, ch: str) -> List[str]:
    """Split on each ``ch``, the delimiter joined to the text after it (a run
    of delimiters: all but the last alone), as ``tokenizers``'
    ``MergedWithNext``."""
    parts = s.split(ch)
    if all(parts[1:]):  # no delimiter run and none at the end: each joins the text after it
        return ([parts[0]] if parts[0] else []) + [ch + p for p in parts[1:]]
    segs = [(p, p == ch) for p in re.split(f"({re.escape(ch)})", s) if p]
    out: List[List] = []
    next_match = False
    for text, is_match in reversed(segs):
        if is_match and not next_match and out:
            out[-1][0] = text + out[-1][0]
        else:
            out.append([text])
        next_match = is_match
    return [p[0] for p in reversed(out)]


def _split_each(split: Callable[[str], List[str]]) -> PreTokenizer:
    """Each piece split by ``split`` (which gives no empty word): the first
    word starts the text if the first piece did and the word begins it."""

    def f(pieces: List[str], first: bool) -> Tuple[List[str], bool]:
        if not pieces:
            return [], False
        words = split(pieces[0])
        first = first and bool(words) and pieces[0].startswith(words[0])
        for s in pieces[1:]:
            words.extend(split(s))
        return words, first

    return f


def _whitespace_words(s: str) -> List[str]:
    """``\\w+|[^\\w\\s]+``; whitespace dropped."""
    out, i, n = [], 0, len(s)
    while i < n:
        if s[i] in _WHITESPACE:
            i += 1
            continue
        w = _is_word_char(s[i])
        e = i + 1
        while e < n and s[e] not in _WHITESPACE and _is_word_char(s[e]) == w:
            e += 1
        out.append(s[i:e])
        i = e
    return out


def make_pre_tokenizer(spec: Optional[dict]) -> PreTokenizer:
    if spec is None:
        return lambda pieces, first: (pieces, first)
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [make_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces: List[str], first: bool) -> Tuple[List[str], bool]:
            for f in steps:
                pieces, first = f(pieces, first)
            return pieces, first

        return seq
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or "always"
        if spec.get("add_prefix_space") is False:  # the legacy field
            scheme = "never"
        if scheme not in ("always", "first", "never"):
            raise _not_ported(f"the Metaspace prepend_scheme {scheme!r}")
        split = spec.get("split", True)

        def metaspace(pieces: List[str], first: bool) -> Tuple[List[str], bool]:
            out: List[str] = []
            for j, s in enumerate(pieces):
                s = s.replace(" ", rep)
                if (scheme == "always" or (scheme == "first" and first and j == 0)) and not s.startswith(rep):
                    s = rep + s
                if split:
                    out.extend(_merged_with_next(s, rep))
                else:
                    out.append(s)
            return out, first

        return metaspace
    if kind == "ByteLevel":
        prefix_space, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)
        if use_regex:
            compile_onig(GPT2_PATTERN)  # its classes built at load, not on the first non-ASCII text

        def byte_level(pieces: List[str], first: bool) -> Tuple[List[str], bool]:
            out: List[str] = []
            for s in pieces:
                if prefix_space and not s.startswith(" "):
                    s = " " + s
                words = gpt2_split(s) if use_regex else [s]
                mapped, pos = _byte_chars(s), 0  # the piece mapped once, cut at its words' bytes
                for w in words:
                    n = len(w) if s.isascii() else len(w.encode("utf-8"))
                    out.append(mapped[pos : pos + n])
                    pos += n
            return out, first

        return byte_level
    if kind == "WhitespaceSplit":
        return _split_each(lambda s: [w for w in re.split(f"[{re.escape(_WS)}]+", s) if w])
    if kind == "Whitespace":
        return _split_each(_whitespace_words)
    if kind == "BertPreTokenizer":
        return _split_each(bert_split)
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits") else "Contiguous"
        return _split_each(lambda s: split_by(s, _char_matches(_is_numeric, s), behavior))
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        return _split_each(lambda s: split_by(s, _char_matches(_is_punct, s), behavior))
    if kind == "Split":
        return _split_each(_split_pattern(spec))
    if kind == "UnicodeScripts":
        raise _not_ported("the UnicodeScripts pre-tokenizer (Python's unicodedata has no Script property)")
    raise _not_ported(f"the pre-tokenizer type {kind!r}")


def _split_pattern(spec: dict) -> Callable[[str], List[str]]:
    """``Split``: the pattern's matches (a ``String`` matched literally, a
    ``Regex`` through :func:`compile_onig`), flipped with ``invert``, cut
    under ``behavior``."""
    pattern, behavior, invert = spec["pattern"], spec["behavior"], bool(spec.get("invert", False))
    if "String" in pattern:
        rx = re.compile(re.escape(pattern["String"]))
    else:
        rx = compile_onig(pattern["Regex"])

    def split(s: str) -> List[str]:
        matches = _find_matches(rx, s)
        if invert:
            matches = [(a, b, not m) for a, b, m in matches]
        return split_by(s, matches, behavior)

    return split


# ---------------------------------------------------------------------------
# Models: word -> ids
# ---------------------------------------------------------------------------

K_UNK_PENALTY = 10.0  # the unknown piece's score: the lowest score less this


class Unigram:
    """SentencePiece Unigram: the Viterbi path of highest summed score over
    every piece that matches at each position (shorter first; a tie keeps
    the earlier candidate), a character no single piece covers scored as
    unknown, consecutive unknowns fused into one ``unk_id`` (with
    ``byte_fallback``, into the ``<0xNN>`` pieces of their UTF-8 bytes when
    the vocab holds each of them)."""

    def __init__(self, spec: dict):
        self.byte_fallback = bool(spec.get("byte_fallback"))
        vocab = spec["vocab"]
        self.pieces: Dict[str, int] = {p: i for i, (p, _) in enumerate(vocab)}  # a repeated piece: its last id
        self.scores = [float(s) for _, s in vocab]
        self.unk_id = spec.get("unk_id")
        self.unk_score = min(self.scores, default=0.0) - K_UNK_PENALTY
        self.trie: Dict[str, int] = {}  # every prefix of a piece: its id, or -1
        for p, i in self.pieces.items():
            for k in range(1, len(p)):
                self.trie.setdefault(p[:k], -1)
        self.trie.update(self.pieces)
        self.size = len(vocab)

    def __call__(self, w: str) -> Tuple[int, ...]:
        n = len(w)
        if not n:
            return ()
        trie, scores, unk_score = self.trie, self.scores, self.unk_score
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        node = [0] * (n + 1)
        for i in range(n):
            base, single = best[i], False
            for j in range(i + 1, n + 1):
                v = trie.get(w[i:j])
                if v is None:
                    break
                if v >= 0:
                    sc = scores[v] + base
                    if start[j] < 0 or sc > best[j]:
                        best[j], start[j], node[j] = sc, i, v
                    single = single or j == i + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"the Unigram model has no unk_id for {w[i]!r}")
                sc = unk_score + base
                if start[i + 1] < 0 or sc > best[i + 1]:
                    best[i + 1], start[i + 1], node[i + 1] = sc, i, self.unk_id
        out: List[str] = []
        unk: List[str] = []  # the unknown pieces (and the unk piece itself) fuse
        e = n
        while e > 0:
            s = start[e]
            if node[e] == self.unk_id:
                unk.append(w[s:e])
            else:
                if unk:
                    out.append("".join(reversed(unk)))
                    unk = []
                out.append(w[s:e])
            e = s
        if unk:
            out.append("".join(reversed(unk)))
        if not self.byte_fallback:
            return tuple(self.pieces.get(p, self.unk_id) for p in reversed(out))
        ids: List[int] = []
        for p in reversed(out):
            v = self.pieces.get(p)
            if v is None:
                b = _byte_pieces(self.pieces, p)
                if b is not None:
                    ids.extend(b)
                    continue
                v = self.unk_id
            ids.append(v)
        return tuple(ids)


def _byte_pieces(vocab: Dict[str, int], s: str) -> Optional[List[int]]:
    """The ids of ``<0xNN>`` for each UTF-8 byte of ``s``, or None if the
    vocab lacks one of them (byte fallback)."""
    out = []
    for b in s.encode("utf-8"):
        v = vocab.get(f"<0x{b:02X}>")
        if v is None:
            return None
        out.append(v)
    return out


class BPE:
    """Byte-pair merges by rank: each character (``continuing_subword_prefix``
    on all but the first, ``end_of_word_suffix`` on the last) starts as a
    symbol, a character outside the vocab becomes ``unk_token`` (fused with
    its neighbours when ``fuse_unk``) or is dropped when there is none, and
    the pair of lowest rank (then leftmost) merges until none is left, as
    ``tokenizers``' priority queue does it. ``merges`` are ``"a b"`` strings
    or ``[a, b]`` pairs; ``ignore_merges`` takes a word found whole in the
    vocab as one id. With ``byte_fallback`` a symbol outside the vocab
    becomes the ``<0xNN>`` pieces of its bytes (prefix and suffix included)
    when the vocab holds each of them; a pending unknown is not flushed
    before them, as in ``tokenizers``. ``dropout`` above 0 raises: merges
    drawn at random on every call have no fixed ids to hold."""

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise _not_ported(f"a BPE model with dropout {spec['dropout']} (merges drawn at random on every call)")
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.vocab: Dict[str, int] = spec["vocab"]
        self.prefix = spec.get("continuing_subword_prefix")
        self.suffix = spec.get("end_of_word_suffix")
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        plen = len(self.prefix or "")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b[plen:]])
            except KeyError as e:
                raise ValueError(f"BPE merge {rank} ({a!r} {b!r}) names {e} outside the vocab") from None
        self.size = len(self.vocab)

    def __call__(self, w: str) -> Tuple[int, ...]:
        if not w:
            return ()
        vocab = self.vocab
        if self.ignore_merges and w in vocab:
            return (vocab[w],)
        syms: List[int] = []
        unk = None
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = ch if i == 0 or self.prefix is None else self.prefix + ch
            if i == last and self.suffix is not None:
                s += self.suffix
            v = vocab.get(s)
            if v is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(v)
                continue
            if self.byte_fallback:
                b = _byte_pieces(vocab, s)
                if b is not None:
                    syms.extend(b)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in vocab:
                    raise ValueError(f"the BPE unk_token {self.unk_token!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = vocab[self.unk_token]
        if unk is not None:
            syms.append(unk)
        return self._merge(syms)

    def _merge(self, c: List[int]) -> Tuple[int, ...]:
        merges, n = self.merges, len(c)
        if not n:  # every character dropped (no unk_token)
            return ()
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] < 0:
                continue
            j = nxt[pos]
            m = merges.get((c[pos], c[j]))
            if m is None or m[1] != new_id:  # an entry gone stale
                continue
            c[pos], alive[j] = new_id, False
            nxt[pos] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = pos
            if prv[pos] >= 0:
                m = merges.get((c[prv[pos]], c[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] >= 0:
                m = merges.get((c[pos], c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return tuple(v for v, a in zip(c, alive) if a)


class WordLevel:
    """Each word's id in the vocab, else the ``unk_token``'s."""

    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk_token = spec.get("unk_token", "<unk>")
        self.unk_id = self.vocab.get(self.unk_token)
        self.size = len(self.vocab)

    def __call__(self, w: str) -> Tuple[int, ...]:
        if not w:
            return ()
        v = self.vocab.get(w, self.unk_id)
        if v is None:
            raise ValueError(f"the WordLevel unk_token {self.unk_token!r} is not in the vocab (for {w!r})")
        return (v,)


class WordPiece:
    """Greedy longest-match WordPiece over the file's vocab
    (:func:`wordpiece`)."""

    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = spec["vocab"]
        unk = spec.get("unk_token", "[UNK]")
        if unk not in self.vocab:
            raise ValueError(f"the WordPiece unk_token {unk!r} is not in the vocab")
        self.unk_id = self.vocab[unk]
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))
        self.size = len(self.vocab)

    def __call__(self, w: str) -> Tuple[int, ...]:
        return wordpiece(w, self.vocab, self.unk_id, self.prefix, self.max_chars) if w else ()


def make_model(spec: Optional[dict]):
    kind = (spec or {}).get("type")
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "BPE":
        return BPE(spec)
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "WordLevel":
        return WordLevel(spec)
    raise _not_ported(f"the model type {kind!r}" if kind else "a tokenizer.json with no model")


# ---------------------------------------------------------------------------
# Post-processors (a single sequence): the ids around the content
# ---------------------------------------------------------------------------

def make_post_processor(spec: Optional[dict]) -> Tuple[List[int], List[int]]:
    """-> (ids before the content, ids after it)."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind in ("RobertaProcessing", "BertProcessing"):
        return [int(spec["cls"][1])], [int(spec["sep"][1])]
    if kind == "ByteLevel":  # offsets only
        return [], []
    if kind == "TemplateProcessing":
        before: List[int] = []
        after: List[int] = []
        seen = False
        for item in spec["single"]:
            if "Sequence" in item:
                if seen:
                    raise _not_ported("a TemplateProcessing template with the sequence twice")
                seen = True
            else:
                ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(int(i) for i in ids)
        if not seen:
            raise _not_ported("a TemplateProcessing template without the sequence")
        return before, after
    if kind == "Sequence":
        before, after = [], []
        for p in spec["processors"]:
            b, a = make_post_processor(p)
            before, after = b + before, after + a
        return before, after
    raise _not_ported(f"the post-processor type {kind!r}")


# ---------------------------------------------------------------------------
# Added tokens
# ---------------------------------------------------------------------------

class _Added:
    __slots__ = ("content", "id", "lstrip", "rstrip", "single_word", "normalized", "special")

    def __init__(self, content: str, id: int, lstrip=False, rstrip=False, single_word=False, normalized=None,
                 special=False):
        self.content, self.id = content, int(id)
        self.lstrip, self.rstrip, self.single_word = bool(lstrip), bool(rstrip), bool(single_word)
        self.special = bool(special)
        self.normalized = (not self.special) if normalized is None else bool(normalized)


class _Matcher:
    """Leftmost-longest matches of a set of added tokens."""

    def __init__(self, tokens: Sequence[_Added]):
        self.by_content = {t.content: t for t in tokens if t.content}
        alts = sorted(self.by_content, key=len, reverse=True)
        self.rx = re.compile("|".join(re.escape(c) for c in alts)) if alts else None

    def split(self, s: str) -> List[Tuple[Optional[int], int, int]]:
        """-> [(token id or None, start, stop)] covering ``s``."""
        if self.rx is None or not s:
            return [(None, 0, len(s))]
        out, start_offset, n = [], 0, len(s)
        for m in self.rx.finditer(s):
            start, stop = m.span()
            tok = self.by_content[m.group()]
            if tok.single_word and ((start > 0 and _is_word_char(s[start - 1]))
                                    or (stop < n and _is_word_char(s[stop]))):
                continue
            if tok.lstrip:
                while start > 0 and s[start - 1] in _WHITESPACE:
                    start -= 1
                start = max(start, start_offset)
            if tok.rstrip:
                while stop < n and s[stop] in _WHITESPACE:
                    stop += 1
            if start_offset < start:
                out.append((None, start_offset, start))
            out.append((tok.id, start, stop))
            start_offset = stop
        if start_offset != n:
            out.append((None, start_offset, n))
        return out


def _token_fields(value) -> Tuple[Optional[str], dict]:
    if isinstance(value, dict):
        return value.get("content"), {k: value[k] for k in ("lstrip", "rstrip", "single_word", "normalized", "special")
                                      if k in value}
    return value, {}


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------

def tokenizer_class(path: str, cfg: dict) -> Optional[str]:
    """The tokenizer class ``AutoTokenizer`` picks for a directory, less
    ``Fast``: the config's ``tokenizer_class``, else the one of
    ``config.json``'s ``model_type``; None if neither names one."""
    cls_name = cfg.get("tokenizer_class")
    if cls_name is None:
        cls_name = _CLASS_OF_MODEL_TYPE.get(_read_json(os.path.join(path, "config.json")).get("model_type"))
    if cls_name is not None and cls_name.endswith("Fast"):
        cls_name = cls_name[: -len("Fast")]
    return cls_name


class JsonTokenizer:
    """A checkpoint directory's ``tokenizer.json`` (with
    ``tokenizer_config.json``, ``special_tokens_map.json`` and, for the
    tokenizer class, ``config.json``), run as ``transformers``' fast
    tokenizer runs it. ``encode_batch`` -> int32 ids and mask
    ``[B, max_length]``: the content cut to ``max_length`` less the
    post-processor's special tokens, those tokens, then the pad id."""

    def __init__(self, path: str, max_length: int = 256):
        cfg = read_config(path)
        cls_name = tokenizer_class(path, cfg) or "PreTrainedTokenizer"
        if cls_name not in _CLASSES:
            raise _not_ported(f"the tokenizer class {cls_name!r} of {path}")
        self._setup(_read_json(os.path.join(path, "tokenizer.json")), cfg, cls_name, path, max_length)

    def _setup(self, spec: dict, cfg: dict, cls_name: str, path: str, max_length: int) -> None:
        """The pipeline of ``spec`` (a ``tokenizer.json``) as the tokenizer
        class ``cls_name`` loads it with the config ``cfg``."""
        self.tokenizer_class = cls_name
        self.model = make_model(spec.get("model"))
        self.vocab_size = self.model.size
        norm_spec = spec.get("normalizer")
        if cls_name in _BERT_CLASSES and (norm_spec or {}).get("type") == "BertNormalizer":
            norm_spec = {**norm_spec, "lowercase": cfg.get("do_lower_case", True),
                         "strip_accents": cfg.get("strip_accents"),
                         "handle_chinese_chars": cfg.get("tokenize_chinese_chars", True)}
        pre_spec = spec.get("pre_tokenizer")
        if (pre_spec or {}).get("type") == "ByteLevel":
            pre_spec = {**pre_spec, "add_prefix_space": bool(cfg.get("add_prefix_space", False))}
        self.normalizer = make_normalizer(norm_spec)
        self.pre_tokenizer = make_pre_tokenizer(pre_spec)
        self.before, self.after = make_post_processor(spec.get("post_processor"))
        self._set_added(spec.get("added_tokens") or [], cfg, cls_name)
        pad = _token_fields(cfg.get("pad_token", _CLASS_SPECIALS[cls_name].get("pad")))[0]
        if pad is None and spec.get("padding"):
            pad = spec["padding"].get("pad_token")
        self.pad_id = self.token_to_id(pad) if pad is not None else None
        if self.pad_id is None:
            raise ValueError(f"{path}: the tokenizer has no pad token to pad with ({pad!r})")
        unk = getattr(self.model, "unk_id", None)
        if unk is None and isinstance(self.model, BPE) and self.model.unk_token is not None:
            unk = self.model.vocab.get(self.model.unk_token)
        if unk is None:
            name = _token_fields(cfg.get("unk_token", _CLASS_SPECIALS[cls_name].get("unk")))[0]
            unk = self.token_to_id(name) if name is not None else None
        self.unk_id = unk
        self.max_length = max_length
        self._memo: Dict[str, Tuple[int, ...]] = {}

    def _model_vocab(self) -> Dict[str, int]:
        m = self.model
        return m.pieces if isinstance(m, Unigram) else m.vocab

    def token_to_id(self, content: str) -> Optional[int]:
        t = self._added.get(content)
        return t.id if t is not None else self._model_vocab().get(content)

    def _set_added(self, listed, cfg: dict, cls_name: str) -> None:
        """The file's added tokens, then those ``transformers`` adds on load:
        ``added_tokens_decoder`` entries and named special tokens the file
        lacks (a content already there keeps its entry)."""
        added: Dict[str, _Added] = {}
        for t in listed:
            added[t["content"]] = _Added(t["content"], t["id"], t.get("lstrip"), t.get("rstrip"),
                                         t.get("single_word"), t.get("normalized"), t.get("special"))
        next_id = max([self.model.size - 1] + [t.id for t in added.values()]) + 1
        specials: Dict[str, dict] = {}
        for t in (cfg.get("added_tokens_decoder") or {}).values():
            content, attrs = _token_fields(t)
            specials.setdefault(content, attrs)
        defaults = _CLASS_SPECIALS[cls_name]
        for name in _SPECIAL_NAMES:
            key = f"{name}_token"
            content, attrs = _token_fields(cfg[key] if key in cfg else defaults.get(name))
            if content is not None:
                if name == "mask" and not attrs:
                    attrs = dict(_CLASS_MASK.get(cls_name, {}))
                specials.setdefault(content, {"special": True, **attrs})
        extra = cfg["additional_special_tokens"] if "additional_special_tokens" in cfg else _CLASS_ADDITIONAL.get(
            cls_name, ())
        for t in extra or []:
            content, attrs = _token_fields(t)
            specials.setdefault(content, {"special": True, **attrs})
        vocab = self._model_vocab()
        for content, attrs in specials.items():
            if not content or content in added:
                continue
            tid = vocab.get(content)
            if tid is None:
                tid, next_id = next_id, next_id + 1
            added[content] = _Added(content, tid, **attrs)
        self._added = added
        self._raw = _Matcher([t for t in added.values() if not t.normalized])
        self._norm = _Matcher([t for t in added.values() if t.normalized])

    def _word_ids(self, w: str) -> Tuple[int, ...]:
        """The model's ids of a word not in the memo, memoised."""
        ids = self.model(w)
        if len(self._memo) >= _MEMO_WORDS:
            self._memo.clear()
        self._memo[w] = ids
        return ids

    def token_ids(self, text: str) -> List[int]:
        """The content ids of ``text``: no special tokens of the
        post-processor, no truncation or padding."""
        ids: List[int] = []
        for tid, a, b in self._raw.split(text):
            if tid is not None:
                ids.append(tid)
                continue
            piece = text[a:b]
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for tid2, c, d in self._norm.split(piece):
                if tid2 is not None:
                    ids.append(tid2)
                elif d > c:
                    memo = self._memo
                    for w in self.pre_tokenizer([piece[c:d]], a == 0 and c == 0)[0]:
                        w_ids = memo.get(w)
                        ids.extend(self._word_ids(w) if w_ids is None else w_ids)
        return ids

    def encode_batch(self, texts: Sequence[str], max_length: "int | None" = None) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.max_length
        keep = max(L - len(self.before) - len(self.after), 0)
        ids = np.full((len(texts), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, t in enumerate(texts):
            row = [*self.before, *self.token_ids(t)[:keep], *self.after][:L]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def encode(self, text: str, max_length: "int | None" = None):
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]
