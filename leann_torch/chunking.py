"""Text + code chunking.

Counterpart of the JAX package's ``chunking.py`` (standard library only:
``ast`` and ``re``); its output equals that module's, chunk for chunk and
metadata for metadata. Capability parity with the reference's chunking stack
(apps/chunking/utils.py:15-320): ``detect_code_files`` by extension,
``create_ast_chunks`` for code, ``create_traditional_chunks`` for prose, and
the unified ``create_text_chunks`` entry point. The reference delegates to
llama-index's SentenceSplitter and astchunk/tree-sitter; both paths here are
self-contained:

* prose: sentence-aware packing with token(≈word)-budget ``chunk_size`` and
  ``chunk_overlap`` carry-over.
* code: Python files are chunked along real AST boundaries (stdlib ``ast``);
  brace-family languages (JS/TS/Java/Go/Rust/C/C++/C#/Kotlin/Swift/Scala/PHP)
  go through a real lexer (_scan_code_events: comment/string/template-literal
  tracking + matched-brace depth) that yields top-level syntactic units and
  descends into oversized classes method-by-method with the enclosing header
  as context; remaining languages use heuristic block splitting. Parse errors
  fall back per-document to traditional chunking, mirroring the reference
  (utils.py:87-178).
"""

from __future__ import annotations

import ast
import logging
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# extension -> language (reference utils.py:15-23)
CODE_EXTENSIONS: Dict[str, str] = {
    ".py": "python",
    ".java": "java",
    ".cs": "c_sharp",
    ".ts": "typescript",
    ".tsx": "typescript",
    ".js": "javascript",
    ".jsx": "javascript",
    ".c": "c",
    ".h": "c",
    ".cc": "cpp",
    ".cpp": "cpp",
    ".hpp": "cpp",
    ".go": "go",
    ".rs": "rust",
    ".rb": "ruby",
    ".php": "php",
    ".swift": "swift",
    ".kt": "kotlin",
    ".scala": "scala",
}

_SENT_RE = re.compile(r"(?<=[.!?。！？])\s+|(?<=[。！？；])|\n{2,}")
# word-ish units: whitespace tokens for space-delimited scripts, single chars
# for CJK (which has no spaces — counting only \S+ would pack a whole Chinese
# document into one "small" chunk)
_UNIT_RE = re.compile(r"[一-鿿぀-ヿ가-힯]|[^\s一-鿿぀-ヿ가-힯]+")


def detect_code_files(file_path: str) -> Optional[str]:
    """-> language name for code files, else None."""
    import os

    return CODE_EXTENSIONS.get(os.path.splitext(file_path)[1].lower())


def _words(text: str) -> int:
    return len(_UNIT_RE.findall(text))


def split_sentences(text: str) -> List[str]:
    parts = [s.strip() for s in _SENT_RE.split(text)]
    return [s for s in parts if s]


def create_traditional_chunks(
    texts: Sequence[str],
    chunk_size: int = 256,
    chunk_overlap: int = 128,
    metadata: Optional[Sequence[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """Sentence-aware packing into ~chunk_size-word chunks with overlap."""
    out: List[Dict[str, Any]] = []
    for doc_i, text in enumerate(texts):
        md = dict(metadata[doc_i]) if metadata else {}
        sents = split_sentences(text) or ([text.strip()] if text.strip() else [])
        cur: List[str] = []
        cur_words = 0
        for s in sents:
            w = _words(s)
            if w > chunk_size:  # hard-split very long sentences by units
                units = _UNIT_RE.findall(s)
                sep = "" if len(units) > 2 * len(s.split()) else " "  # CJK-ish
                for i in range(0, len(units), chunk_size):
                    piece = sep.join(units[i : i + chunk_size])
                    if cur:
                        out.append({"text": " ".join(cur), "metadata": md})
                        cur, cur_words = [], 0
                    out.append({"text": piece, "metadata": md})
                continue
            if cur_words + w > chunk_size and cur:
                out.append({"text": " ".join(cur), "metadata": md})
                # overlap: carry trailing sentences up to chunk_overlap words
                keep: List[str] = []
                kw = 0
                for prev in reversed(cur):
                    pw = _words(prev)
                    if kw + pw > chunk_overlap:
                        break
                    keep.insert(0, prev)
                    kw += pw
                cur, cur_words = keep, kw
            cur.append(s)
            cur_words += w
        if cur:
            out.append({"text": " ".join(cur), "metadata": md})
    return out


# ---------------------------------------------------------------------------
# AST-aware code chunking
# ---------------------------------------------------------------------------


def _python_ast_chunks(source: str, max_chunk_size: int) -> List[str]:
    """Chunk along top-level def/class boundaries; large classes split by
    method. Falls back (raises) on syntax errors."""
    tree = ast.parse(source)
    lines = source.splitlines()

    def seg(a, b):  # 1-based inclusive line range
        return "\n".join(lines[a - 1 : b])

    blocks: List[Tuple[int, int]] = []
    prev_end = 0
    for node in tree.body:
        start = min(getattr(node, "lineno", prev_end + 1),
                    min((d.lineno for d in getattr(node, "decorator_list", [])), default=10**9))
        end = getattr(node, "end_lineno", start)
        if isinstance(node, ast.ClassDef) and _words(seg(start, end)) > max_chunk_size:
            # split big classes: header + each method
            sub_start = start
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    istart = min(item.lineno, min((d.lineno for d in item.decorator_list), default=10**9))
                    if istart > sub_start:
                        blocks.append((sub_start, istart - 1))
                    blocks.append((istart, item.end_lineno))
                    sub_start = item.end_lineno + 1
            if sub_start <= end:
                blocks.append((sub_start, end))
        else:
            blocks.append((start, end))
        prev_end = end
    # merge small adjacent blocks up to max_chunk_size
    chunks: List[str] = []
    cur: Optional[Tuple[int, int]] = None
    for a, b in blocks:
        if cur and _words(seg(cur[0], b)) <= max_chunk_size:
            cur = (cur[0], b)
        else:
            if cur:
                chunks.append(seg(*cur))
            cur = (a, b)
    if cur:
        chunks.append(seg(*cur))
    return [c for c in chunks if c.strip()]


_BLOCK_START = re.compile(
    r"^(export\s+)?(pub\s+)?(public|private|protected|static|final|async|def|fn|func|function|class|struct|enum|impl|interface|trait|namespace|module|object|type)\b"
)


# languages whose structure the brace lexer parses for real (the rest keep
# the line heuristic below)
_BRACE_LANGS = {
    "javascript", "typescript", "java", "c", "cpp", "c_sharp", "go", "rust",
    "kotlin", "swift", "scala", "php",
}


def _skip_string(source: str, i: int, quote: str, multiline: bool) -> int:
    """Return the index just past a string literal starting at ``i``; raises
    on unterminated literals (parse failure -> traditional fallback)."""
    n = len(source)
    j = i + 1
    while j < n:
        c = source[j]
        if c == "\\":
            j += 2
            continue
        if c == quote:
            return j + 1
        if c == "\n" and not multiline:
            raise ValueError(f"unterminated string at offset {i}")
        j += 1
    raise ValueError(f"unterminated string at offset {i}")


def _scan_code_events(source: str, lang: str) -> List[Tuple[int, str, int]]:
    """Single-pass lexer over a brace-family source: tracks line/block
    comments, string/char/template literals, and brace depth. Returns
    ``(index, char, depth)`` events for every structural ``{`` / ``}`` (depth
    BEFORE the open, AFTER the close — i.e. the nesting level of the block)
    and every depth-0 ``;``. Raises ValueError on unbalanced braces or
    unterminated literals — real parse errors, handled by the caller's
    fallback exactly like a tree-sitter failure would be."""
    i, n, depth = 0, len(source), 0
    out: List[Tuple[int, str, int]] = []
    backtick_langs = ("javascript", "typescript", "go")
    while i < n:
        c = source[i]
        two = source[i : i + 2]
        if two == "//" or (lang == "php" and c == "#"):
            j = source.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if two == "/*":
            j = source.find("*/", i + 2)
            if j < 0:
                raise ValueError("unterminated block comment")
            i = j + 2
            continue
        if c == '"':
            # single-line strings; a multi-line raw literal raises and the
            # document degrades to traditional chunking (same as a parse fail)
            i = _skip_string(source, i, c, multiline=False)
            continue
        if c == "`" and lang in backtick_langs:
            # template/raw literal: interpolated ${...} braces are balanced,
            # and both sides are skipped, so depth stays consistent
            i = _skip_string(source, i, c, multiline=True)
            continue
        if c == "'":
            if lang == "rust":
                # lifetime ('a) vs char literal ('x' / '\n'): only consume
                # when a closing quote sits within escape distance
                if i + 2 < n and source[i + 2] == "'" and source[i + 1] != "\\":
                    i += 3
                elif i + 3 < n and source[i + 1] == "\\" and source[i + 3] == "'":
                    i += 4
                else:
                    i += 1
                continue
            i = _skip_string(source, i, c, multiline=False)
            continue
        if c == "{":
            out.append((i, "{", depth))
            depth += 1
        elif c == "}":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced '}}' at offset {i}")
            out.append((i, "}", depth))
        elif c == ";" and depth == 0:
            out.append((i, ";", 0))
        i += 1
    if depth != 0:
        raise ValueError("unbalanced braces at EOF")
    return out


def _top_level_units(source: str, lang: str) -> List[str]:
    """Split into top-level syntactic units: each ends just past a depth-0
    closing brace (+ optional ';') or a depth-0 statement ';'."""
    events = _scan_code_events(source, lang)
    cuts = []
    for idx, ch, depth in events:
        if (ch == "}" and depth == 0) or ch == ";":
            end = idx + 1
            if ch == "}" and end < len(source) and source[end] == ";":
                end += 1  # `};` terminators stay with their block
            cuts.append(end)
    units, prev = [], 0
    for c in cuts:
        if c <= prev:
            continue
        if source[prev:c].strip():
            units.append(source[prev:c].strip("\n"))
        prev = c
    if source[prev:].strip():
        units.append(source[prev:].strip("\n"))
    return units


def _structural_code_chunks(source: str, lang: str, max_chunk_size: int,
                            header: str = "", depth: int = 0) -> List[str]:
    """AST-boundary chunking for brace-family languages: top-level units
    (functions, classes, statements) pack into ~max_chunk_size-word chunks;
    an oversized unit descends into its outermost brace block (e.g. class ->
    methods), each child chunk prefixed with the enclosing header for context
    (the astchunk behavior the reference relies on, utils.py:87-178)."""
    units = _top_level_units(source, lang)
    chunks: List[str] = []
    cur = ""

    def flush():
        nonlocal cur
        if cur.strip():
            chunks.append(header + cur if header else cur)
        cur = ""

    for unit in units:
        w = _words(unit)
        if w > max_chunk_size and depth < 4:
            flush()
            ev = _scan_code_events(unit, lang)
            open_ = next((i for i, ch, dp in ev if ch == "{" and dp == 0), None)
            close = next((i for i, ch, dp in reversed(ev) if ch == "}" and dp == 0), None)
            if open_ is not None and close is not None and close > open_ + 1:
                head = unit[:open_].strip()
                body = unit[open_ + 1 : close]
                sub_header = (header + head + " {\n") if head else header
                sub = _structural_code_chunks(body, lang, max_chunk_size,
                                              header=sub_header, depth=depth + 1)
                if len(sub) > 1 or (sub and _words(sub[0]) <= max_chunk_size * 2):
                    chunks.extend(sub)
                    continue
            # no block to descend into: hard-split by words
            words = unit.split()
            for s in range(0, len(words), max_chunk_size):
                chunks.append((header or "") + " ".join(words[s : s + max_chunk_size]))
            continue
        if cur and _words(cur) + w > max_chunk_size:
            flush()
        cur = cur + "\n" + unit if cur else unit
    flush()
    return chunks


def _heuristic_code_chunks(source: str, max_chunk_size: int) -> List[str]:
    """Language-agnostic block splitter: break at column-0 block starters."""
    lines = source.splitlines()
    starts = [i for i, ln in enumerate(lines) if ln and not ln[0].isspace() and _BLOCK_START.match(ln)]
    if not starts:
        return [c["text"] for c in create_traditional_chunks([source], chunk_size=max_chunk_size)]
    starts = [0] + [s for s in starts if s != 0] + [len(lines)]
    blocks = ["\n".join(lines[a:b]) for a, b in zip(starts[:-1], starts[1:])]
    chunks: List[str] = []
    cur = ""
    for blk in blocks:
        if cur and _words(cur) + _words(blk) <= max_chunk_size:
            cur = cur + "\n" + blk
        else:
            if cur.strip():
                chunks.append(cur)
            cur = blk
        while _words(cur) > max_chunk_size * 2:  # oversized block: hard split
            words = cur.split()
            chunks.append(" ".join(words[: max_chunk_size]))
            cur = " ".join(words[max_chunk_size:])
    if cur.strip():
        chunks.append(cur)
    return chunks


def create_ast_chunks(
    documents: Sequence[Dict[str, Any]],
    max_chunk_size: int = 512,
    chunk_overlap: int = 64,
    fallback_traditional: bool = True,
) -> List[Dict[str, Any]]:
    """documents: [{"text", "metadata": {"file_path": ...}}]. Per-document
    fallback to traditional chunking on parse failure (reference
    utils.py:87-178); ``fallback_traditional=False`` re-raises instead
    (reference utils.py:299-306)."""
    out: List[Dict[str, Any]] = []
    for doc in documents:
        text = doc.get("text", "")
        md = dict(doc.get("metadata", {}))
        lang = detect_code_files(md.get("file_path", "")) or md.get("language")
        try:
            if lang == "python":
                chunks = _python_ast_chunks(text, max_chunk_size)
            elif lang in _BRACE_LANGS:
                chunks = _structural_code_chunks(text, lang, max_chunk_size)
            elif lang:
                chunks = _heuristic_code_chunks(text, max_chunk_size)
            else:
                raise ValueError("not a code file")
        except (SyntaxError, ValueError) as e:
            if not fallback_traditional:
                raise
            logger.debug("ast chunking fell back for %s: %s", md.get("file_path"), e)
            chunks = [c["text"] for c in create_traditional_chunks([text], max_chunk_size, chunk_overlap)]
        for c in chunks:
            out.append({"text": c, "metadata": md})
    return out


def create_text_chunks(
    documents: Sequence[Dict[str, Any]],
    chunk_size: int = 256,
    chunk_overlap: int = 128,
    use_ast_chunking: bool = False,
    ast_chunk_size: int = 512,
    ast_chunk_overlap: int = 64,
    code_file_extensions: Optional[Sequence[str]] = None,
    ast_fallback_traditional: bool = True,
) -> List[Dict[str, Any]]:
    """Unified entry (reference utils.py:231-320): routes code files to AST
    chunking when enabled, everything else to traditional chunking."""
    if not use_ast_chunking:
        return create_traditional_chunks(
            [d.get("text", "") for d in documents], chunk_size, chunk_overlap,
            [d.get("metadata", {}) for d in documents],
        )
    exts = set(code_file_extensions) if code_file_extensions else set(CODE_EXTENSIONS)
    code_docs, text_docs = [], []
    for d in documents:
        import os

        ext = os.path.splitext(d.get("metadata", {}).get("file_path", ""))[1].lower()
        (code_docs if ext in exts else text_docs).append(d)
    out = create_ast_chunks(code_docs, ast_chunk_size, ast_chunk_overlap,
                            fallback_traditional=ast_fallback_traditional)
    out += create_traditional_chunks(
        [d.get("text", "") for d in text_docs], chunk_size, chunk_overlap,
        [d.get("metadata", {}) for d in text_docs],
    )
    return out
