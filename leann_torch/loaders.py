"""Document loading: directory walking, filtering, per-format text extraction.

Counterpart of the JAX package's ``loaders.py`` (standard library only): the
same files in the same order, the same text. Capability parity with the
reference CLI's document pipeline (cli.py:855-1212): ~50 default text
extensions, gitignore-based filtering (cli.py:298-327), git-submodule
skipping (cli.py:329-353), hidden-file filtering, and a PDF extraction chain
(PyMuPDF → pdfplumber → pypdf, cli.py:15-43). Each reader library is
optional and imported where it is used; without them a built-in best-effort
extractor reads the PDF (zlib content streams + Tj/TJ text operators).
"""

from __future__ import annotations

import fnmatch
import logging
import os
import re
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

DEFAULT_EXTENSIONS = [
    ".txt", ".md", ".rst", ".org", ".tex", ".log", ".csv", ".tsv", ".json", ".jsonl",
    ".yaml", ".yml", ".toml", ".ini", ".cfg", ".conf", ".xml", ".html", ".htm",
    ".py", ".java", ".js", ".jsx", ".ts", ".tsx", ".c", ".h", ".cc", ".cpp", ".hpp",
    ".go", ".rs", ".rb", ".php", ".swift", ".kt", ".scala", ".sh", ".bash", ".zsh",
    ".sql", ".r", ".jl", ".lua", ".pl", ".m", ".mm", ".proto", ".gradle", ".cmake",
    ".dockerfile", ".pdf",
]


# ---------------------------------------------------------------------------
# gitignore-style filtering (self-contained; reference uses gitignore-parser)
# ---------------------------------------------------------------------------


class GitignoreFilter:
    def __init__(self, patterns: Sequence[str]):
        self.rules = []
        for raw in patterns:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            neg = line.startswith("!")
            if neg:
                line = line[1:]
            dir_only = line.endswith("/")
            line = line.rstrip("/")
            anchored = line.startswith("/")
            line = line.lstrip("/")
            self.rules.append((neg, dir_only, anchored, line))

    @classmethod
    def from_dir(cls, root: str) -> "GitignoreFilter":
        path = os.path.join(root, ".gitignore")
        if os.path.exists(path):
            with open(path, encoding="utf-8", errors="replace") as f:
                return cls(f.readlines())
        return cls([])

    def ignores(self, rel_path: str, is_dir: bool = False) -> bool:
        rel = rel_path.replace(os.sep, "/")
        parts = rel.split("/")
        ignored = False
        for neg, dir_only, anchored, pat in self.rules:
            if dir_only and not is_dir and not any(
                fnmatch.fnmatch("/".join(parts[: i + 1]), pat) for i in range(len(parts) - 1)
            ):
                if not fnmatch.fnmatch(rel, pat):
                    continue
            target_hit = (
                fnmatch.fnmatch(rel, pat)
                or (not anchored and any(fnmatch.fnmatch(p, pat) for p in parts))
                or (not anchored and fnmatch.fnmatch(rel, f"*/{pat}"))
            )
            if target_hit:
                ignored = not neg
        return ignored


def _git_submodule_dirs(root: str) -> List[str]:
    """Paths listed in .gitmodules (skipped during indexing; cli.py:329-353)."""
    gm = os.path.join(root, ".gitmodules")
    if not os.path.exists(gm):
        return []
    with open(gm, encoding="utf-8", errors="replace") as f:
        return re.findall(r"^\s*path\s*=\s*(.+)$", f.read(), re.MULTILINE)


# ---------------------------------------------------------------------------
# PDF extraction chain
# ---------------------------------------------------------------------------


def extract_pdf_text(path: str) -> str:
    """PyMuPDF → pdfplumber → pypdf → built-in minimal extractor."""
    try:
        import fitz  # PyMuPDF

        with fitz.open(path) as doc:
            return "\n".join(page.get_text() for page in doc)
    except ImportError:
        pass
    try:
        import pdfplumber

        with pdfplumber.open(path) as pdf:
            return "\n".join(p.extract_text() or "" for p in pdf.pages)
    except ImportError:
        pass
    try:
        from pypdf import PdfReader

        return "\n".join(p.extract_text() or "" for p in PdfReader(path).pages)
    except ImportError:
        pass
    return _builtin_pdf_text(path)


_TJ_RE = re.compile(rb"\((?:\\.|[^\\()])*\)\s*Tj|\[(?:[^\]]*)\]\s*TJ")
_STR_RE = re.compile(rb"\((?:\\.|[^\\()])*\)")


def _pdf_unescape(b: bytes) -> str:
    out = []
    i = 0
    while i < len(b):
        c = b[i]
        if c == 0x5C and i + 1 < len(b):  # backslash
            n = b[i + 1]
            mapping = {0x6E: "\n", 0x72: "\r", 0x74: "\t", 0x28: "(", 0x29: ")", 0x5C: "\\"}
            if n in mapping:
                out.append(mapping[n])
                i += 2
                continue
            if 0x30 <= n <= 0x37:  # octal escape
                oct_digits = b[i + 1 : i + 4]
                j = 0
                while j < len(oct_digits) and 0x30 <= oct_digits[j] <= 0x37:
                    j += 1
                out.append(chr(int(oct_digits[:j], 8)))
                i += 1 + j
                continue
            i += 1
            continue
        out.append(chr(c))
        i += 1
    return "".join(out)


def _builtin_pdf_text(path: str) -> str:
    """Best-effort: inflate FlateDecode streams and read Tj/TJ show-text ops.
    Handles simple unencrypted PDFs with standard encodings; returns "" on
    anything exotic rather than raising."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return ""
    texts: List[str] = []
    for m in re.finditer(rb"stream\r?\n", data):
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            continue
        raw = data[start:end].rstrip(b"\r\n")
        try:
            content = zlib.decompress(raw)
        except zlib.error:
            content = raw
        if b"Tj" not in content and b"TJ" not in content:
            continue
        for op in _TJ_RE.finditer(content):
            for s in _STR_RE.finditer(op.group(0)):
                texts.append(_pdf_unescape(s.group(0)[1:-1]))
            texts.append(" ")
        texts.append("\n")
    return "".join(texts)


# ---------------------------------------------------------------------------
# Per-file readers
# ---------------------------------------------------------------------------


def read_file_text(path: str) -> Optional[str]:
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".pdf":
            return extract_pdf_text(path)
        if ext in (".html", ".htm"):
            raw = Path(path).read_text(encoding="utf-8", errors="replace")
            try:
                from bs4 import BeautifulSoup

                return BeautifulSoup(raw, "html.parser").get_text(" ")
            except ImportError:
                return re.sub(r"<[^>]+>", " ", raw)
        return Path(path).read_text(encoding="utf-8", errors="replace")
    except OSError as e:
        logger.warning("failed to read %s: %s", path, e)
        return None


def load_documents(
    data_dir: str,
    file_types: Optional[Sequence[str]] = None,
    exclude_dirs: Sequence[str] = ("node_modules", ".git", "__pycache__", ".venv", "venv", "build", "dist"),
    include_hidden: bool = False,
    use_gitignore: bool = True,
    max_file_size_mb: float = 10.0,
    max_items: int = -1,
) -> List[Dict[str, Any]]:
    """Walk ``data_dir`` -> [{"text", "metadata": {"file_path", "file_name",
    "extension"}}] with gitignore / submodule / hidden-file filtering."""
    root = os.path.abspath(data_dir)
    if os.path.isfile(root):
        text = read_file_text(root)
        return [{"text": text or "", "metadata": {"file_path": root, "file_name": os.path.basename(root),
                                                  "extension": os.path.splitext(root)[1].lower()}}]
    exts = {e.lower() if e.startswith(".") else "." + e.lower() for e in (file_types or DEFAULT_EXTENSIONS)}
    gi = GitignoreFilter.from_dir(root) if use_gitignore else GitignoreFilter([])
    submodules = {os.path.normpath(os.path.join(root, p)) for p in _git_submodule_dirs(root)}
    docs: List[Dict[str, Any]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        dirnames[:] = [
            d for d in dirnames
            if d not in exclude_dirs
            and (include_hidden or not d.startswith("."))
            and os.path.normpath(os.path.join(dirpath, d)) not in submodules
            and not gi.ignores(os.path.normpath(os.path.join(rel_dir, d)), is_dir=True)
        ]
        for fn in sorted(filenames):
            if not include_hidden and fn.startswith("."):
                continue
            ext = os.path.splitext(fn)[1].lower()
            if ext not in exts:
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.normpath(os.path.join(rel_dir, fn))
            if gi.ignores(rel):
                continue
            try:
                if os.path.getsize(full) > max_file_size_mb * 1024 * 1024:
                    continue
            except OSError:
                continue
            text = read_file_text(full)
            if not text or not text.strip():
                continue
            docs.append({"text": text, "metadata": {"file_path": full, "file_name": fn, "extension": ext}})
            if 0 < max_items <= len(docs):
                return docs
    return docs
