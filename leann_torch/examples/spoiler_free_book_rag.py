"""Spoiler-free book RAG on leann_torch, the metadata-filtering demo (the
JAX package's ``examples/spoiler_free_book_rag.py``; reference
examples/spoiler_free_book_rag.py:144-153).

    python -m leann_torch.examples.spoiler_free_book_rag --book BOOK.txt \\
        --up-to-chapter 3 [--device cuda]

Index a book with per-chapter metadata (its "Chapter N" headings), then
answer questions with a ``{"chapter": {"<=": N}}`` filter so retrieval
never leaks passages from chapters the reader hasn't reached. Without the
book the demo exits with a message. The index is kept under
``--index-dir`` and reused.
"""

import argparse
import os
import re
from typing import List, Optional

from leann_torch import LeannBuilder, LeannChat, LeannSearcher
from leann_torch.device import resolve_device
from leann_torch.examples.basic_demo import NO_BOOK


def load_chapters(path):
    text = open(path, encoding="utf-8").read()
    # split on "Chapter N" headings
    parts = re.split(r"\n\s*Chapter\s+([IVXLC\d]+)\.?\s*\n", text)
    chapters = []
    for i in range(1, len(parts) - 1, 2):
        chapters.append((len(chapters) + 1, parts[i + 1]))
    return chapters or [(1, text)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="RAG over a book, restricted to the chapters read so far")
    ap.add_argument("--book", default=None, help="a plain-text book with 'Chapter N' headings")
    ap.add_argument("--up-to-chapter", type=int, default=3)
    ap.add_argument("--query", default="Who has Elizabeth met so far?")
    ap.add_argument("--index-dir", default="./spoiler_free_index")
    ap.add_argument("--device", default="cuda",
                    help="default cuda; without CUDA the demo exits unless given --device cpu")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    index = os.path.join(args.index_dir, "book.leann")

    if not os.path.exists(index + ".meta.json"):
        if not args.book or not os.path.isfile(args.book):
            raise SystemExit("error: " + NO_BOOK.format(path=args.book))
        chapters = load_chapters(args.book)
        builder = LeannBuilder(backend_name="hnsw", embedding_model="hash-minilm", max_length=128,
                               device=args.device)
        for ch_num, ch_text in chapters:
            for p in ch_text.split("\n\n"):
                p = p.strip().replace("\n", " ")
                if len(p) > 120:
                    builder.add_text(p, metadata={"chapter": ch_num})
        builder.build_index(index)
        print(f"Indexed {len(chapters)} chapters")

    searcher = LeannSearcher(index, device=args.device)
    results = searcher.search(
        args.query, top_k=5, metadata_filters={"chapter": {"<=": args.up_to_chapter}}
    )
    print(f"Results restricted to chapters 1..{args.up_to_chapter}:")
    for r in results:
        print(f"  [ch.{r.metadata['chapter']}] {r.text[:100]}")
    if any(r.metadata["chapter"] > args.up_to_chapter for r in results):
        raise AssertionError("spoiler leaked!")

    chat = LeannChat(index, llm_config={"type": "simulated"}, searcher=searcher, device=args.device)
    print("A:", chat.ask(args.query, top_k=5, metadata_filters={"chapter": {"<=": args.up_to_chapter}}))
    searcher.cleanup()


if __name__ == "__main__":
    main()
