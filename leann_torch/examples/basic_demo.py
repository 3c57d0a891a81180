"""Canonical API demo on leann_torch: build -> search -> chat (the JAX
package's ``examples/basic_demo.py``; reference examples/basic_demo.py).

    python -m leann_torch.examples.basic_demo --book BOOK.txt [--device cuda]

Indexes the book's paragraphs (over 120 characters, the first 500) with the
encoder on the card, searches with the recompute beam search, and answers a
question with the simulated LLM. The book is a plain-text file, such as
Project Gutenberg's Pride and Prejudice; without it the demo exits with a
message. The index is kept under ``--index-dir`` and reused.
"""

import argparse
import os
from typing import List, Optional

from leann_torch import LeannBuilder, LeannChat, LeannSearcher
from leann_torch.device import resolve_device

NO_BOOK = ("no book at {path!r}: pass --book PATH to a plain-text book "
           "(e.g. Pride and Prejudice from Project Gutenberg)")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="build -> search -> chat over a book")
    ap.add_argument("--book", default=None, help="a plain-text book (paragraphs split by blank lines)")
    ap.add_argument("--index-dir", default="./demo_index")
    ap.add_argument("--device", default="cuda",
                    help="default cuda; without CUDA the demo exits unless given --device cpu")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    index = os.path.join(args.index_dir, "pp.leann")

    if not os.path.exists(index + ".meta.json"):
        if not args.book or not os.path.isfile(args.book):
            raise SystemExit("error: " + NO_BOOK.format(path=args.book))
        text = open(args.book, encoding="utf-8").read()
        paras = [p.strip().replace("\n", " ") for p in text.split("\n\n") if len(p.strip()) > 120]
        builder = LeannBuilder(backend_name="hnsw", embedding_model="hash-minilm", max_length=128,
                               device=args.device)
        for i, p in enumerate(paras[:500]):
            builder.add_text(p, metadata={"paragraph": i})
        builder.build_index(index)
        print(f"Built index with {min(500, len(paras))} chunks")

    searcher = LeannSearcher(index, device=args.device)
    results = searcher.search("What does Mr. Darcy say about pride?", top_k=3)
    for r in results:
        print(f"[{r.score:.3f}] {r.text[:120]}")

    chat = LeannChat(index, llm_config={"type": "simulated"}, searcher=searcher, device=args.device)
    print("\nQ: Who is Mr. Bingley?")
    print("A:", chat.ask("Who is Mr. Bingley?", top_k=3))
    searcher.cleanup()


if __name__ == "__main__":
    main()
