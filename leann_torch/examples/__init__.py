"""Demos of leann_torch over a book: ``basic_demo`` (build, search, chat),
``spoiler_free_book_rag`` (a chapter filter) and ``sharded_demo`` (the
gp-mesh build and search, ``--shards N``). Each takes the book's
path: ``python -m leann_torch.examples.basic_demo --book BOOK.txt``."""
