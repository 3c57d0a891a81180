"""Shared RAG-example scaffolding of leann_torch's apps.

The JAX package's ``apps/base_rag_example.py`` on this package: the same
argument groups (index / embedding / LLM / chunking / search / build), the
build-then-chat ``run()`` flow, skip-rebuild-if-exists, and interactive or
single-query modes, plus ``--device`` (default ``cuda``; without CUDA the
app exits with ``resolve_device``'s message unless given ``--device cpu``),
which the builder, the searcher and the chat run on. Subclasses implement
``load_data()``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from leann_torch import LeannBuilder, LeannChat
from leann_torch.device import resolve_device


class BaseRAGExample(ABC):
    name: str = "base"
    description: str = "RAG example"
    default_index_name: str = "rag_index"

    def __init__(self):
        self.parser = argparse.ArgumentParser(description=self.description)
        self._add_common_args()
        self._add_specific_arguments(self.parser)

    def _add_common_args(self):
        p = self.parser
        idx = p.add_argument_group("index")
        idx.add_argument("--index-dir", default=f"./{self.default_index_name}")
        idx.add_argument("--backend", default="hnsw", choices=["hnsw", "diskann", "flat"])
        idx.add_argument("--force-rebuild", action="store_true")
        idx.add_argument("--graph-degree", type=int, default=32)
        idx.add_argument("--build-complexity", type=int, default=128)
        idx.add_argument("--compact", action=argparse.BooleanOptionalAction, default=True)
        idx.add_argument("--recompute", action=argparse.BooleanOptionalAction, default=True)

        emb = p.add_argument_group("embedding")
        emb.add_argument("--embedding-model", default="hash-minilm")
        emb.add_argument("--embedding-mode", default="tpu",
                         choices=["tpu", "sentence-transformers", "openai", "ollama", "gemini", "mlx", "simulated"])
        emb.add_argument("--max-length", type=int, default=256)

        chunk = p.add_argument_group("chunking")
        chunk.add_argument("--chunk-size", type=int, default=256)
        chunk.add_argument("--chunk-overlap", type=int, default=128)
        chunk.add_argument("--use-ast-chunking", action="store_true")
        chunk.add_argument("--ast-chunk-size", type=int, default=512)
        chunk.add_argument("--ast-chunk-overlap", type=int, default=64)
        chunk.add_argument("--max-items", type=int, default=-1)

        llm = p.add_argument_group("llm")
        llm.add_argument("--llm", default="simulated", choices=["ollama", "openai", "gemini", "hf", "simulated"])
        llm.add_argument("--llm-model", default=None)
        llm.add_argument("--host", default="http://localhost:11434")
        llm.add_argument("--thinking-budget", default=None, choices=[None, "low", "medium", "high"])

        srch = p.add_argument_group("search")
        srch.add_argument("--top-k", type=int, default=5)
        srch.add_argument("--search-complexity", type=int, default=64)
        srch.add_argument("--beam-width", type=int, default=8)
        srch.add_argument("--prune-ratio", type=float, default=0.0)

        p.add_argument("--device", default="cuda",
                       help="the device of the builder, searcher and chat (default cuda; without CUDA "
                            "the app exits unless given --device cpu)")
        p.add_argument("--query", default=None, help="single query (omit for interactive chat)")

    def _add_specific_arguments(self, parser: argparse.ArgumentParser) -> None:
        """Subclass hook for extra args."""

    @abstractmethod
    async def load_data(self, args) -> List[Dict[str, Any]]:
        """-> [{"text", "metadata"}] chunks ready to index."""

    # -- flow ---------------------------------------------------------------

    def index_prefix(self, args) -> str:
        return os.path.join(args.index_dir, "documents.leann")

    def build_index(self, args) -> str:
        prefix = self.index_prefix(args)
        if os.path.exists(prefix + ".meta.json") and not args.force_rebuild:
            print(f"Index exists at {prefix}; skipping build (use --force-rebuild).")
            return prefix
        # a loop of its own: the caller may be any thread, with or without one
        chunks = asyncio.run(self.load_data(args))
        if not chunks:
            raise SystemExit("No data found to index.")
        print(f"Indexing {len(chunks)} chunks...")
        bk = {"M": args.graph_degree, "efConstruction": args.build_complexity} if args.backend == "hnsw" else (
            {"graph_degree": args.graph_degree, "complexity": args.build_complexity}
            if args.backend == "diskann" else {}
        )
        builder = LeannBuilder(
            backend_name=args.backend, embedding_model=args.embedding_model,
            embedding_mode=args.embedding_mode, is_compact=args.compact,
            is_recompute=args.recompute, max_length=args.max_length, device=args.device, **bk,
        )
        for c in chunks:
            builder.add_text(c["text"], metadata=c.get("metadata", {}))
        builder.build_index(prefix)
        return prefix

    def run(self, argv: Optional[List[str]] = None) -> None:
        """Parse ``argv`` (the command line when None), build the index unless
        it exists, then answer ``--query`` or chat until ``quit``."""
        args = self.parser.parse_args(argv)
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"error: {e}") from None
        prefix = self.build_index(args)
        llm_config = {"type": args.llm, "model": args.llm_model, "host": args.host,
                      "thinking_budget": args.thinking_budget}
        search_kwargs = dict(complexity=args.search_complexity, beam_width=args.beam_width,
                             prune_ratio=args.prune_ratio)
        chat = LeannChat(prefix, llm_config=llm_config, device=args.device)
        try:
            if args.query:
                print(chat.ask(args.query, top_k=args.top_k, **search_kwargs))
            else:
                print(f"{self.name} RAG ready. Type 'quit' to exit.")
                while True:
                    try:
                        q = input("You: ").strip()
                    except (EOFError, KeyboardInterrupt):
                        break
                    if q.lower() in ("quit", "exit", ""):
                        break
                    print("Assistant:", chat.ask(q, top_k=args.top_k, **search_kwargs))
        finally:
            chat.cleanup()
