"""Code RAG: index a source repository with AST-aware chunking.

leann_torch's copy of the JAX package's ``apps/code_rag.py``, run as
``python -m leann_torch.apps.code_rag --device cuda ...``. Parity with the
reference code_rag (apps/code_rag.py:19-211): include-ext /
exclude-dirs / max-file-size controls, AST chunking on by default.
"""

from __future__ import annotations

from typing import Any, Dict, List

from leann_torch.apps.base_rag_example import BaseRAGExample
from leann_torch.chunking import CODE_EXTENSIONS, create_text_chunks
from leann_torch.loaders import load_documents


class CodeRAG(BaseRAGExample):
    name = "code"
    description = "RAG over a source-code repository (AST-aware chunking)"
    default_index_name = "code_index"

    def _add_specific_arguments(self, parser):
        parser.add_argument("--repo-dir", default=".")
        parser.add_argument("--include-extensions", nargs="+",
                            default=sorted(CODE_EXTENSIONS) + [".md", ".rst", ".txt"])
        parser.add_argument("--exclude-dirs", nargs="+",
                            default=["node_modules", ".git", "__pycache__", ".venv", "build", "dist", "third_party"])
        parser.add_argument("--max-file-size-mb", type=float, default=2.0)

    async def load_data(self, args) -> List[Dict[str, Any]]:
        docs = load_documents(
            args.repo_dir, file_types=args.include_extensions, exclude_dirs=args.exclude_dirs,
            max_file_size_mb=args.max_file_size_mb, max_items=args.max_items,
        )
        return create_text_chunks(
            docs, chunk_size=args.chunk_size, chunk_overlap=args.chunk_overlap,
            use_ast_chunking=True, ast_chunk_size=args.ast_chunk_size,
            ast_chunk_overlap=args.ast_chunk_overlap,
        )


if __name__ == "__main__":
    CodeRAG().run()
