"""Document RAG: index a directory of documents (txt/md/pdf/...) and chat.

leann_torch's copy of the JAX package's ``apps/document_rag.py``, run as
``python -m leann_torch.apps.document_rag --device cuda ...``. Parity with the
reference document_rag (apps/document_rag.py:17-131):
directory reader over ``--data-dir``, optional AST chunking for code files,
``--max-items`` cap.
"""

from __future__ import annotations

from typing import Any, Dict, List

from leann_torch.apps.base_rag_example import BaseRAGExample
from leann_torch.chunking import create_text_chunks
from leann_torch.loaders import load_documents


class DocumentRAG(BaseRAGExample):
    name = "document"
    description = "RAG over a directory of documents"
    default_index_name = "document_index"

    def _add_specific_arguments(self, parser):
        parser.add_argument("--data-dir", default="./data")
        parser.add_argument("--file-types", nargs="+", default=None)

    async def load_data(self, args) -> List[Dict[str, Any]]:
        docs = load_documents(args.data_dir, file_types=args.file_types, max_items=args.max_items)
        return create_text_chunks(
            docs, chunk_size=args.chunk_size, chunk_overlap=args.chunk_overlap,
            use_ast_chunking=args.use_ast_chunking, ast_chunk_size=args.ast_chunk_size,
            ast_chunk_overlap=args.ast_chunk_overlap,
        )


if __name__ == "__main__":
    DocumentRAG().run()
