"""Email RAG over Apple Mail exports (.emlx).

leann_torch's copy of the JAX package's ``apps/email_rag.py``, run as
``python -m leann_torch.apps.email_rag --device cuda ...``. Parity with the
reference email_rag (apps/email_rag.py:19-157).
"""

from __future__ import annotations

from typing import Any, Dict, List

from leann_torch.apps.base_rag_example import BaseRAGExample
from leann_torch.apps.email_data.email_reader import find_mail_directories, load_emails
from leann_torch.chunking import create_traditional_chunks


class EmailRAG(BaseRAGExample):
    name = "email"
    description = "RAG over Apple Mail (.emlx) messages"
    default_index_name = "email_index"

    def _add_specific_arguments(self, parser):
        parser.add_argument("--mail-dir", nargs="+", default=None,
                            help="Messages directories (default: auto-discover ~/Library/Mail)")

    async def load_data(self, args) -> List[Dict[str, Any]]:
        dirs = args.mail_dir or find_mail_directories()
        if not dirs:
            raise SystemExit("No Apple Mail directories found; pass --mail-dir.")
        emails = load_emails(dirs, max_count=args.max_items)
        print(f"Parsed {len(emails)} emails")
        texts, metas = [], []
        for e in emails:
            texts.append(f"Subject: {e['subject']}\nFrom: {e['from']}\nTo: {e['to']}\n\n{e['body']}")
            metas.append({"subject": e["subject"], "from": e["from"], "date": e["date"]})
        return create_traditional_chunks(texts, args.chunk_size, args.chunk_overlap, metas)


if __name__ == "__main__":
    EmailRAG().run()
