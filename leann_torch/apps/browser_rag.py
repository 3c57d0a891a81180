"""Browser-history RAG (Chrome).

leann_torch's copy of the JAX package's ``apps/browser_rag.py``, run as
``python -m leann_torch.apps.browser_rag --device cuda ...``. Parity with the
reference browser_rag (apps/browser_rag.py:20-171).
"""

from __future__ import annotations

from typing import Any, Dict, List

from leann_torch.apps.base_rag_example import BaseRAGExample
from leann_torch.apps.history_data.history import find_history_databases, load_history


class BrowserRAG(BaseRAGExample):
    name = "browser"
    description = "RAG over Chrome browsing history"
    default_index_name = "browser_index"

    def _add_specific_arguments(self, parser):
        parser.add_argument("--history-db", nargs="+", default=None,
                            help="Chrome History sqlite files (default: auto-discover)")

    async def load_data(self, args) -> List[Dict[str, Any]]:
        dbs = args.history_db or find_history_databases()
        if not dbs:
            raise SystemExit("No Chrome history databases found; pass --history-db.")
        entries = load_history(dbs, max_count=args.max_items)
        print(f"Loaded {len(entries)} history entries")
        return [
            {"text": f"{e['title']} — {e['url']}",
             "metadata": {"url": e["url"], "visit_count": e["visit_count"], "profile": e["profile"]}}
            for e in entries
        ]


if __name__ == "__main__":
    BrowserRAG().run()
