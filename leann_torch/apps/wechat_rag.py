"""WeChat chat-history RAG.

leann_torch's copy of the JAX package's ``apps/wechat_rag.py``, run as
``python -m leann_torch.apps.wechat_rag --device cuda ...``. Parity with the
reference wechat_rag (apps/wechat_rag.py:19-189): consumes a
WeChatTweak-style JSON export directory and indexes conversation windows.
"""

from __future__ import annotations

from typing import Any, Dict, List

from leann_torch.apps.base_rag_example import BaseRAGExample
from leann_torch.apps.history_data.wechat_history import load_wechat_export


class WeChatRAG(BaseRAGExample):
    name = "wechat"
    description = "RAG over exported WeChat chat history"
    default_index_name = "wechat_index"

    def _add_specific_arguments(self, parser):
        parser.add_argument("--export-dir", required=True, help="directory of exported chat JSON files")
        parser.add_argument("--window", type=int, default=20, help="messages per conversation chunk")

    async def load_data(self, args) -> List[Dict[str, Any]]:
        chunks = load_wechat_export(args.export_dir, window=args.window, max_count=args.max_items)
        if not chunks:
            raise SystemExit(f"No WeChat exports found under {args.export_dir}.")
        print(f"Loaded {len(chunks)} conversation windows")
        return chunks


if __name__ == "__main__":
    WeChatRAG().run()
