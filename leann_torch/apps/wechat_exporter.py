#!/usr/bin/env python
"""WeChat chat-history exporter (leann_torch's copy of the JAX package's
``apps/wechat_exporter.py``, which the port does not import).

    python -m leann_torch.apps.wechat_exporter --output ./wechat_export

Parity with the reference's standalone wechat-exporter tool
(packages/wechat-exporter/main.py, console script in root pyproject). The
reference (and this tool) target macOS WeChat with WeChatTweak-CLI installed:
message databases live under ``~/Library/Containers/com.tencent.xinWeChat``
and are readable once WeChatTweak has decrypted them.

Output: one ``<contact>.json`` per conversation in the shape consumed by
``leann_torch/apps/history_data/wechat_history.py``::

    [{"contact": str, "messages": [{"from": str, "time": str, "text": str}]}]

On non-macOS hosts (or without WeChatTweak) the tool explains what is missing
instead of failing cryptically.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sqlite3
import sys

WECHAT_CONTAINER = "~/Library/Containers/com.tencent.xinWeChat/Data/Library/Application Support/com.tencent.xinWeChat"


def find_message_dbs(root: "str | None" = None) -> list:
    root = os.path.expanduser(root or WECHAT_CONTAINER)
    if not os.path.isdir(root):
        return []
    return sorted(glob.glob(os.path.join(root, "**", "msg_*.db"), recursive=True)) + sorted(
        glob.glob(os.path.join(root, "**", "MSG*.db"), recursive=True)
    )


def export_db(db_path: str, out_dir: str, limit_per_chat: int = 0) -> int:
    """Export chat tables from one (decrypted) message db. Returns number of
    conversations written."""
    conn = sqlite3.connect(db_path)
    try:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name LIKE 'Chat_%'"
        )]
        written = 0
        for table in tables:
            try:
                q = f'SELECT mesLocalID, msgCreateTime, mesDes, msgContent FROM "{table}" ORDER BY msgCreateTime'
                if limit_per_chat:
                    q += f" LIMIT {int(limit_per_chat)}"
                rows = conn.execute(q).fetchall()
            except sqlite3.Error:
                continue
            if not rows:
                continue
            messages = [
                {"from": ("other" if des else "me"), "time": str(ts), "text": str(content or "")}
                for (_mid, ts, des, content) in rows
            ]
            payload = [{"contact": table, "messages": messages}]
            with open(os.path.join(out_dir, f"{table}.json"), "w", encoding="utf-8") as f:
                json.dump(payload, f, ensure_ascii=False)
            written += 1
        return written
    finally:
        conn.close()


def main() -> int:
    ap = argparse.ArgumentParser(description="Export WeChat chat history to JSON for leann indexing")
    ap.add_argument("--output", "-o", default="./wechat_export")
    ap.add_argument("--wechat-root", default=None, help="override the WeChat container path")
    ap.add_argument("--limit-per-chat", type=int, default=0)
    args = ap.parse_args()

    dbs = find_message_dbs(args.wechat_root)
    if not dbs:
        if sys.platform != "darwin":
            print("wechat_exporter: WeChat message databases are only accessible on macOS "
                  "(with WeChatTweak-CLI). Copy the decrypted msg_*.db files here and pass "
                  "--wechat-root, or run this on the Mac.", file=sys.stderr)
        else:
            print(f"wechat_exporter: no message databases under "
                  f"{args.wechat_root or WECHAT_CONTAINER}. Install WeChatTweak-CLI and "
                  "re-login to WeChat first.", file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)
    total = 0
    for db in dbs:
        n = export_db(db, args.output, args.limit_per_chat)
        print(f"{db}: {n} conversations")
        total += n
    print(f"Exported {total} conversations to {args.output}")
    print(f"Next: python -m leann_torch.apps.wechat_rag --export-dir {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
