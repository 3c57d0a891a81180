"""Chrome browser-history reader (leann_torch's copy of the JAX package's
``apps/history_data/history.py``, which the port does not import).

Parity with the reference history reader (apps/history_data/history.py:10-186):
reads the Chrome ``History`` SQLite database (urls table), multi-profile
discovery, copies the DB before reading (Chrome keeps it locked).
"""

from __future__ import annotations

import os
import shutil
import sqlite3
import tempfile
from typing import Any, Dict, List, Optional

CHROME_ROOTS = [
    "~/Library/Application Support/Google/Chrome",  # macOS
    "~/.config/google-chrome",  # Linux
    "~/.config/chromium",
    "~/AppData/Local/Google/Chrome/User Data",  # Windows
]


def find_history_databases() -> List[str]:
    """All profile History DBs across known Chrome roots."""
    found = []
    for root in CHROME_ROOTS:
        root = os.path.expanduser(root)
        if not os.path.isdir(root):
            continue
        for entry in sorted(os.listdir(root)):
            if entry == "Default" or entry.startswith("Profile"):
                db = os.path.join(root, entry, "History")
                if os.path.exists(db):
                    found.append(db)
    return found


def load_history(db_paths: Optional[List[str]] = None, max_count: int = -1) -> List[Dict[str, Any]]:
    """-> [{"title", "url", "visit_count", "last_visit_time"}]."""
    paths = db_paths or find_history_databases()
    out: List[Dict[str, Any]] = []
    for db in paths:
        tmp = tempfile.NamedTemporaryFile(suffix=".sqlite", delete=False)
        tmp.close()
        try:
            shutil.copy2(db, tmp.name)  # Chrome locks the live DB
            conn = sqlite3.connect(tmp.name)
            cur = conn.execute(
                "SELECT title, url, visit_count, last_visit_time FROM urls "
                "ORDER BY last_visit_time DESC"
            )
            for title, url, visits, ts in cur:
                if not title and not url:
                    continue
                out.append({"title": title or "", "url": url or "",
                            "visit_count": int(visits or 0), "last_visit_time": int(ts or 0),
                            "profile": os.path.basename(os.path.dirname(db))})
                if 0 < max_count <= len(out):
                    conn.close()
                    return out
            conn.close()
        except sqlite3.Error:
            continue
        finally:
            os.unlink(tmp.name)
    return out
