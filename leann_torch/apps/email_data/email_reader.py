"""Apple Mail ``.emlx`` reader (leann_torch's copy of the JAX package's
``apps/email_data/email_reader.py``, which the port does not import).

Parity with the reference LEANN_email_reader (apps/email_data/
LEANN_email_reader.py:27-167): parses .emlx files (a byte-count line, an
RFC-822 message, then a plist blob), extracts subject/from/to/date + text
body, and auto-discovers Apple Mail "Messages" directories under
``~/Library/Mail``.
"""

from __future__ import annotations

import email
import email.policy
import os
from pathlib import Path
from typing import Any, Dict, List, Optional


def parse_emlx(path: str) -> Optional[Dict[str, Any]]:
    try:
        raw = Path(path).read_bytes()
        # first line is the message byte count
        nl = raw.index(b"\n")
        count = int(raw[:nl].strip())
        msg_bytes = raw[nl + 1 : nl + 1 + count]
        msg = email.message_from_bytes(msg_bytes, policy=email.policy.default)
    except (ValueError, OSError, IndexError):
        return None
    body = ""
    try:
        part = msg.get_body(preferencelist=("plain", "html"))
        if part is not None:
            body = part.get_content()
            if part.get_content_type() == "text/html":
                import re

                body = re.sub(r"<[^>]+>", " ", body)
    except Exception:
        body = ""
    return {
        "subject": str(msg.get("Subject", "")),
        "from": str(msg.get("From", "")),
        "to": str(msg.get("To", "")),
        "date": str(msg.get("Date", "")),
        "body": body.strip(),
        "file_path": path,
    }


def find_mail_directories(root: Optional[str] = None) -> List[str]:
    """Auto-discover Apple Mail Messages dirs (reference auto-discovery)."""
    root = root or os.path.expanduser("~/Library/Mail")
    found = []
    if not os.path.isdir(root):
        return found
    for dirpath, dirnames, _ in os.walk(root):
        if os.path.basename(dirpath) == "Messages":
            found.append(dirpath)
            dirnames[:] = []
    return found


def load_emails(mail_dirs: Optional[List[str]] = None, max_count: int = -1) -> List[Dict[str, Any]]:
    dirs = mail_dirs or find_mail_directories()
    out: List[Dict[str, Any]] = []
    for d in dirs:
        for dirpath, _, filenames in os.walk(d):
            for fn in filenames:
                if not fn.endswith(".emlx"):
                    continue
                parsed = parse_emlx(os.path.join(dirpath, fn))
                if parsed and parsed["body"]:
                    out.append(parsed)
                    if 0 < max_count <= len(out):
                        return out
    return out
