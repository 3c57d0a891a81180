"""WeChat chat-history reader for WeChatTweak JSON exports (leann_torch's
copy of the JAX package's ``apps/history_data/wechat_history.py``, which
the port does not import).

Parity with the reference WeChat pipeline (apps/history_data/
wechat_history.py:93-551): consumes the REAL WeChatTweak-CLI export artifact —
one JSON file per contact holding a flat message list with keys ``fromUser``,
``toUser``, ``content`` (raw string with ``wxid_xxx:`` sender prefixes, or a
dict for quoted messages), ``message``, ``createTime`` (unix epoch seconds)
and ``isSentFromSelf``. Media/system messages arrive as XML payloads inside
``content`` and are filtered out (image/emoji/voice/video/appmsg/recalled),
matching the reference's ``_is_text_message`` semantics
(wechat_history.py:139-198).

Two document modes, as in the reference ``load_data``
(wechat_history.py:394-551):

* per-message (default): one chunk per readable message with a
  contact/time/self header;
* concatenated (``concatenate=True``): messages grouped into conversation
  windows bounded by ``max_length`` characters AND a ``time_window_minutes``
  gap, with optional ``overlap_messages`` carried between consecutive groups
  (wechat_history.py:200-315).

The simplified shape ``[{"contact", "messages": [{"from", "time", "text"}]}]``
(what leann_torch/apps/wechat_exporter.py emits on non-macOS hosts) is accepted too.
"""

from __future__ import annotations

import json
import os
import re
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional, Tuple

_WXID_PREFIX_RE = re.compile(r"^wxid_[^:]+:\s*")
_SENDER_PREFIX_RE = re.compile(r"^[^:<\n]{1,64}:\s*")
_MARKUP_RE = re.compile(r"<[^>]+>|\[[^\]]{1,16}\]")  # xml-ish markup + emoticon tags


def _extract_readable_text(content: Any) -> str:
    """Readable text from a raw WeChatTweak ``content`` payload.

    Dict payloads (quoted messages) contribute their title/quoted/content/
    text fields joined with `` | ``; string payloads lose their
    ``wxid_xxx:`` / ``Name:`` sender prefixes; XML bodies and recall notices
    yield empty (reference wechat_history.py:93-137).
    """
    if not content:
        return ""
    if isinstance(content, dict):
        parts = [str(content[k]) for k in ("title", "quoted", "content", "text")
                 if content.get(k)]
        return " | ".join(parts)
    if not isinstance(content, str):
        return ""
    clean = _WXID_PREFIX_RE.sub("", content)
    clean = _SENDER_PREFIX_RE.sub("", clean)
    clean = clean.strip()
    if clean.startswith("<") or "recalled a message" in clean:
        return ""
    return clean


def _is_text_message(content: Any) -> bool:
    """True when the payload is a readable text message — mirrors the
    reference's media-XML screens (wechat_history.py:139-198)."""
    if not content:
        return False
    if isinstance(content, dict):
        return any(content.get(k) for k in ("title", "quoted", "content", "text"))
    if not isinstance(content, str):
        return False
    if "<img" in content and "cdnurl" in content:
        return False
    if "<emoji" in content and "productid" in content:
        return False
    if "<voice" in content or "<video" in content:
        return False
    if "<appmsg" in content and "appid" in content:
        return False
    if "recalled a message" in content:
        return False
    return bool(_extract_readable_text(content))


def clean_message(text: str) -> str:
    """Strip inline XML and emoticon tags like ``[Laugh]`` (the simplified-
    shape fallback carries markup inline instead of as full XML payloads)."""
    return _MARKUP_RE.sub(" ", text or "").strip()


def _fmt_time(epoch: Any) -> str:
    try:
        return datetime.fromtimestamp(float(epoch)).strftime("%Y-%m-%d %H:%M:%S")
    except (TypeError, ValueError, OSError, OverflowError):
        return str(epoch) if epoch else "Unknown"


def _normalize_message(m: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """WeChatTweak or simplified message dict -> {text, time_epoch, time_str,
    sender, self} | None when unreadable/non-text."""
    if not isinstance(m, dict):
        return None
    if "content" in m or "createTime" in m or "fromUser" in m:
        content = m.get("content", "")
        if not _is_text_message(content):
            return None
        text = _extract_readable_text(content) or str(m.get("message", "")).strip()
        if not text:
            return None
        epoch = m.get("createTime", 0)
        return {
            "text": text,
            "time_epoch": float(epoch) if epoch else 0.0,
            "time_str": _fmt_time(epoch) if epoch else "Unknown",
            "sender": m.get("fromUser", ""),
            "self": bool(m.get("isSentFromSelf", False)),
        }
    # simplified exporter shape
    text = clean_message(m.get("text") or "")
    if not text:
        return None
    return {
        "text": text,
        "time_epoch": 0.0,
        "time_str": str(m.get("time", "")) or "Unknown",
        "sender": m.get("from", m.get("sender", "?")),
        "self": False,
    }


def _iter_contact_messages(payload: Any, fallback_contact: str
                           ) -> Iterable[Tuple[str, List[Any]]]:
    if isinstance(payload, dict):
        payload = [payload]
    if (isinstance(payload, list) and payload and isinstance(payload[0], dict)
            and "messages" in payload[0]):
        for grp in payload:
            yield grp.get("contact", fallback_contact), grp.get("messages", [])
    else:
        yield fallback_contact, payload if isinstance(payload, list) else []


def _concatenate(msgs: List[Dict[str, Any]], max_length: int,
                 time_window_minutes: int, overlap_messages: int
                 ) -> List[List[Dict[str, Any]]]:
    """Group normalized messages under the reference's dual constraint:
    a group closes when adding the next message would exceed ``max_length``
    chars, or when the inter-message gap exceeds ``time_window_minutes``
    (-1 disables either bound). ``overlap_messages`` trailing messages carry
    into the next group (wechat_history.py:200-315)."""
    groups: List[List[Dict[str, Any]]] = []
    cur: List[Dict[str, Any]] = []
    cur_len = 0
    last_t: Optional[float] = None

    def close() -> None:
        nonlocal cur, cur_len
        if cur:
            groups.append(cur)
            tail = cur[-overlap_messages:] if overlap_messages > 0 else []
            cur = list(tail)
            cur_len = sum(len(m["text"]) for m in cur)

    for m in msgs:
        if (time_window_minutes != -1 and last_t is not None and m["time_epoch"] > 0
                and (m["time_epoch"] - last_t) / 60 > time_window_minutes):
            close()
        if max_length != -1 and cur and cur_len + len(m["text"]) > max_length:
            close()
        cur.append(m)
        cur_len += len(m["text"])
        if m["time_epoch"] > 0:
            last_t = m["time_epoch"]
    if cur:
        groups.append(cur)
    return groups


def load_wechat_export(
    export_dir: str,
    window: int = 20,
    max_count: int = -1,
    *,
    concatenate: bool = True,
    max_length: int = 1000,
    time_window_minutes: int = 30,
    overlap_messages: int = 0,
    include_non_text: bool = False,
) -> List[Dict[str, Any]]:
    """Read every ``*.json`` under ``export_dir`` ->
    ``[{"text", "metadata": {"contact", "start_time", "end_time",
    "n_messages"}}]``.

    ``concatenate=True`` (default) builds conversation windows bounded by
    ``max_length`` chars / ``time_window_minutes`` gaps / ``window`` messages;
    ``concatenate=False`` emits one chunk per message with the reference's
    per-message header (Contact / Is sent from self / Time / Message).
    ``include_non_text=True`` keeps media/system messages (their ``message``
    summary field) instead of dropping them.
    """
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(export_dir):
        return out
    for fn in sorted(os.listdir(export_dir)):
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(export_dir, fn), encoding="utf-8") as f:
                payload = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        for contact, raw_msgs in _iter_contact_messages(payload, os.path.splitext(fn)[0]):
            msgs = []
            for m in raw_msgs:
                norm = _normalize_message(m)
                if norm is None and include_non_text and isinstance(m, dict):
                    summary = str(m.get("message", "")).strip()
                    if summary:
                        norm = {"text": summary,
                                "time_epoch": float(m.get("createTime", 0) or 0),
                                "time_str": _fmt_time(m.get("createTime", 0)),
                                "sender": m.get("fromUser", ""), "self": False}
                if norm is not None:
                    msgs.append(norm)
            if not msgs:
                continue
            if not concatenate:
                for m in msgs:
                    out.append({
                        "text": (f"Contact: {contact}\n"
                                 f"Is sent from self: {m['self']}\n"
                                 f"Time: {m['time_str']}\n"
                                 f"Message: {m['text']}"),
                        "metadata": {"contact": contact, "start_time": m["time_str"],
                                     "end_time": m["time_str"], "n_messages": 1},
                    })
                    if 0 < max_count <= len(out):
                        return out
                continue
            for grp in _concatenate(msgs, max_length, time_window_minutes,
                                    overlap_messages):
                # the `window` message cap is an additional upper bound kept
                # from the simplified reader's contract (tests/CLI callers)
                for s in range(0, len(grp), window if window > 0 else len(grp)):
                    sub = grp[s : s + window] if window > 0 else grp
                    lines = [
                        f"({m['time_str']}) "
                        f"{'[Me]' if m['self'] else '[' + (m['sender'] or 'Contact') + ']'}: "
                        f"{m['text']}"
                        for m in sub
                    ]
                    out.append({
                        "text": "\n".join(lines),
                        "metadata": {"contact": contact,
                                     "start_time": sub[0]["time_str"],
                                     "end_time": sub[-1]["time_str"],
                                     "n_messages": len(sub)},
                    })
                    if 0 < max_count <= len(out):
                        return out
    return out
