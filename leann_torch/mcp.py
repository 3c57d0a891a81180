"""MCP (Model Context Protocol) server over stdio for the port:
``python -m leann_torch.mcp [--device cuda|cpu]``.

Counterpart of the JAX package's ``mcp.py``. Parity with the reference MCP
server (mcp.py:8-155): a minimal JSON-RPC loop on stdin exposing
``leann_search`` and ``leann_list`` tools. Like the reference, tool calls
shell out to the port's CLI (``python -m leann_torch.cli``, mcp.py:98-110)
so the server process stays lightweight and index state lives in the CLI
process; the server's ``--device`` goes to every call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Any, Dict

PROTOCOL_VERSION = "2024-11-05"

TOOLS = [
    {
        "name": "leann_search",
        "description": "Search a LEANN vector index for passages relevant to a query.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "index_name": {"type": "string", "description": "Name of the index to search"},
                "query": {"type": "string", "description": "Search query"},
                "top_k": {"type": "integer", "default": 5},
                "complexity": {"type": "integer", "default": 64},
            },
            "required": ["index_name", "query"],
        },
    },
    {
        "name": "leann_list",
        "description": "List all LEANN indexes across registered projects.",
        "inputSchema": {"type": "object", "properties": {}},
    },
]


def _run_cli(args: list, device: str = "cuda") -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "leann_torch.cli", *args, "--device", device],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        return f"error: {proc.stderr.strip() or proc.stdout.strip()}"
    return proc.stdout.strip()


def handle_request(req: Dict[str, Any], device: str = "cuda") -> "Dict[str, Any] | None":
    method = req.get("method")
    rid = req.get("id")
    if method == "initialize":
        result = {
            "protocolVersion": PROTOCOL_VERSION,
            "capabilities": {"tools": {}},
            "serverInfo": {"name": "leann-torch-mcp", "version": "0.1.0"},
        }
    elif method == "notifications/initialized":
        return None
    elif method == "tools/list":
        result = {"tools": TOOLS}
    elif method == "tools/call":
        params = req.get("params", {})
        name = params.get("name")
        args = params.get("arguments", {})
        if name == "leann_search":
            out = _run_cli([
                "search", args["index_name"], args["query"],
                "--top-k", str(args.get("top_k", 5)),
                "--complexity", str(args.get("complexity", 64)),
                "--non-interactive",
            ], device)
        elif name == "leann_list":
            out = _run_cli(["list"], device)
        else:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32601, "message": f"unknown tool {name!r}"}}
        result = {"content": [{"type": "text", "text": out}]}
    else:
        if rid is None:
            return None
        return {"jsonrpc": "2.0", "id": rid, "error": {"code": -32601, "message": f"unknown method {method!r}"}}
    return {"jsonrpc": "2.0", "id": rid, "result": result}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m leann_torch.mcp", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="handed to every CLI call (default cuda)")
    device = ap.parse_args(argv).device
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        resp = handle_request(req, device)
        if resp is not None:
            sys.stdout.write(json.dumps(resp) + "\n")
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
